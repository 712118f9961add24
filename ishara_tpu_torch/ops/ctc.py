"""CTC loss as a log-space forward recursion (port of
``ishara_tpu/ops/ctc.py``).

A statically shaped alpha recursion over the blank-extended label sequence,
batched, differentiable by autograd through the loop. Blank id is the pad
token (59): ``label_lengths`` defaults to the count of non-blank labels and
``logit_lengths`` to the full frame count.

Shapes: logits ``[B, T, C]``; labels ``[B, U]`` padded with blank; the
extended state dimension is ``S = 2U + 1``. This composite is the plain
version of the kernel in :mod:`.ctc_kernel`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _logaddexp(a, b):
    """log(exp(a) + exp(b)) with -1e30 standing for log 0: where both are
    -1e30 the result is -1e30, and the discarded branch stays finite so that
    autograd never forms inf * 0."""
    m = torch.maximum(a, b)
    both = m <= NEG_INF
    m_safe = torch.where(both, 0.0, m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    s_safe = torch.where(both, 1.0, s)
    return torch.where(both, NEG_INF, m_safe + torch.log(s_safe))


def extend_labels(labels: torch.Tensor, blank_id: int):
    """Blank-extended labels and masks: (lab_ext int64 [B, S], allow_skip
    bool [B, S], state_valid bool [B, S], label_lengths int64 [B]), with
    label lengths taken as the non-blank count."""
    B, U = labels.shape
    S = 2 * U + 1
    s_idx = torch.arange(S, device=labels.device)
    is_label = (s_idx % 2) == 1
    labels = labels.to(torch.int64)
    lab_ext = torch.where(is_label,
                          labels[:, torch.clamp(s_idx // 2, max=U - 1)],
                          blank_id)
    prev2 = torch.cat([lab_ext.new_full((B, 2), -1), lab_ext[:, :-2]], dim=1)
    allow_skip = is_label[None, :] & (lab_ext != prev2) \
        & (s_idx[None, :] >= 2)
    label_lengths = (labels != blank_id).sum(dim=-1)
    state_valid = s_idx[None, :] < (2 * label_lengths[:, None] + 1)
    return lab_ext, allow_skip, state_valid, label_lengths


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    raise ValueError(reduction)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             logit_lengths: torch.Tensor | None = None,
             label_lengths: torch.Tensor | None = None,
             blank_id: int = 59, reduction: str = "mean",
             impl: str = "auto") -> torch.Tensor:
    """Negative log-likelihood of ``labels`` under the CTC alignment model.

    ``impl``: "auto" sends the training contract (default lengths) to the
    forward-backward kernel (:func:`.ctc_kernel.ctc_loss_kernel`) when
    ``logits`` is a CUDA tensor; "scan" forces this composite; "kernel"
    forces the kernel's module (its plain version on a CPU tensor)."""
    if impl not in ("auto", "scan", "kernel"):
        raise ValueError(f"impl must be 'auto', 'scan' or 'kernel', "
                         f"got {impl!r}")
    if impl != "scan" and logit_lengths is None and label_lengths is None:
        if impl == "kernel" or logits.is_cuda:
            from .ctc_kernel import ctc_loss_kernel
            return ctc_loss_kernel(logits, labels, blank_id=blank_id,
                                   reduction=reduction)
    B, T, C = logits.shape
    U = labels.shape[1]
    S = 2 * U + 1
    dev = logits.device

    lab_ext, allow_skip, _, nonblank = extend_labels(labels, blank_id)
    if label_lengths is None:
        label_lengths = nonblank
    label_lengths = label_lengths.to(device=dev, dtype=torch.int64)
    if logit_lengths is None:
        logit_lengths = torch.full((B,), T, dtype=torch.int64, device=dev)
    logit_lengths = logit_lengths.to(device=dev, dtype=torch.int64)
    s_idx = torch.arange(S, device=dev)
    state_valid = s_idx[None, :] < (2 * label_lengths[:, None] + 1)

    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    # emit[t, b, s] = log_probs[b, t, ext[b, s]]
    emit = torch.gather(log_probs, 2,
                        lab_ext[:, None, :].expand(B, T, S)).transpose(0, 1)

    neg = emit.new_full((B, S), NEG_INF)
    first = torch.where(label_lengths > 0, emit[0, :, 1], NEG_INF)
    alpha = torch.cat([emit[0, :, :1], first[:, None], neg[:, 2:]], dim=1)

    def shift(a, n):
        return torch.cat([neg[:, :n], a[:, :-n]], dim=1)

    for t in range(1, T):
        skip = torch.where(allow_skip, shift(alpha, 2), NEG_INF)
        new = _logaddexp(_logaddexp(alpha, shift(alpha, 1)), skip) + emit[t]
        new = torch.where(state_valid, new, NEG_INF)
        active = (t < logit_lengths)[:, None]    # rows past their length
        alpha = torch.where(active, new, alpha)  # stay frozen

    final_label = 2 * label_lengths - 1
    final_blank = 2 * label_lengths
    a_label = torch.where(
        label_lengths > 0,
        alpha.gather(1, final_label.clamp(min=0)[:, None])[:, 0], NEG_INF)
    a_blank = alpha.gather(1, final_blank[:, None])[:, 0]
    return reduce_loss(-_logaddexp(a_label, a_blank), reduction)
