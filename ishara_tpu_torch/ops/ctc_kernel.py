"""CTC loss by forward-backward recursions with an analytic gradient (port
of ``ishara_tpu/ops/ctc_kernel.py``).

:func:`ctc_loss_kernel` replaces the Pallas ``ctc_loss_kernel``: the same
value and gradient as :func:`ishara_tpu_torch.ops.ctc.ctc_loss` restricted
to the training contract (every row's logit length is the full ``T``, label
length is the non-blank count, blank = pad). On a CUDA tensor it launches
``csrc/ctc.cu`` -- an alpha kernel in the forward pass and a beta kernel in
the backward pass, each a chain warp per row that steps only the row's own
``2L + 1`` states, fed by producer warps and, backward, drained by gradient
warps -- or raises; on a CPU tensor it runs the plain version beside it
(:func:`ctc_forward_plain`, :func:`ctc_backward_plain`), which repeats the
kernels' arithmetic step by step: additive -1e30 masks, the three-way
log-add-exp ``lae(lae(a, b), c)`` with its both -1e30 guard, the ``beta +
emit`` carry, ``exp(min(gamma, 0))``, occupancies 0 at the states past
``2L``. The kernels take exp and log from the card's ex2 / lg2 units; the
plain version from PyTorch.

Gradient identity (the classic forward-backward result): with
``alpha_t(s)`` inclusive and ``beta_t(s)`` exclusive of frame t's emission,

    dL_b / dlogits[b, t, c] = softmax(logits)[b, t, c]
        - sum_{s: ext[b, s] = c} exp(alpha_t(s) + beta_t(s) - logP_b).

No batch padding is needed here (the reference pads odd batches for its
grid): one CUDA block handles one batch row. :func:`ctc_plan` mirrors the
kernels' launch plan and :func:`ctc_fits` their guard.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ctc import NEG_INF as NEG
from .ctc import _logaddexp, extend_labels, reduce_loss


def _lae3(a, b, c):
    return _logaddexp(_logaddexp(a, b), c)


def _masks(labels, blank_id):
    lab_ext, allow_skip, state_valid, lab_len = extend_labels(labels,
                                                              blank_id)
    skip_add = torch.where(allow_skip, 0.0, NEG).to(torch.float32)
    valid_add = torch.where(state_valid, 0.0, NEG).to(torch.float32)
    return lab_ext, skip_add, valid_add, lab_len


def _emit(logits, lab_ext):
    """(log-probabilities [B, T, C], emit [B, T, S])."""
    B, T, _ = logits.shape
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    S = lab_ext.shape[1]
    return log_probs, torch.gather(log_probs, 2,
                                   lab_ext[:, None, :].expand(B, T, S))


def _shift_r(a, n):
    return torch.cat([a.new_full((a.shape[0], n), NEG), a[:, :-n]], dim=1)


def _shift_l(a, n):
    return torch.cat([a[:, n:], a.new_full((a.shape[0], n), NEG)], dim=1)


def ctc_forward_plain(logits, labels, blank_id: int = 59):
    """Plain version of the alpha kernel: (nll [B], alpha [B, T, S])."""
    B, T, _ = logits.shape
    lab_ext, skip_add, valid_add, lab_len = _masks(labels, blank_id)
    S = lab_ext.shape[1]
    _, emit = _emit(logits, lab_ext)
    s_idx = torch.arange(S, device=logits.device)[None, :]
    init_add = torch.where(s_idx < 2, 0.0, NEG).to(torch.float32) + valid_add
    alphas = [init_add + emit[:, 0]]
    for t in range(1, T):
        prev = alphas[-1]
        new = _lae3(prev, _shift_r(prev, 1), _shift_r(prev, 2) + skip_add)
        alphas.append(new + emit[:, t] + valid_add)
    alpha = torch.stack(alphas, dim=1)
    a_last = alphas[-1]
    a_lab = torch.where(
        lab_len > 0,
        a_last.gather(1, (2 * lab_len - 1).clamp(min=0)[:, None])[:, 0], NEG)
    a_blk = a_last.gather(1, (2 * lab_len)[:, None])[:, 0]
    return -_logaddexp(a_lab, a_blk), alpha


def ctc_backward_plain(logits, labels, alpha, nll, dy, blank_id: int = 59):
    """Plain version of the beta kernel: d(sum_b dy_b * nll_b) / dlogits,
    f32 ``[B, T, C]``. Reads ``alpha`` at each row's valid states only (the
    kernel writes no others)."""
    B, T, C = logits.shape
    lab_ext, skip_add, valid_add, lab_len = _masks(labels, blank_id)
    S = lab_ext.shape[1]
    log_probs, emit = _emit(logits, lab_ext)
    s_idx = torch.arange(S, device=logits.device)[None, :]
    L = lab_len[:, None]
    state_valid = s_idx < 2 * L + 1
    fin = torch.where((s_idx == 2 * L) | ((s_idx == 2 * L - 1) & (L > 0)),
                      0.0, NEG).to(torch.float32)
    # a skip out of s lands at s + 2: allowed iff allow_skip[s + 2]
    skip_from = _shift_l(skip_add, 2)
    logp = -nll[:, None]
    p_state = [None] * T
    be = None
    for t in reversed(range(T)):
        if t == T - 1:
            beta = fin
        else:
            beta = _lae3(be, _shift_l(be, 1), _shift_l(be, 2) + skip_from) \
                + valid_add
        be = beta + emit[:, t]
        gamma = alpha[:, t] + beta - logp
        p_state[t] = torch.where(state_valid,
                                 torch.exp(torch.clamp(gamma, max=0.0)), 0.0)
    p_state = torch.stack(p_state, dim=1)                     # [B, T, S]
    occ = torch.zeros_like(log_probs).scatter_add_(
        2, lab_ext[:, None, :].expand(B, T, S), p_state)
    return (torch.exp(log_probs) - occ) * dy[:, None, None]


# The kernels' launch plan, as csrc/ctc.cu computes it (ishara_ctc_plan):
# the chain's shape, the shared-memory ring's chunks; a producer warp a
# ring slot and, backward, GRAD_WARPS gradient warps beside the chain.
GRAD_WARPS = 6
MAX_CHAIN_WARPS = 22
SMEM_PAIR, SMEM_LIMIT = 113 * 1024, 227 * 1024


def chain_shape(n: int) -> tuple[int, int]:
    """(states a lane K, chain warps W) for a row of ``n`` states."""
    k, w = -(-n // 32), 1
    if k > 8:
        k, w = 8, -(-n // 256)
    if w > 9:
        k, w = 16, -(-n // 512)
    return k, w


def _smem_bytes(U, C, backward, stage, tc, ns) -> int:
    slots = ns * tc
    K, W = chain_shape(2 * U + 1)
    ring = slots * 32 * K * W
    words = (2 * ring if backward else ring) + 2 * slots \
        + (slots * C if stage else 0) + (3 if backward else 1) * U \
        + 128 + 4 + 32
    return 3 * ns * 8 + 4 * words


def ctc_plan(U: int, C: int, backward: bool):
    """(K, W, frames a chunk, chunks in the ring, logits staged (0 / 1),
    shared-memory bytes) of a launch with ``U`` labels (its widest row,
    ``2U + 1`` states) and ``C`` classes, or None when no ring fits a
    block."""
    K, W = chain_shape(2 * U + 1)
    for limit in (SMEM_PAIR, SMEM_LIMIT):
        for stage in (1, 0):
            for tc in (16, 8, 4, 2, 1):
                for ns in (4, 2):
                    nbytes = _smem_bytes(U, C, backward, stage, tc, ns)
                    if nbytes <= limit:
                        return K, W, tc, ns, stage, nbytes
    return None


def ctc_fits(T: int, C: int, U: int) -> bool:
    """True when the kernels take rows of T frames, C classes and U labels
    (``ishara_ctc_fits``): neither T nor C bounds shared memory; the states
    bound the chain's warps and the ring's smallest plan."""
    return T >= 1 and C >= 1 and U >= 0 \
        and 2 * U + 1 <= MAX_CHAIN_WARPS * 512 \
        and ctc_plan(U, C, True) is not None


def _check(logits, labels):
    if logits.dim() != 3 or labels.dim() != 2 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"logits [B, T, C] and labels [B, U] expected, got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")


def _launch_alpha(logits, labels, blank_id, want_alpha):
    B, T, C = logits.shape
    U = labels.shape[1]
    S = 2 * U + 1
    if not ctc_fits(T, C, U):
        raise ValueError(f"the CTC kernels step at most "
                         f"{MAX_CHAIN_WARPS * 512} states and keep a ring of "
                         f"at least 4 (2U + 1) words in shared memory, got "
                         f"T={T}, U={U}, C={C}")
    nll = logits.new_empty((B,))
    alpha = logits.new_empty((B, T, S)) if want_alpha else None
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("ctc", "ishara_ctc_alpha",
                         [I, P, P, I, I, I, I, I, P, P, P])
    rc = fn(_build.device_index(logits), logits.data_ptr(),
            labels.data_ptr(), B, T, C, U, blank_id,
            None if alpha is None else alpha.data_ptr(), nll.data_ptr(),
            _build.stream_of(logits))
    _build.check("ctc", rc, "CTC alpha kernel")
    return nll, alpha


def _launch_beta(logits, labels, alpha, nll, dy, blank_id):
    B, T, C = logits.shape
    grad = torch.empty_like(logits)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("ctc", "ishara_ctc_beta",
                         [I, P, P, P, P, P, I, I, I, I, I, P, P])
    rc = fn(_build.device_index(logits), logits.data_ptr(),
            labels.data_ptr(), alpha.data_ptr(), nll.data_ptr(),
            dy.data_ptr(), B, T, C, labels.shape[1], blank_id,
            grad.data_ptr(), _build.stream_of(logits))
    _build.check("ctc", rc, "CTC beta kernel")
    return grad


class _CtcNll(torch.autograd.Function):
    """Per-row NLL; logits f32 contiguous, labels int32 contiguous."""

    @staticmethod
    def forward(ctx, logits, labels, blank_id):
        ctx.blank_id = blank_id
        if logits.device.type == "cpu":
            nll, alpha = ctc_forward_plain(logits, labels, blank_id)
        else:
            nll, alpha = _launch_alpha(logits, labels, blank_id,
                                       ctx.needs_input_grad[0])
            ctc_loss_kernel.launches += 1
        ctx.save_for_backward(logits, labels, alpha, nll)
        return nll

    @staticmethod
    def backward(ctx, dy):
        logits, labels, alpha, nll = ctx.saved_tensors
        dy = dy.to(torch.float32).contiguous()
        if logits.device.type == "cpu":
            grad = ctc_backward_plain(logits, labels, alpha, nll, dy,
                                      ctx.blank_id)
        else:
            grad = _launch_beta(logits, labels, alpha, nll, dy, ctx.blank_id)
            ctc_loss_kernel.launches_bwd += 1
        return grad, None, None


def ctc_loss_kernel(logits: torch.Tensor, labels: torch.Tensor,
                    blank_id: int = 59, reduction: str = "mean"):
    """CTC loss for the training contract (full logit length, labels
    blank-padded): logits ``[B, T, C]``, labels ``[B, U]`` integers.
    Replaces ``ishara_tpu.ops.ctc_kernel.ctc_loss_kernel``."""
    _check(logits, labels)
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the CTC kernels run on CUDA or CPU tensors, not "
                         f"{logits.device}")
    logits32 = logits.to(torch.float32).contiguous()
    labels32 = labels.to(device=logits.device, dtype=torch.int32).contiguous()
    return reduce_loss(_CtcNll.apply(logits32, labels32, int(blank_id)),
                       reduction)


# launches of the alpha (forward) and the beta (backward) kernel
ctc_loss_kernel.launches = 0
ctc_loss_kernel.launches_bwd = 0
