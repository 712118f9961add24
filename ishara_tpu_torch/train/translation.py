"""Train and eval steps of the encoder-decoder translation model (port of
``ishara_tpu/train/translation.py``).

A step is the training forward (teacher forcing on ``tokens[:, :-1]``),
the confidence target, the loss, the backward and the shared guarded update
of :mod:`.state` (optimizer, Lookahead, non-finite guard), all on the
state's device. The confidence target is the normalized Levenshtein
similarity between the argmax of the detached logits and the target,
computed on the device (:mod:`ishara_tpu_torch.ops.levenshtein`) with no
host sync.

**Randomness** follows the CTC steps: the step's dropout and augmentation
seeds are :func:`ishara_tpu_torch.ops.dropout.step_seeds` of (``seed``,
``state.step``), so the same (seed, step) gives the same masks and
augmentations.

**Data and tensor parallelism** (``mesh=``) follow the CTC steps: each process takes
its rows of the global batch and the step computes the unsharded step's
function. The cross-entropy is a mean over the global batch's non-pad
tokens, so each process divides its token sum by the global count (times
the number of processes, which the mean of the all-reduce takes out).
"""

from __future__ import annotations

import torch

from ..decode.autoregressive import greedy_from_memory
from ..models.seq2seq import translation_loss
from ..ops.dropout import step_seeds
from ..ops.levenshtein import normalized_similarity
from ..parallel.shard import batch_shard, gather_rows, reduce_sum_
from ..parallel.tp import gathered_weights
from ..preprocess.augment import augment, draws_from_seed
from ..preprocess.pipeline import GroupStats, frame_mask
from .state import (
    TrainState,
    _finish_step,
    _flat_grads,
    _mean_over_shards,
    _on,
    _preprocess_batch,
    _row0,
    check_mesh,
    mesh_shard,
)


def token_lengths(ids: torch.Tensor, eos: int, pad: int) -> torch.Tensor:
    """Length up to (excluding) the first eos or pad; a row with neither has
    its full length. int32 [B]."""
    is_end = (ids == eos) | (ids == pad)
    # argmax returns the first of equal maxima: the first end
    first = torch.argmax(is_end.to(torch.int32), dim=-1)
    full = torch.full_like(first, ids.shape[-1])
    return torch.where(is_end.any(dim=-1), first, full).to(torch.int32)


def _grouped(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The preprocess output ``[B, T, 276]`` as the model's ``[B, T, 92,
    3]`` (the concat order is landmark-major, so a reshape regroups it) and
    its frame mask ``[B, T]``."""
    B, T, _ = flat.shape
    return flat.reshape(B, T, 92, 3), frame_mask(flat)


def _ce_denominator(tgt_out, pad_idx, shard):
    """The divisor of this process's token sum: its own token count
    (clamped at 1) alone, or the global count over the processes."""
    if shard is None:
        return None
    count = (tgt_out != pad_idx).sum().to(torch.float32).reshape(1)
    reduce_sum_(count, shard.groups)
    return torch.clamp(count[0], min=1.0) / (shard.rows // shard.local)


def make_translation_train_step(pad_idx: int = 0, eos_idx: int = 2,
                                conf_weight: float = 0.1,
                                with_grads: bool = False, mesh=None):
    """Train step on a grouped batch: ``x`` ``[B, T, 92, 3]``, ``mask``
    ``[B, T]`` (optional), ``tokens`` ``[B, S]`` (sos ... eos pad ...).
    Returns (state, {"loss", "grad_norm", "confidence_mean"}) -- and
    "grads" by parameter name with ``with_grads``. With ``mesh`` the batch
    is this process's rows of the global batch."""
    check_mesh(mesh)

    def step(state: TrainState, batch: dict, seed: int = 0):
        batch = _on(batch, state.device)
        dropout_seed = step_seeds(seed, state.step)[0:1]
        tokens = batch["tokens"]
        shard = mesh_shard(mesh, tokens.shape[0])
        tgt_in, tgt_out = tokens[:, :-1], tokens[:, 1:]
        old_stats = [b.clone() for b in state.batch_stats.values()]
        # the Parameters, taken before any is swapped for its gathered value
        params = list(state.model.parameters())
        with batch_shard(shard), gathered_weights(state.model):
            pred, confidence = state.model(
                batch["x"], batch.get("mask"), tgt_in, training=True,
                seed=dropout_seed)
            with torch.no_grad():
                pred_ids = torch.argmax(pred, dim=-1).to(torch.int32)
                sim = normalized_similarity(
                    pred_ids, tgt_out,
                    token_lengths(pred_ids, eos_idx, pad_idx),
                    token_lengths(tgt_out, eos_idx, pad_idx))
            loss = translation_loss(
                pred, tgt_out, confidence, sim, pad_idx=pad_idx,
                conf_weight=conf_weight,
                ce_denominator=_ce_denominator(tgt_out, pad_idx, shard))
            grads = _flat_grads(state, loss, params)
        grads, loss = _mean_over_shards(grads, loss.detach(), shard)
        state, metrics = _finish_step(state, loss, grads, old_stats)
        conf = confidence.detach()
        metrics["confidence_mean"] = conf.mean() if shard is None \
            else gather_rows(conf, shard).mean()
        if with_grads:
            metrics["grads"] = state._leaves(grads)
        return state, metrics

    return step


def make_fused_translation_train_step(stats: GroupStats, frame_len: int,
                                      aug_prob: float = 0.2,
                                      pad_idx: int = 0, eos_idx: int = 2,
                                      conf_weight: float = 0.1,
                                      with_grads: bool = False, mesh=None):
    """Train step from a raw batch: ``raw`` ``[B, Tmax, 276]``, ``lengths``
    ``[B]`` and ``labels`` ``[B, S]`` go through augmentation,
    preprocessing, the regrouping to ``[B, T, 92, 3]`` and
    :func:`make_translation_train_step`'s step on the device (with
    ``mesh``, on this process's rows of the global batch)."""
    base = make_translation_train_step(pad_idx, eos_idx, conf_weight,
                                       with_grads=with_grads, mesh=mesh)

    def step(state: TrainState, batch: dict, seed: int = 0):
        batch = _on(batch, state.device)
        seeds = step_seeds(seed, state.step)
        shard = mesh_shard(mesh, batch["raw"].shape[0])
        with torch.no_grad():
            raw, lengths = batch["raw"], batch["lengths"]
            if aug_prob > 0.0:
                raw, lengths = augment(
                    raw, lengths, prob=aug_prob,
                    draws=draws_from_seed(seeds[1:2], raw.shape[0],
                                          _row0(shard)))
            x, mask = _grouped(_preprocess_batch(raw, lengths, stats,
                                                 frame_len, False))
        # the base step draws its dropout seed, seeds[0], from the same
        # (seed, step)
        return base(state, {"x": x, "mask": mask, "tokens": batch["labels"]},
                    seed)

    return step


def make_fused_translation_eval_step(stats: GroupStats, frame_len: int,
                                     max_len: int = 64, pad_idx: int = 0,
                                     eos_idx: int = 2, mesh=None):
    """Eval step from a raw batch: preprocess (no augmentation), the
    encoder once, the uncached greedy decode of ``max_len`` tokens (the
    reference's ``greedy_translate``) and the teacher-forced loss. Returns
    ``loss``, ``loss_per_seq`` (so a caller can pad a tail batch and still
    average over the real rows), ``ids`` ``[B, max_len]`` (sos first),
    ``counts`` (``max_len`` for every row) and ``confidence``. With
    ``mesh`` the batch is this process's rows and the outputs are the
    global batch's, on every process."""
    check_mesh(mesh)

    @torch.no_grad()
    def step(state: TrainState, batch: dict):
        batch = _on(batch, state.device)
        shard = mesh_shard(mesh, batch["raw"].shape[0])
        model = state.model
        x, mask = _grouped(_preprocess_batch(
            batch["raw"], batch["lengths"], stats, frame_len, False))
        labels = batch["labels"]
        with batch_shard(shard), gathered_weights(model):
            memory, confidence = model.encode(x, mask)
            tokens = greedy_from_memory(model, memory, mask, max_len,
                                        eos=eos_idx, pad=pad_idx)
            pred = model.decode(labels[:, :-1], memory, mask)
        tgt_out = labels[:, 1:]
        valid = (tgt_out != pad_idx).to(torch.float32)
        logp = torch.log_softmax(pred, dim=-1)
        nll = -logp.gather(-1, tgt_out[..., None].long())[..., 0]
        per_seq = (nll * valid).sum(dim=1) \
            / torch.clamp(valid.sum(dim=1), min=1.0)
        sums = torch.stack([(nll * valid).sum(), valid.sum()])
        if shard is not None:
            reduce_sum_(sums, shard.groups)
            per_seq, tokens, confidence = (
                gather_rows(t, shard) for t in (per_seq, tokens, confidence))
        loss = sums[0] / torch.clamp(sums[1], min=1.0)
        counts = torch.full((tokens.shape[0],), tokens.shape[1],
                            dtype=torch.int32, device=tokens.device)
        return {"loss": loss, "loss_per_seq": per_seq, "ids": tokens,
                "counts": counts, "confidence": confidence}

    return step
