"""Train state and the CTC train / eval steps (port of
``ishara_tpu/train/state.py``).

One step is forward (bf16-capable), CTC loss, backward, the optimizer update
with lr-coupled weight decay, the Lookahead sync on the step counter and the
BatchNorm statistics update, with no host round-trip: the non-finite guard,
the Lookahead sync and the counters are all selected on the device.

PyTorch idiom where the reference is functional: a step **updates the state
in place** and returns it. The parameters live in one flat float32 tensor
(``state.params``) of which the model's ``nn.Parameter``s are views, so the
optimizer, the Lookahead slow weights and the guard each work on one tensor;
``state.param_dict()`` and friends give the leaves by name.

**Randomness.** The reference folds the step into its key
(``fold_in(rng, state.step)``); here a step takes an integer base ``seed``
and derives its dropout and augmentation seeds from (seed, ``state.step``)
on the device (:func:`ishara_tpu_torch.ops.dropout.step_seeds`), so the same
(seed, step) gives the same masks and augmentations -- also on a step that
the guard skipped, since ``state.step`` advances on those too, while the
learning-rate schedule's own count does not.

**QAT** (``qat=True``): the forward pass computes with the int8
fake-quantized weights of :mod:`.qat`, the gradient reaches the float32
master weights through the straight-through estimator.

**Data parallelism** (``mesh=``): each process takes its rows of a global
batch of ``B`` rows (``B / mesh.size()`` a process) and the step computes
the function the unsharded step computes on all ``B``: its augmentation
and dropout draw at the global rows, BatchNorm takes the global batch's
statistics (:mod:`ishara_tpu_torch.parallel.shard`), and one all-reduce
averages the flat gradient with the loss, so the loss, the gradient norm,
the non-finite guard and Lookahead see the global values and every replica
stays the same bit for bit. On a 2-D ``(dcn, data)`` mesh the sums run
within ``data`` first, then across ``dcn``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..decode.greedy import greedy_decode_batch
from ..device import resolve_device
from ..ops.ctc import ctc_loss
from ..ops.dropout import step_seeds
from ..parallel.shard import batch_shard, gather_rows, reduce_sum_
from ..preprocess.augment import augment, draws_from_seed
from ..preprocess.pipeline import GroupStats, preprocess
from .optim import global_norm
from .qat import qat_weights

_STATS = ("running_mean", "running_var")


def _flatten_parameters(model) -> tuple[torch.Tensor, dict[str, slice]]:
    """Move every parameter of ``model`` into one flat float32 tensor, of
    which each ``nn.Parameter`` becomes a view. Returns the tensor and each
    parameter's slice by name."""
    named = list(model.named_parameters())
    flat = torch.cat([p.detach().reshape(-1).to(torch.float32)
                      for _, p in named])
    slices, at = {}, 0
    for name, p in named:
        n = p.numel()
        p.data = flat[at:at + n].view(p.shape)
        slices[name] = slice(at, at + n)
        at += n
    return flat, slices


class TrainState:
    """``step``, the fast parameters (``params``, flat), the Lookahead
    ``slow_params``, the batch statistics (the model's BatchNorm buffers),
    the optimizer state and ``nonfinite_count``, all on one device."""

    def __init__(self, model, tx, params, slices, slow_params, opt_state,
                 step, nonfinite_count, lookahead_sync_period: int = 5,
                 lookahead_alpha: float = 0.5):
        self.model, self.tx = model, tx
        self.params, self.slices = params, slices
        self.slow_params, self.opt_state = slow_params, opt_state
        self.step, self.nonfinite_count = step, nonfinite_count
        self.lookahead_sync_period = lookahead_sync_period
        self.lookahead_alpha = lookahead_alpha

    @classmethod
    def create(cls, model, tx, device=None, **kw) -> "TrainState":
        """A fresh state around ``model`` (its current weights) on
        ``device`` (default ``cuda``; raises when no card is visible). The
        model is moved there and its parameters are re-laid as views of one
        flat tensor; training mode is the steps' business
        (``model(x, training=True)``)."""
        device = resolve_device(device)
        model = model.to(device)
        params, slices = _flatten_parameters(model)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return cls(model, tx, params, slices, params.clone(),
                   tx.init(params), zero, zero.clone(), **kw)

    @property
    def device(self):
        return self.params.device

    def _leaves(self, flat) -> dict[str, torch.Tensor]:
        shapes = dict(self.model.named_parameters())
        return {name: flat[s].view(shapes[name].shape)
                for name, s in self.slices.items()}

    def param_dict(self) -> dict[str, torch.Tensor]:
        """The fast parameters by name (views of ``params``)."""
        return self._leaves(self.params)

    def slow_param_dict(self) -> dict[str, torch.Tensor]:
        return self._leaves(self.slow_params)

    def moment_dicts(self) -> tuple[dict, dict]:
        """The optimizer's first and second moments by parameter name."""
        return (self._leaves(self.opt_state["mu"]),
                self._leaves(self.opt_state["nu"]))

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The model's BatchNorm running statistics by buffer name."""
        return {name: b for name, b in self.model.named_buffers()
                if name.rsplit(".", 1)[-1] in _STATS}

    def clone(self) -> "TrainState":
        """An independent copy (model, parameters, optimizer state)."""
        model = copy.deepcopy(self.model)
        params, slices = _flatten_parameters(model)
        return TrainState(
            model, self.tx, params, slices, self.slow_params.clone(),
            {k: v.clone() for k, v in self.opt_state.items()},
            self.step.clone(), self.nonfinite_count.clone(),
            self.lookahead_sync_period, self.lookahead_alpha)


def _local(v):
    """A DTensor's local rows (a batch from ``host_local_to_global``), or
    ``v`` itself."""
    to_local = getattr(v, "to_local", None)
    return to_local() if to_local is not None else v


def _on(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (other entries, such as
    the phrases' strings, are left out); a DTensor gives its local rows."""
    return {k: torch.as_tensor(_local(v)).to(device)
            for k, v in batch.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def check_mesh(mesh) -> None:
    """Raise TypeError unless ``mesh`` is None or a ``DeviceMesh``."""
    if mesh is None:
        return
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh "
                        f"(ishara_tpu_torch.parallel.make_mesh), got "
                        f"{type(mesh).__name__}")


def mesh_shard(mesh, local_rows: int):
    """This process's batch shard of ``local_rows`` rows on ``mesh`` (None
    without a mesh)."""
    if mesh is None:
        return None
    from ..parallel.mesh import batch_shard_of

    return batch_shard_of(mesh, local_rows)


def _row0(shard) -> int:
    return 0 if shard is None else shard.row0


def _mean_over_shards(grads, loss, shard):
    """The gradient and the loss averaged over the shard's processes in
    one all-reduce (identity without a shard)."""
    if shard is None:
        return grads, loss
    buf = torch.cat([grads, loss.reshape(1).to(torch.float32)])
    reduce_sum_(buf, shard.groups)
    buf.div_(shard.rows // shard.local)
    return buf[:-1], buf[-1].to(loss.dtype)


def _stats_on(stats: GroupStats, device) -> GroupStats:
    return GroupStats(
        mean={g: torch.as_tensor(v, dtype=torch.float32).to(device)
              for g, v in stats.mean.items()},
        std={g: torch.as_tensor(v, dtype=torch.float32).to(device)
             for g, v in stats.std.items()})


def _preprocess_batch(raw, lengths, stats, frame_len, dominant_hand):
    stats = _stats_on(stats, raw.device)
    return torch.vmap(
        lambda r, n: preprocess(r, n, stats, frame_len,
                                dominant_hand=dominant_hand))(raw, lengths)


def _flat_grads(state: TrainState, loss, params=None) -> torch.Tensor:
    """The gradient of ``loss`` by every parameter (``params``: the model's
    ``Parameter``s, taken before any were swapped for fake-quantized
    copies), laid out as ``state.params`` (zeros where a parameter does not
    reach the loss)."""
    params = list(state.model.parameters()) if params is None else params
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return torch.cat([
        (torch.zeros_like(p) if g is None else g).reshape(-1)
        .to(torch.float32)
        for g, p in zip(grads, params)])


def _loss_and_grads(state: TrainState, x, labels, seed, blank_id,
                    qat=False):
    """(loss, flat gradient, the batch statistics before the forward); the
    backward pass runs inside the QAT block too (a ``remat`` block's
    recomputation must see the same weights)."""
    old_stats = [b.clone() for b in state.batch_stats.values()]
    params = list(state.model.parameters())
    with qat_weights(state.model, qat):
        logits = state.model(x, training=True, seed=seed)
        loss = ctc_loss(logits, labels, blank_id=blank_id)
        grads = _flat_grads(state, loss, params)
    return loss.detach(), grads, old_stats


@torch.no_grad()
def _finish_step(state: TrainState, loss, grads, old_stats):
    """Optimizer update + Lookahead + non-finite guard, shared by the CTC
    and translation train steps. A non-finite loss or gradient leaves every leaf of the
    state unchanged but ``step`` and ``nonfinite_count``; the decision is a
    ``where`` on the device."""
    grad_norm = global_norm(grads)
    updates, new_opt = state.tx.update(grads, state.opt_state, state.params,
                                       grad_norm=grad_norm)
    fast = state.params + updates
    k = state.lookahead_sync_period
    if k > 1:
        sync = (state.step + 1) % k == 0
        slow = state.slow_params
        new_slow = torch.where(sync,
                               slow + state.lookahead_alpha * (fast - slow),
                               slow)
        new_fast = torch.where(sync, new_slow, fast)
    else:
        new_slow, new_fast = fast, fast

    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    state.params.copy_(torch.where(ok, new_fast, state.params))
    state.slow_params.copy_(torch.where(ok, new_slow, state.slow_params))
    for b, old in zip(state.batch_stats.values(), old_stats):
        b.copy_(torch.where(ok, b, old))
    state.opt_state = {name: torch.where(ok, new_opt[name], old)
                       for name, old in state.opt_state.items()}
    state.step = state.step + 1
    state.nonfinite_count = state.nonfinite_count + (~ok).to(torch.int32)
    return state, {"loss": loss, "grad_norm": grad_norm}


def ctc_train_step(state: TrainState, batch: dict, seed: int = 0,
                   blank_id: int = 59) -> tuple[TrainState, dict]:
    """One CTC training step. ``batch``: x ``[B, T, F]`` float32 (already
    preprocessed), labels ``[B, U]``. Returns (state, {"loss",
    "grad_norm"}), both 0-d tensors on the device."""
    batch = _on(batch, state.device)
    dropout_seed = step_seeds(seed, state.step)[0:1]
    loss, grads, old = _loss_and_grads(state, batch["x"], batch["labels"],
                                       dropout_seed, blank_id)
    return _finish_step(state, loss, grads, old)


def make_fused_ctc_train_step(stats: GroupStats, frame_len: int,
                              aug_prob: float = 0.2, blank_id: int = 59,
                              lr_flip_prob: float = 0.0,
                              dominant_hand: bool = False, qat: bool = False,
                              with_grads: bool = False, mesh=None):
    """Train step from a raw batch: ``raw`` ``[B, Tmax, 276]``, ``lengths``
    ``[B]`` and ``labels`` ``[B, U]`` go through augmentation, preprocessing,
    forward, CTC, backward and the update on the device.
    ``dominant_hand`` canonicalises handedness in the preprocess (must match
    serving); ``lr_flip_prob`` enables the LR-flip augmentation; ``qat``
    trains through the int8 fake-quantizer (:mod:`.qat`); ``with_grads``
    also returns the gradients by parameter name. With ``mesh`` (a
    ``DeviceMesh``) the batch is this process's rows of the global batch
    (a DTensor from ``host_local_to_global`` gives its local rows)."""
    check_mesh(mesh)

    def step(state: TrainState, batch: dict, seed: int = 0):
        batch = _on(batch, state.device)
        seeds = step_seeds(seed, state.step)
        shard = mesh_shard(mesh, batch["raw"].shape[0])
        with torch.no_grad():
            raw, lengths = batch["raw"], batch["lengths"]
            if aug_prob > 0.0 or lr_flip_prob > 0.0:
                raw, lengths = augment(
                    raw, lengths, prob=aug_prob, flip_prob=lr_flip_prob,
                    draws=draws_from_seed(seeds[1:2], raw.shape[0],
                                          _row0(shard)))
            x = _preprocess_batch(raw, lengths, stats, frame_len,
                                  dominant_hand)
        with batch_shard(shard):
            loss, grads, old = _loss_and_grads(state, x, batch["labels"],
                                               seeds[0:1], blank_id, qat)
        grads, loss = _mean_over_shards(grads, loss, shard)
        state, metrics = _finish_step(state, loss, grads, old)
        if with_grads:
            metrics["grads"] = state._leaves(grads)
        return state, metrics

    return step


def make_fused_ctc_eval_step(stats: GroupStats, frame_len: int,
                             blank_id: int = 59, dominant_hand: bool = False,
                             qat: bool = False, mesh=None):
    """Eval step from a raw batch: preprocess (no augmentation) -> forward
    -> per-sequence loss -> greedy decode. ``loss_per_seq`` lets a caller
    pad a tail batch and still average over the real rows. With ``qat``
    the forward sees the int8 fake-quantized weights (the numerics of the
    int8 export). With ``mesh`` the batch is this process's rows and the
    outputs are the global batch's, on every process."""
    check_mesh(mesh)

    @torch.no_grad()
    def step(state: TrainState, batch: dict):
        batch = _on(batch, state.device)
        shard = mesh_shard(mesh, batch["raw"].shape[0])
        x = _preprocess_batch(batch["raw"], batch["lengths"], stats,
                              frame_len, dominant_hand)
        with qat_weights(state.model, qat):
            logits = state.model(x, training=False)
        per_seq = ctc_loss(logits, batch["labels"], blank_id=blank_id,
                           reduction="none")
        ids, counts = greedy_decode_batch(logits, blank_id=blank_id)
        if shard is not None:
            per_seq, ids, counts = (gather_rows(t, shard)
                                    for t in (per_seq, ids, counts))
        return {"loss": per_seq.mean(), "loss_per_seq": per_seq,
                "ids": ids, "counts": counts}

    return step


@torch.no_grad()
def ctc_eval_step(state: TrainState, batch: dict, blank_id: int = 59) -> dict:
    batch = _on(batch, state.device)
    logits = state.model(batch["x"], training=False)
    return {"loss": ctc_loss(logits, batch["labels"], blank_id=blank_id),
            "logits": logits}
