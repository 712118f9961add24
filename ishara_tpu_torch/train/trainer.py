"""The Trainer: epoch orchestration, validation, checkpoints, telemetry (port
of ``ishara_tpu/train/trainer.py``).

* ``task="ctc"`` trains the encoder of any CTC family
  (:func:`~ishara_tpu_torch.models.encoder.build_model`) on CTC,
  ``task="translation"`` the encoder-decoder model
  (:class:`ASLTranslationModel`, built from the model config's ``dim``,
  ``num_heads``, ``dropout`` and ``variant``) on cross-entropy plus its
  confidence loss;
* each batch is one call of the fused step: augment -> preprocess ->
  forward -> loss -> backward -> update on the device, the host only
  collating the next batch on a prefetch thread;
* validation every ``validate_every_epochs`` with greedy decode (for
  translation the uncached autoregressive decode, decoded through the
  tokenizer) and the three normalized-Levenshtein conventions, and 32
  example predictions;
* best, periodic and final checkpoints, exact mid-epoch resume, early
  stopping, restoring the best weights at the end, and a checkpoint on
  SIGTERM;
* with ``mesh`` (a ``DeviceMesh``, :mod:`ishara_tpu_torch.parallel`) data
  parallelism, one process a card: every process draws the same global
  batch order and keeps its rows (``batch_size / mesh.size()``), the steps
  compute the unsharded step's function, validation scores the global
  batch, and only rank 0 writes logs, histograms and checkpoints, which
  every rank restores from.

Where it differs from the reference: the state lives on ``device`` (default
``cuda``; raises when no card is visible); the step's randomness is the
integer ``TrainConfig.seed``, its masks and augmentations drawn from (seed,
``state.step``) on the device; the initial weights are the port model's own
initialisation, drawn under ``torch.manual_seed(seed)``. Each epoch record
also carries ``data_wait_s`` (time the loop waited for the host's next
batch) and, on validation epochs, ``val_time_s``.
"""

from __future__ import annotations

import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import IsharaConfig
from ..device import resolve_device
from ..evaluation.metrics import normalized_levenshtein
from ..models.encoder import build_model
from ..models.seq2seq import ASLTranslationModel
from ..preprocess.pipeline import GroupStats
from ..utils.logging import MetricLogger
from ..utils.prefetch import prefetch
from ..utils.profiling import Throughput
from .checkpoint import CheckpointManager
from .optim import make_optimizer
from .state import (
    TrainState,
    check_mesh,
    make_fused_ctc_eval_step,
    make_fused_ctc_train_step,
    mesh_shard,
)
from .translation import (
    make_fused_translation_eval_step,
    make_fused_translation_train_step,
)


class Trainer:
    def __init__(
        self,
        config: IsharaConfig,
        train_data,
        val_data,
        tokenizer,
        stats: GroupStats | None = None,
        workdir: str | Path = "runs/default",
        mesh=None,
        max_raw_frames: int = 384,
        task: str = "ctc",
        device=None,
    ):
        if task not in ("ctc", "translation"):
            raise ValueError(task)
        check_mesh(mesh)
        bs = config.train.batch_size
        if mesh is not None and bs % mesh.size():
            raise ValueError(f"batch_size {bs} is not divisible by the "
                             f"mesh's {mesh.size()} processes")
        self.mesh = mesh
        # this process's rows of each global batch, and whether it writes
        local = bs if mesh is None else bs // mesh.size()
        row0 = 0 if mesh is None else mesh_shard(mesh, local).row0
        self._rows = slice(row0, row0 + local)
        self._writes = mesh is None or dist.get_rank() == 0
        self.device = resolve_device(device)
        self.cfg = config
        self.train_data = train_data
        self.val_data = val_data
        self.tokenizer = tokenizer
        self.stats = stats or GroupStats.identity()
        self.workdir = Path(workdir)
        self.max_raw_frames = max_raw_frames
        self._bucket_sampler = None
        self.task = task

        mcfg = config.model
        tcfg = config.train
        if tcfg.bucket_boundaries:
            # the sampler is built first so the LR schedule is sized to the
            # bucketed step count (each bucket drops its own remainder)
            from ..data.sampler import BucketSampler, dataset_lengths

            caps = tuple(sorted({min(b, self.max_raw_frames)
                                 for b in tcfg.bucket_boundaries}))
            self._bucket_sampler = BucketSampler(
                dataset_lengths(train_data), tcfg.batch_size, caps,
                seed=tcfg.seed)
            steps_per_epoch = max(1, len(self._bucket_sampler.batches(0)))
        else:
            steps_per_epoch = max(1, len(train_data) // tcfg.batch_size)
        tcfg.steps_per_epoch = steps_per_epoch

        tx, self.schedule = make_optimizer(tcfg)
        lookahead = (tcfg.lookahead_sync_period
                     if tcfg.optimizer == "radam_lookahead" else 1)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(tcfg.seed)
            if task == "ctc":
                # on the CPU: TrainState.create moves it
                self.model = build_model(mcfg, device="cpu")
            else:
                self.model = ASLTranslationModel(
                    num_classes=tokenizer.vocab_size, feature_dim=mcfg.dim,
                    num_heads=mcfg.num_heads, dropout=mcfg.dropout,
                    # model.variant selects the encoder family here too
                    encoder_type=("conformer" if mcfg.variant == "conformer"
                                  else "squeezeformer"))
        self.state = TrainState.create(self.model, tx, device=self.device,
                                       lookahead_sync_period=lookahead)
        if task == "ctc":
            step_kw = dict(lr_flip_prob=tcfg.lr_flip_prob,
                           dominant_hand=mcfg.dominant_hand, qat=tcfg.qat)

            def make_step(with_grads=False):
                return make_fused_ctc_train_step(
                    self.stats, mcfg.frame_len, tcfg.aug_prob,
                    mcfg.blank_id, with_grads=with_grads, mesh=mesh,
                    **step_kw)

            self._eval_step = make_fused_ctc_eval_step(
                self.stats, mcfg.frame_len, mcfg.blank_id,
                dominant_hand=mcfg.dominant_hand, qat=tcfg.qat, mesh=mesh)
        else:
            ids = dict(pad_idx=tokenizer.pad_token,
                       eos_idx=tokenizer.eos_token)

            def make_step(with_grads=False):
                return make_fused_translation_train_step(
                    self.stats, mcfg.frame_len, tcfg.aug_prob,
                    with_grads=with_grads, mesh=mesh, **ids)

            self._eval_step = make_fused_translation_eval_step(
                self.stats, mcfg.frame_len, mesh=mesh, **ids)
        self._train_step = make_step()
        self._hist_step = make_step(with_grads=True) \
            if tcfg.histogram_every_steps > 0 else None

        self.workdir.mkdir(parents=True, exist_ok=True)
        if self._writes:
            config.to_json(self.workdir / "config.json")
        self.logger = MetricLogger(self.workdir if self._writes else None)
        self.ckpt = CheckpointManager(self.workdir / "ckpt")
        self.best_score = -np.inf
        self.history: list[dict] = []
        # resume bookkeeping: epochs fully completed (train() starts there;
        # restored by resume()), and batches consumed inside the epoch in
        # flight, so a checkpoint written mid-epoch resumes at the exact
        # batch: each epoch's schedule is a function of (seed, epoch) and
        # the step's masks of (seed, state.step), so skipping is exact
        self.completed_epochs = 0
        self._epoch_batches_done = 0
        self._resume_skip = 0

    # ------------------------------------------------------------------
    def _epoch_indices(self, epoch: int) -> list:
        """The epoch's batches as (indices, max_frames) pairs: length-
        bucketed with ``bucket_boundaries`` set (data/sampler.py), else a
        (seed, epoch) permutation cut into whole batches."""
        tcfg = self.cfg.train
        if self._bucket_sampler is not None:
            return self._bucket_sampler.batches(epoch)
        rng = np.random.default_rng(tcfg.seed * 1000 + epoch)
        idx = rng.permutation(len(self.train_data))
        bs = tcfg.batch_size
        n = (len(idx) // bs) * bs
        batched = idx[:n].reshape(-1, bs) if n else idx[:0].reshape(0, bs)
        return [(b, self.max_raw_frames) for b in batched]

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int, seed: int,
                    start_batch: int = 0) -> float:
        """One epoch; ``start_batch`` skips the first N batches of the
        (seed, epoch) schedule -- the mid-epoch resume path (batch bi runs
        at the same ``state.step`` as in an uninterrupted run, so its masks
        and augmentations are the same)."""
        tput = Throughput()
        losses = []
        schedule = self._epoch_indices(epoch)[start_batch:]
        batches = prefetch(
            (self.train_data.batch(idx[self._rows], self.tokenizer,
                                   max_frames=cap)
             for idx, cap in schedule),
            depth=2,
        )
        self._epoch_batches_done = start_batch
        self._data_wait = 0.0
        bi = start_batch
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                self._data_wait += time.perf_counter() - t0
                if batch is None:
                    break
                metrics = self._step(bi, batch, seed)
                self._epoch_batches_done = bi + 1
                if bi % 10 == 0:
                    # a non-finite batch is skipped inside the step (every
                    # skip is counted in state.nonfinite_count); this sparse
                    # sample only feeds the loss log
                    loss = float(metrics["loss"])
                    if np.isfinite(loss):
                        losses.append(loss)
                        if self._writes:
                            self._log_step(metrics, loss, epoch, tput)
                bi += 1
        finally:
            batches.close()  # stops the prefetch thread
        return float(np.mean(losses)) if losses else float("nan")

    def _step(self, bi: int, batch: dict, seed: int) -> dict:
        every = self.cfg.train.histogram_every_steps
        if self._hist_step is None or bi % every != 0:
            self.state, metrics = self._train_step(self.state, batch, seed)
            return metrics
        # the same update with the gradients returned: per-layer gradient
        # and parameter histograms
        self.state, metrics = self._hist_step(self.state, batch, seed)
        grads = metrics.pop("grads")
        if not self._writes:
            return metrics
        step = int(self.state.step)
        self.logger.log_histograms(grads, step=step, prefix="grad")
        self.logger.log_histograms(self.state.param_dict(), step=step,
                                   prefix="param")
        return metrics

    def _log_step(self, metrics: dict, loss: float, epoch: int,
                  tput: Throughput) -> None:
        step = int(self.state.step)
        self.logger.log(
            {
                "train_loss": loss,
                "grad_norm": float(metrics["grad_norm"]),
                "lr": float(self.schedule(step)),
                "seqs_per_sec": tput.update(10 * self.cfg.train.batch_size),
                "epoch": epoch,
            },
            step=step,
        )

    def validate(self, max_batches: int | None = None) -> dict:
        bs = self.cfg.train.batch_size
        all_preds, all_targets = [], []
        loss_sum, loss_n = 0.0, 0
        n_batches = max(1, -(-len(self.val_data) // bs))  # ceil: cover tail
        if max_batches:
            n_batches = min(n_batches, max_batches)
        for bi in range(n_batches):
            # the tail batch is padded to the static batch size by repeating
            # the last index; the padded rows are dropped from loss and score
            n_real = min((bi + 1) * bs, len(self.val_data)) - bi * bs
            indices = [min(bi * bs + j, len(self.val_data) - 1)
                       for j in range(bs)]
            batch = self.val_data.batch(
                indices, self.tokenizer, max_frames=self.max_raw_frames
            )
            # this process's rows in; the global batch's outputs back
            out = self._eval_step(self.state, {
                k: batch[k][self._rows] for k in ("raw", "lengths", "labels")})
            loss_sum += float(out["loss_per_seq"][:n_real].sum())
            loss_n += n_real
            ids = out["ids"][:n_real].cpu().numpy()
            counts = out["counts"][:n_real].cpu().numpy()
            all_preds += [
                self.tokenizer.decode(i[:c]) for i, c in zip(ids, counts)
            ]
            all_targets += list(batch["phrases"])[:n_real]
        return {
            "val_loss": loss_sum / max(loss_n, 1),
            "val_score": normalized_levenshtein(all_preds, all_targets),
            "val_score_maxlen": normalized_levenshtein(
                all_preds, all_targets, "max_len"),
            "val_score_pooled": normalized_levenshtein(
                all_preds, all_targets, "pooled"),
            "examples": list(zip(all_preds[:32], all_targets[:32])),
        }

    # ------------------------------------------------------------------
    def train(self, num_epochs: int | None = None) -> list[dict]:
        tcfg = self.cfg.train
        num_epochs = num_epochs or tcfg.num_epochs
        seed = tcfg.seed

        # preemption safety: SIGTERM writes a checkpoint before exit
        def _on_term(signum, frame):
            self._save(wait=True)
            raise SystemExit(143)

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread
        try:
            # resume() restores completed_epochs; epochs already run are
            # not replayed. Early stopping counts from the epoch of the last
            # improvement, observable only at validation epochs.
            last_improve_epoch = self.completed_epochs - 1
            for epoch in range(self.completed_epochs, num_epochs):
                t0 = time.time()
                start_batch = self._resume_skip  # mid-epoch resume offset
                self._resume_skip = 0            # (first epoch only)
                train_loss = self.train_epoch(epoch, seed,
                                              start_batch=start_batch)
                self.completed_epochs = epoch + 1
                self._epoch_batches_done = 0
                rec = {"epoch": epoch, "train_loss": train_loss,
                       "epoch_time_s": round(time.time() - t0, 4),
                       "data_wait_s": round(self._data_wait, 4),
                       "nonfinite_batches": int(self.state.nonfinite_count)}
                stop_early = False
                if (epoch + 1) % tcfg.validate_every_epochs == 0 \
                        or epoch == num_epochs - 1:
                    t1 = time.time()
                    val = self.validate()
                    rec["val_time_s"] = round(time.time() - t1, 4)
                    examples = val.pop("examples")
                    rec.update(val)
                    for p, t in examples[:32] if self._writes else ():
                        print(f"  pred={p!r} target={t!r}")
                    if val["val_score"] > self.best_score:
                        self.best_score = val["val_score"]
                        last_improve_epoch = epoch
                        self._save(val_score=val["val_score"], best=True)
                    elif (tcfg.early_stop_patience > 0
                          and epoch - last_improve_epoch
                          >= tcfg.early_stop_patience):
                        rec["early_stopped"] = True
                        stop_early = True
                if (epoch + 1) % tcfg.checkpoint_every_epochs == 0:
                    self._save()
                if self._writes:
                    self.logger.log(rec, step=int(self.state.step))
                self.history.append(rec)
                if stop_early:
                    break
            if tcfg.restore_best_at_end:
                self.restore_best()
        finally:
            # a final checkpoint is always written
            self._save(wait=True)
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return self.history

    def _save(self, wait: bool = False, best: bool = False, **metrics):
        """A checkpoint of the state with the resume bookkeeping (and
        ``metrics``), written by rank 0 only under a mesh."""
        if self._writes:
            self.ckpt.save(int(self.state.step), self.state,
                           metrics={**metrics, **self._resume_meta()},
                           wait=wait, best=best)

    def _sync(self) -> None:
        """Under a mesh, wait until every process (rank 0's writes
        included) has come this far."""
        if self.mesh is not None:
            dist.barrier()

    def _resume_meta(self) -> dict:
        return {"completed_epochs": self.completed_epochs,
                "epoch_batches_done": int(self._epoch_batches_done),
                "best_score": (float(self.best_score)
                               if np.isfinite(self.best_score) else None)}

    def restore_best(self) -> bool:
        """Load the best-validation checkpoint into ``self.state`` in place.
        Returns False when there is none yet."""
        self._sync()
        try:
            self.state = self.ckpt.restore(self.state, best=True)
            return True
        except FileNotFoundError:
            return False

    def resume(self) -> bool:
        """Restore the newest checkpoint if there is one: parameters,
        optimizer state and step, and the loop's bookkeeping (completed
        epochs, batches consumed in the epoch in flight, best validation
        score), so ``train()`` continues where the interrupted run stopped.
        The continuation skips exactly the batches already consumed, so the
        concatenated run equals an uninterrupted one. Under a mesh every
        process restores from rank 0's checkpoint."""
        self._sync()
        step = self.ckpt.latest_step()
        if step is None:
            return False
        self.state = self.ckpt.restore(self.state)
        meta = self.ckpt.step_meta(step)
        if "completed_epochs" in meta:
            self.completed_epochs = int(meta["completed_epochs"])
        self._resume_skip = int(meta.get("epoch_batches_done", 0))
        if meta.get("best_score") is not None:
            self.best_score = float(meta["best_score"])
        return True
