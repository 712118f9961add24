"""Checkpoint save / restore (port of ``ishara_tpu/train/checkpoint.py``).

The same surface as the reference's orbax wrapper, in the port's own format:
one ``torch.save`` file a step holding the reference's payload -- ``params``,
``slow_params``, ``batch_stats``, ``opt_state`` and ``step`` (not
``nonfinite_count``) -- in a main chain that keeps the newest
``max_to_keep``, a protected ``best/`` chain that keeps one, and the
``meta.json`` sidecar of metrics and resume bookkeeping.

Every file is written under a temporary name and renamed into place, so a
preemption leaves either the old checkpoint or the new one, never half of
one. :meth:`CheckpointManager.restore` writes **in place**: the port's
``TrainState`` keeps each parameter of its model as a view of one flat
tensor, so the restored values are copied into ``state.params``,
``state.slow_params``, the model's BatchNorm buffers and the optimizer
state's tensors, never swapped for new tensors the model would not see.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _atomic_write(path: Path, write) -> None:
    """``write(tmp)`` to a temporary name beside ``path``, then rename it
    over ``path``."""
    tmp = path.with_name(f".{path.name}.tmp")
    write(tmp)
    os.replace(tmp, path)


class _Chain:
    """One directory of ``step_<n>.pt`` files, keeping the newest
    ``max_to_keep``."""

    def __init__(self, directory: Path, max_to_keep: int):
        self.directory = directory
        self.max_to_keep = max_to_keep
        directory.mkdir(parents=True, exist_ok=True)

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _STEP_FILE.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: dict) -> None:
        _atomic_write(self.path(step), lambda tmp: torch.save(payload, tmp))
        for old in self.steps()[:-self.max_to_keep]:
            self.path(old).unlink(missing_ok=True)


class CheckpointManager:
    """Best / latest retention with a metadata sidecar."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self._main = _Chain(self.directory, max_to_keep)
        # best checkpoints live in their own chain so the recency-only
        # retention of the main chain can never remove them
        self._best = _Chain(self.directory / "best", 1)
        self._meta_path = self.directory / "meta.json"

    @staticmethod
    def _payload(state) -> dict:
        """The reference's payload, on the host."""
        return {
            "params": state.params.detach().cpu(),
            "slow_params": state.slow_params.detach().cpu(),
            "batch_stats": {k: v.detach().cpu()
                            for k, v in state.batch_stats.items()},
            "opt_state": {k: v.detach().cpu()
                          for k, v in state.opt_state.items()},
            "step": state.step.detach().cpu(),
        }

    @staticmethod
    def _jsonable(v):
        if isinstance(v, (bool, int, str)) or v is None:
            return v
        return float(v)

    def save(self, step: int, state, metrics: dict | None = None,
             wait: bool = False, best: bool = False) -> None:
        """``best=True`` also writes to the protected best chain. ``metrics``
        lands in the meta.json sidecar -- the Trainer keeps its resume
        bookkeeping there (``completed_epochs``, ``epoch_batches_done``,
        ``best_score``), which :meth:`step_meta` hands back. Writes are
        synchronous, so ``wait`` has nothing to wait for."""
        payload = self._payload(state)
        self._main.save(step, payload)
        if best:
            self._best.save(step, payload)
        if metrics is not None:
            meta = self.read_meta()
            entry = meta.get(str(step), {})
            entry.update({k: self._jsonable(v) for k, v in metrics.items()})
            meta[str(step)] = entry
            _atomic_write(self._meta_path,
                          lambda tmp: tmp.write_text(json.dumps(meta,
                                                                indent=2)))

    def step_meta(self, step: int) -> dict:
        """The meta.json sidecar entry for ``step`` ({} if none)."""
        return self.read_meta().get(str(step), {})

    @torch.no_grad()
    def restore(self, state, step: int | None = None, best: bool = False):
        """Copy checkpoint ``step`` (default the newest) into ``state`` (same
        model and optimizer) in place, and return ``state``. ``best=True``
        reads the protected best chain."""
        chain = self._best if best else self._main
        step = chain.latest_step() if step is None else step
        if step is None or not chain.path(step).exists():
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{chain.directory}")
        saved = torch.load(chain.path(step), map_location="cpu",
                           weights_only=True)
        state.params.copy_(saved["params"])
        state.slow_params.copy_(saved["slow_params"])
        stats = state.batch_stats
        if set(stats) != set(saved["batch_stats"]):
            raise ValueError("the checkpoint's batch statistics do not match "
                             "the model's")
        for name, buf in stats.items():
            buf.copy_(saved["batch_stats"][name])
        if set(state.opt_state) != set(saved["opt_state"]):
            raise ValueError("the checkpoint's optimizer state does not "
                             "match the state's")
        for name, t in state.opt_state.items():
            t.copy_(saved["opt_state"][name])
        state.step.copy_(saved["step"])
        return state

    def latest_step(self) -> int | None:
        return self._main.latest_step()

    def best_step(self, metric: str = "val_score",
                  mode: str = "max") -> int | None:
        meta = self.read_meta()
        entries = [(int(s), m.get(metric)) for s, m in meta.items()
                   if m.get(metric) is not None]
        if not entries:
            return None
        sign = 1 if mode == "max" else -1
        return max(entries, key=lambda kv: sign * kv[1])[0]

    def read_meta(self) -> dict:
        if self._meta_path.exists():
            return json.loads(self._meta_path.read_text())
        return {}

    def close(self):
        """Nothing is in flight: every save has finished when it returns."""
