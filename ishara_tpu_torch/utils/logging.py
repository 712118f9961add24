"""Metric logging (port of ``ishara_tpu/utils/logging.py``): a JSONL sink and
stdout, with the same records as the reference.

wandb mirrors the metrics when it imports and ``ISHARA_WANDB=1`` is set;
TensorBoard (``torch.utils.tensorboard``) when it imports and
``ISHARA_TENSORBOARD=1`` is set. Either is skipped silently when it cannot
start. No credential is read or written here: wandb finds its own login.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


class MetricLogger:
    def __init__(self, workdir: str | Path | None = None, name: str = "train",
                 print_every: int = 10):
        self.t0 = time.time()
        self.print_every = print_every
        self._file = None
        if workdir is not None:
            Path(workdir).mkdir(parents=True, exist_ok=True)
            self._file = open(Path(workdir) / f"{name}_metrics.jsonl", "a")
        self._wandb = None
        if os.environ.get("ISHARA_WANDB") == "1":
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(project=os.environ.get(
                        "ISHARA_WANDB_PROJECT", "ishara-tpu"))
            except Exception:
                self._wandb = None
        self._tb = None
        if os.environ.get("ISHARA_TENSORBOARD") == "1" and workdir is not None:
            try:
                from torch.utils.tensorboard import (  # noqa: PLC0415
                    SummaryWriter,
                )

                self._tb = SummaryWriter(str(Path(workdir) / "tb"))
            except Exception:
                self._tb = None
        self._n = 0

    def log(self, metrics: dict, step: int | None = None) -> None:
        rec = {"t": round(time.time() - self.t0, 3), **metrics}
        if step is not None:
            rec["step"] = int(step)
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None and step is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
        self._n += 1
        if self._n % self.print_every == 0 or "val_score" in metrics:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
            )
            print(parts, file=sys.stderr, flush=True)

    def log_histograms(self, tensors: dict[str, torch.Tensor],
                       step: int | None = None, prefix: str = "grad",
                       bins: int = 20) -> None:
        """Per-layer value histograms of named tensors (``state.param_dict()``
        or the gradients by name): the JSONL gets ``{"histograms": {"t",
        "step", "<prefix>/<name>": {"counts", "lo", "hi", "norm"}}}``, or
        ``{"nonfinite": n}`` for a tensor with no finite value; wandb gets
        its Histograms, TensorBoard its histogram summaries."""
        rec: dict = {"t": round(time.time() - self.t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        wb: dict = {}
        for name, t in tensors.items():
            v = t.detach().to(torch.float32).cpu().numpy().ravel()
            if v.size == 0:
                continue
            name = f"{prefix}/{name}"
            finite = v[np.isfinite(v)]
            if finite.size == 0:
                rec[name] = {"nonfinite": int(v.size)}
                continue
            counts, edges = np.histogram(finite, bins=bins)
            rec[name] = {
                "counts": counts.tolist(),
                "lo": float(edges[0]), "hi": float(edges[-1]),
                "norm": float(np.linalg.norm(finite)),
            }
            if self._wandb is not None:
                wb[name] = self._wandb.Histogram(np_histogram=(counts, edges))
            if self._tb is not None and step is not None:
                self._tb.add_histogram(name, finite, step)
        if self._file is not None:
            self._file.write(json.dumps({"histograms": rec}) + "\n")
            self._file.flush()
        if self._wandb is not None and wb:
            self._wandb.log(wb, step=step)

    def close(self):
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
