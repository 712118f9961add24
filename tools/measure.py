"""Measuring helpers shared by the compare tools (``tools/*_compare.py``),
which time one or more checkouts of the port within one call on the card.

- :func:`smi`: the card's name and power limit, as ``nvidia-smi`` gives
  them, to stand beside every number;
- :func:`device_ms`: the median device time of ``fn`` over ``runs``
  launches by CUDA events, each after a ~2 ms device spin;
- :func:`step_ms`: the median host time of a training step ending in a
  synchronize (10 steps after 3 warm-up steps);
- :func:`step_device_ms`: the device's busy time a step, and the time a
  step of the kernels whose names hold given parts, under
  ``torch.profiler``;
- :func:`close`: the largest error of a result against its plain version,
  raising outside ``tol * (max|ref| + |ref|)``;
- :func:`load_root` / :func:`train_step_case`: import ``ishara_tpu_torch``
  from a checkout and build its kernels; a ``baseline_config(4)`` training
  step at batch :data:`B` from it (:data:`STEPS`: the steps the tools
  measure).
"""

import dataclasses
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

B = 256   # the recipe's batch

# the training steps measured: (tag, frame_len, config changes, frames per
# character and most frames of the synthetic batch)
STEPS = (("flagship_step", 176, {}, 8, 96),
         ("long_step", 512, {"dropout": 0.0}, 80, 768),
         ("causal_step", 176, {"causal": True, "attn_context": 176}, 8, 96))


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, runs=50):
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def step_ms(step, state, batch):
    import torch

    for _ in range(3):
        state, _ = step(state, batch, seed=0)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch, seed=0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_device_ms(step, state, batch, n=5, names=("ffn_",)):
    """The device's busy time a step and the time a step of the kernels
    whose name holds one of ``names`` (K4's own, ``ffn_``, by default), over
    ``n`` steps under the profiler. ``names`` may be a dict of such tuples:
    the second result is then a dict of their times a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step(state, batch, seed=0)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, t in rows) / n / 1e3
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    def own(parts):
        return sum(t for key, t in rows if any(m in key for m in parts)) \
            / n / 1e3

    if isinstance(names, dict):
        return busy, {label: own(parts) for label, parts in names.items()}
    return busy, own(names)


def close(what, got, ref, tol):
    got, ref = got.detach().float(), ref.float()
    err = (got - ref).abs()
    if not bool(got.isfinite().all()) or \
            not bool((err <= tol * (ref.abs().max() + ref.abs())).all()):
        raise AssertionError(f"{what}: max_abs_err {float(err.max()):.3e} "
                             f"outside tol {tol}")
    return float(err.max())


def load_root(root, first_build):
    """Imports ``ishara_tpu_torch`` from the checkout at ``root`` (dropping
    any other checkout's modules), copies the libraries of ``first_build``
    whose source is unchanged, builds the rest; returns its ``_build``."""
    for name in [m for m in sys.modules if m.startswith("ishara_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from ishara_tpu_torch.ops import _build
    finally:
        sys.path.remove(root)
    if first_build is not None:  # the same source and flags, the same name
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for lib in Path(first_build).glob("lib*.so"):
            for f in (lib, lib.with_suffix(".log")):
                if f.exists() and not (_build.BUILD_DIR / f.name).exists():
                    shutil.copy(f, _build.BUILD_DIR / f.name)
    _build.build()
    return _build


def train_step_case(frame_len, extra, fpc, max_frames):
    """(step, state, batch): ``make_fused_ctc_train_step`` of
    ``baseline_config(4)`` at batch B (bf16, the recipe's ``TrainConfig()``)
    with ``frame_len`` and ``extra`` changed, on a synthetic batch, from the
    checkout that :func:`load_root` imported."""
    import torch

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = dataclasses.replace(baseline_config(4).model, frame_len=frame_len,
                              **extra)
    torch.manual_seed(4)
    model = build_model(cfg, device="cuda")
    host = SyntheticASLFR(num_sequences=B, frames_per_char=fpc,
                          seed=3).batch(range(B), CTCTokenizer(),
                                        max_frames=max_frames)
    batch = {k: torch.from_numpy(host[k]).cuda()
             for k in ("raw", "lengths", "labels")}
    tx, _ = make_optimizer(TrainConfig())
    state = TrainState.create(model, tx, device="cuda")
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=TrainConfig().aug_prob,
                                     blank_id=cfg.blank_id)
    return step, state, batch
