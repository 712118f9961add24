"""Time the feed-forward training kernel K4 and the training steps that run
it, of one or more checkouts of the port, for comparing checkouts within one
call on the card.

    python3 tools/ffn_compare.py ROOT [ROOT ...]

For each ROOT in turn (a checkout's root, e.g. one unpacked by ``git
archive``), imports ``ishara_tpu_torch`` from it and builds its kernels
(libraries whose source is unchanged are copied from the first root's
build). Then:

- K4 (``ffn_residual``, bf16, hidden 512, rates 0.4 / 0.4) at x ``[45056,
  256]`` (the flagship step's rows, batch 256 x T 176) and ``[131072, 256]``
  (T 512): the forward and the backward (every gradient), each held against
  the plain version (chip_smoke.py's tolerance), then the median of 50
  launches by CUDA events, each after a ~2 ms device spin (device time
  only);
- the ``F.linear`` / ``silu`` / ``dropout`` composition at the same shapes,
  forward and backward, timed the same way;
- one step of ``baseline_config(4)`` at batch 256 (bf16, the recipe's
  ``TrainConfig()``): the flagship step (T 176), the long step
  (``frame_len=512``, ``dropout=0.0``) and the causal flagship step
  (``causal=True``, ``attn_context`` 176); the median of 10 steps by the
  host clock, each ending in a synchronize, with K4's launches a step;
  then 5 steps under ``torch.profiler``: the device's busy time a step (the
  sum of every device kernel's and copy's time) and K4's own kernels' time
  a step (those named ``ffn_``; the weight products it shares with K7 are
  not counted there). The host's clock varies from call to call far more
  than the device's busy time, so compare steps by the latter.

Prints one line a measurement and a JSON object a checkout, each with the
card's name and power limit. Give the roots as parent, change, change,
parent to see the spread between runs of the same code.
"""

import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, D, M = 256, 256, 512
RATES = (0.4, 0.4)
TOL = 0.02   # chip_smoke.py's TRAIN_TOL["bf16"]


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
    ``n`` steps under the profiler."""
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
    own = sum(t for key, t in rows if any(m in key for m in names)) / n / 1e3
    return busy, own


def close(what, got, ref, tol):
    got, ref = got.detach().float(), ref.float()
    err = (got - ref).abs()
    if not bool(got.isfinite().all()) or \
            not bool((err <= tol * (ref.abs().max() + ref.abs())).all()):
        raise AssertionError(f"{what}: max_abs_err {float(err.max()):.3e} "
                             f"outside tol {tol}")
    return float(err.max())


def kernel_times(fk, T, card, out):
    import torch
    import torch.nn.functional as F

    n = B * T
    g = torch.Generator(device="cuda").manual_seed(T)
    x, res, dy = (torch.randn((n, D), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    x.requires_grad_()
    res.requires_grad_()
    ws = [torch.randn(s, generator=g, device="cuda").mul(sc)
          .to(torch.bfloat16).requires_grad_()
          for s, sc in (((D, M), D ** -0.5), ((M,), 0.1), ((M, D), M ** -0.5),
                        ((D,), 0.1))]
    seeds = torch.tensor([7, 8], dtype=torch.int32, device="cuda")

    def fwd():
        return fk.ffn_residual(x, res, *ws, seeds, *RATES)

    o = fwd()

    def bwd():
        return torch.autograd.grad(o, [x, res] + ws, dy, retain_graph=True)

    grads = bwd()
    with torch.no_grad():
        w1, b1, w2, b2 = (w.detach() for w in ws)
        ref = fk.ffn_forward_plain(x.detach(), res.detach(), w1,
                                   b1.float(), w2, b2.float(), seeds, *RATES)
        rdx, rdw1, rdb1, rdw2, rdb2 = fk.ffn_backward_plain(
            x.detach(), dy, w1, b1.float(), w2, seeds, *RATES)
    err = max([close(f"T {T} out", o, ref, TOL)]
              + [close(f"T {T} {name}", a, b, TOL) for name, a, b in zip(
                  ("dx", "dw1", "db1", "dw2", "db2"),
                  (grads[0], *grads[2:]), (rdx, rdw1, rdb1, rdw2, rdb2))])
    del ref, rdx, rdw1, rdb1, rdw2, rdb2
    design = fk.ffn_plan(torch.bfloat16, D, M).design \
        if hasattr(fk, "ffn_plan") else "no ffn_plan"
    rows = {"design": design, "max_abs_err": err,
            "fwd_ms": device_ms(fwd), "bwd_ms": device_ms(bwd)}

    def comp():
        h = F.dropout(F.silu(F.linear(x, ws[0].t(), ws[1])), RATES[0], True)
        return res + F.dropout(F.linear(h, ws[2].t(), ws[3]), RATES[1], True)

    co = comp()
    rows["composition_fwd_ms"] = device_ms(comp)
    rows["composition_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
        co, [x, res] + ws, dy, retain_graph=True))
    out[f"k4_T{T}"] = rows
    print(f"{out['root']} K4 [{n}, {D}] hidden {M} rates {RATES} bf16 "
          f"({design}): forward {rows['fwd_ms']:.4f} ms, backward "
          f"{rows['bwd_ms']:.4f} ms; the composition "
          f"{rows['composition_fwd_ms']:.4f} / "
          f"{rows['composition_bwd_ms']:.4f} ms; max_abs_err {err:.3e} "
          f"(tol {TOL}); {card}", flush=True)


# the training steps measured: (tag, frame_len, config changes, frames per
# character and most frames of the synthetic batch)
STEPS = (("flagship_step", 176, {}, 8, 96),
         ("long_step", 512, {"dropout": 0.0}, 80, 768),
         ("causal_step", 176, {"causal": True, "attn_context": 176}, 8, 96))


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


def time_root(root, first_build, card):
    import torch

    _build = load_root(root, first_build)
    from ishara_tpu_torch.ops import ffn_kernel as fk

    out = {"root": root, "card": card}
    for T in (176, 512):
        kernel_times(fk, T, card, out)
        torch.cuda.empty_cache()

    for tag, frame_len, extra, fpc, max_frames in STEPS:
        step, state, batch = train_step_case(frame_len, extra, fpc,
                                             max_frames)
        before = (fk.ffn_residual.launches, fk.ffn_residual.launches_bwd)
        state, _ = step(state, batch, seed=0)
        launches = (fk.ffn_residual.launches - before[0],
                    fk.ffn_residual.launches_bwd - before[1])
        ms = step_ms(step, state, batch)
        busy, k4 = step_device_ms(step, state, batch)
        out[tag + "_ms"] = ms
        out[tag + "_busy_ms"] = busy
        out[tag + "_k4_device_ms"] = k4
        out[tag + "_k4_launches"] = launches
        print(f"{root} {tag} (T {frame_len}): {ms:.2f} ms a step (median of "
              f"10, host clock); device busy {busy:.3f} ms a step, K4's "
              f"kernels {k4:.3f} ms a step (profiler, 5 steps); K4 "
              f"{launches[0]} + {launches[1]} launches a step; {card}",
              flush=True)
        del state, step, batch
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return str(_build.BUILD_DIR)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    card = smi()
    first_build = None
    for root in sys.argv[1:]:
        built = time_root(root, first_build, card)
        first_build = first_build or built
    return 0


if __name__ == "__main__":
    sys.exit(main())
