"""Time the CTC loss kernel K1 and the two training steps that run it, of
one or more checkouts of the port, for comparing checkouts within one call
on the card.

    python3 tools/ctc_compare.py ROOT [ROOT ...]

For each ROOT in turn (a checkout's root, e.g. one unpacked by ``git
archive``), imports ``ishara_tpu_torch`` from it and builds its kernels
(libraries whose source is unchanged are copied from the first root's
build). Then:

- K1 at the flagship step's shapes (B 256, T 176, U 64, C 60, logits
  2 N(0, 1)) on two label sets: chip_smoke.py's (1-30 labels, an all-blank
  row, a row of repeats, a row of all 64 labels: 129 states) and the
  training step's own (``SyntheticASLFR(256, seed=3)``'s phrases of 3-10
  characters): the forward (alpha and nll) and the backward (the
  gradient), each held against the plain recursions (chip_smoke.py's
  tolerances) and a second launch, then the median of 50 launches by CUDA
  events, each after a ~2 ms device spin (device time only);
- one step of ``baseline_config(4)`` at batch 256 (bf16, the recipe's
  ``TrainConfig()``): the flagship step at T 176 and the long step at
  ``frame_len=512``, ``dropout=0.0``, as chip_smoke.py builds them; the
  median of 10 steps by the host clock, each ending in a synchronize.

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

import numpy as np

B, T, U, C, BLANK = 256, 176, 64, 60, 59


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


def label_sets(SyntheticASLFR, CTCTokenizer):
    rng = np.random.default_rng(11)
    smoke = np.full((B, U), BLANK, np.int32)
    for b in range(B):
        n = int(rng.integers(1, 31))
        smoke[b, :n] = rng.integers(0, 59, n)
    smoke[0] = BLANK
    smoke[1, :6] = [7, 7, 7, 3, 3, 7]
    smoke[2] = rng.integers(0, 59, U)
    step = SyntheticASLFR(num_sequences=B, seed=3).batch(
        range(B), CTCTokenizer(), max_frames=96)["labels"]
    return {"smoke": smoke, "step": np.asarray(step, np.int32)}


def close(what, got, ref, tol):
    err = (got - ref).abs()
    if not bool(got.isfinite().all()) or \
            not bool((err <= tol * (ref.abs().max() + ref.abs())).all()):
        raise AssertionError(f"{what}: max_abs_err {float(err.max()):.3e} "
                             f"outside tol {tol}")
    return float(err.max())


def time_root(root, first_build, card):
    import torch

    for name in [m for m in sys.modules if m.startswith("ishara_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from ishara_tpu_torch.config import TrainConfig, baseline_config
        from ishara_tpu_torch.data.synthetic import SyntheticASLFR
        from ishara_tpu_torch.data.tokenizer import CTCTokenizer
        from ishara_tpu_torch.models.encoder import build_model
        from ishara_tpu_torch.ops import _build
        from ishara_tpu_torch.ops import ctc_kernel as ck
        from ishara_tpu_torch.preprocess.pipeline import GroupStats
        from ishara_tpu_torch.train import (
            TrainState,
            make_fused_ctc_train_step,
            make_optimizer,
        )
    finally:
        sys.path.remove(root)

    if first_build is not None:  # the same source and flags, the same name
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for lib in Path(first_build).glob("lib*.so"):
            for f in (lib, lib.with_suffix(".log")):
                if f.exists() and not (_build.BUILD_DIR / f.name).exists():
                    shutil.copy(f, _build.BUILD_DIR / f.name)
    _build.build()
    out = {"root": root, "card": card}
    g = torch.Generator(device="cuda").manual_seed(11)
    x = 2.0 * torch.randn((B, T, C), generator=g, device="cuda")
    dy = torch.rand((B,), generator=g, device="cuda") + 0.5
    for tag, labels in label_sets(SyntheticASLFR, CTCTokenizer).items():
        lab = torch.from_numpy(labels).cuda()
        nll, alpha = ck._launch_alpha(x, lab, BLANK, True)
        grad = ck._launch_beta(x, lab, alpha, nll, dy, BLANK)
        nll2, alpha2 = ck._launch_alpha(x, lab, BLANK, True)
        grad2 = ck._launch_beta(x, lab, alpha2, nll2, dy, BLANK)
        with torch.no_grad():
            rn, ra = ck.ctc_forward_plain(x, lab, BLANK)
            rg = ck.ctc_backward_plain(x, lab, ra, rn, dy, BLANK)
        errs = (close(f"{tag} nll", nll, rn, 2e-5),
                close(f"{tag} gradient", grad, rg, 2e-4))
        same = bool(torch.equal(nll, nll2) and torch.equal(grad, grad2))
        f_ms = device_ms(lambda: ck._launch_alpha(x, lab, BLANK, True))
        b_ms = device_ms(
            lambda: ck._launch_beta(x, lab, alpha, nll, dy, BLANK))
        states = int(2 * (labels != BLANK).sum(1).max() + 1)
        out[f"k1_{tag}"] = {"fwd_ms": f_ms, "bwd_ms": b_ms,
                            "max_abs_err": errs, "second_launch_equal": same,
                            "widest_row_states": states}
        print(f"{root} K1 {tag} (widest row {states} states): forward "
              f"{f_ms:.4f} ms ({1e3 * f_ms / T:.3f} us a frame), backward "
              f"{b_ms:.4f} ms ({1e3 * b_ms / T:.3f} us a frame); nll, "
              f"gradient max_abs_err {errs[0]:.3e}, {errs[1]:.3e}; second "
              f"launch bit-equal {same}; {card}", flush=True)
        del nll, alpha, grad, nll2, alpha2, grad2, rn, ra, rg

    for tag, frame_len, dropout, fpc, max_frames in (
            ("flagship_step", 176, None, 8, 96),
            ("long_step", 512, 0.0, 80, 768)):
        cfg = baseline_config(4).model
        cfg = dataclasses.replace(cfg, frame_len=frame_len,
                                  dropout=cfg.dropout if dropout is None
                                  else dropout)
        torch.manual_seed(4)
        model = build_model(cfg, device="cuda")
        host = SyntheticASLFR(num_sequences=B, frames_per_char=fpc,
                              seed=3).batch(range(B), CTCTokenizer(),
                                            max_frames=max_frames)
        batch = {k: torch.from_numpy(host[k]).cuda()
                 for k in ("raw", "lengths", "labels")}
        tx, _ = make_optimizer(TrainConfig())
        state = TrainState.create(model, tx, device="cuda")
        step = make_fused_ctc_train_step(GroupStats.identity(),
                                         cfg.frame_len,
                                         aug_prob=TrainConfig().aug_prob,
                                         blank_id=cfg.blank_id)
        ms = step_ms(step, state, batch)
        out[tag + "_ms"] = ms
        print(f"{root} {tag} (T {frame_len}): {ms:.2f} ms a step (median of "
              f"10, host clock); {card}", flush=True)
        del model, state, step, batch
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
