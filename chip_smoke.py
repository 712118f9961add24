#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):

1. Build the CUDA kernels from ``ishara_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and print the card's name and power limit.
2. Kernels: each ported kernel (the fused Squeezeformer and Conformer stacks)
   at the main path's shapes -- T=176, dim 256, 8 heads, 4 blocks of
   ``baseline_config(5)`` -- at bf16 and f32 weight storage, held against
   its plain PyTorch version on the card, and timed (CUDA events, median of
   100 runs after warm-up) beside its plain version and its bound.
3. Engine: ``baseline_config(5)`` with seeded random weights served by
   ``InferenceEngine(fused=True)`` on the card. Requests of every length
   class, a left-hand-dominant one, NaN hands and an all-NaN one; the fused
   logits against the unfused path's; the kernels' launch counts over the
   main-path run; p50/p99 request latency; device time by kernel under
   ``torch.profiler``; ``BatchedEngine(fused=True)`` on a batch of 4; the
   constant-phrase fallback probe.
4. One JSON line listing every ported kernel, then the card's name and
   power limit, then ``{"ok": true, "device": {...}}`` as the last line.

Exits with a non-zero code, printing no result, when no CUDA device is
visible or the port's package is not beside this script.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# Tolerances of kernel against plain version, per element:
# |kernel - plain| <= ATOL + RTOL * |plain|. At f32 storage both do f32
# arithmetic and differ only in summation order; at bf16 both round q, k, v
# and p to bf16 at the same points, but a last-bit difference before a
# rounding can move one value by a bf16 ulp (2^-8 relative).
KERNEL_TOL = {"f32": (1e-3, 1e-3), "bf16": (1e-2, 1e-2)}
# Fused (bf16 weights) against unfused (f32) logits: the tolerance the JAX
# package's own test holds its bf16 deploy numerics to
# (tests/test_fused_block.py, test_fused_encoder_forward_parity).
LOGIT_TOL = (5e-2, 5e-2)
FALLBACK_TEXT = "2 a-e -aroe"
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def randomize(model, seed: int) -> None:
    """Seeded random weights and realistic BN statistics: matrices
    N(0, 1/fan_in), norm scales 1 + 0.1 N, biases and means 0.1 N, running
    variances 0.5 + U(0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            n = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                v = 0.5 + torch.rand(t.shape, generator=g)
            elif name.endswith("weight") and t.dim() >= 2:
                v = n / math.sqrt(t[0].numel())
            elif name.endswith("weight"):
                v = 1.0 + 0.1 * n
            else:
                v = 0.1 * n
            t.copy_(v)


def requests(seed: int):
    """(label, raw [T, 276]) requests made with numpy from ``seed``."""
    from ishara_tpu_torch.data import landmarks as lm

    rng = np.random.default_rng(seed)
    r = lm.GROUP_IDX["rhand"].ravel()
    l_ = lm.GROUP_IDX["lhand"].ravel()

    def seq(T, p_r=0.2, p_l=0.7):
        x = rng.random((T, lm.N_COLS)).astype(np.float32)
        x[np.ix_(rng.random(T) < p_r, r)] = np.nan
        x[np.ix_(rng.random(T) < p_l, l_)] = np.nan
        return x

    out = [("len60", seq(60)), ("len150", seq(150)), ("len250", seq(250)),
           ("len384", seq(384)), ("len500", seq(500)), ("len700", seq(700)),
           ("left_dominant", seq(200, p_r=0.8, p_l=0.1))]
    nan_hands = seq(120)
    nan_hands[:, np.concatenate([r, l_])] = np.nan
    out.append(("nan_hands", nan_hands))
    out.append(("all_nan", np.full((90, lm.N_COLS), np.nan, np.float32)))
    return out


def time_ms(fn, runs: int = 100, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms (one CUDA event pair per run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def stack_work(spec, x, mask, leaves, num_heads):
    """(bytes, operations) the stack must move and do: each input read and
    the output written once; matmul, attention and depthwise-conv
    multiply-adds counted as 2 operations each (elementwise work, under 1%
    of the total, is left out)."""
    T, D = x.shape
    nb = leaves[0].shape[0]
    nbytes = 2 * x.numel() * 4 + mask.numel() * 4 + sum(
        w.numel() * w.element_size() for w in leaves)
    ops = 0
    for (name, kind, _), w in zip(spec, leaves):
        if kind == "m":
            rows = 1 if name.startswith("se") else T
            ops += 2 * rows * w.shape[1] * w.shape[2] * nb
        elif name == "dww":
            ops += 2 * T * w.shape[1] * w.shape[2] * nb
    ops += 4 * T * T * D * nb  # q.k and p.v over all heads
    return nbytes, ops


def kernel_phase(model, x0, mask):
    """Each kernel at bf16 and f32 storage against its plain version."""
    import torch

    from ishara_tpu_torch.bridge import conformer_block_args, squeeze_block_args
    from ishara_tpu_torch.ops import fused_block as fb

    cfg = model.cfg
    sd = model.state_dict()
    kernels = [
        ("fused_squeezeformer_stack", fb.fused_squeezeformer_stack,
         fb.SQUEEZE_LEAVES, squeeze_block_args, "squeezeformer",
         cfg.num_squeeze_blocks, "ishara_tpu/ops/fused_block.py:615"),
        ("fused_conformer_stack", fb.fused_conformer_stack,
         fb.CONFORMER_LEAVES, conformer_block_args, "conformer",
         cfg.num_conform_blocks, "ishara_tpu/ops/fused_block.py:629"),
    ]
    rows = {}
    x_in = x0
    for name, fn, spec, args_of, prefix, nblocks, replaces in kernels:
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            leaves = fb.stack_block_args(
                [args_of(sd, f"{prefix}.{i}.", dt) for i in range(nblocks)])
            got = fn(x_in, mask, leaves, num_heads=cfg.num_heads)
            torch.cuda.synchronize()
            ref = fb.PLAIN[fn](x_in, mask, leaves, cfg.num_heads)
            err = (got - ref).abs()
            atol, rtol = KERNEL_TOL[tag]
            max_abs = float(err.max())
            max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= atol + rtol * ref.abs()).all())
            ms = time_ms(lambda: fn(x_in, mask, leaves,
                                    num_heads=cfg.num_heads))
            plain_ms = time_ms(lambda: fb.PLAIN[fn](x_in, mask, leaves,
                                                    cfg.num_heads))
            nbytes, ops = stack_work(spec, x_in, mask, leaves, cfg.num_heads)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS_PER_S[tag] * 1e3
            row = dict(name=name, route="cuda",
                       source="ishara_tpu_torch/ops/csrc/fused_block.cu",
                       replaces=replaces, launches=None,
                       max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=None)
            log(f"kernel {name} [{tag} weights] T={x_in.shape[0]} "
                f"dim={x_in.shape[1]} blocks={nblocks}: max_abs_err "
                f"{max_abs:.3e} max_rel_err {max_rel:.3e} "
                f"(tol |err| <= {atol} + {rtol}*|plain|) "
                f"{'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
                f"({nbytes} bytes, {ops} operations, by {row['bound_by']})")
            if not ok:
                raise AssertionError(f"{name} [{tag}] disagrees with its "
                                     f"plain version")
            rows[(name, tag)] = row
            if tag == "f32":
                next_in = ref  # the next stack's input on the main path
        x_in = next_in.contiguous()
    return rows


# The kernels of csrc/fused_block.cu, as the profiler's names spell them
# ("(anonymous namespace)::gemm_kernel<...>(...)").
PORT_KERNEL = re.compile(r"::(gemm_kernel|attention_kernel|dwconv_kernel|"
                         r"se_gate_kernel|se_apply_kernel|layernorm_kernel)\b")


def profile_phase(engine, reqs, n: int = 20):
    """Device time by kernel over ``n`` fused requests (torch.profiler with
    CUPTI), and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            engine(reqs[i % len(reqs)][1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, _, t in rows)
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"profile: InferenceEngine(fused=True), {n} requests: wall "
        f"{wall_us / n:.1f} us/request with the profiler on, device busy "
        f"{busy / n:.1f} us/request ({100 * busy / wall_us:.1f}% of wall)")
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:20]:
        m = PORT_KERNEL.search(key)
        name = m.group(1) if m else key[:60]
        if m and "bfloat16" in key:
            name += "<bf16>"
        log(f"  {t / n:9.1f} us/request {100 * t / busy:5.1f}% "
            f"{count / n:6.1f} calls/request  {name}")


def engine_phase(model, reqs, smi):
    import torch

    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.ops import fused_block as fb
    from ishara_tpu_torch.preprocess.pipeline import preprocess
    from ishara_tpu_torch.serve import BatchedEngine, InferenceEngine

    cfg = model.cfg
    fused = InferenceEngine(model, fused=True, device=DEVICE)
    plain = InferenceEngine(model, fused=False, device=DEVICE)
    fused(reqs[0][1])  # warm-up outside the counted run
    torch.cuda.synchronize()

    # the main path, with the launch counts read around it
    fb.fused_squeezeformer_stack.launches = 0
    fb.fused_conformer_stack.launches = 0
    results = [(label, *fused(raw)) for label, raw in reqs]
    torch.cuda.synchronize()
    launches = {"fused_squeezeformer_stack":
                fb.fused_squeezeformer_stack.launches,
                "fused_conformer_stack": fb.fused_conformer_stack.launches}
    log(f"engine main path: {len(reqs)} requests, kernel launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    tok = CTCTokenizer()
    enc = fb.FusedEncoder(cfg, model.state_dict(), device=DEVICE)
    worst = 0.0
    for (label, ids, count), (_, raw) in zip(results, reqs):
        if ids.shape != (fused.max_out,) or not 0 <= count <= fused.max_out:
            raise AssertionError(f"{label}: bad output {ids.shape} {count}")
        pids, pcount = plain(raw)
        n = min(raw.shape[0], fused.max_raw_frames)
        buf = torch.zeros((fused.max_raw_frames, raw.shape[1]),
                          device=DEVICE)
        buf[:n] = torch.from_numpy(raw[:n]).to(DEVICE)
        x = preprocess(buf, torch.tensor(max(n, 1), device=DEVICE),
                       fused.stats, cfg.frame_len, thin=True)
        with torch.no_grad():
            lf = enc(x)
            lp = model(x[None])[0]
        if not bool(torch.isfinite(lf).all()):
            raise AssertionError(f"{label}: non-finite fused logits")
        err = (lf - lp).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= LOGIT_TOL[0] + LOGIT_TOL[1] * lp.abs()).all()):
            raise AssertionError(f"{label}: fused logits off the unfused "
                                 f"path by {float(err.max()):.3e}")
        agree = int((lf.argmax(-1) == lp.argmax(-1)).sum())
        log(f"  {label:14s} T={raw.shape[0]:4d} count={count:2d} "
            f"text={tok.decode(ids[:count])!r} | unfused count={pcount} "
            f"same_ids={bool((ids == pids).all())} | logits max_abs_err "
            f"{float(err.max()):.3e}, frame argmax agree {agree}/"
            f"{lf.shape[0]}")
    log(f"fused vs unfused logits: max_abs_err {worst:.3e} "
        f"(tol |err| <= {LOGIT_TOL[0]} + {LOGIT_TOL[1]}*|unfused|) PASS")

    lat = {}
    for tag, eng in (("fused", fused), ("unfused", plain)):
        times = []
        for i in range(200):
            raw = reqs[i % len(reqs)][1]
            t0 = time.perf_counter()
            eng(raw)
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        lat[tag] = (times[len(times) // 2], times[int(len(times) * 0.99) - 1])
        log(f"latency InferenceEngine(fused={tag == 'fused'}) preset 5, "
            f"200 requests: p50 {lat[tag][0]:.4f} ms p99 {lat[tag][1]:.4f} ms "
            f"on {smi}")

    profile_phase(fused, reqs)

    batched = BatchedEngine(model, batch_size=4, fused=True, device=DEVICE)
    bids, bcounts = batched([raw for _, raw in reqs[:4]])
    for i, (label, ids, count) in enumerate(results[:4]):
        if not (np.array_equal(bids[i], ids) and bcounts[i] == count):
            raise AssertionError(f"BatchedEngine row {i} ({label}) differs "
                                 f"from InferenceEngine")
    log(f"BatchedEngine(fused=True) batch 4: counts {bcounts.tolist()} "
        f"match InferenceEngine")

    with torch.no_grad():
        bias = model.classifier.bias
        saved = float(bias[59])
        bias[59] = 1000.0
        probe = InferenceEngine(model, fused=True, device=DEVICE)
        text = probe.predict_text(reqs[2][1], tok)
        bias[59] = saved
    if text != FALLBACK_TEXT:
        raise AssertionError(f"fallback probe gave {text!r}")
    log(f"fallback probe: {text!r} PASS")
    return launches, lat


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    import ishara_tpu_torch
    if Path(ishara_tpu_torch.__file__).resolve().parents[1] != here:
        print("chip_smoke: ishara_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    from ishara_tpu_torch.config import baseline_config
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.ops import _build
    from ishara_tpu_torch.preprocess.pipeline import (
        GroupStats,
        frame_mask,
        preprocess,
    )

    # The plain versions and the unfused path are the references here: keep
    # cuBLAS and cuDNN at full f32 (cuDNN convolutions default to TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for line in _build.build_log("fused_block").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas " + line.strip())
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    cfg = baseline_config(5).model
    model = build_model(cfg, device=DEVICE)
    randomize(model, seed=0)
    reqs = requests(seed=0)

    # the main path's stem output for one request with a padded tail
    raw = torch.zeros((384, 276), device=DEVICE)
    raw[:150] = torch.from_numpy(reqs[1][1]).to(DEVICE)
    x = preprocess(raw, torch.tensor(150, device=DEVICE),
                   GroupStats.identity(), cfg.frame_len, thin=True)
    mask = frame_mask(x)
    with torch.no_grad():
        h = model.stem_bn(model.stem_conv(x) + model.pos_enc).contiguous()
    log(f"kernel input: T={h.shape[0]} dim={h.shape[1]}, "
        f"{int(mask.sum())} valid frames")
    rows = kernel_phase(model, h, mask)

    launches, lat = engine_phase(model, reqs, smi)
    line = []
    for (name, tag), row in rows.items():
        if tag == "bf16":
            row["launches"] = launches[name]
            line.append(row)
    log(json.dumps({"kernels": line}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
