#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):

1. Build the CUDA kernels from ``ishara_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and print the card's name and power limit.
2. Kernels, at the main paths' shapes (T=176, dim 256, 8 heads), each held
   against its plain PyTorch version on the card and timed (CUDA events,
   median after warm-up) beside its plain version and its bound:
   the Squeezeformer and Conformer stacks of ``baseline_config(5)`` (4
   blocks each) at bf16, f32 and int8 weight storage, and as the persistent
   ``dma=True`` kernel (also held equal to ``dma=False``, and timed with a
   cold L2); the conv-group stacks of ``baseline_config(3)`` (2 groups of
   three Conv1DBlocks + a Squeezeformer or Conformer block) and of a
   ``conv_transformer`` configuration of the same widths (inner Transformer
   blocks); one block alone (N = 1).
3. Engines, each with seeded random weights on nine requests of every
   length class, a left-hand-dominant one, NaN hands and an all-NaN one:
   preset 5 through ``InferenceEngine(fused=True)``, ``fused="int8"``,
   ``fused=True, dma=True`` and ``fused="int8", dma=True``; preset 3 through
   ``fused=False``, ``True``, ``"int8"`` and ``True, dma=True``; the
   ``conv_transformer`` configuration through ``fused=False`` and ``True``.
   Fused logits against the unfused path's (int8 against the unfused model
   on the dequantized weights), dma ids against non-dma ids, the kernels'
   launch counts over each nine-request run, p50/p99 request latency, device
   time by kernel under ``torch.profiler``, ``BatchedEngine``, and the
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

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit). int8
# weights multiply f32 activations: no tensor-core type takes that pair, so
# the bf16 rate (dequantize, then bf16 mma) is the card's best for them.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 989e12}
L2_BYTES = 50 * 2 ** 20
# Tolerances of kernel against plain version, per element:
# |kernel - plain| <= ATOL + RTOL * |plain|. At f32 storage both do f32
# arithmetic and differ only in summation order; at bf16 and int8 both hold
# the same weights (and int8 scales) and round q, k, v and p to bf16 at the
# same points, but a last-bit difference before a rounding can move one
# value by a bf16 ulp (2^-8 relative).
KERNEL_TOL = {"f32": (1e-3, 1e-3), "bf16": (1e-2, 1e-2), "int8": (1e-2, 1e-2)}
# Fused (bf16 or int8 weights) against unfused (f32) logits: the tolerance
# the JAX package's own tests hold its bf16 and int8 deploy numerics to
# (tests/test_fused_block.py, test_fused_encoder_forward_parity and
# test_fused_encoder_int8_parity).
LOGIT_TOL = (5e-2, 5e-2)
FALLBACK_TEXT = "2 a-e -aroe"
DEVICE = "cuda"
SOURCE = "ishara_tpu_torch/ops/csrc/fused_block.cu"
REF = "ishara_tpu/ops/fused_block.py"


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


def time_ms(fn, runs: int = 100, warmup: int = 5, before=None,
            head_start: bool = True) -> float:
    """Median device time of ``fn`` in ms (one CUDA event pair per run).
    ``before`` runs ahead of each timed run, outside its event pair. With
    ``head_start`` the device first spins for about a millisecond (touching
    no memory), so that the host has enqueued all of ``fn``'s launches
    before the first one starts and the time is the device's alone; without
    it the runs follow each other directly and a slow host shows in the
    time, as it does for a caller."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        if before is not None:
            before()
        if head_start:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_ms(fn, runs: int = 50) -> float:
    """Median host time of one call of ``fn`` in ms: what the caller's
    thread spends before the call returns, the device idle at its start."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _tensors(w):
    return w if isinstance(w, tuple) else (w,)


def stack_work(fb, kind, x, mask, conv, leaves):
    """(bytes, operations) a stack must move and do: each input read and
    the output written once -- int8 matrices at one byte a value, their
    scale leaves included; matmul, attention, depthwise-conv and ECA-window
    multiply-adds counted as 2 operations each (the other elementwise work,
    under 1% of the total, is left out)."""
    T, D = x.shape
    nb = _tensors(leaves[0])[0].shape[0]
    nbytes = 2 * x.numel() * 4 + mask.numel() * 4
    ops = 4 * T * T * D * nb  # q.k and p.v over all heads
    specs = [(fb.CONV1D_LEAVES, cl) for cl in conv] + \
        [(fb.INNER[kind][1], leaves)]
    for spec, lv in specs:
        for (name, lkind, _), w in zip(spec, lv):
            nbytes += sum(t.numel() * t.element_size() for t in _tensors(w))
            q = _tensors(w)[0]
            if lkind == "m":
                rows = 1 if name.startswith("se") else T
                ops += 2 * rows * q.shape[1] * q.shape[2] * nb
            elif name == "dww":
                ops += 2 * T * q.shape[1] * q.shape[2] * nb
            elif name == "ecw":  # the window over channels, on the GAP row
                ops += 2 * q.shape[1] * _tensors(lv[0])[0].shape[-1] * nb
    return nbytes, ops


def stem_output(model, raw_np, n):
    """The main path's stem output [T, dim] and mask for one request."""
    import torch

    from ishara_tpu_torch.preprocess.pipeline import (
        GroupStats,
        frame_mask,
        preprocess,
    )

    raw = torch.zeros((384, 276), device=DEVICE)
    raw[:n] = torch.from_numpy(raw_np[:n]).to(DEVICE)
    x = preprocess(raw, torch.tensor(n, device=DEVICE),
                   GroupStats.identity(), model.cfg.frame_len, thin=True)
    with torch.no_grad():
        h = model.stem_bn(model.stem_conv(x) + model.pos_enc).contiguous()
    return h, frame_mask(x)


def kernel_phase(models, reqs):
    """Every kernel form against its plain version, timed beside its bound.
    Returns {(config, kind, storage tag, dma): row}."""
    import torch

    from ishara_tpu_torch.ops import fused_block as fb

    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device=DEVICE)
    wrappers = {"squeezeformer": (fb.fused_squeezeformer_stack, f"{REF}:615"),
                "conformer": (fb.fused_conformer_stack, f"{REF}:629")}
    # (config, segment kinds in the encoder's order,
    #  forms (storage tag, dma) in the order they run)
    plan = [
        ("preset5", ("squeezeformer", "conformer"),
         [("bf16", False), ("f32", False), ("int8", False), ("bf16", True),
          ("f32", True), ("int8", True)]),
        ("preset3", ("squeezeformer", "conformer"),
         [("bf16", False), ("f32", False), ("int8", False), ("bf16", True)]),
        ("conv_transformer", ("transformer",),
         [("bf16", False), ("f32", False), ("int8", False)]),
    ]
    storages = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": "int8"}
    rows = {}
    for config, kinds, forms in plan:
        model = models[config]
        cfg = model.cfg
        sd = model.state_dict()
        x_in, mask = stem_output(model, reqs[1][1], 150)
        qsd = fb.quantize_serving_weights(sd)
        for kind in kinds:
            grouped = cfg.variant in ("conv_hybrid", "conv_transformer")
            if grouped:
                fn, replaces = fb.fused_conv_group_stack, f"{REF}:430"
                name = f"fused_conv_group_stack[{kind}]"
            else:
                fn, replaces = wrappers[kind]
                name = fn.__name__
            outs = {}
            for tag, dma in forms:
                conv, leaves = fb.encoder_segment_args(
                    cfg, qsd if tag == "int8" else sd, kind, storages[tag])

                def run(dma=dma, conv=conv, leaves=leaves):
                    if grouped:
                        return fn(x_in, mask, (conv, leaves), kind,
                                  num_heads=cfg.num_heads, dma=dma)
                    return fn(x_in, mask, leaves, num_heads=cfg.num_heads,
                              dma=dma)

                def plain(conv=conv, leaves=leaves):
                    return fb.group_stack_plain(x_in, mask, (conv, leaves),
                                                kind, cfg.num_heads)

                got = run()
                torch.cuda.synchronize()
                ref = plain()
                err = (got - ref).abs()
                atol, rtol = KERNEL_TOL[tag]
                max_abs = float(err.max())
                max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= atol + rtol * ref.abs()).all())
                form = f"{tag} weights" + (", dma" if dma else "")
                extra = ""
                if dma:
                    same = torch.equal(got, outs[tag])
                    grid, per_sm, smem = fb.last_persistent_launch
                    extra = (f"; equals dma=False bit for bit: {same}; one "
                             f"cooperative launch of {grid} blocks "
                             f"({per_sm} an SM, {smem} B shared memory)")
                    ok = ok and same
                else:
                    outs[tag] = got
                ms = time_ms(run)
                loop_ms = time_ms(run, head_start=False)
                cold_ms = time_ms(run, runs=30, before=flush.zero_)
                call_ms = host_ms(run)
                plain_ms = time_ms(plain, runs=20, warmup=2,
                                   head_start=False)
                nbytes, ops = stack_work(fb, kind, x_in, mask, conv, leaves)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[tag] * 1e3
                row = dict(
                    name=name + ("" if (tag, dma) == ("bf16", False)
                                 else f"[{tag}{',dma' if dma else ''}]"),
                    route="cuda", source=SOURCE,
                    replaces=(f"{REF}:599" if dma else
                              f"{REF}:65" if tag == "int8" else replaces),
                    launches=None, max_abs_err=max_abs, ms=ms,
                    plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=None, back_to_back_ms=loop_ms,
                    cold_l2_ms=cold_ms, host_call_ms=call_ms)
                nblocks = _tensors(leaves[0])[0].shape[0]
                log(f"kernel {name} [{form}] {config} T={x_in.shape[0]} "
                    f"dim={x_in.shape[1]} blocks={nblocks}: max_abs_err "
                    f"{max_abs:.3e} max_rel_err {max_rel:.3e} "
                    f"(tol |err| <= {atol} + {rtol}*|plain|) "
                    f"{'PASS' if ok else 'FAIL'}{extra}; kernel {ms:.4f} ms "
                    f"({cold_ms:.4f} ms after an L2 flush, {loop_ms:.4f} ms "
                    f"back to back without a head start; the call takes "
                    f"{call_ms:.4f} ms of host time), plain "
                    f"{plain_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
                    f"({nbytes} bytes, {ops} operations, by "
                    f"{row['bound_by']})")
                if not ok:
                    raise AssertionError(f"{name} [{form}] disagrees with "
                                         f"its plain version or its "
                                         f"dma=False form")
                rows[(config, kind, tag, dma)] = row
                if (tag, dma) == ("f32", False):
                    next_in = ref  # the next segment's input on the path
            # the unfused nn.Module blocks of the same segment, the nearest
            # thing PyTorch's own calls offer (no single call computes it)
            stacks = {"squeezeformer": (model.conv_squeeze,
                                        model.squeezeformer),
                      "conformer": (model.conv_conform, model.conformer),
                      "transformer": (model.conv_t, model.transformer)}[kind]

            def modules(stacks=stacks):
                with torch.no_grad():
                    h, m = x_in[None], mask[None]
                    for i, blk in enumerate(stacks[1]):
                        for conv in (stacks[0][i] if len(stacks[0]) else ()):
                            h = conv(h, m)
                        h = blk(h, m)
                return h

            mods_ms = time_ms(modules, runs=20, warmup=2, head_start=False)
            log(f"  the same segment as unfused nn.Module blocks (cuBLAS, "
                f"cuDNN, f32): {mods_ms:.4f} ms")
            for key, row in rows.items():
                if key[:2] == (config, kind):
                    row["unfused_modules_ms"] = mods_ms
            x_in = next_in.contiguous()

    # K5c: one block alone is the stack kernel with N = 1
    model = models["preset5"]
    sd = model.state_dict()
    x_in, mask = stem_output(model, reqs[1][1], 150)
    for kind, block_fn, args_of in (
            ("squeezeformer", fb.fused_squeezeformer_block,
             fb.INNER["squeezeformer"][2]),
            ("conformer", fb.fused_conformer_block,
             fb.INNER["conformer"][2])):
        args = args_of(sd, f"{kind}.0.", torch.bfloat16)
        leaves = fb.stack_block_args([args])
        stack_fn = wrappers[kind][0]
        got = block_fn(x_in, mask, args, num_heads=model.cfg.num_heads)
        ref = fb.group_stack_plain(x_in, mask, ((), leaves), kind,
                                   model.cfg.num_heads)
        err = (got - ref).abs()
        atol, rtol = KERNEL_TOL["bf16"]
        if not bool((err <= atol + rtol * ref.abs()).all()):
            raise AssertionError(f"{block_fn.__name__} disagrees with its "
                                 f"plain version")
        ms = time_ms(lambda: stack_fn(x_in, mask, leaves,
                                      num_heads=model.cfg.num_heads))
        nbytes, ops = stack_work(fb, kind, x_in, mask, (), leaves)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["bf16"])
        log(f"kernel {block_fn.__name__} [bf16 weights, N=1] max_abs_err "
            f"{float(err.max()):.3e} PASS; kernel {ms:.4f} ms, bound "
            f"{bound * 1e3:.5f} ms ({nbytes} bytes, {ops} operations)")
    return rows


# The kernels of csrc/fused_block.cu, as the profiler's names spell them
# ("(anonymous namespace)::gemm_kernel<...>(...)").
PORT_KERNEL = re.compile(
    r"::(gemm_kernel|attention_kernel|dwconv_kernel|se_gate_kernel|"
    r"eca_gate_kernel|se_apply_kernel|layernorm_kernel|"
    r"stack_persistent_kernel)\b")


def profile_phase(label, engine, reqs, n: int = 20):
    """Device time by kernel over ``n`` requests (torch.profiler with
    CUPTI), the port's kernel launches per request, and the device's busy
    share of the wall time."""
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
    port = [(c, t) for k, c, t in rows if PORT_KERNEL.search(k)]
    log(f"profile: {label}, {n} requests: wall {wall_us / n:.1f} us/request "
        f"with the profiler on, device busy {busy / n:.1f} us/request "
        f"({100 * busy / wall_us:.1f}% of wall); the port's kernels: "
        f"{sum(c for c, _ in port) / n:.1f} launches/request, "
        f"{sum(t for _, t in port) / n:.1f} us/request; all device kernels "
        f"and copies: {sum(c for _, c, _ in rows) / n:.1f} /request")
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:14]:
        m = PORT_KERNEL.search(key)
        name = m.group(1) if m else key[:60]
        if m and "bfloat16" in key:
            name += "<bf16>"
        if m and "signed char" in key:
            name += "<int8>"
        log(f"  {t / n:9.1f} us/request {100 * t / busy:5.1f}% "
            f"{count / n:6.1f} calls/request  {name}")
    return sum(c for c, _ in port) / n


def latencies(engines, reqs, smi, rounds: int = 200, unfused: int = 50):
    """p50/p99 host-clock request latency of every engine. The engines take
    turns, request by request, so that a spell of host noise falls on all of
    them alike; an unfused engine serves only the first ``unfused`` rounds.
    ``engines`` maps a label to (engine, is_fused)."""
    times = {label: [] for label in engines}
    for i in range(rounds):
        raw = reqs[i % len(reqs)][1]
        for label, (engine, fused) in engines.items():
            if not fused and i >= unfused:
                continue
            t0 = time.perf_counter()
            engine(raw)
            times[label].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for label, ts in times.items():
        ts.sort()
        out[label] = (ts[len(ts) // 2], ts[int(len(ts) * 0.99) - 1])
        log(f"latency {label}, {len(ts)} requests: p50 {out[label][0]:.4f} "
            f"ms p99 {out[label][1]:.4f} ms on {smi}")
    return out


def engine_phase(models, reqs, smi):
    """Serve every engine path. Returns {(config, fused, dma):
    {wrapper name: launches over the nine-request run}}."""
    import torch

    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.ops import fused_block as fb
    from ishara_tpu_torch.preprocess.pipeline import preprocess
    from ishara_tpu_torch.serve import BatchedEngine, InferenceEngine

    tok = CTCTokenizer()
    wrappers = (fb.fused_squeezeformer_stack, fb.fused_conformer_stack,
                fb.fused_conv_group_stack)
    expected = {"preset5": {"fused_squeezeformer_stack",
                            "fused_conformer_stack"},
                "preset3": {"fused_conv_group_stack"},
                "conv_transformer": {"fused_conv_group_stack"}}
    plan = [("preset5", True, False), ("preset5", "int8", False),
            ("preset5", True, True), ("preset5", "int8", True),
            ("preset3", False, False), ("preset3", True, False),
            ("preset3", "int8", False), ("preset3", True, True),
            ("conv_transformer", False, False),
            ("conv_transformer", True, False)]
    engines, results, launches = {}, {}, {}

    def frames(engine, raw):
        n = min(raw.shape[0], engine.max_raw_frames)
        buf = torch.zeros((engine.max_raw_frames, raw.shape[1]),
                          device=DEVICE)
        buf[:n] = torch.from_numpy(raw[:n]).to(DEVICE)
        return preprocess(buf, torch.tensor(max(n, 1), device=DEVICE),
                          engine.stats, engine.frame_len, thin=True)

    for config, fused, dma in plan:
        model = models[config]
        cfg = model.cfg
        label = (f"InferenceEngine(fused={fused!r}, dma={dma}) {config} "
                 f"({cfg.variant})")
        eng = InferenceEngine(model, fused=fused, dma=dma, device=DEVICE)
        engines[(config, fused, dma)] = eng
        eng(reqs[0][1])  # warm-up outside the counted run
        torch.cuda.synchronize()

        # the main path, with the launch counts read around it
        for w in wrappers:
            w.launches = 0
        fb.fused_conv_group_stack.launches_by_inner.clear()
        res = [(label_, *eng(raw)) for label_, raw in reqs]
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        counts.update(
            (f"fused_conv_group_stack[{k}]", n) for k, n in
            fb.fused_conv_group_stack.launches_by_inner.items())
        results[(config, fused, dma)] = res
        launches[(config, fused, dma)] = counts
        log(f"engine {label}: {len(reqs)} requests, kernel launches {counts}")
        for name in expected[config] if fused else ():
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched by {label}")
        if not fused and any(counts.values()):
            raise AssertionError(f"{label} launched a fused kernel")
        for (label_, ids, count) in res:
            if ids.shape != (eng.max_out,) or not 0 <= count <= eng.max_out:
                raise AssertionError(f"{label_}: bad output {ids.shape} "
                                     f"{count}")

        if dma:  # the same ids and counts as the launch-by-launch engine
            for (label_, ids, count), (_, ids0, count0) in zip(
                    res, results[(config, fused, False)]):
                if count != count0 or not np.array_equal(ids, ids0):
                    raise AssertionError(f"{label}: {label_} differs from "
                                         f"the dma=False engine")
            log("  ids and counts equal the dma=False engine's on all "
                "requests PASS")
        elif fused:
            # logits against the unfused model: on the same weights, or at
            # int8 on the dequantized ones
            sd = model.state_dict()
            ref_model = model
            if fused == "int8":
                sd = fb.quantize_serving_weights(sd)
                ref_model = build_model(cfg, device=DEVICE)
                ref_model.load_state_dict(fb.dequantize_serving_weights(sd))
            enc = fb.FusedEncoder(
                cfg, sd, device=DEVICE,
                compute_dtype="int8" if fused == "int8" else torch.bfloat16)
            worst = 0.0
            for (label_, ids, count), (_, raw) in zip(res, reqs):
                x = frames(eng, raw)
                with torch.no_grad():
                    lf = enc(x)
                    lp = ref_model(x[None])[0]
                if not bool(torch.isfinite(lf).all()):
                    raise AssertionError(f"{label_}: non-finite fused logits")
                err = (lf - lp).abs()
                worst = max(worst, float(err.max()))
                if not bool((err <= LOGIT_TOL[0]
                             + LOGIT_TOL[1] * lp.abs()).all()):
                    raise AssertionError(
                        f"{label}: {label_}: fused logits off the unfused "
                        f"path by {float(err.max()):.3e}")
                agree = int((lf.argmax(-1) == lp.argmax(-1)).sum())
                log(f"  {label_:14s} T={raw.shape[0]:4d} count={count:2d} "
                    f"text={tok.decode(ids[:count])!r} | logits max_abs_err "
                    f"{float(err.max()):.3e}, frame argmax agree {agree}/"
                    f"{lf.shape[0]}")
            against = ("the unfused model on the dequantized weights"
                       if fused == "int8" else "the unfused model")
            log(f"  fused logits vs {against}: max_abs_err {worst:.3e} "
                f"(tol |err| <= {LOGIT_TOL[0]} + {LOGIT_TOL[1]}*|unfused|) "
                f"PASS")
        else:
            with torch.no_grad():
                lp = model(frames(eng, reqs[1][1])[None])[0]
            if lp.shape != (cfg.frame_len, cfg.num_classes) \
                    or not bool(torch.isfinite(lp).all()):
                raise AssertionError(f"{label}: bad logits {lp.shape}")
            log(f"  logits {tuple(lp.shape)} finite PASS")

    timed = {f"InferenceEngine(fused={fused!r}, dma={dma}) {config}":
             (eng, bool(fused))
             for (config, fused, dma), eng in engines.items()}
    # preset 5 unfused, the yardstick of its fused engines
    timed["InferenceEngine(fused=False, dma=False) preset5"] = (
        InferenceEngine(models["preset5"], fused=False, device=DEVICE), False)
    latencies(timed, reqs, smi)

    per_req = {}
    for key in (("preset5", True, False), ("preset5", True, True),
                ("preset3", True, False)):
        per_req[key] = profile_phase(
            f"InferenceEngine(fused=True, dma={key[2]}) {key[0]}",
            engines[key], reqs)
    nstacks = 2
    if abs(per_req[("preset5", True, True)] - nstacks) > 1e-9:
        raise AssertionError(
            f"dma=True launched {per_req[('preset5', True, True)]} port "
            f"kernels a request, not one a stack ({nstacks})")
    log(f"dma=True: one kernel launch a stack ({nstacks} a request) PASS")

    for config, fused in (("preset5", True), ("preset5", "int8"),
                          ("preset3", True)):
        batched = BatchedEngine(models[config], batch_size=4, fused=fused,
                                device=DEVICE)
        bids, bcounts = batched([raw for _, raw in reqs[:4]])
        for i, (label_, ids, count) in enumerate(
                results[(config, fused, False)][:4]):
            if not (np.array_equal(bids[i], ids) and bcounts[i] == count):
                raise AssertionError(
                    f"BatchedEngine(fused={fused!r}) {config} row {i} "
                    f"({label_}) differs from InferenceEngine")
        log(f"BatchedEngine(fused={fused!r}) {config} batch 4: counts "
            f"{bcounts.tolist()} match InferenceEngine")

    for config, fused in (("preset5", True), ("preset5", "int8"),
                          ("preset3", True)):
        model = models[config]
        with torch.no_grad():
            bias = model.classifier.bias
            saved = float(bias[59])
            bias[59] = 1000.0
            probe = InferenceEngine(model, fused=fused, device=DEVICE)
            text = probe.predict_text(reqs[2][1], tok)
            bias[59] = saved
        if text != FALLBACK_TEXT:
            raise AssertionError(f"fallback probe ({config}, fused="
                                 f"{fused!r}) gave {text!r}")
        log(f"fallback probe {config} fused={fused!r}: {text!r} PASS")
    return launches


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
    from ishara_tpu_torch.config import EncoderConfig, baseline_config
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.ops import _build
    from ishara_tpu_torch.ops import fused_block as fb

    # The plain versions and the unfused path are the references here: keep
    # cuBLAS and cuDNN at full f32 (cuDNN convolutions default to TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    entry = None
    for line in _build.build_log("fused_block").splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+(\w+_kernel)(\w*)'",
                      line)
        if m:
            entry = m.group(1) + " " + m.group(2)[:12]
        elif "spill" in line and not line.strip().startswith("0 bytes"):
            log(f"  ptxas {entry}: {line.strip()}")
        elif "Used" in line and entry:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")
            entry = None
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # preset 5 (hybrid 4+4) and preset 3 (conv_hybrid 2+2, kernel sizes
    # 11/5/3, top_mult 2) as the package defines them; the JAX package has
    # no conv_transformer preset, so that family runs at the same widths
    # with two groups and the 4x FFN of its TransformerBlock's default.
    configs = {
        "preset5": baseline_config(5).model,
        "preset3": baseline_config(3).model,
        "conv_transformer": EncoderConfig(
            variant="conv_transformer", dim=256, num_heads=8,
            num_squeeze_blocks=2, num_conform_blocks=0,
            kernel_sizes=(11, 5, 3), num_conv_per_block=3,
            expansion_factor=4, dropout=0.2, top_mult=1),
    }
    models = {}
    for seed, (name, cfg) in enumerate(configs.items()):
        models[name] = build_model(cfg, device=DEVICE)
        randomize(models[name], seed=seed)
    reqs = requests(seed=0)

    # the quantizer gives the same integers and scales for weights on the
    # card and on the CPU (the CPU tests hold it to the reference bit for bit)
    sd = models["preset3"].state_dict()
    on_card = fb.quantize_serving_weights(sd)
    on_cpu = fb.quantize_serving_weights({k: v.cpu() for k, v in sd.items()})
    for k, v in on_cpu.items():
        if isinstance(v, dict) and not (
                torch.equal(v["q"], on_card[k]["q"].cpu())
                and torch.equal(v["scale"], on_card[k]["scale"].cpu())):
            raise AssertionError(f"quantizer differs on the card for {k}")
    log("quantize_serving_weights of weights on the card equals the CPU's "
        "bit for bit PASS")

    rows = kernel_phase(models, reqs)
    launches = engine_phase(models, reqs, smi)

    # every ported kernel form that an engine path runs, with the launches
    # of that path's nine-request run
    line = []
    for (config, kind, tag, dma), row in rows.items():
        fused = {"bf16": True, "int8": "int8"}.get(tag)
        counts = launches.get((config, fused, dma))
        if fused is None or counts is None:
            continue  # f32 storage, or a form that no engine here serves
        wrapper = row["name"].removesuffix(
            f"[{tag}{',dma' if dma else ''}]")
        row["launches"] = counts.get(wrapper, 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} ({config}) was not launched "
                                 f"on its engine path")
        row["config"] = config
        line.append(row)
    log(json.dumps({"kernels": line}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
