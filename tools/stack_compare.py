"""Time every form of the block-stack kernels K5 / K6 of one or more
checkouts of the port, and the fused preset-5 request end to end, for
comparing checkouts within one call on the card.

    python3 tools/stack_compare.py ROOT [ROOT ...]

For each ROOT in turn (a checkout's root, e.g. one unpacked by ``git
archive``), imports ``ishara_tpu_torch`` from it, builds only its stack
kernel (``csrc/fused_block.cu``) and, on models with seeded random weights,
runs every stack segment of preset 5 (hybrid 4 + 4: the Squeezeformer and
the Conformer stack), preset 3 (conv_hybrid 2 + 2, kernel sizes 11 / 5 / 3)
and a conv_transformer of the same widths (2 groups, 4x FFN), at dim 256, 8
heads, T 176 (150 frames valid), in every form: f32, bf16 and int8 weights,
``dma`` False and True; then preset 5's stacks at dims 144, 196 and 324 (4
heads) at bf16, where a checkout's guard may refuse them. Each form is first
held against its plain version (chip_smoke.py's tolerances) and a second
launch, then timed: the median of 50 launches by CUDA events, each after a
~2 ms device spin so that the host has enqueued the whole stack (device time
only). A ``torch.profiler`` trace of one call of each bf16 stack at dim 256
splits the call's device span into kernel time by kernel and the gaps
between kernels.

Then every checkout's ``InferenceEngine(fused=True)`` on preset 5 serves
the same requests, the checkouts taking turns request by request, and the
host clock gives each one's p50 and p99 request latency: host time
included, as a user sees it.

Prints one line a form and a JSON object a checkout. Give the roots as
parent, change, change, parent to see the spread between runs of the same
code.
"""

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np

T, VALID = 176, 150
KERNEL_TOL = {"f32": (1e-3, 1e-3), "bf16": (1e-2, 1e-2), "int8": (1e-2, 1e-2)}
FORMS = [(tag, dma) for tag in ("bf16", "f32", "int8") for dma in (False, True)]
ROUNDS = 300  # requests a checkout's engine serves, after 20 of warm-up


def randomize(model, seed):
    """chip_smoke.py's weights: matrices N(0, 1/fan_in), norm scales
    1 + 0.1 N, biases and means 0.1 N, running variances 0.5 + U(0, 1)."""
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


def time_ms(fn, runs=50):
    import torch

    for _ in range(3):
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


def trace_split(fn):
    """(kernels, device span us, kernel time us, {kernel kind: us}) of one
    call of ``fn``: the profiled call, of three, that recorded the most
    kernels (a profiler can miss a call's kernels), or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "anonymous namespace" in e.name]
        if len(evs) > len(best):
            best = evs
    if not best:
        return None
    start = min(e.time_range.start for e in best)
    end = max(e.time_range.end for e in best)
    kinds = {}
    for e in best:
        m = re.search(r"::(\w+?)(<|\()", e.name)
        k = m.group(1) if m else e.name[:40]
        kinds[k] = kinds.get(k, 0.0) + e.time_range.elapsed_us()
    return (len(best), end - start, sum(kinds.values()),
            {k: round(v, 2) for k, v in sorted(kinds.items())})


def check(root, key, got, ref, again, tag):
    import torch

    atol, rtol = KERNEL_TOL[tag]
    err = (got - ref).abs()
    if not (bool(torch.isfinite(got).all())
            and bool((err <= atol + rtol * ref.abs()).all())):
        raise AssertionError(f"{root} {key}: off its plain version by "
                             f"{float(err.max()):.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"{root} {key}: a second launch differs")
    return float(err.max())


def time_root(root):
    """Every form of ``root``'s stack kernel; returns its fused preset-5
    engine for the end-to-end turn."""
    import torch

    for name in [m for m in sys.modules if m.startswith("ishara_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from ishara_tpu_torch.config import EncoderConfig, baseline_config
        from ishara_tpu_torch.models import fused as fenc
        from ishara_tpu_torch.models.encoder import build_model
        from ishara_tpu_torch.ops import _build
        from ishara_tpu_torch.ops import fused_block as fb
        from ishara_tpu_torch.serve import InferenceEngine
    finally:
        sys.path.remove(root)

    def build_stack_only():
        src = _build.SRC_DIR / "fused_block.cu"
        lib = _build._lib_path(src)
        if not lib.exists():
            lib.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib), str(src)], check=True,
                           capture_output=True)
        return {"fused_block": lib}

    _build.build = build_stack_only
    configs = {
        "preset5": baseline_config(5).model,
        "preset3": dataclasses.replace(baseline_config(3).model,
                                       dtype="float32"),
        "conv_transformer": EncoderConfig(
            variant="conv_transformer", dim=256, num_heads=8,
            num_squeeze_blocks=2, num_conform_blocks=0,
            kernel_sizes=(11, 5, 3), num_conv_per_block=3,
            expansion_factor=4, dropout=0.2, top_mult=1),
    }
    kinds = {"hybrid": ("squeezeformer", "conformer"),
             "conv_hybrid": ("squeezeformer", "conformer"),
             "conv_transformer": ("transformer",)}
    storages = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": "int8"}
    mask = (torch.arange(T) < VALID).cuda()
    out, splits, models = {}, {}, {}
    cases = [(config, cfg, seed, tag, dma)
             for seed, (config, cfg) in enumerate(configs.items())
             for tag, dma in FORMS]
    for dim in (144, 196, 324):
        cfg = dataclasses.replace(configs["preset5"], dim=dim, num_heads=4)
        cases.append((f"preset5_dim{dim}", cfg, dim, "bf16", False))
    for config, cfg, seed, tag, dma in cases:
        if config not in models:
            models[config] = build_model(cfg, device="cuda")
            randomize(models[config], seed)
        sd = models[config].state_dict()
        if tag == "int8":
            sd = fb.quantize_serving_weights(sd)
        g = torch.Generator().manual_seed(7)
        x = torch.randn((T, cfg.dim), generator=g).cuda()
        grouped = cfg.variant != "hybrid"
        for kind in kinds[cfg.variant]:
            conv, leaves = fenc.encoder_segment_args(cfg, sd, kind,
                                                     storages[tag])

            def run(dma=dma, conv=conv, leaves=leaves, kind=kind, x=x,
                    cfg=cfg):
                if grouped:
                    return fb.fused_conv_group_stack(
                        x, mask, (conv, leaves), kind,
                        num_heads=cfg.num_heads, dma=dma)
                fn = {"squeezeformer": fb.fused_squeezeformer_stack,
                      "conformer": fb.fused_conformer_stack}[kind]
                return fn(x, mask, leaves, num_heads=cfg.num_heads, dma=dma)

            key = f"{config}/{kind}/{tag}" + ("/dma" if dma else "")
            try:
                got = run()
            except ValueError as e:  # a width the checkout's guard refuses
                out[key] = "refused"
                print(f"{root} {key}: refused ({e})", flush=True)
                continue
            torch.cuda.synchronize()
            ref = fb.group_stack_plain(x, mask.float(), (conv, leaves), kind,
                                       cfg.num_heads)
            err = check(root, key, got, ref, run(), tag)
            out[key] = ms = time_ms(run)
            print(f"{root} {key}: {ms:.4f} ms (max_abs_err {err:.3e})",
                  flush=True)
            if tag == "bf16" and not dma and "_dim" not in config:
                split = trace_split(run)
                if split is not None:
                    n, span, busy, by = split
                    splits[key] = {"kernels": n, "span_us": span,
                                   "kernel_us": busy, "by_kernel_us": by}
                    print(f"{root} {key} trace: {n} kernels, device span "
                          f"{span:.1f} us, kernels {busy:.1f} us, gaps "
                          f"{span - busy:.1f} us; {by}", flush=True)
    engine = InferenceEngine(models["preset5"], fused=True, device="cuda")
    print(json.dumps({"root": root, "ms": out, "trace": splits}), flush=True)
    return engine


def requests(n, seed=0):
    """``n`` raw requests [len, 276] with NaN hands, 60-384 frames."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((int(rng.integers(60, 385)), 276)).astype(np.float32)
        x[rng.random(x.shape[0]) < 0.3, :] = np.nan
        out.append(x)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    roots = sys.argv[1:]
    engines = [time_root(root) for root in roots]
    reqs = requests(16)
    for i in range(20):
        for eng in engines:
            eng(reqs[i % len(reqs)])
    times = [[] for _ in roots]
    for i in range(ROUNDS):
        for j, eng in enumerate(engines):
            t0 = time.perf_counter()
            eng(reqs[i % len(reqs)])
            times[j].append((time.perf_counter() - t0) * 1e3)
    for root, ts in zip(roots, times):
        ts.sort()
        p50, p99 = ts[len(ts) // 2], ts[int(len(ts) * 0.99) - 1]
        print(f"{root} InferenceEngine(fused=True) preset5, {ROUNDS} "
              f"requests in turns: p50 {p50:.4f} ms p99 {p99:.4f} ms",
              flush=True)
        print(json.dumps({"root": root, "e2e_p50_ms": p50, "e2e_p99_ms": p99}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
