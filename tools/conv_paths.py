#!/usr/bin/env python3
"""Time K7 (``conv_module_residual``) on each of its paths, on the card.

    python3 tools/conv_paths.py [--T 176] [--runs 20]

At x ``[256, T, 256]`` (E 512, r 32, the flagship's widths) and 15, 33 and
63 depthwise taps, bf16 and f32: the forward and the backward C calls with
every tile configuration whose shared memory fits, and with the general
path (the chain of row kernels), each forced in turn; CUDA-event medians.
The plan ``conv_kernel.tile_plan`` chooses is marked. A shape that
``conv_kernel.conv_plan`` gives the wgmma design (bf16, 15 taps) runs it
whatever the configuration, so it is timed once, as "wgmma". Prints the
card's name and power limit first.
"""

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def time_ms(fn, runs):
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=176)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()

    import torch

    from ishara_tpu_torch.ops import conv_kernel as ck

    if not torch.cuda.is_available():
        print("conv_paths: no CUDA device is visible", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    B, T, D, E, r = 256, args.T, 256, 512, 32
    configs = ck._configs
    for K in (15, 33, 63):
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            g = torch.Generator(device="cuda").manual_seed(K)

            def rand(*shape, scale=1.0):
                return torch.randn(shape, generator=g, device="cuda") * scale

            x = rand(B, T, D).to(dt)
            dy = rand(B, T, D).to(dt)
            mask = torch.ones((B, T), device="cuda")
            params = (1 + rand(D, scale=0.1), rand(D, scale=0.1),
                      rand(D, E, scale=D ** -0.5), rand(E, scale=0.1),
                      rand(K, E, scale=K ** -0.5), rand(E, D, scale=E ** -0.5),
                      rand(D, scale=0.1), rand(D, r, scale=D ** -0.5),
                      rand(r, scale=0.1), rand(r, D, scale=r ** -0.5),
                      rand(D, scale=0.1))
            a = ck._prep(x, mask, *params)
            chosen = (ck.tile_plan(T, D, K, dt, False),
                      ck.tile_plan(T, D, K, dt, True))
            chosen = tuple(-1 if p is None else p["config"] for p in chosen)
            wgmma = ck.conv_plan(dt, D, E, K) == "wgmma"
            for direction in ("fwd", "bwd"):
                backward = direction == "bwd"
                cands = [i for i, (mtp, _, ec) in
                         enumerate(ck._TILE_CONFIGS[(dt, backward)])
                         if ck.tile_smem(dt, backward, mtp, ec, D, K)
                         <= ck.SMEM_LIMIT] + [-1]
                line = []
                for c in cands[:1] if wgmma else cands:
                    if backward:
                        # the backward takes the forward's p: the chosen
                        # forward plan's, or the general path's
                        f = chosen[0] if c >= 0 and chosen[0] >= 0 else -1
                        pair = (f, c) if f >= 0 else (-1, -1)
                        if c >= 0 and f < 0:
                            continue
                        ck._configs = (lambda p: lambda *_a: p)((pair[0], -1))
                        _, p = ck._launch_fwd(x, a)
                        ck._configs = (lambda p: lambda *_a: p)(pair)
                        ms = time_ms(lambda: ck._launch_bwd(x, dy, a, p),
                                     args.runs)
                    else:
                        ck._configs = (lambda p: lambda *_a: p)((c, -1))
                        ms = time_ms(lambda: ck._launch_fwd(x, a), args.runs)
                    ck._configs = configs
                    mark = "*" if c == chosen[backward] else ""
                    name = ("wgmma" if wgmma else "general" if c < 0
                            else f"tile {c}")
                    line.append(f"{name}{mark} {ms:.4f}")
                print(f"K {K} {tag} {direction} [{B}, {T}, {D}]: "
                      + ", ".join(line) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
