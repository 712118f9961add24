"""Time the conv-module training kernel K7 and the training steps that run
it, of one or more checkouts of the port, for comparing checkouts within one
call on the card.

    python3 tools/conv_compare.py ROOT [ROOT ...]

For each ROOT in turn (a checkout's root, e.g. one unpacked by ``git
archive``), imports ``ishara_tpu_torch`` from it and builds its kernels
(libraries whose source is unchanged are copied from the first root's
build). Then:

- K7 (``conv_module_residual``, bf16, D 256, E 512, K 15, r 32, the
  preset-4 Squeezeformer conv module with random weights, a random mask
  with one empty sequence) at x ``[256, 176, 256]`` and ``[256, 512,
  256]``: the forward and all twelve gradients held against the plain
  version (chip_smoke.py's tolerance), a second backward bit for bit, then
  the median of 50 launches by CUDA events, each after a ~2 ms device spin
  (device time only), forward and backward;
- the port's composition of the same module (``fused=False``: ``F.conv1d``,
  ``layer_norm``, ``silu``, the SE), forward and backward, timed the same
  way;
- one step of ``baseline_config(4)`` at batch 256 (bf16, the recipe's
  ``TrainConfig()``): the flagship step (T 176) and the long step
  (``frame_len=512``, ``dropout=0.0``); the median of 10 steps by the host
  clock, each ending in a synchronize, with K7's launches a step (by design
  where the checkout counts them) and the peak of allocated memory over a
  step; then 5 steps under ``torch.profiler``: the device's busy time a
  step and K7's own kernels' time a step (the tile or wgmma kernels, the SE
  gate and its weight gradients, the apply; the weight products and the
  fixed-order sums it shares with K4 are not counted there). Compare steps
  by the busy time: the host's clock varies from call to call far more.

Prints one line a measurement and a JSON object a checkout, each with the
card's name and power limit. Give the roots as parent, change, change,
parent to see the spread between runs of the same code.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from measure import (  # noqa: E402
    STEPS,
    close,
    device_ms,
    load_root,
    smi,
    step_device_ms,
    step_ms,
    train_step_case,
)

B, D, K = 256, 256, 15
TOL = 0.02   # chip_smoke.py's TRAIN_TOL["bf16"]
K7_KERNELS = ("fwd_tile_kernel<", "bwd_tile_kernel<", "cwg::",
              "se_tiles_kernel", "se_wgrad_kernel", "::apply_kernel<")


def kernel_times(ck, SqueezeformerConvModule, T, card, out):
    import torch

    torch.manual_seed(T)
    module = SqueezeformerConvModule(D, K, 2, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, 0.05)
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn((B, T, D), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn((B, T, D), generator=g, device="cuda").to(
        torch.bfloat16)
    lengths = torch.randint(T // 3, T + 1, (B,), generator=g, device="cuda")
    lengths[0] = 0
    mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
    args = module.kernel_args(x, mask)
    wrt = [x] + list(args[1:])

    def fwd():
        return ck.conv_module_residual(x, *args)

    o = fwd()

    def bwd():
        return torch.autograd.grad(o, wrt, dy, retain_graph=True)

    grads, again = bwd(), bwd()
    with torch.no_grad():
        pa = ck._prep(x, *args)
        ref = ck.conv_module_forward_plain(x, *pa)
        rg = ck.conv_module_backward_plain(x, pa[0], dy, *pa[1:])
    err = max([close(f"T {T} out", o, ref, TOL)]
              + [close(f"T {T} gradient {i}", a, b, TOL)
                 for i, (a, b) in enumerate(zip(grads, rg))])
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    if not same:
        raise AssertionError(f"T {T}: two backwards differ")
    del ref, rg, pa, again
    design = ck.conv_plan(torch.bfloat16, D, 2 * D, K) \
        if hasattr(ck, "conv_plan") else "tile"
    rows = {"design": design, "max_abs_err": err,
            "fwd_ms": device_ms(fwd), "bwd_ms": device_ms(bwd)}
    module.fused = False
    co = module(x, mask, training=True)
    params = [x] + list(module.parameters())
    rows["composition_fwd_ms"] = device_ms(
        lambda: module(x, mask, training=True))
    rows["composition_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
        co, params, dy, retain_graph=True))
    out[f"k7_T{T}"] = rows
    print(f"{out['root']} K7 [{B}, {T}, {D}] E {2 * D} K {K} bf16 "
          f"({design}): forward {rows['fwd_ms']:.4f} ms, backward "
          f"{rows['bwd_ms']:.4f} ms; the composition "
          f"{rows['composition_fwd_ms']:.4f} / "
          f"{rows['composition_bwd_ms']:.4f} ms; max_abs_err {err:.3e} "
          f"(tol {TOL}), a second backward bit for bit; {card}", flush=True)


def time_root(root, first_build, card):
    import torch

    _build = load_root(root, first_build)
    from ishara_tpu_torch.models.layers import SqueezeformerConvModule
    from ishara_tpu_torch.ops import conv_kernel as ck

    out = {"root": root, "card": card}
    for T in (176, 512):
        kernel_times(ck, SqueezeformerConvModule, T, card, out)
        torch.cuda.empty_cache()

    w = ck.conv_module_residual
    for tag, frame_len, extra, fpc, max_frames in STEPS[:2]:
        step, state, batch = train_step_case(frame_len, extra, fpc,
                                             max_frames)
        state, _ = step(state, batch, seed=0)
        before = (w.launches, w.launches_bwd,
                  dict(getattr(w, "launches_by_design", {})),
                  dict(getattr(w, "launches_bwd_by_design", {})))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch, seed=0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = (w.launches - before[0], w.launches_bwd - before[1])
        by_design = [{d: n - b[d] for d, n in now.items() if n != b[d]}
                     for now, b in ((getattr(w, "launches_by_design", {}),
                                     before[2]),
                                    (getattr(w, "launches_bwd_by_design", {}),
                                     before[3]))]
        ms = step_ms(step, state, batch)
        busy, k7 = step_device_ms(step, state, batch, names=K7_KERNELS)
        out[tag + "_ms"] = ms
        out[tag + "_busy_ms"] = busy
        out[tag + "_k7_device_ms"] = k7
        out[tag + "_k7_launches"] = launches
        out[tag + "_k7_by_design"] = by_design
        out[tag + "_peak_gib"] = peak
        print(f"{root} {tag} (T {frame_len}): {ms:.2f} ms a step (median of "
              f"10, host clock); device busy {busy:.3f} ms a step, K7's "
              f"kernels {k7:.3f} ms a step (profiler, 5 steps); K7 "
              f"{launches[0]} + {launches[1]} launches a step "
              f"{by_design or ''}; max_memory_allocated over a step "
              f"{peak:.2f} GiB; {card}", flush=True)
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
