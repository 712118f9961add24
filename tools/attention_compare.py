"""Time the attention training kernels K3 (``flash_mhsa``) and K8
(``flash_mhsa_blocked``) and the training steps that run them, of one or
more checkouts of the port, for comparing checkouts within one call on the
card.

    python3 tools/attention_compare.py ROOT [ROOT ...]

For each ROOT in turn (a checkout's root, e.g. one unpacked by ``git
archive``), imports ``ishara_tpu_torch`` from it and builds its kernels
(libraries whose source is unchanged are copied from the first root's
build; ``tools/ffn_compare.py``'s helpers). Then:

- K3, bf16, dropout 0.4, q / k / v as the layer makes them (views of one
  ``[B, T, H, 3 Dh]`` projection) at ``[256, 8, 176, 32]`` (the flagship)
  and ``[256, 8, 384, 32]`` (K3's longest T), a padded tail and one fully
  masked row: the forward and the backward (dq, dk, dv), each held against
  the plain version (chip_smoke.py's tolerance), with the backward's design
  where the checkout names one; then the median of 50 launches by CUDA
  events, each after a ~2 ms device spin (device time only);
- ``F.scaled_dot_product_attention`` (additive mask, the same dropout rate
  and scale) forward and backward on the same inputs, timed the same way;
- K8 at ``[256, 8, 512, 32]`` (no dropout), forward and backward, held
  against the plain version, with each direction's design where the
  checkout names one, timed so beside ``F.scaled_dot_product_attention``;
- one step of ``baseline_config(4)`` at batch 256 (bf16, the recipe's
  ``TrainConfig()``): the flagship step (T 176), the long step (T 512,
  dropout 0) and the causal flagship step; the median of 10 steps by the
  host clock, each ending in a synchronize, with K3's launches a step; then
  5 steps under ``torch.profiler``: the device's busy time a step and K3's
  own kernels' time a step (``tc::fwd_kernel``, ``tc::dq_kernel``,
  ``tc::dkv_kernel``, ``k3wg::bwd_wg_kernel``, ``k8wg::fwd_wg_kernel``; on
  the long step these names are K8's, which shares the core and the
  backward). Compare steps by the busy time: the host's clock varies from
  call to call far more.

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

B, H, DH = 256, 8, 32
RATE = 0.4
TOL = 0.02   # chip_smoke.py's TRAIN_TOL["bf16"]
K3_KERNELS = ("tc::fwd_kernel<", "tc::dq_kernel<", "tc::dkv_kernel<",
              "k3wg::bwd_wg_kernel<", "k8wg::fwd_wg_kernel<")


def k3_times(at, T, card, out):
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(T)
    qkv = torch.randn((B, T, H, 3 * DH), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    d_o = torch.randn((B, H, T, DH), generator=g, device="cuda").to(
        torch.bfloat16)
    lengths = torch.randint(40, T + 1, (B,), generator=g, device="cuda")
    lengths[0] = 0                                   # every key masked
    bias = at.mask_to_bias(torch.arange(T, device="cuda")[None, :]
                           < lengths[:, None])
    seed = torch.tensor([977], dtype=torch.int32, device="cuda")
    scale = (H * DH) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(DH, dim=-1)

    def fwd():
        return at.flash_mhsa(q, k, v, bias, seed, scale, RATE)

    o = fwd()

    def bwd():
        return torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)

    grads = bwd()
    with torch.no_grad():
        ro, lse = at.mhsa_forward_plain(q, k, v, bias, seed, scale, RATE)
        rgrads = at.mhsa_backward_plain(q, k, v, bias, seed, ro, lse, d_o,
                                        scale, RATE)
    err = max([close(f"K3 T {T} o", o, ro, TOL)]
              + [close(f"K3 T {T} d{n}", a, b, TOL)
                 for n, a, b in zip("qkv", grads, rgrads)])
    del ro, lse, rgrads
    design = at.backward_plan(q, k, v) \
        if hasattr(at, "backward_plan") else "general"
    mask = bias[:, None, None, :].to(torch.bfloat16)
    lq = qkv.detach().clone().requires_grad_()

    def lib_fwd():
        a, b, c = lq.transpose(1, 2).split(DH, dim=-1)
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              dropout_p=RATE, scale=scale)

    lo = lib_fwd()
    rows = {"design": design, "max_abs_err": err,
            "fwd_ms": device_ms(fwd), "bwd_ms": device_ms(bwd),
            "sdpa_fwd_ms": device_ms(lib_fwd),
            "sdpa_bwd_ms": device_ms(lambda: torch.autograd.grad(
                lo, lq, d_o, retain_graph=True))}
    out[f"k3_T{T}"] = rows
    print(f"{out['root']} K3 q, k, v [{B}, {H}, {T}, {DH}] bf16 rate {RATE} "
          f"(backward: {design}): forward {rows['fwd_ms']:.4f} ms, backward "
          f"{rows['bwd_ms']:.4f} ms; F.scaled_dot_product_attention "
          f"{rows['sdpa_fwd_ms']:.4f} / {rows['sdpa_bwd_ms']:.4f} ms "
          f"(backward {rows['bwd_ms'] / rows['sdpa_bwd_ms']:.3f}x); "
          f"max_abs_err {err:.3e} (tol {TOL}); {card}", flush=True)


def k8_times(ab, card, out, T=512):
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(T)
    qkv = torch.randn((B, T, H, 3 * DH), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    d_o = torch.randn((B, H, T, DH), generator=g, device="cuda").to(
        torch.bfloat16)
    lengths = torch.randint(40, T + 1, (B,), generator=g, device="cuda")
    bias = torch.where(torch.arange(T, device="cuda")[None, :]
                       < lengths[:, None], 0.0, -1e30).float()
    scale = (H * DH) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(DH, dim=-1)

    def fwd():
        return ab.flash_mhsa_blocked(q, k, v, bias, scale)

    def bwd():
        return torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)

    o = fwd()
    grads = bwd()
    with torch.no_grad():
        ro, lse = ab.blocked_attention_forward_plain(q, k, v, bias, scale)
        rgrads = ab.blocked_attention_backward_plain(q, k, v, bias, ro, lse,
                                                     d_o, scale)
    err = max([close(f"K8 T {T} o", o, ro, TOL)]
              + [close(f"K8 T {T} d{n}", a, b, TOL)
                 for n, a, b in zip("qkv", grads, rgrads)])
    del ro, lse, rgrads, grads
    design = tuple(ab.plan_of(q, k, v)) if hasattr(ab, "plan_of") \
        else ("general", "general")
    mask = bias[:, None, None, :].to(torch.bfloat16)
    lq = qkv.detach().clone().requires_grad_()

    def lib_fwd():
        a, b, c = lq.transpose(1, 2).split(DH, dim=-1)
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              scale=scale)

    lo = lib_fwd()
    rows = {"design": design, "max_abs_err": err,
            "fwd_ms": device_ms(fwd), "bwd_ms": device_ms(bwd),
            "sdpa_fwd_ms": device_ms(lib_fwd),
            "sdpa_bwd_ms": device_ms(lambda: torch.autograd.grad(
                lo, lq, d_o, retain_graph=True))}
    out[f"k8_T{T}"] = rows
    fx = rows["fwd_ms"] / rows["sdpa_fwd_ms"]
    bx = rows["bwd_ms"] / rows["sdpa_bwd_ms"]
    print(f"{out['root']} K8 q, k, v [{B}, {H}, {T}, {DH}] bf16 (forward "
          f"{design[0]}, backward {design[1]}): forward "
          f"{rows['fwd_ms']:.4f} ms, backward {rows['bwd_ms']:.4f} ms; "
          f"F.scaled_dot_product_attention {rows['sdpa_fwd_ms']:.4f} / "
          f"{rows['sdpa_bwd_ms']:.4f} ms ({fx:.3f}x / {bx:.3f}x); "
          f"max_abs_err {err:.3e} (tol {TOL}); {card}", flush=True)


def time_root(root, first_build, card):
    import torch

    _build = load_root(root, first_build)
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab

    out = {"root": root, "card": card}
    for T in (176, 384):
        k3_times(at, T, card, out)
        torch.cuda.empty_cache()
    k8_times(ab, card, out)
    torch.cuda.empty_cache()

    for tag, frame_len, extra, fpc, max_frames in STEPS:
        step, state, batch = train_step_case(frame_len, extra, fpc,
                                             max_frames)
        before = (at.flash_mhsa.launches, at.flash_mhsa.launches_bwd)
        state, _ = step(state, batch, seed=0)
        launches = (at.flash_mhsa.launches - before[0],
                    at.flash_mhsa.launches_bwd - before[1])
        ms = step_ms(step, state, batch)
        busy, k3 = step_device_ms(step, state, batch, names=K3_KERNELS)
        out[tag + "_ms"] = ms
        out[tag + "_busy_ms"] = busy
        out[tag + "_k3_device_ms"] = k3
        out[tag + "_k3_launches"] = launches
        print(f"{root} {tag} (T {frame_len}): {ms:.2f} ms a step (median of "
              f"10, host clock); device busy {busy:.3f} ms a step, the "
              f"attention core's kernels {k3:.3f} ms a step (profiler, 5 "
              f"steps); K3 {launches[0]} + {launches[1]} launches a step; "
              f"{card}", flush=True)
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
