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

B, D, M = 256, 256, 512
RATES = (0.4, 0.4)
TOL = 0.02   # chip_smoke.py's TRAIN_TOL["bf16"]


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
