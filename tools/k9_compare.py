"""Time the decode kernel K9 of one checkout of the port, for comparing
checkouts within one call on the card.

    python3 tools/k9_compare.py ROOT [ROOT ...]

For each ROOT in turn (a checkout's root, e.g. one unpacked by ``git
archive``), imports ``ishara_tpu_torch`` from it, builds only its
``csrc/decoder.cu`` and times K9 at the reference geometry (dim 208, 8
heads, 2 + 2 decoder layers, 62 classes, T 176, max_out 64, the eos logit
held down so that all 63 steps run) at beam widths 1, 4, 8 and 12, and at
dim 320 with 2 heads of 160 (greedy, beam 4): the median of 20 launches by
CUDA events, after its tokens are checked against the plain version's and a
second launch. A geometry the checkout's guard refuses is reported as such.
Prints one line a geometry and a JSON object a checkout. Give the roots as
parent, change, change, parent to see the spread between calls of the
same code.
"""

import json
import statistics
import subprocess
import sys

CASES = ((208, 8, 1, False), (208, 8, 4, True), (208, 8, 8, True),
         (208, 8, 12, True), (320, 2, 1, False), (320, 2, 4, True))


def time_root(root):
    import torch

    for name in [m for m in sys.modules if m.startswith("ishara_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from ishara_tpu_torch.models.seq2seq import ASLTranslationModel
        from ishara_tpu_torch.ops import _build
        from ishara_tpu_torch.ops import decoder_kernel as dk
    finally:
        sys.path.remove(root)

    def build_decoder_only():
        src = _build.SRC_DIR / "decoder.cu"
        lib = _build._lib_path(src)
        if not lib.exists():
            lib.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib), str(src)], check=True,
                           capture_output=True)
        return {"decoder": lib}

    _build.build = build_decoder_only
    out = {}
    for dim, heads, W, beam in CASES:
        key = f"dim{dim}_h{heads}_w{W}"
        m = ASLTranslationModel(num_classes=62, feature_dim=dim,
                                num_layers=2, num_decoder_layers=2,
                                num_heads=heads).cuda()
        if not dk.fused_decode_fits(m, 176, 64, W):
            out[key] = "refused"
            print(f"{root} {key}: refused by the guard", flush=True)
            continue
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, t in m.state_dict().items():
                n = torch.randn(t.shape, generator=g)
                if t.dim() >= 2:
                    n = n / t.shape[-1] ** 0.5
                elif name.endswith("weight"):
                    n = 1.0 + 0.1 * n
                else:
                    n = 0.1 * n
                t.copy_(n)
        memory = torch.randn((1, 176, dim), generator=g).cuda()
        mask = (torch.arange(176) < 150)[None].cuda()
        pack = dk.pack_decoder(m)
        pack[pack.numel() - 62 * dim - 62 + 2] -= 1e4    # the eos logit
        cross = dk.cross_pack(m, memory)
        madd = dk.memory_add(mask, 176, "cuda")
        args = (pack, cross, madd, dim, heads, 2, 62, 64, W, beam, 1, 2, 0,
                1e-6)
        first, again = dk._launch(*args), dk._launch(*args)
        want, _, _ = dk.decode_plain(pack, cross, madd, d=dim, H=heads, L=2,
                                     C=62, max_len=64, beam_width=W,
                                     beam=beam)
        if not (torch.equal(first[0], want) and torch.equal(again[0], want)):
            raise AssertionError(f"{root} {key}: tokens differ from the "
                                 f"plain version's")
        for _ in range(3):
            dk._launch(*args)
        ts = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dk._launch(*args)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        ms = statistics.median(ts)
        out[key] = ms
        print(f"{root} {key}: {ms:.4f} ms ({1e3 * ms / 63:.2f} us a step), "
              f"tokens equal the plain version's", flush=True)
    print(json.dumps({"root": root, "ms": out}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for root in sys.argv[1:]:
        time_root(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
