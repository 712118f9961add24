"""The port's CUDA kernels on the card against their plain PyTorch versions.

These tests need a CUDA card and skip without one. They import neither
``jax`` nor the JAX package, so they also run on a machine that has only
PyTorch (``conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small shapes (dim 64, 4 heads of 16, T = 24 or 23 with a padded tail, conv
kernel sizes 7 and 3) that the main paths' widths do not reach, for every
kernel form: block stacks and conv groups, f32 / bf16 / int8 storage, one
launch a stage or the persistent ``dma=True`` kernel. Tolerances, per element |got - want| <=
tol + tol * |want|: kernel against plain version 1e-3 at f32 storage (f32
on both sides, sums in another order) and 1e-2 at bf16 (the same bf16
rounding points, where a last-bit difference before a rounding can move a
value by one bf16 ulp); the whole fused forward against the unfused model
1e-3 at f32 storage and 5e-2 at bf16 and int8 (int8 against the model on the
dequantized weights), the JAX package's own tolerance for its fused forward.
"""

import math

import numpy as np
import pytest
import torch

from ishara_tpu_torch.config import EncoderConfig
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.ops import fused_block as fb

DTYPES = {"f32": (torch.float32, 1e-3, 1e-3),
          "bf16": (torch.bfloat16, 1e-2, 5e-2),
          "int8": ("int8", 1e-2, 5e-2)}
SEGMENTS = {"hybrid": ("squeezeformer", "conformer"),
            "conv_hybrid": ("squeezeformer", "conformer"),
            "conv_transformer": ("transformer",)}


def _model(variant, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EncoderConfig(variant=variant, dim=64, num_heads=4,
                        num_squeeze_blocks=2, num_conform_blocks=2,
                        kernel_sizes=(7, 3), num_conv_per_block=2,
                        frame_len=T)
    m = build_model(cfg, device="cuda")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            n = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                n = 0.5 + torch.rand(t.shape, generator=g)
            elif name.endswith("weight") and t.dim() >= 2:
                n = n / math.sqrt(t[0].numel())
            elif name.endswith("weight"):
                n = 1.0 + 0.1 * n
            else:
                n = 0.1 * n
            t.copy_(n)
    return m


def _inputs(T, dim):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, dim)).astype(np.float32))
    return x.cuda(), (torch.arange(T) < T - 5).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 23])
@pytest.mark.parametrize("dma", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("variant,kind", [
    (v, k) for v, kinds in SEGMENTS.items() for k in kinds])
def test_kernel_matches_plain(variant, kind, dt, dma, T):
    """Every stack kernel -- block stacks and conv groups, each storage, as
    launches and as the persistent kernel, even and odd T -- against its
    plain version; the persistent form equals the launches bit for bit."""
    tdt, tol, _ = DTYPES[dt]
    model = _model(variant, T)
    sd = model.state_dict()
    if dt == "int8":
        sd = fb.quantize_serving_weights(sd)
    conv, leaves = fb.encoder_segment_args(model.cfg, sd, kind, tdt)
    x, mask = _inputs(T, model.cfg.dim)
    heads = model.cfg.num_heads
    if variant == "hybrid":
        fn = {"squeezeformer": fb.fused_squeezeformer_stack,
              "conformer": fb.fused_conformer_stack}[kind]

        def run(dma):
            return fn(x, mask, leaves, num_heads=heads, dma=dma)
    else:
        fn = fb.fused_conv_group_stack

        def run(dma):
            return fn(x, mask, (conv, leaves), kind, num_heads=heads, dma=dma)
    before = fn.launches
    got = run(dma)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = fb.group_stack_plain(x, mask, (conv, leaves), kind, heads)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dma:
        assert torch.equal(got, run(False))


@pytest.mark.cuda
@pytest.mark.parametrize("dma", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("variant", list(SEGMENTS))
def test_fused_forward_matches_model(variant, dt, dma):
    T = 24
    tdt, _, tol = DTYPES[dt]
    model = _model(variant, T)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, model.cfg.input_dim)).astype(np.float32)
    x[T - 5:] = 0.0  # padding frames
    x = torch.from_numpy(x).cuda()
    sd = model.state_dict()
    if dt == "int8":  # against the model on the dequantized weights
        sd = fb.quantize_serving_weights(sd)
        model.load_state_dict(fb.dequantize_serving_weights(sd))
    got = fb.fused_encoder_forward(model.cfg, sd, x, compute_dtype=tdt,
                                   dma=dma, device="cuda")
    with torch.no_grad():
        want = model(x[None])[0]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
