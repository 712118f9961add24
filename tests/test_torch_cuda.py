"""The port's CUDA kernels on the card against their plain PyTorch versions.

These tests need a CUDA card and skip without one. They import neither
``jax`` nor the JAX package, so they also run on a machine that has only
PyTorch (``conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small shapes (dim 64, 4 heads of 16, T = 24 with a padded tail) that the
main path's widths do not reach. Tolerances, per element |got - want| <=
tol + tol * |want|: kernel against plain version 1e-3 at f32 storage (f32
on both sides, sums in another order) and 1e-2 at bf16 (the same bf16
rounding points, where a last-bit difference before a rounding can move a
value by one bf16 ulp); the whole fused forward against the unfused model
1e-3 at f32 storage and 5e-2 at bf16, the JAX package's own bf16 tolerance
for its fused forward.
"""

import math

import numpy as np
import pytest
import torch

from ishara_tpu_torch.bridge import conformer_block_args, squeeze_block_args
from ishara_tpu_torch.config import EncoderConfig
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.ops import fused_block as fb

T, VALID = 24, 19
DTYPES = {"f32": (torch.float32, 1e-3, 1e-3), "bf16": (torch.bfloat16, 1e-2,
                                                       5e-2)}


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EncoderConfig(variant="hybrid", dim=64, num_heads=4,
                        num_squeeze_blocks=2, num_conform_blocks=2,
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


def _inputs(dim):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, dim)).astype(np.float32))
    return x.cuda(), (torch.arange(T) < VALID).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["squeezeformer", "conformer"])
def test_kernel_matches_plain(model, kind, dt):
    tdt, tol, _ = DTYPES[dt]
    args_of, fn = ((squeeze_block_args, fb.fused_squeezeformer_stack)
                   if kind == "squeezeformer"
                   else (conformer_block_args, fb.fused_conformer_stack))
    sd = model.state_dict()
    leaves = fb.stack_block_args(
        [args_of(sd, f"{kind}.{i}.", tdt) for i in range(2)])
    x, mask = _inputs(model.cfg.dim)
    before = fn.launches
    got = fn(x, mask, leaves, num_heads=model.cfg.num_heads)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = fb.PLAIN[fn](x, mask, leaves, model.cfg.num_heads)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_forward_matches_model(model, dt):
    tdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, model.cfg.input_dim)).astype(np.float32)
    x[VALID:] = 0.0  # padding frames
    x = torch.from_numpy(x).cuda()
    got = fb.fused_encoder_forward(model.cfg, model.state_dict(), x,
                                   compute_dtype=tdt, device="cuda")
    with torch.no_grad():
        want = model(x[None])[0]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
