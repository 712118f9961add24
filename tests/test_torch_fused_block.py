"""The port's fused block stacks (K5a Squeezeformer, K5b Conformer) and its
``fused_encoder_forward`` against the JAX package's Pallas kernels run in
interpret mode, as tests/test_fused_block.py runs them.

On the CPU the port's wrappers run their plain PyTorch versions. Tolerances:
at f32 weight storage atol = rtol = 5e-5 (both f32; sums in another order);
at bf16 storage atol = rtol = 1e-2: both round the weights, and q, k, v and
p in attention, to bf16 at the same points, but an f32 difference in the
last bit before a rounding can move one value by a bf16 ulp.

The CUDA kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py`` (marked ``cuda``; it skips without a card) and
by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.models.blocks import ConformerBlock as JConformerBlock
from ishara_tpu.models.blocks import SqueezeformerBlock as JSqueezeBlock
from ishara_tpu.ops import fused_block as jfb

import ishara_tpu_torch.config as tcfg
from ishara_tpu_torch.bridge import (
    conformer_block_args,
    flax_to_state_dict,
    squeeze_block_args,
)
from ishara_tpu_torch.ops import fused_block as tfb

from torch_port_helpers import jax_model, perturb, port_model, small_config

T, DIM, HEADS, K = 24, 64, 4, 15
DTYPES = {"f32": (jnp.float32, torch.float32, 5e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _block(kind, nblocks):
    """Flax variables for ``nblocks`` blocks of one kind, an input and a
    mask with a padded tail."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, DIM)).astype(np.float32)
    mask = np.arange(T) < 19
    if kind == "squeezeformer":
        mod = JSqueezeBlock(DIM, HEADS, 2, K, dropout=0.0)
    else:
        mod = JConformerBlock(DIM, HEADS, 2, K, attn_dropout=0.0,
                              drop_rate=0.0)
    vs = [perturb(mod.init(jax.random.key(i), jnp.asarray(x)[None],
                           jnp.asarray(mask)[None], False), seed=i + 1)
          for i in range(nblocks)]
    return x, mask, vs


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["squeezeformer", "conformer"])
def test_block_matches_pallas_interpret(kind, dt):
    jdt, tdt, tol = DTYPES[dt]
    x, mask, (v,) = _block(kind, 1)
    sd = flax_to_state_dict(v)
    if kind == "squeezeformer":
        want = jfb.fused_squeezeformer_block(
            jnp.asarray(x), jnp.asarray(mask), v["params"], num_heads=HEADS,
            interpret=True, compute_dtype=jdt)
        got = tfb.fused_squeezeformer_block(
            torch.from_numpy(x), torch.from_numpy(mask),
            squeeze_block_args(sd, "", tdt), num_heads=HEADS)
    else:
        want = jfb.fused_conformer_block(
            jnp.asarray(x), jnp.asarray(mask), v["params"], v["batch_stats"],
            num_heads=HEADS, interpret=True, compute_dtype=jdt)
        got = tfb.fused_conformer_block(
            torch.from_numpy(x), torch.from_numpy(mask),
            conformer_block_args(sd, "", tdt), num_heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind", ["squeezeformer", "conformer"])
def test_stack_matches_pallas_interpret(kind):
    """Two blocks through the stacked (grid-pipelined) kernel, bf16."""
    jdt, tdt, tol = DTYPES["bf16"]
    x, mask, vs = _block(kind, 2)
    sds = [flax_to_state_dict(v) for v in vs]
    if kind == "squeezeformer":
        want = jfb.fused_squeezeformer_stack(
            jnp.asarray(x), jnp.asarray(mask), [v["params"] for v in vs],
            num_heads=HEADS, interpret=True, compute_dtype=jdt)
        leaves = tfb.stack_block_args(
            [squeeze_block_args(sd, "", tdt) for sd in sds])
        got = tfb.fused_squeezeformer_stack(
            torch.from_numpy(x), torch.from_numpy(mask), leaves,
            num_heads=HEADS)
    else:
        want = jfb.fused_conformer_stack(
            jnp.asarray(x), jnp.asarray(mask), [v["params"] for v in vs],
            [v["batch_stats"] for v in vs], num_heads=HEADS, interpret=True,
            compute_dtype=jdt)
        leaves = tfb.stack_block_args(
            [conformer_block_args(sd, "", tdt) for sd in sds])
        got = tfb.fused_conformer_stack(
            torch.from_numpy(x), torch.from_numpy(mask), leaves,
            num_heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid"])
def test_fused_encoder_forward_matches_pallas_interpret(variant, dt):
    jdt, tdt, tol = DTYPES[dt]
    cfg = small_config(variant)
    model, variables = jax_model(cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((cfg.frame_len, cfg.input_dim)).astype(np.float32)
    x[18:] = 0.0  # padding frames
    want = jfb.fused_encoder_forward(cfg, variables, jnp.asarray(x),
                                     interpret=True, compute_dtype=jdt)
    sd = port_model(cfg, variables).state_dict()
    got = tfb.fused_encoder_forward(
        tcfg.EncoderConfig(**dataclasses.asdict(cfg)), sd,
        torch.from_numpy(x), compute_dtype=tdt, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_cpu_path_counts_no_launch_and_checks_inputs():
    x, mask, (v,) = _block("squeezeformer", 1)
    args = squeeze_block_args(flax_to_state_dict(v), "", torch.bfloat16)
    before = tfb.fused_squeezeformer_stack.launches
    tfb.fused_squeezeformer_block(torch.from_numpy(x), torch.from_numpy(mask),
                                  args, num_heads=HEADS)
    assert tfb.fused_squeezeformer_stack.launches == before
    bad = list(args)
    bad[2] = bad[2].to(torch.float32)  # one matrix at another storage dtype
    with pytest.raises(ValueError, match="f1w1"):
        tfb.fused_squeezeformer_block(torch.from_numpy(x),
                                      torch.from_numpy(mask), tuple(bad),
                                      num_heads=HEADS)
    with pytest.raises(ValueError, match="num_heads"):
        tfb.fused_squeezeformer_block(torch.from_numpy(x),
                                      torch.from_numpy(mask), args,
                                      num_heads=5)
    cfg = tcfg.EncoderConfig(**dataclasses.asdict(small_config("hybrid")))
    with pytest.raises(NotImplementedError, match="int8"):
        tfb.FusedEncoder(cfg, {}, compute_dtype="int8", device="cpu")

