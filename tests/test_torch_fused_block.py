"""The port's fused block stacks (K5a Squeezeformer, K5b Conformer, K6 conv
groups, their int8 form K5e and their dma form K5d) and its
``fused_encoder_forward`` against the JAX package's Pallas kernels run in
interpret mode, as tests/test_fused_block.py runs them.

On the CPU the port's wrappers run their plain PyTorch versions. Tolerances:
at f32 weight storage atol = rtol = 5e-5 (both f32; sums in another order);
at bf16 storage atol = rtol = 1e-2: both round the weights, and q, k, v and
p in attention, to bf16 at the same points, but an f32 difference in the
last bit before a rounding can move one value by a bf16 ulp. At int8 storage
both sides hold identical int8 leaves and scales and round to bf16 at the
same points: the whole forward agrees within 1e-3, and within 5e-2 (the
reference's own tolerance) of the unfused model on the dequantized weights.
The quantizer itself is held to the reference's bit for bit.

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
from ishara_tpu.serve.export import _dequantize_tree, _quantize_tree

from ishara_tpu_torch import bridge
from ishara_tpu_torch.bridge import (
    conformer_block_args,
    conv1d_block_args,
    flax_to_state_dict,
    squeeze_block_args,
    transformer_block_args,
)
from ishara_tpu_torch.models import fused
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


def _tcfg(cfg):
    return tcfg.EncoderConfig(**dataclasses.asdict(cfg))


def _frames(cfg, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cfg.frame_len, cfg.input_dim)).astype(np.float32)
    x[18:] = 0.0  # padding frames
    return x


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid",
                                     "conv_hybrid", "conv_transformer"])
def test_fused_encoder_forward_matches_pallas_interpret(variant, dt):
    jdt, tdt, tol = DTYPES[dt]
    cfg = small_config(variant)
    model, variables = jax_model(cfg)
    x = _frames(cfg)
    want = jfb.fused_encoder_forward(cfg, variables, jnp.asarray(x),
                                     interpret=True, compute_dtype=jdt)
    sd = port_model(cfg, variables).state_dict()
    got = fused.fused_encoder_forward(_tcfg(cfg), sd, torch.from_numpy(x),
                                    compute_dtype=tdt, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("variant", ["hybrid", "conv_hybrid",
                                     "conv_transformer"])
def test_fused_encoder_dma_matches_pallas_interpret(variant):
    """dma=True against the reference's double-buffered DMA kernels at f32
    (5e-5); it changes no arithmetic, so on the CPU it equals dma=False."""
    cfg = small_config(variant)
    model, variables = jax_model(cfg)
    x = _frames(cfg)
    want = jfb.fused_encoder_forward(cfg, variables, jnp.asarray(x),
                                     interpret=True,
                                     compute_dtype=jnp.float32, dma=True)
    sd = port_model(cfg, variables).state_dict()
    got, same = (fused.fused_encoder_forward(
        _tcfg(cfg), sd, torch.from_numpy(x), compute_dtype=torch.float32,
        dma=dma, device="cpu") for dma in (True, False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_array_equal(got.numpy(), same.numpy())


def _groups(inner, dt_j, dt_t, variables=None, quantized=False):
    """The conv groups of a small conv-family model for both packages:
    (cfg, jax groups, port groups)."""
    variant = "conv_transformer" if inner == "transformer" else "conv_hybrid"
    cfg = small_config(variant)
    if variables is None:
        _, variables = jax_model(cfg)
    params, stats = variables["params"], variables["batch_stats"]
    sd = flax_to_state_dict(variables)
    if quantized:
        params = _quantize_tree(params)
        sd = tfb.quantize_serving_weights(sd)
    tag, name, jargs, targs = {
        "squeezeformer": ("squeeze", "squeezeformer", jfb._squeeze_args,
                          squeeze_block_args),
        "conformer": ("conform", "conformer", jfb._conformer_args,
                      conformer_block_args),
        "transformer": ("t", "transformer", jfb._transformer_args,
                        transformer_block_args),
    }[inner]
    jgroups, tgroups = [], []
    for i in range(2):
        jconv = tuple(jfb._conv1d_args(params[f"conv_{tag}{i}_{j}"],
                                       stats[f"conv_{tag}{i}_{j}"], dt_j)
                      for j in range(cfg.num_conv_per_block))
        p = params[f"{name}_{i}"]
        jinner = jargs(p, stats[f"{name}_{i}"], dt_j) \
            if inner == "conformer" else jargs(p, dt_j)
        jgroups.append((jconv, jinner))
        tgroups.append((
            tuple(conv1d_block_args(sd, f"conv_{tag}.{i}.{j}.", dt_t)
                  for j in range(cfg.num_conv_per_block)),
            targs(sd, f"{name}.{i}.", dt_t)))
    return cfg, jgroups, tgroups


@pytest.mark.parametrize("inner", ["squeezeformer", "conformer",
                                   "transformer"])
def test_group_stack_matches_pallas_interpret(inner):
    """K6: two groups of (2 Conv1DBlocks, kernel sizes 7 and 3 -> one
    ``inner`` block) at f32 storage, mask with a padded tail; 5e-5."""
    cfg, jgroups, tgroups = _groups(inner, jnp.float32, torch.float32)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((T, DIM)).astype(np.float32)
    mask = np.arange(T) < 19
    want = jfb.fused_conv_group_stack(jnp.asarray(x), jnp.asarray(mask),
                                      jgroups, inner, num_heads=HEADS,
                                      interpret=True)
    groups = tfb.stack_group_args(tgroups)
    before = tfb.fused_conv_group_stack.launches
    got = tfb.fused_conv_group_stack(torch.from_numpy(x),
                                     torch.from_numpy(mask), groups, inner,
                                     num_heads=HEADS)
    assert tfb.fused_conv_group_stack.launches == before  # CPU: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    same = tfb.fused_conv_group_stack(torch.from_numpy(x),
                                      torch.from_numpy(mask), groups, inner,
                                      num_heads=HEADS, dma=True)
    np.testing.assert_array_equal(got.numpy(), same.numpy())
    assert tfb.PLAIN[tfb.fused_conv_group_stack] is tfb.group_stack_plain


def _quantized_entries(tree, prefix=""):
    """(state_dict key, {"q", "scale"}) for each quantized flax kernel."""
    for key, val in tree.items():
        if bridge.is_quantized(val):
            yield prefix + "weight", val
        elif isinstance(val, dict):
            yield from _quantized_entries(
                val, prefix + bridge._module_name(key) + ".")


@pytest.mark.parametrize("variant", ["hybrid", "conv_hybrid",
                                     "conv_transformer"])
def test_quantizer_matches_reference_bit_for_bit(variant):
    """Every q and every scale of the port's quantizer (on the bridged
    state_dict) equals the reference's ``_quantize_tree`` (on the flax
    tree), Dense, 1x1 conv, depthwise and ECA kernels alike; 1-D leaves and
    BN statistics stay float."""
    cfg = small_config(variant, top_mult=2)
    _, variables = jax_model(cfg)
    want = _quantize_tree(variables["params"])
    sd = flax_to_state_dict(variables)
    got = tfb.quantize_serving_weights(sd)
    seen = set()
    for key, val in _quantized_entries(want):
        q = np.asarray(val["q"])
        np.testing.assert_array_equal(got[key]["q"].numpy(),
                                      bridge._convert_kernel(q), err_msg=key)
        assert got[key]["q"].dtype == torch.int8
        np.testing.assert_array_equal(got[key]["scale"].numpy(),
                                      np.asarray(val["scale"]), err_msg=key)
        seen.add(key)
    assert seen == {k for k, v in got.items() if bridge.is_quantized(v)}
    assert seen == {k for k, v in sd.items() if v.dim() >= 2}
    assert got["stem_bn.running_var"] is sd["stem_bn.running_var"]
    back = tfb.dequantize_serving_weights(got)
    deq = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, _dequantize_tree(want))})
    for key in seen:
        np.testing.assert_array_equal(back[key].numpy(), deq[key].numpy())


@pytest.mark.parametrize("inner", ["squeezeformer", "conformer",
                                   "transformer"])
def test_int8_kernel_leaves_match_reference_bit_for_bit(inner):
    """The int8 leaves in the kernel layout: (q [in, out], scale [out])
    pairs, and the dequantized depthwise and ECA kernels."""
    _, jgroups, tgroups = _groups(inner, "int8", "int8", quantized=True)
    for (jconv, jinner), (tconv, tinner) in zip(jgroups, tgroups):
        for jl, tl in zip(list(jconv) + [jinner], list(tconv) + [tinner]):
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                if isinstance(a, tuple):
                    assert b[0].dtype == torch.int8
                    np.testing.assert_array_equal(np.asarray(a[0]),
                                                  b[0].numpy())
                    np.testing.assert_array_equal(np.asarray(a[1])[0],
                                                  b[1].numpy())
                else:
                    np.testing.assert_array_equal(
                        np.asarray(a).reshape(b.shape), b.numpy())


@pytest.mark.parametrize("variant", ["hybrid", "conv_hybrid",
                                     "conv_transformer"])
def test_fused_encoder_int8_matches_pallas_interpret(variant):
    cfg = small_config(variant)
    model, variables = jax_model(cfg)
    x = _frames(cfg)
    qvars = {"params": jfb.quantize_serving_weights(variables["params"]),
             "batch_stats": variables["batch_stats"]}
    want = jfb.fused_encoder_forward(cfg, qvars, jnp.asarray(x),
                                     interpret=True, compute_dtype="int8")
    port = port_model(cfg, variables)
    qsd = tfb.quantize_serving_weights(port.state_dict())
    got = fused.fused_encoder_forward(_tcfg(cfg), qsd, torch.from_numpy(x),
                                    compute_dtype="int8", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    # against the unfused model on the dequantized weights: the reference's
    # own tolerance (scale after the dot; q, k, v, p rounded to bf16)
    port.load_state_dict(tfb.dequantize_serving_weights(qsd))
    with torch.no_grad():
        unfused = port(torch.from_numpy(x)[None])[0]
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=5e-2,
                               atol=5e-2)
    # a float storage dtype dequantizes int8 entries on load, as the
    # reference's _mat_fn does
    f32 = fused.fused_encoder_forward(_tcfg(cfg), qsd, torch.from_numpy(x),
                                    compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(f32.numpy(), unfused.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_int8_mode_requires_quantized_weights():
    cfg = small_config("conv_hybrid")
    _, variables = jax_model(cfg)
    sd = port_model(cfg, variables).state_dict()
    with pytest.raises(ValueError, match="quantize_serving_weights"):
        fused.FusedEncoder(_tcfg(cfg), sd, compute_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="quantize_serving_weights"):
        squeeze_block_args(sd, "squeezeformer.0.", "int8")
    with pytest.raises(ValueError, match="compute_dtype"):
        fused.FusedEncoder(_tcfg(cfg), sd, compute_dtype=torch.float16,
                         device="cpu")
    # a pair where the storage is bf16, and a tensor where it is int8
    x = torch.zeros((T, DIM))
    mask = torch.ones(T)
    qsd = tfb.quantize_serving_weights(sd)
    q = list(tfb.stack_block_args(
        [squeeze_block_args(qsd, "squeezeformer.0.", "int8")]))
    f = list(tfb.stack_block_args(
        [squeeze_block_args(sd, "squeezeformer.0.", torch.bfloat16)]))
    mixed = list(f)
    mixed[2] = q[2]
    with pytest.raises(ValueError, match="f1w1"):
        tfb.fused_squeezeformer_stack(x, mask, tuple(mixed), num_heads=HEADS)
    mixed = list(q)
    mixed[2] = f[2]
    with pytest.raises(ValueError, match="f1w1"):
        tfb.fused_squeezeformer_stack(x, mask, tuple(mixed), num_heads=HEADS)
    with pytest.raises(ValueError, match="inner"):
        tfb.fused_conv_group_stack(x, mask, ((), tuple(f)), "lstm",
                                   num_heads=HEADS)


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

