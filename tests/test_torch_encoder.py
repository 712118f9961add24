"""The port's ``IsharaEncoder`` (PyTorch, CPU, f32) against the flax model's
eval logits, with the flax variables bridged (non-trivial LN/BN affine
parameters and BN running statistics). Tolerance: atol = rtol = 1e-4 for
the encoder and the attention blocks (both f32; sums run in another order),
1e-5 for the conv families' layers and blocks taken alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.models import blocks as jblocks
from ishara_tpu.models import layers as jlayers
from ishara_tpu.models.blocks import ConformerBlock as JConformerBlock
from ishara_tpu.models.blocks import SqueezeformerBlock as JSqueezeBlock

from ishara_tpu_torch.bridge import flax_to_state_dict
from ishara_tpu_torch.models import blocks as tblocks
from ishara_tpu_torch.models import layers as tlayers
from ishara_tpu_torch.models.blocks import ConformerBlock, SqueezeformerBlock

from torch_port_helpers import jax_model, perturb, port_model, small_config


def _inputs(kind, cfg):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, cfg.frame_len, cfg.input_dim)).astype(
        np.float32)
    if kind == "padded":
        x[0, 17:] = 0.0
        x[1, 5:] = 0.0
    elif kind == "all_padding":  # finfo.min and -1e30 masks both go uniform
        x[1] = 0.0
    return x


@pytest.mark.parametrize("kind", ["padded", "all_padding"])
@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid",
                                     "conv_hybrid", "conv_transformer",
                                     "parallel_branches",
                                     "squeezeformer_unet"])
def test_encoder_matches_flax(variant, kind):
    cfg = small_config(variant)
    model, variables = jax_model(cfg)
    x = _inputs(kind, cfg)
    want = np.asarray(model.apply(variables, jnp.asarray(x), training=False))
    with torch.no_grad():
        got = port_model(cfg, variables)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block", ["squeezeformer", "conformer"])
def test_block_matches_flax(block):
    """One block alone, bridged from its own variable subtree."""
    T, dim, heads = 24, 64, 4
    if block == "squeezeformer":
        jb, tb = JSqueezeBlock(dim, heads, 2, 15, dropout=0.0), \
            SqueezeformerBlock(dim, heads, 2, 15)
    else:
        jb = JConformerBlock(dim, heads, 2, 15, attn_dropout=0.0,
                             drop_rate=0.0)
        tb = ConformerBlock(dim, heads, 2, 15)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, T, dim)).astype(np.float32)
    mask = rng.random((1, T)) > 0.2
    variables = perturb(jb.init(jax.random.key(0), jnp.asarray(x),
                                jnp.asarray(mask), False))
    want = np.asarray(jb.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                               False))
    tb.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = tb.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["eca", "eca_even", "causal_dw",
                                  "causal_dw_dilated", "conv1d_k7",
                                  "conv1d_k3", "conv1d_widen", "transformer"])
def test_conv_family_module_matches_flax(name):
    """ECA, CausalDWConv1D, Conv1DBlock and TransformerBlock alone, bridged
    from their own variables, on an input with masked frames (f32, 1e-5)."""
    T, dim, heads = 24, 64, 4
    jm, tm, masked = {
        "eca": (jlayers.ECA(5), tlayers.ECA(5), True),
        "eca_even": (jlayers.ECA(4), tlayers.ECA(4), True),
        "causal_dw": (jlayers.CausalDWConv1D(7),
                      tlayers.CausalDWConv1D(dim, 7), False),
        "causal_dw_dilated": (jlayers.CausalDWConv1D(3, 2, True),
                              tlayers.CausalDWConv1D(dim, 3, 2, True), False),
        "conv1d_k7": (jblocks.Conv1DBlock(dim, 7),
                      tblocks.Conv1DBlock(dim, dim, 7), True),
        "conv1d_k3": (jblocks.Conv1DBlock(dim, 3),
                      tblocks.Conv1DBlock(dim, dim, 3), True),
        "conv1d_widen": (jblocks.Conv1DBlock(2 * dim, 5),  # no skip add
                         tblocks.Conv1DBlock(dim, 2 * dim, 5), True),
        "transformer": (jblocks.TransformerBlock(dim, heads, 2, 0.0, 0.0),
                        tblocks.TransformerBlock(dim, heads, 2), True),
    }[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, T, dim)).astype(np.float32)
    mask = rng.random((2, T)) > 0.3
    args = (jnp.asarray(x), jnp.asarray(mask)) if masked else (jnp.asarray(x),)
    variables = perturb(jm.init(jax.random.key(0), *args))
    want = np.asarray(jm.apply(variables, *args))
    tm.load_state_dict(flax_to_state_dict(variables))
    targs = (torch.from_numpy(x), torch.from_numpy(mask)) if masked \
        else (torch.from_numpy(x),)
    with torch.no_grad():
        got = tm.eval()(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bridge_covers_every_tensor():
    """The bridged state_dict has exactly the port model's keys and
    shapes (load_state_dict is strict), and layouts are transposed."""
    cfg = small_config("hybrid")
    _, variables = jax_model(cfg)
    sd = flax_to_state_dict(variables)
    model = port_model(cfg, variables)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    k = np.asarray(variables["params"]["stem_conv"]["kernel"])
    np.testing.assert_array_equal(sd["stem_conv.weight"].numpy(), k.T)
    dw = np.asarray(variables["params"]["conformer_1"]["conv"]["dw"]["kernel"])
    np.testing.assert_array_equal(
        sd["conformer.1.conv.dw.weight"].numpy(), dw.transpose(2, 1, 0))
    var = np.asarray(variables["batch_stats"]["stem_bn"]["var"])
    np.testing.assert_array_equal(sd["stem_bn.running_var"].numpy(), var)


@pytest.mark.parametrize("variant", ["conv_hybrid", "conv_transformer"])
def test_bridge_covers_every_conv_family_tensor(variant):
    cfg = small_config(variant)
    _, variables = jax_model(cfg)
    sd = flax_to_state_dict(variables)
    own = port_model(cfg, variables).state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    tag = "squeeze1" if variant == "conv_hybrid" else "t1"
    eca = np.asarray(variables["params"][f"conv_{tag}_1"]["eca"]["conv"]
                     ["kernel"])
    np.testing.assert_array_equal(
        sd[f"conv_{tag[:-1]}.1.1.eca.conv.weight"].numpy(),
        eca.transpose(2, 1, 0))


@pytest.mark.parametrize("variant", ["parallel_branches",
                                     "squeezeformer_unet"])
def test_unported_variants_raise(variant):
    """The two families once refused are built now, as a causal hybrid
    is; what still raises is serving either through the fused kernels,
    which implement neither (ValueError, as the reference's
    ``fused_encoder_forward``)."""
    from ishara_tpu_torch.config import EncoderConfig
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.serve.engine import InferenceEngine

    for cfg in (EncoderConfig(variant=variant, dim=32, num_heads=4,
                              frame_len=16),
                EncoderConfig(variant="hybrid", dim=32, num_heads=4,
                              frame_len=16, causal=True)):
        model = build_model(cfg, device="cpu")
        with torch.no_grad():
            out = model(torch.ones(1, 16, 276))
        assert out.shape[-1] == cfg.num_classes
        assert torch.isfinite(out).all()
        with pytest.raises(ValueError, match="fused"):
            InferenceEngine(model, device="cpu", fused=True)


@pytest.mark.parametrize("variant", ["parallel_branches",
                                     "squeezeformer_unet"])
def test_new_family_bf16_matches_flax(variant):
    """bf16 against bf16 (see ``test_torch_train_modules.py``'s tolerance:
    each framework rounds every product, in another order; the small
    models' logits are held to atol = 0.15)."""
    cfg = small_config(variant, dtype="bfloat16", num_squeeze_blocks=2,
                       num_conform_blocks=1)
    model, variables = jax_model(cfg)
    x = _inputs("padded", cfg)
    want = np.asarray(model.apply(variables, jnp.asarray(x), training=False))
    with torch.no_grad():
        got = port_model(cfg, variables)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.15)


@pytest.mark.parametrize("variant", ["conv_hybrid", "squeezeformer",
                                     "hybrid", "parallel_branches"])
def test_get_model_matches_jax(variant):
    """``get_model`` builds the configuration JAX's builds (the reference
    defaults, ``top_mult`` 2 for conv_hybrid and squeezeformer, kwargs into
    the config) and, on JAX's weights, its logits; the top-level export is
    the same function."""
    import dataclasses

    from ishara_tpu import get_model as jget_model
    import ishara_tpu_torch
    from ishara_tpu_torch.models import get_model

    kw = dict(dim=32, num_conv_squeeze_blocks=1, num_conv_conform_blocks=1,
              kernel_sizes=(5, 3), num_conv_per_block=2, dropout_rate=0.0,
              num_heads=4, variant=variant, frame_len=24, top_dropout=0.0)
    jm = jget_model(**kw)
    tm = ishara_tpu_torch.get_model(device="cpu", **kw)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.top_mult == (2 if variant in ("conv_hybrid",
                                                "squeezeformer") else 1)
    assert not tm.training
    x = _inputs("padded", jm.cfg)
    variables = perturb(jm.init(jax.random.key(0), jnp.zeros_like(x[:1])))
    tm.load_state_dict(flax_to_state_dict(variables))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert get_model(device="cpu").cfg.variant == "conv_hybrid"
    # as JAX's get_model, it builds an IsharaEncoder: the U-Net is
    # build_model's
    with pytest.raises(ValueError, match="unknown variant"):
        get_model(variant="squeezeformer_unet", device="cpu")


@pytest.mark.parametrize("variant", ["parallel_branches",
                                     "squeezeformer_unet"])
def test_bridge_covers_every_new_family_tensor(variant):
    cfg = small_config(variant)
    _, variables = jax_model(cfg)
    sd = flax_to_state_dict(variables)
    own = port_model(cfg, variables).state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("variant", ["conv_hybrid", "conv_transformer"])
def test_causal_conv_family_raises_as_the_reference(variant):
    """The reference refuses causal mode for the conv families with a
    ValueError (their ECA gate sees the whole sequence); so does the port."""
    from ishara_tpu.config import EncoderConfig as JConfig
    from ishara_tpu.models.encoder import build_model as jbuild
    from ishara_tpu_torch.config import EncoderConfig
    from ishara_tpu_torch.models.encoder import build_model

    with pytest.raises(ValueError, match="causal"):
        jbuild(JConfig(variant=variant, dim=32, causal=True)).init(
            jax.random.key(0), jnp.zeros((1, 176, 276)))
    with pytest.raises(ValueError, match="causal"):
        build_model(EncoderConfig(variant=variant, dim=32, causal=True),
                    device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        build_model(EncoderConfig(variant="no_such", dim=32), device="cpu")
