"""The port's ``IsharaEncoder`` (PyTorch, CPU, f32) against the flax model's
eval logits, with the flax variables bridged (non-trivial LN/BN affine
parameters and BN running statistics). Tolerance: atol = rtol = 1e-4 (both
f32; sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.models.blocks import ConformerBlock as JConformerBlock
from ishara_tpu.models.blocks import SqueezeformerBlock as JSqueezeBlock

from ishara_tpu_torch.bridge import flax_to_state_dict
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
@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid"])
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


@pytest.mark.parametrize("variant", ["conv_hybrid", "conv_transformer",
                                     "parallel_branches"])
def test_unported_variants_raise(variant):
    from ishara_tpu_torch.config import EncoderConfig
    from ishara_tpu_torch.models.encoder import build_model

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(EncoderConfig(variant=variant, dim=32), device="cpu")
    with pytest.raises(NotImplementedError, match="causal"):
        build_model(EncoderConfig(variant="hybrid", dim=32, causal=True),
                    device="cpu")
