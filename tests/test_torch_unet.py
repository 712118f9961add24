"""The port's Temporal U-Net Squeezeformer (``models/squeezeformer_unet.py``)
and the ``squeezeformer_unet`` family against the JAX package's, on the
CPU: the relative positional encoding and shift, the relative attention,
the 2-D subsampling, the time reduction at odd and even lengths, the
recovery, the post-LN block in eval and training mode, the encoder with
and without subsampling, the whole model through ``build_model`` (f32 and
bf16, eval and training at dropout 0, with gradients) and its dropout
sites. Its train step, engines and bundles, with the parallel-branches
family's, are ``test_torch_families.py``'s.

Tolerances: f32 against f32, atol = rtol = 1e-5 for single layers and
1e-4 for blocks, models and gradients. bf16 against bf16: both round each
Linear / Conv output to bf16 (the post-LN blocks' LayerNorms return f32 in
both, checked) but sum in another order before each rounding; the
log-probs (|value| up to ~10) are held to atol = 0.15, as the bf16
encoders of ``test_torch_train_modules.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.models import squeezeformer_unet as ju

from ishara_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from ishara_tpu_torch.models import squeezeformer_unet as tu
from ishara_tpu_torch.models.layers import number_dropout_sites

from torch_port_helpers import (
    assert_grads_match,
    jax_model,
    perturb,
    port_model,
    small_config,
)

DIM, HEADS = 32, 4


def f32(t):
    return t.detach().to(torch.float32).numpy()


def _x_mask(T, C=DIM, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    mask = np.ones((2, T), bool)
    mask[0, T - 5:] = False
    mask[1, 2:4] = False
    return x, mask


def _bridged(jm, tm, *init_args):
    variables = perturb(jm.init(jax.random.key(0), *init_args))
    tm.load_state_dict(flax_to_state_dict(variables))
    return variables


def test_rel_positional_encoding_and_shift():
    np.testing.assert_array_equal(tu.rel_positional_encoding(7, 16),
                                  ju.rel_positional_encoding(7, 16))
    x = np.random.default_rng(0).standard_normal((2, 3, 6, 11)).astype(
        np.float32)
    want = ju.RelativeMultiHeadAttention._rel_shift(jnp.asarray(x))
    got = tu.RelativeMultiHeadAttention._rel_shift(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_mask", [True, False])
def test_relative_attention_matches_jax(with_mask):
    x, mask = _x_mask(12)
    m = mask if with_mask else None
    jm = ju.RelativeMultiHeadAttention(DIM, HEADS, dropout=0.0)
    tm = tu.RelativeMultiHeadAttention(DIM, HEADS, dropout=0.0)
    jmask = None if m is None else jnp.asarray(m)
    variables = _bridged(jm, tm, jnp.asarray(x), jmask)
    assert {"u_bias", "v_bias"} <= set(variables["params"])
    want = jm.apply(variables, jnp.asarray(x), jmask)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if m is None
                 else torch.from_numpy(m))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("T", [16, 19])
def test_subsampling_matches_jax(T):
    x = np.random.default_rng(1).standard_normal((2, T, 22)).astype(
        np.float32)
    jm, tm = ju.DepthwiseConv2dSubsampling(8), tu.DepthwiseConv2dSubsampling(8)
    variables = _bridged(jm, tm, jnp.asarray(x))
    assert variables["params"]["conv1"]["kernel"].ndim == 4
    want = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and the rank-4 kernels bridge back as they came
    back = state_dict_to_flax(tm.state_dict())["params"]
    for name in ("conv1", "dwconv"):
        np.testing.assert_array_equal(back[name]["kernel"],
                                      variables["params"][name]["kernel"])


@pytest.mark.parametrize("T", [10, 11, 12, 13])
@pytest.mark.parametrize("k", [5, 4])
def test_time_reduction_matches_jax(T, k):
    """flax's SAME padding at stride 2 (the smaller half on the left): the
    output has ceil(T / 2) frames at odd and even T and kernel sizes."""
    x, _ = _x_mask(T)
    jm = ju.TimeReductionLayer(DIM, kernel_size=k)
    tm = tu.TimeReductionLayer(DIM, kernel_size=k)
    variables = _bridged(jm, tm, jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape[1] == -(-T // 2) == want.shape[1]
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    up = tu.recover_resolution(got, T)
    np.testing.assert_array_equal(
        f32(up), np.asarray(ju.recover_resolution(jnp.asarray(f32(got)), T)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [False, True])
def test_post_ln_block_matches_jax(training, dtype):
    """The block in eval and in training mode (batch statistics in its
    BatchNorm, rate 0); its LayerNorms have no compute dtype, so in a bf16
    block they return float32 in both packages."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, mask = _x_mask(14, seed=2)
    jm = ju._PostLNBlock(DIM, HEADS, kernel_size=7, dropout=0.0, dtype=jd)
    tm = tu._PostLNBlock(DIM, HEADS, kernel_size=7, dropout=0.0, dtype=td)
    jx, jmask = jnp.asarray(x, jd), jnp.asarray(mask)
    variables = _bridged(jm, tm, jx, jmask, False)
    if training:
        want, upd = jm.apply(variables, jx, jmask, True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jx, jmask, False)
    got = tm(torch.from_numpy(x).to(td), torch.from_numpy(mask), training)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 0.15
    np.testing.assert_allclose(f32(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    if training:
        sd = tm.state_dict()
        for key, val in flax_to_state_dict(
                {"batch_stats": upd["batch_stats"]}).items():
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(
                    sd[key].numpy(), val.numpy(), err_msg=key,
                    rtol=1e-4 if dtype == "float32" else 2e-2,
                    atol=1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("subsample", [False, True])
def test_speech_encoder_matches_jax(subsample):
    """The block stack with time reduction at block 1 and recovery at block
    3 (T 16 -> 8 -> 16, the mask halved and restored), with and without
    the 2-D subsampling front (which takes input_dim 20 to 5 * dim)."""
    T, F = 16, 20
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T, F)).astype(np.float32)
    mask = np.ones((2, T), bool)
    mask[0, 11:] = False
    kw = dict(dim=DIM, num_layers=4, num_heads=HEADS, kernel_size=7,
              reduce_idx=1, recover_idx=3, dropout=0.0, subsample=subsample,
              input_dim=F)
    jm = ju.SpeechSqueezeformerEncoder(**kw)
    tm = tu.SpeechSqueezeformerEncoder(**kw)
    variables = _bridged(jm, tm, jnp.asarray(x), jnp.asarray(mask))
    assert {"time_reduce", "recover_proj", "block_3"} <= set(
        variables["params"])
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _unet_cfg(**kw):
    base = dict(variant="squeezeformer_unet", dim=DIM, num_heads=HEADS,
                num_squeeze_blocks=3, frame_len=24)
    base.update(kw)
    return small_config(**base)


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, cfg.frame_len, cfg.input_dim)).astype(
        np.float32)
    x[0, 17:] = 0.0
    x[1, 5:] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frame_len", [24, 23])
def test_unet_model_matches_jax(frame_len, dtype):
    """The adapter's log-probs through ``build_model``: n 3 blocks, the
    reduction at 1 (at 0 for an odd frame_len) and the recovery at 2."""
    cfg = _unet_cfg(frame_len=frame_len, dtype=dtype)
    model, variables = jax_model(cfg)
    x = _inputs(cfg)
    want = model.apply(variables, jnp.asarray(x), training=False)
    port = port_model(cfg, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-4 if dtype == "float32" else 0.15
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=tol,
                               atol=tol)
    # log-probs: each frame's probabilities sum to 1
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, atol=1e-5)


def test_unet_training_forward_and_gradients_match_jax():
    cfg = _unet_cfg()
    model, variables = jax_model(cfg)
    x = _inputs(cfg)
    proj = np.random.default_rng(4).standard_normal(
        (cfg.num_classes,)).astype(np.float32)

    def loss(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jnp.sum(out * proj), (out, upd)

    (_, (want, upd)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    port = port_model(cfg, variables)
    got = port(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    (got * torch.from_numpy(proj)).sum().backward()
    assert_grads_match(
        {n: p.grad for n, p in port.named_parameters()},
        flax_to_state_dict({"params": jax.device_get(grads)}))
    sd = port.state_dict()
    for key, val in flax_to_state_dict(
            {"batch_stats": upd["batch_stats"]}).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[key].numpy(), val.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=key)


def test_unet_dropout_sites_follow_the_seed():
    """Three sites a block (the attention probabilities, each FFN's
    hidden); the same (seed, step) gives the same forward, another seed
    another."""
    from ishara_tpu_torch.models.encoder import build_model
    import ishara_tpu_torch.config as tcfg

    cfg = tcfg.EncoderConfig(variant="squeezeformer_unet", dim=DIM,
                             num_heads=HEADS, num_squeeze_blocks=4,
                             frame_len=24, dropout=0.3)
    model = build_model(cfg, device="cpu")
    assert model.num_sites == 12 == number_dropout_sites(model)
    x = torch.from_numpy(_inputs(cfg))
    seed = torch.tensor([7], dtype=torch.int32)
    a = model(x, training=True, seed=seed)
    b = model(x, training=True, seed=seed)
    c = model(x, training=True, seed=torch.tensor([8], dtype=torch.int32))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="seed"):
        model(x, training=True)
