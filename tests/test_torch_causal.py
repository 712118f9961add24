"""Causal mode of the port against the JAX package's, on the CPU, f32: the
running-mean pool and the causal SE gate, the causal banded attention, the
left-padded conv modules, both causal blocks, the causal encoder of every
attention-block family in eval and in training mode (dropout 0) with its
gradients, and one causal fused train step leaf by leaf. Then what only the
port can break: a causal layer never reaches the attention, tiled-attention
or conv-module kernels (the kernels implement the bidirectional
semantics), and a perturbed future frame leaves the earlier logits as they
were.

Tolerance: atol = rtol = 1e-5 for single layers and 1e-4 for blocks, whole
encoders and gradients (sums run in another order); the train step as
``test_torch_train_step.py`` holds it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.models import layers as jlayers
from ishara_tpu.models.blocks import ConformerBlock as JConformerBlock
from ishara_tpu.models.blocks import SqueezeformerBlock as JSqueezeBlock
from ishara_tpu.preprocess import GroupStats as JGroupStats
from ishara_tpu.train import make_fused_ctc_train_step as j_make_fused

from ishara_tpu_torch.bridge import flax_to_state_dict
from ishara_tpu_torch.models import layers as tlayers
from ishara_tpu_torch.models.blocks import ConformerBlock, SqueezeformerBlock
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.train import make_fused_ctc_train_step

from test_torch_train_step import (
    FRAME_LEN,
    assert_metrics_match,
    assert_states_match,
    setup,
)
from torch_port_helpers import (
    assert_grads_match,
    jax_model,
    perturb,
    port_model,
    small_config,
)

T, DIM, HEADS = 20, 32, 4


def f32(t):
    return t.detach().to(torch.float32).numpy()


def _x_mask(seed=0, C=DIM):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    mask = rng.random((2, T)) > 0.25
    mask[1, :3] = False          # a row whose first frames are padding
    return x, mask


@pytest.mark.parametrize("with_mask", [True, False])
def test_causal_masked_mean_matches_jax(with_mask):
    x, mask = _x_mask()
    m = mask if with_mask else None
    want = jlayers.causal_masked_mean(
        jnp.asarray(x), None if m is None else jnp.asarray(m))
    got = tlayers.causal_masked_mean(
        torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _layer_pair(name):
    """(flax module, port module, flax call args builder, port call)."""
    if name == "se":
        return (jlayers.SqueezeExcite(DIM, causal=True),
                tlayers.SqueezeExcite(DIM, causal=True))
    if name.startswith("mhsa"):
        ctx = int(name.split("_")[1])
        return (jlayers.MultiHeadSelfAttention(DIM, HEADS, causal=True,
                                               attn_context=ctx),
                tlayers.MultiHeadSelfAttention(DIM, HEADS, causal=True,
                                               attn_context=ctx))
    if name == "conformer_conv":
        return (jlayers.ConformerConvModule(DIM, 7, causal=True),
                tlayers.ConformerConvModule(DIM, 7, causal=True))
    return (jlayers.SqueezeformerConvModule(DIM, 7, 2, causal_se=True),
            tlayers.SqueezeformerConvModule(DIM, 7, 2, causal_se=True))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", ["se", "mhsa_0", "mhsa_5",
                                  "conformer_conv", "squeeze_conv"])
def test_causal_layer_matches_jax(name, training):
    """Each causal layer alone, bridged from its own variables, on an input
    with masked frames; in training mode at rate 0 (the Conformer conv
    module's BatchNorm then takes batch statistics)."""
    x, mask = _x_mask(1)
    jm, tm = _layer_pair(name)
    jx, jmask = jnp.asarray(x), jnp.asarray(mask)
    if name == "conformer_conv":
        variables = perturb(jm.init(jax.random.key(0), jx, False))
        want = jm.apply(variables, jx, training,
                        mutable=["batch_stats"])[0] if training \
            else jm.apply(variables, jx, False)
    elif name.startswith("mhsa"):
        variables = perturb(jm.init(jax.random.key(0), jx, jmask))
        want = jm.apply(variables, jx, jmask, deterministic=not training)
    elif name == "se":
        variables = perturb(jm.init(jax.random.key(0), jx, jmask))
        want = jm.apply(variables, jx, jmask)
    else:
        variables = perturb(jm.init(jax.random.key(0), jx, jmask, False))
        want = jm.apply(variables, jx, jmask, training)
    tm.load_state_dict(flax_to_state_dict(variables))
    tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        if name == "conformer_conv":
            got = tm(tx, training)
        elif name.startswith("mhsa"):
            got = tm(tx, tmask, training)
        elif name == "se":
            got = tm(tx, tmask)
        else:
            got = tm(tx, tmask, training)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("block", ["squeezeformer", "conformer"])
@pytest.mark.parametrize("ctx", [0, 6])
def test_causal_block_matches_jax(block, ctx):
    x, mask = _x_mask(2)
    if block == "squeezeformer":
        jb = JSqueezeBlock(DIM, HEADS, 2, 7, dropout=0.0, causal=True,
                           attn_context=ctx)
        tb = SqueezeformerBlock(DIM, HEADS, 2, 7, causal=True,
                                attn_context=ctx)
    else:
        jb = JConformerBlock(DIM, HEADS, 2, 7, attn_dropout=0.0,
                             drop_rate=0.0, causal=True, attn_context=ctx)
        tb = ConformerBlock(DIM, HEADS, 2, 7, causal=True, attn_context=ctx)
    jx, jmask = jnp.asarray(x), jnp.asarray(mask)
    variables = perturb(jb.init(jax.random.key(0), jx, jmask, False))
    want = jb.apply(variables, jx, jmask, False)
    tb.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = tb.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _encoder_inputs(cfg):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, cfg.frame_len, cfg.input_dim)).astype(
        np.float32)
    x[0, 17:] = 0.0
    x[1, 6:9] = 0.0            # invalid frames inside the sequence
    return x


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid"])
def test_causal_encoder_matches_jax(variant, training):
    """Logits and, in training mode, every parameter's gradient of a fixed
    projection of the logits and the new batch statistics."""
    cfg = small_config(variant, causal=True, attn_context=9)
    model, variables = jax_model(cfg)
    x = _encoder_inputs(cfg)
    port = port_model(cfg, variables)
    if not training:
        want = model.apply(variables, jnp.asarray(x), training=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        return
    proj = np.random.default_rng(4).standard_normal(
        (cfg.num_classes,)).astype(np.float32)

    def loss(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jnp.sum(out * proj), (out, upd)

    (_, (want, upd)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
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


def test_causal_fused_train_step_matches_jax():
    """One step of the fused CTC train step on a causal hybrid (raw batch,
    preprocess, forward, CTC, backward, RAdam + Lookahead) from the same
    weights, leaf by leaf."""
    jstate, tstate, batch, _ = setup(causal=True, attn_context=12)
    assert tstate.model.cfg.causal
    jstep = jax.jit(j_make_fused(JGroupStats.identity(), FRAME_LEN,
                                 aug_prob=0.0, blank_id=59))
    tstep = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                      aug_prob=0.0, blank_id=59)
    jb = {k: jnp.asarray(batch[k]) for k in ("raw", "lengths", "labels")}
    jstate, jm = jstep(jstate, jb, jax.random.key(0))
    tstate, tm = tstep(tstate, batch, seed=0)
    assert_metrics_match(tm, jm)
    assert_states_match(tstate, jstate)


@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid"])
def test_future_frame_leaves_earlier_logits_unchanged(variant):
    """Perturbing frame t changes no logit before t (and does change t's);
    the bidirectional model's earlier logits do move."""
    cfg = small_config(variant, causal=True, attn_context=9)
    _, variables = jax_model(cfg)
    x = _encoder_inputs(cfg)
    x2 = x.copy()
    t = 12
    x2[:, t] += 1.0
    for causal in (True, False):
        cfg_c = small_config(variant, causal=causal, attn_context=9)
        port = port_model(cfg_c, variables)
        with torch.no_grad():
            a = port(torch.from_numpy(x)).numpy()
            b = port(torch.from_numpy(x2)).numpy()
        if causal:
            np.testing.assert_array_equal(a[:, :t], b[:, :t])
            assert np.abs(a[:, t] - b[:, t]).max() > 1e-3
        else:
            assert np.abs(a[:, :t] - b[:, :t]).max() > 1e-3


def _refuse(name):
    def fn(*a, **kw):
        raise AssertionError(f"a causal layer reached {name}")
    return fn


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_causal_training_never_reaches_the_bidirectional_kernels(
        monkeypatch, dropout):
    """With the kernel paths taken (as on a CUDA tensor) a causal hybrid's
    training step reaches neither the attention kernels (flash or tiled)
    nor the conv-module kernel, whatever the selection table says; the
    feed-forward kernel's wrapper it does reach when a site drops. The
    bidirectional model on the same geometry reaches all of them."""
    from ishara_tpu_torch.ops import selection

    row = dict(train_attn="flash", train_attn_nodrop="flash",
               serve_attn="einsum", ffn_dropout_kernel=True,
               conv_module_fused=True)
    monkeypatch.setattr(selection, "_ANCHORS", {(64, 32, 4): row})
    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    calls = {"ffn": 0}
    ffn = tlayers.ffn_residual

    def count_ffn(*a, **kw):
        calls["ffn"] += 1
        return ffn(*a, **kw)

    monkeypatch.setattr(tlayers, "ffn_residual", count_ffn)
    for mod, fn in ((tlayers.attention, "flash_mhsa"),
                    (tlayers.attention_blocked, "flash_mhsa_blocked"),
                    (tlayers.conv_kernel, "conv_module_residual")):
        monkeypatch.setattr(mod, fn, _refuse(fn))
    _, tstate, batch, _ = setup(causal=True, attn_context=12,
                                dropout=dropout, top_dropout=dropout)
    step = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                     aug_prob=0.0, blank_id=59)
    _, m = step(tstate, batch, seed=1)
    assert np.isfinite(float(m["loss"]))
    assert calls["ffn"] == (4 if dropout else 0)
    _, bstate, batch, _ = setup(dropout=dropout, top_dropout=dropout)
    with pytest.raises(AssertionError, match="reached"):
        step(bstate, batch, seed=1)
