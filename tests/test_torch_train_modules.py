"""The port's training-mode modules against the JAX package's on the same
numpy inputs, dropout rates 0 (the JAX package draws its CPU masks with
``jax.random``; the port's Philox masks are tested by their own properties
in ``test_torch_dropout.py``): BatchNorm with flax's semantics, the FFN and
attention layers, the training forward of every family with its new batch
statistics, the augmentations with JAX's draws fed in, the synthetic corpus,
the schedules, the optimizer's update against optax, and the metrics.

Tolerances: f32 against f32, rtol = atol = 1e-4 for whole encoders and 1e-5
for single layers (sums run in another order). bf16 against bf16: both
frameworks round every Dense / Conv output and every normalised tensor to
bf16 but sum in another order before each rounding, and an ulp (2^-8
relative) so moved is carried through the remaining layers; the logits of
the small models here (|logit| up to ~2) are held to atol = 0.15, the batch
statistics (f32 reductions of bf16 tensors) to rtol = atol = 2e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from ishara_tpu.data import synthetic as jsyn
from ishara_tpu.data.tokenizer import CTCTokenizer as JTokenizer
from ishara_tpu.evaluation import metrics as jmetrics
from ishara_tpu.models import layers as jlayers
from ishara_tpu.preprocess import augment as jaug
from ishara_tpu.train import optim as joptim

from ishara_tpu_torch import config as tconfig
from ishara_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from ishara_tpu_torch.data import synthetic as tsyn
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.evaluation import metrics as tmetrics
from ishara_tpu_torch.models import layers as tlayers
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.preprocess import augment as taug
from ishara_tpu_torch.train import optim as toptim

from torch_port_helpers import jax_model, perturb, port_model, small_config

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def f32(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.95, 0.99])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_matches_flax(dtype, momentum):
    """Output, running mean and running variance (the biased batch
    variance, unlike torch.nn.BatchNorm1d) after one training call, and the
    eval output with the new statistics."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 10, 16)) * 2.0 + 0.5).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=1e-3, dtype=jd)
    variables = perturb(jbn.init(jax.random.key(0), jnp.asarray(x)))
    want, upd = jbn.apply(variables, jnp.asarray(x, jd),
                          mutable=["batch_stats"])
    tbn = tlayers.BatchNorm(16, eps=1e-3, momentum=momentum, dtype=td)
    tbn.load_state_dict(flax_to_state_dict(variables))
    got = tbn(torch.from_numpy(x).to(td), training=True)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(f32(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)
    # torch's own BatchNorm would have used the unbiased variance
    xf = torch.from_numpy(x).to(td).float().reshape(-1, 16)
    unbiased = momentum * torch.from_numpy(
        np.asarray(variables["batch_stats"]["var"])) \
        + (1 - momentum) * xf.var(0, unbiased=True)
    assert not np.allclose(tbn.running_var.numpy(), unbiased.numpy(),
                           rtol=1e-5, atol=1e-6)
    want_eval = nn.BatchNorm(use_running_average=True, epsilon=1e-3,
                             dtype=jd).apply(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x, jd))
    np.testing.assert_allclose(
        f32(tbn(torch.from_numpy(x).to(td))),
        np.asarray(want_eval, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# FusedFFN and MHSA, training mode, rate 0
# ---------------------------------------------------------------------------

def test_fused_ffn_training_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    res = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jm = jlayers.FusedFFN(32, 2, dropout=0.0, res_rate=0.0)
    variables = perturb(jm.init(jax.random.key(0), jnp.asarray(res),
                                jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(res), jnp.asarray(x),
                    deterministic=False)
    tm = tlayers.FusedFFN(32, 2, dropout=0.0, res_rate=0.0)
    tm.load_state_dict(flax_to_state_dict(variables))
    got = tm(torch.from_numpy(res), torch.from_numpy(x), training=True)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_mhsa_training_matches_flax(use_flash):
    """The einsum path and the forced kernel path (its plain version on the
    CPU) against flax's einsum path, output and input gradient."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    mask = rng.random((2, 24)) > 0.2
    dy = rng.standard_normal((2, 24, 64)).astype(np.float32)
    jm = jlayers.MultiHeadSelfAttention(64, 4, dropout=0.0)
    variables = perturb(jm.init(jax.random.key(0), jnp.asarray(x),
                                jnp.asarray(mask)))
    want, vjp = jax.vjp(
        lambda a: jm.apply(variables, a, jnp.asarray(mask),
                           deterministic=False), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    tm = tlayers.MultiHeadSelfAttention(64, 4, dropout=0.0,
                                        use_flash=use_flash)
    tm.load_state_dict(flax_to_state_dict(variables))
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, torch.from_numpy(mask), training=True)
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(dy))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-4)


def test_mhsa_with_heads_of_128_and_dropout_takes_the_kernel(monkeypatch):
    """Dim 256 in 2 heads of 128, training, attention dropout 0.4, with the
    kernel paths taken on the CPU: the layer goes through the attention
    kernel's wrapper (whose card kernel once refused heads of 128) and its
    output and input gradient match flax's einsum composition on the same
    weights with the port's Philox mask of the site in place of flax's
    dropout draw, at f32 (1e-4, the tolerance of the other MHSA paths)."""
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops.dropout import keep_mask, site_seed_table
    from ishara_tpu_torch.ops.dropout import site_seeds

    B, T, D, H, rate = 2, 24, 256, 2, 0.4
    Dh = D // H
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = rng.random((B, T)) > 0.2
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    jm = jlayers.MultiHeadSelfAttention(D, H, dropout=rate)
    variables = perturb(jm.init(jax.random.key(0), jnp.asarray(x),
                                jnp.asarray(mask)))
    table = site_seed_table(torch.tensor([91], dtype=torch.int32), 2)
    keep = keep_mask(site_seeds(table, 1, 1), (B, H, T, T), rate).numpy()
    params = variables["params"]

    def flax_composition(a):
        qkv = (a @ params["qkv"]["kernel"]).reshape(B, T, H, 3 * Dh)
        q, k, v = jnp.split(qkv.transpose(0, 2, 1, 3), 3, axis=-1)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
        s = jnp.where(jnp.asarray(mask)[:, None, None, :], s,
                      jnp.finfo(s.dtype).min)
        p = nn.softmax(s, axis=-1) * jnp.asarray(keep) / (1.0 - rate)
        o = jnp.einsum("bhqk,bhkd->bhqd", p, v)
        return o.transpose(0, 2, 1, 3).reshape(B, T, D) \
            @ params["proj"]["kernel"]

    want, vjp = jax.vjp(flax_composition, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))

    calls = []
    wrapper = at.flash_mhsa

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return wrapper(q, *a, **kw)

    monkeypatch.setattr(tlayers, "on_card", lambda t: True)
    monkeypatch.setattr(at, "flash_mhsa", spy)
    tm = tlayers.MultiHeadSelfAttention(D, H, dropout=rate)
    tm.load_state_dict(flax_to_state_dict(variables))
    tm.site = 1
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, torch.from_numpy(mask), training=True, seed=table)
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(dy))
    assert calls == [(B, H, T, Dh)]
    assert at.kernel_takes(torch.bfloat16, T, Dh)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-4)


def test_dropout_masks_do_not_depend_on_the_path_taken():
    """With dropout on, a layer's kernel path (its plain version here) and
    its composition drop the same elements, because both key their masks by
    the site's seeds and index them by flat position: the layer's output and
    input gradient agree to f32 rounding (1e-5) whichever path ran."""
    from ishara_tpu_torch.ops.dropout import site_seed_table
    from ishara_tpu_torch.ops.ffn_kernel import ffn_residual

    rng = np.random.default_rng(4)
    table = site_seed_table(torch.tensor([77], dtype=torch.int32), 3)
    x = torch.from_numpy(rng.standard_normal((2, 24, 64)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, 24)) > 0.2)
    dy = torch.from_numpy(rng.standard_normal((2, 24, 64)).astype(np.float32))

    outs = []
    for use_flash in (False, True):
        torch.manual_seed(0)
        m = tlayers.MultiHeadSelfAttention(64, 4, dropout=0.3,
                                           use_flash=use_flash)
        m.site = 1
        xr = x.clone().requires_grad_()
        y = m(xr, mask, training=True, seed=table)
        outs.append((y.detach(), torch.autograd.grad(y, xr, dy)[0]))
    assert not torch.equal(outs[0][0], m(x, mask, training=False).detach())
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)

    torch.manual_seed(0)
    ffn = tlayers.FusedFFN(64, 2, dropout=0.3, res_rate=0.2)
    ffn.site = 2
    xr, rr = x.clone().requires_grad_(), (2 * x).requires_grad_()
    y = ffn(rr, xr, training=True, seed=table)      # the composition
    want = torch.autograd.grad(y, (xr, rr, ffn.fc1.weight), dy)
    y2 = ffn_residual(xr, rr, ffn.fc1.weight.t(), ffn.fc1.bias,
                      ffn.fc2.weight.t(), ffn.fc2.bias, table[2, :2], 0.3, 0.2)
    got = torch.autograd.grad(y2, (xr, rr, ffn.fc1.weight), dy)
    np.testing.assert_allclose(y2.detach().numpy(), y.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The encoder's training forward, every family
# ---------------------------------------------------------------------------

def _training_inputs(cfg):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, cfg.frame_len, cfg.input_dim)).astype(
        np.float32)
    x[0, 17:] = 0.0
    x[2, 9:] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid",
                                     "conv_hybrid", "conv_transformer"])
def test_encoder_training_forward_matches_flax(variant, dtype):
    """Logits and every new batch statistic after one training-mode forward
    (batch statistics in every BatchNorm, rates 0)."""
    blocks = 1 if dtype == "bfloat16" else 2
    cfg = small_config(variant, dtype=dtype, num_squeeze_blocks=blocks,
                       num_conform_blocks=blocks)
    model, variables = jax_model(cfg)
    x = _training_inputs(cfg)
    want, upd = model.apply(variables, jnp.asarray(x), training=True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.key(1)})
    port = port_model(cfg, variables)
    got = port(torch.from_numpy(x), training=True)
    assert got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        stat_tol = 1e-4
    else:
        np.testing.assert_allclose(f32(got), np.asarray(want), rtol=0,
                                   atol=0.15)
        stat_tol = 2e-2
    new_stats = flax_to_state_dict({"batch_stats": upd["batch_stats"]})
    own = port.state_dict()
    assert any(k.endswith("running_var") for k in new_stats)
    for key, val in new_stats.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(own[key].numpy(), val.numpy(),
                                   rtol=stat_tol, atol=stat_tol, err_msg=key)
    # ... and they moved: the eval-mode forward is another function now
    old = flax_to_state_dict(variables)
    assert any(not np.allclose(own[k].numpy(), old[k].numpy())
               for k in new_stats if k.endswith("running_mean"))


def test_encoder_eval_bf16_matches_flax():
    cfg = small_config("hybrid", dtype="bfloat16", num_squeeze_blocks=1,
                       num_conform_blocks=1)
    model, variables = jax_model(cfg)
    x = _training_inputs(cfg)
    want = model.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = port_model(cfg, variables)(torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=0, atol=0.15)


def test_unsupported_training_options_raise():
    cfg = tconfig.EncoderConfig(variant="hybrid", dim=32, num_heads=4,
                                remat=True)
    # remat is ported: the model builds, and its training forward (each
    # block recomputed in the backward pass) equals the plain model's
    remat = build_model(cfg, device="cpu")
    plain = build_model(dataclasses.replace(cfg, remat=False), device="cpu")
    plain.load_state_dict(remat.state_dict())
    x = torch.ones(2, cfg.frame_len, 276)
    seed = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(remat(x, training=True, seed=seed),
                       plain(x, training=True, seed=seed))
    with pytest.raises(ValueError, match="dtype"):
        build_model(dataclasses.replace(cfg, remat=False, dtype="float16"),
                    device="cpu")
    model = build_model(tconfig.EncoderConfig(
        variant="squeezeformer", dim=32, num_heads=4, num_squeeze_blocks=1,
        frame_len=16, dropout=0.1), device="cpu")
    with pytest.raises(ValueError, match="seed"):
        model(torch.ones(1, 16, 276), training=True)


def test_state_dict_to_flax_round_trip():
    cfg = small_config("conv_hybrid")
    _, variables = jax_model(cfg)
    back = state_dict_to_flax(flax_to_state_dict(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]})
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


# ---------------------------------------------------------------------------
# Augmentation, with JAX's draws fed in
# ---------------------------------------------------------------------------

B_AUG, T_AUG = 5, 40


def _raw_batch():
    rng = np.random.default_rng(4)
    x = rng.random((B_AUG, T_AUG, 276)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    lengths = np.array([40, 31, 12, 1, 25], np.int32)
    return x, lengths


def _keys(seed):
    return jax.random.split(jax.random.key(seed), B_AUG)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(got, want, tol=1e-5):
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=tol,
                               atol=tol, equal_nan=True)


def _warp_draws(keys):
    ks = jax.vmap(jax.random.split)(keys)
    return (jax.vmap(jax.random.uniform)(ks[:, 0]),
            jax.vmap(lambda k: jax.random.uniform(k, minval=0.5,
                                                  maxval=1.5))(ks[:, 1]))


def _affine_draws(keys):
    ks = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    return (jax.vmap(lambda k: jax.random.uniform(k, minval=-10.0,
                                                  maxval=10.0))(ks[:, 0]),
            jax.vmap(lambda k: jax.random.uniform(k, minval=0.8,
                                                  maxval=1.2))(ks[:, 1]),
            jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-0.1,
                                                  maxval=0.1))(ks[:, 2]))


def _mask_draws(keys):
    ks = jax.vmap(jax.random.split)(keys)
    return (jax.vmap(jax.random.uniform)(ks[:, 0]),
            jax.vmap(jax.random.uniform)(ks[:, 1]))


def _shift_draws(keys):
    return jax.vmap(lambda k: jax.random.randint(k, (), -10, 11))(keys)


def _finger_draws(keys):
    return jax.vmap(lambda k: jax.random.bernoulli(k, 0.1, (42,)))(keys)


@pytest.mark.parametrize("prob", [1.0, 0.5, 0.0])
def test_time_warp_matches_jax(prob):
    x, lengths = _raw_batch()
    keys = _keys(0)
    want_x, want_len = jax.vmap(
        lambda k, a, n: jaug.time_warp(k, a, n, prob=prob))(
        keys, jnp.asarray(x), jnp.asarray(lengths))
    u, factor = _warp_draws(keys)
    got_x, got_len = taug.time_warp(_t(x), _t(lengths), prob, u=_t(u),
                                    factor=_t(factor))
    _same(got_x, want_x)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_time_shift_matches_jax():
    x, lengths = _raw_batch()
    keys = _keys(1)
    want_x, want_len = jax.vmap(jaug.time_shift)(
        keys, jnp.asarray(x), jnp.asarray(lengths))
    got_x, got_len = taug.time_shift(_t(x), _t(lengths),
                                     shift=_t(_shift_draws(keys)))
    _same(got_x, want_x, tol=0)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_spatial_affine_matches_jax():
    x, _ = _raw_batch()
    keys = _keys(2)
    want = jax.vmap(jaug.spatial_affine)(keys, jnp.asarray(x))
    theta, scale, offset = _affine_draws(keys)
    _same(taug.spatial_affine(_t(x), _t(theta), _t(scale), _t(offset)), want)


def test_temporal_mask_matches_jax():
    x, lengths = _raw_batch()
    keys = _keys(3)
    want = jax.vmap(jaug.temporal_mask)(keys, jnp.asarray(x),
                                        jnp.asarray(lengths))
    u_span, u_start = _mask_draws(keys)
    assert np.isnan(np.asarray(want)).sum() > np.isnan(x).sum()
    _same(taug.temporal_mask(_t(x), _t(lengths), u_span=_t(u_span),
                             u_start=_t(u_start)), want, tol=0)


def test_lr_flip_and_finger_dropout_match_jax():
    x, _ = _raw_batch()
    keys = _keys(4)
    want = jax.vmap(lambda k, a: jaug.lr_flip(k, a, prob=0.5))(
        keys, jnp.asarray(x))
    u = jax.vmap(jax.random.uniform)(keys)
    assert 0 < int((np.asarray(u) < 0.5).sum()) < B_AUG
    _same(taug.lr_flip(_t(x), 0.5, u=_t(u)), want, tol=1e-7)
    want = jax.vmap(jaug.finger_dropout)(keys, jnp.asarray(x))
    _same(taug.finger_dropout(_t(x), drop=_t(_finger_draws(keys))), want,
          tol=0)


@pytest.mark.parametrize("seed,prob,flip", [(5, 0.2, 0.0), (6, 0.7, 0.5),
                                            (7, 1.0, 1.0)])
def test_augment_matches_jax(seed, prob, flip):
    """The composite, fed every draw JAX makes from its ten sub-keys."""
    x, lengths = _raw_batch()
    keys = _keys(seed)
    want_x, want_len = jax.vmap(
        lambda k, a, n: jaug.augment(k, a, n, prob=prob, flip_prob=flip))(
        keys, jnp.asarray(x), jnp.asarray(lengths))
    ks = jax.vmap(lambda k: jax.random.split(k, 10))(keys)
    (k_warp, k_aff, k_affp, k_tm, k_tmp, k_flip, k_fd, k_fdp, k_sh,
     k_shp) = (ks[:, i] for i in range(10))
    uni = jax.vmap(jax.random.uniform)
    p_warp, factor = _warp_draws(k_warp)
    theta, scale, offset = _affine_draws(k_aff)
    u_span, u_start = _mask_draws(k_tm)
    draws = {"p_warp": p_warp, "factor": factor, "p_shift": uni(k_shp),
             "shift": _shift_draws(k_sh), "p_affine": uni(k_affp),
             "theta_deg": theta, "scale": scale, "offset": offset,
             "p_mask": uni(k_tmp), "u_span": u_span, "u_start": u_start,
             "p_fingers": uni(k_fdp), "fingers": _finger_draws(k_fd),
             "p_flip": uni(k_flip)}
    got_x, got_len = taug.augment(_t(x), _t(lengths), prob, flip,
                                  draws={k: _t(v) for k, v in draws.items()})
    _same(got_x, want_x)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_augment_draws_are_a_function_of_the_seed():
    x, lengths = _raw_batch()
    seed = torch.tensor([31], dtype=torch.int32)
    d = taug.draws_from_seed(seed, B_AUG)
    assert set(d) == set(taug._DRAWS)
    assert d["offset"].shape == (B_AUG, 2) and d["fingers"].shape == (
        B_AUG, 42)
    assert bool(((d["shift"] >= -10) & (d["shift"] <= 10)).all())
    assert bool(((d["factor"] >= 0.5) & (d["factor"] < 1.5)).all())
    a = taug.augment(_t(x), _t(lengths), 0.5, draws=d)
    b = taug.augment(_t(x), _t(lengths), 0.5,
                     draws=taug.draws_from_seed(seed, B_AUG))
    _same(a[0], b[0].numpy(), tol=0)
    c = taug.augment(_t(x), _t(lengths), 0.5,
                     draws=taug.draws_from_seed(seed + 1, B_AUG))
    assert not np.array_equal(f32(a[0]), f32(c[0]), equal_nan=True)
    g = torch.Generator().manual_seed(0)
    e = taug.augment(_t(x), _t(lengths), 0.5, generator=g)
    assert e[0].shape == x.shape and e[1].shape == lengths.shape
    with pytest.raises(ValueError, match="Generator"):
        taug.augment(_t(x), _t(lengths))


# ---------------------------------------------------------------------------
# Synthetic corpus, schedules, optimizer, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["SyntheticASLFR", "HardSyntheticASLFR"])
def test_synthetic_batches_are_byte_equal(cls):
    want = getattr(jsyn, cls)(num_sequences=8, seed=3).batch(
        range(8), JTokenizer(), max_frames=96)
    got = getattr(tsyn, cls)(num_sequences=8, seed=3).batch(
        range(8), CTCTokenizer(), max_frames=96)
    assert got["phrases"] == want["phrases"]
    for key in ("raw", "lengths", "labels"):
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes()


STEPS = [0, 3, 999, 1000, 2500, 4999, 5000, 7000, 30000, 49999, 60000]


@pytest.mark.parametrize("method", ["exp", "log"])
def test_lrfn_schedule_matches_jax(method):
    args = (4e-3, 5, 50, 1000)
    want = joptim.lrfn_schedule(*args, warmup_method=method)
    got = toptim.lrfn_schedule(*args, warmup_method=method)
    for step in STEPS:
        np.testing.assert_allclose(
            float(got(torch.tensor(step, dtype=torch.int32))),
            float(want(jnp.asarray(step, jnp.int32))), rtol=1e-5, atol=1e-9,
            err_msg=str(step))  # atol: the cosine's last steps cancel to ~0


def test_onecycle_schedule_matches_optax():
    want = joptim.onecycle_schedule(4e-3, 1000)
    got = toptim.onecycle_schedule(4e-3, 1000)
    for step in (0, 1, 150, 299, 300, 301, 650, 999, 1000, 1500):
        np.testing.assert_allclose(float(got(step)), float(want(step)),
                                   rtol=1e-5, atol=1e-12, err_msg=str(step))


@pytest.mark.parametrize("kind", ["radam_lookahead", "radam", "adamw"])
def test_optimizer_updates_match_optax(kind):
    """Eight updates on one flat parameter vector against the JAX package's
    optax chain: the updates and both moments. Large gradients on the first
    steps exercise the clip; count 6 crosses RAdam's threshold (4).

    Tolerance 2e-5 relative, except RAdam's rectified updates: optax forms
    ``ro = ro_inf - 2 t b2^t / (1 - b2^t)`` in float32, a difference of two
    numbers near 2000 that turns one ulp of ``b2^t`` (XLA's and PyTorch's
    ``pow`` differ by one) into 0.02 of ``ro`` and about 1% of the
    rectifier just above the threshold. Both do the same float32
    arithmetic; those updates are held to 3e-2."""
    cfg = dict(optimizer=kind, steps_per_epoch=2, num_epochs=6,
               warmup_epochs=2)
    jtx, _ = joptim.make_optimizer(
        __import__("ishara_tpu.config", fromlist=["TrainConfig"])
        .TrainConfig(**cfg))
    ttx, _ = toptim.make_optimizer(tconfig.TrainConfig(**cfg))
    rng = np.random.default_rng(5)
    p = rng.standard_normal(300).astype(np.float32)
    jp, jstate = jnp.asarray(p), jtx.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    tstate = ttx.init(tp)
    for i in range(8):
        scale = 5.0 if i < 2 else 0.01
        g = (rng.standard_normal(300) * scale).astype(np.float32)
        jupd, jstate = jtx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update(torch.from_numpy(g), tstate, tp)
        tp = tp + tupd
        rectified = kind != "adamw" and i >= 5
        # (where the direction and the weight decay nearly cancel, the 1%
        # shows against the update's size, not the element's)
        np.testing.assert_allclose(
            tupd.numpy(), np.asarray(jupd), rtol=3e-2 if rectified else 2e-5,
            atol=1e-2 * float(jnp.abs(jupd).max()) if rectified else 1e-9,
            err_msg=f"update {i}")
        tp = torch.from_numpy(np.asarray(jp).copy())  # one update at a time
    adam = jstate[1]
    np.testing.assert_allclose(tstate["mu"].numpy(), np.asarray(adam.mu),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(tstate["nu"].numpy(), np.asarray(adam.nu),
                               rtol=1e-5, atol=1e-12)
    assert int(tstate["count"]) == int(adam.count) == 8
    assert int(tstate["schedule_count"]) == int(jstate[3].count) == 8
    with pytest.raises(ValueError):
        toptim.make_optimizer(tconfig.TrainConfig(optimizer="sgd"))


def test_metrics_match_jax_package():
    rng = np.random.default_rng(6)
    alphabet = list("abc -")
    words = ["".join(rng.choice(alphabet, size=rng.integers(0, 9)))
             for _ in range(40)]
    preds, targets = words[:20], words[20:]
    for a, b in zip(preds, targets):
        assert tmetrics.levenshtein(a, b) == jmetrics.levenshtein(a, b)
    assert tmetrics.levenshtein("kitten", "sitting") == 3
    for mode in ("competition", "max_len", "pooled"):
        assert tmetrics.normalized_levenshtein(preds, targets, mode) == \
            pytest.approx(jmetrics.normalized_levenshtein(preds, targets,
                                                          mode), abs=1e-12)
    assert tmetrics.character_error_rate(preds, targets) == pytest.approx(
        jmetrics.character_error_rate(preds, targets), abs=1e-12)
    with pytest.raises(ValueError):
        tmetrics.normalized_levenshtein(preds, targets[:-1])
    with pytest.raises(ValueError):
        tmetrics.normalized_levenshtein(preds, targets, "other")
