"""The port's attention module (``ishara_tpu_torch/ops/attention.py``, whose
plain version runs here on the CPU) against the JAX package's
``flash_mhsa(interpret=True)`` and ``reference_mhsa`` on the same numpy
inputs. f32: forward rtol = atol = 1e-5, gradients 1e-4 (the JAX package's
own tolerances for kernel against oracle). bf16: the output is rounded to
bf16 on both sides, one ulp (2^-8 relative) apart at most where a last bit
differs before the rounding: rtol = atol = 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.ops.attention import flash_mhsa as j_flash_mhsa
from ishara_tpu.ops.attention import mask_to_bias as j_mask_to_bias
from ishara_tpu.ops.attention import reference_mhsa as j_reference_mhsa

from ishara_tpu_torch.ops import attention as at

B, H, T, Dh = 2, 4, 32, 16
SCALE = (H * Dh) ** -0.5
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def case(seed=0):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, H, T, Dh)).astype(np.float32)
               for _ in range(3))
    mask = r.random((B, T)) > 0.25
    d_o = r.standard_normal((B, H, T, Dh)).astype(np.float32)
    return q, k, v, mask, d_o


def as_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def as_np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_grads_match_pallas_interpret(dtype):
    q, k, v, mask, d_o = case()
    jd = jnp.dtype(dtype)
    bias = j_mask_to_bias(jnp.asarray(mask))
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    want, vjp = jax.vjp(
        lambda a, b, c: j_flash_mhsa(a, b, c, bias, scale=SCALE,
                                     interpret=True), jq, jk, jv)
    want_g = vjp(jnp.asarray(d_o, jd))

    tq, tk, tv = (as_torch(a, dtype).requires_grad_() for a in (q, k, v))
    tbias = at.mask_to_bias(torch.from_numpy(mask))
    got = at.flash_mhsa(tq, tk, tv, tbias, scale=SCALE)
    got_g = torch.autograd.grad(got, (tq, tk, tv), as_torch(d_o, dtype))
    assert got.dtype == getattr(torch, dtype)
    f_tol, g_tol = TOL[dtype]
    np.testing.assert_allclose(as_np(got), np.asarray(want, np.float32),
                               rtol=f_tol, atol=f_tol)
    for a, b, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(as_np(a), np.asarray(b, np.float32),
                                   rtol=g_tol, atol=g_tol, err_msg=name)


def test_heads_of_128_match_pallas_interpret():
    """Two heads of 128 (dim 256), the width the card kernel zero-pads to
    its 128-wide tile: the plain version against the Pallas kernel in
    interpret mode at rate 0, f32 (the module's f32 tolerances above)."""
    r = np.random.default_rng(5)
    q, k, v, d_o = (r.standard_normal((2, 2, 32, 128)).astype(np.float32)
                    for _ in range(4))
    mask = r.random((2, 32)) > 0.25
    scale = 256 ** -0.5
    bias = j_mask_to_bias(jnp.asarray(mask))
    want, vjp = jax.vjp(
        lambda a, b, c: j_flash_mhsa(a, b, c, bias, scale=scale,
                                     interpret=True),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(d_o))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = at.flash_mhsa(tq, tk, tv, at.mask_to_bias(torch.from_numpy(mask)),
                        scale=scale)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(d_o))
    assert at.kernel_takes(torch.bfloat16, 32, 128)
    f_tol, g_tol = TOL["float32"]
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=f_tol,
                               atol=f_tol)
    for a, b, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(as_np(a), np.asarray(b), rtol=g_tol,
                                   atol=g_tol, err_msg=name)


def test_heads_of_320_match_pallas_interpret():
    """One head of 320 -- wider than the card kernel's 256-wide tile, so it
    runs there in 256-wide column chunks: the plain version against the
    Pallas kernel in interpret mode (which holds the whole head in one
    block) at rate 0, f32 (the module's f32 tolerances); the kernel takes
    any head width."""
    r = np.random.default_rng(6)
    q, k, v, d_o = (r.standard_normal((2, 1, 32, 320)).astype(np.float32)
                    for _ in range(4))
    mask = r.random((2, 32)) > 0.25
    mask[1] = False
    scale = 320 ** -0.5
    bias = j_mask_to_bias(jnp.asarray(mask))
    want, vjp = jax.vjp(
        lambda a, b, c: j_flash_mhsa(a, b, c, bias, scale=scale,
                                     interpret=True),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(d_o))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = at.flash_mhsa(tq, tk, tv, at.mask_to_bias(torch.from_numpy(mask)),
                        scale=scale)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(d_o))
    for dh in (320, 512, 1000):
        assert at.kernel_takes(torch.bfloat16, 32, dh)
        assert at.kernel_takes(torch.float32, 384, dh)
    assert not at.kernel_takes(torch.float32, 32, 0)
    f_tol, g_tol = TOL["float32"]
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=f_tol,
                               atol=f_tol)
    for a, b, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(as_np(a), np.asarray(b), rtol=g_tol,
                                   atol=g_tol, err_msg=name)


def test_mhsa_layer_with_a_head_of_320_takes_the_kernel(monkeypatch):
    """An MHSA layer of one head of 320 in training, with the kernel paths
    taken on the CPU: it goes through the attention wrapper (no raise for
    the wide head) and matches the JAX layer on bridged weights at f32
    (1e-4, the tolerance of the other MHSA paths)."""
    from ishara_tpu.models import layers as jlayers
    from ishara_tpu_torch.bridge import flax_to_state_dict
    from ishara_tpu_torch.models import layers as tlayers
    from torch_port_helpers import perturb

    T, dim = 40, 320
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, T, dim)).astype(np.float32)
    mask = rng.random((2, T)) > 0.2
    dy = rng.standard_normal((2, T, dim)).astype(np.float32)
    jm = jlayers.MultiHeadSelfAttention(dim, 1, dropout=0.0)
    variables = perturb(jm.init(jax.random.key(0), jnp.asarray(x),
                                jnp.asarray(mask)))
    want, vjp = jax.vjp(
        lambda a: jm.apply(variables, a, jnp.asarray(mask),
                           deterministic=False), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))

    calls = []
    wrapper = at.flash_mhsa

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return wrapper(*a, **kw)

    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers.attention, "flash_mhsa", spy)
    tm = tlayers.MultiHeadSelfAttention(dim, 1, dropout=0.0)
    tm.load_state_dict(flax_to_state_dict(variables))
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, torch.from_numpy(mask), training=True)
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(dy))
    assert calls == [(2, 1, T, dim)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-4)


def test_matches_reference_mhsa_of_both_packages():
    q, k, v, mask, _ = case(1)
    bias = j_mask_to_bias(jnp.asarray(mask))
    want = np.asarray(j_reference_mhsa(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), bias, SCALE))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tbias = at.mask_to_bias(torch.from_numpy(mask))
    np.testing.assert_array_equal(tbias.numpy(), np.asarray(bias))
    np.testing.assert_allclose(
        at.reference_mhsa(tq, tk, tv, tbias, SCALE).numpy(), want,
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        at.flash_mhsa(tq, tk, tv, tbias, scale=SCALE).numpy(), want,
        rtol=1e-5, atol=1e-5)


def test_backward_matches_autograd_of_the_reference():
    q, k, v, mask, _ = case(2)
    bias = at.mask_to_bias(torch.from_numpy(mask))
    grads = []
    for fn in (lambda a, b, c: at.flash_mhsa(a, b, c, bias, scale=SCALE),
               lambda a, b, c: at.reference_mhsa(a, b, c, bias, SCALE)):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        grads.append(torch.autograd.grad((fn(tq, tk, tv) ** 2).sum(),
                                         (tq, tk, tv)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_fully_masked_row_is_finite():
    """Every key masked: uniform weights, as the JAX kernel gives."""
    r = np.random.default_rng(1)
    x = r.standard_normal((1, 1, 8, 8)).astype(np.float32)
    want = j_flash_mhsa(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                        j_mask_to_bias(jnp.zeros((1, 8), bool)), scale=0.125,
                        interpret=True)
    t = torch.from_numpy(x).requires_grad_()
    out = at.flash_mhsa(t, t, t, at.mask_to_bias(torch.zeros((1, 8),
                                                             dtype=torch.bool)),
                        scale=0.125)
    (g,) = torch.autograd.grad(out.sum(), t)
    assert bool(out.isfinite().all()) and bool(g.isfinite().all())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def einsum_with_mask(q, k, v, mask, keep, rate):
    """The layer's einsum path with an explicit keep mask on the
    probabilities."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * SCALE
    s = s.masked_fill(~mask[:, None, None, :], torch.finfo(s.dtype).min)
    p = s.softmax(-1) * keep / (1.0 - rate)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def test_explicit_keep_mask_matches_einsum_composition():
    q, k, v, mask, d_o = case(3)
    rate = 0.3
    keep = torch.from_numpy(
        np.random.default_rng(4).random((B, H, T, T)) >= rate)
    tmask = torch.from_numpy(mask)
    bias = at.mask_to_bias(tmask)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = einsum_with_mask(tq, tk, tv, tmask, keep, rate)
    want_g = torch.autograd.grad(want, (tq, tk, tv), torch.from_numpy(d_o))
    with torch.no_grad():
        o, lse = at.mhsa_forward_plain(tq, tk, tv, bias, None, SCALE, rate,
                                       keep=keep)
        got_g = at.mhsa_backward_plain(tq, tk, tv, bias, None, o, lse,
                                       torch.from_numpy(d_o), SCALE, rate,
                                       keep=keep)
    np.testing.assert_allclose(o.numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_philox_dropout_is_regenerated_in_the_backward():
    """With dropout on, autograd of the wrapper equals the explicit-mask
    oracle fed the Philox mask of the same seed; the same seed gives the
    same output, another seed another."""
    from ishara_tpu_torch.ops.dropout import keep_mask

    q, k, v, mask, d_o = case(5)
    rate = 0.4
    seed = torch.tensor([77], dtype=torch.int32)
    tmask = torch.from_numpy(mask)
    bias = at.mask_to_bias(tmask)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = at.flash_mhsa(tq, tk, tv, bias, seed, SCALE, rate)
    got_g = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(d_o))
    keep = keep_mask(seed, (B, H, T, T), rate)
    want = einsum_with_mask(tq, tk, tv, tmask, keep, rate)
    want_g = torch.autograd.grad(want, (tq, tk, tv), torch.from_numpy(d_o))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        assert torch.equal(out, at.flash_mhsa(tq, tk, tv, bias, seed, SCALE,
                                              rate))
        assert not torch.equal(out, at.flash_mhsa(tq, tk, tv, bias, seed + 1,
                                                  SCALE, rate))
