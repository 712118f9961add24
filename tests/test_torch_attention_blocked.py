"""The port's tiled attention (``ishara_tpu_torch/ops/attention_blocked.py``,
whose plain versions run here on the CPU) against the JAX package's
``flash_mhsa_blocked(interpret=True)`` on the same numpy inputs: the
forward's output and row logsumexp, and dq, dk, dv. T divisible by the
blocks and not (padding), blocks of 16, 64 and 128, heads of 12, 32, 64,
128, 256 and 320 (two column chunks on the card),
partly masked keys and one sequence with every key masked (whose output is
V averaged over all Tp keys, padded zeros included, as in the reference).
f32: rtol = atol = 1e-5 on the output, 1e-5 of the largest entry on the
gradients (sums over up to 256 keys in another order); bf16 inputs: the
output is rounded to bf16 on both sides, one ulp (2^-8) apart at most where
a last bit differs before the rounding: 2e-2.

Then the MHSA layer's tiled branch, taken on the CPU through the wrapper,
against the JAX layer's composition at rate 0 on bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.models import layers as jlayers
from ishara_tpu.ops.attention import mask_to_bias as j_mask_to_bias
from ishara_tpu.ops.attention_blocked import _padded_fwd
from ishara_tpu.ops.attention_blocked import flash_mhsa_blocked as j_blocked

from ishara_tpu_torch.bridge import flax_to_state_dict
from ishara_tpu_torch.models import layers as tlayers
from ishara_tpu_torch.ops import attention as at
from ishara_tpu_torch.ops import attention_blocked as ab

from torch_port_helpers import perturb

B, H = 2, 2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def case(T, Dh, seed=0):
    r = np.random.default_rng(seed)
    q, k, v, d_o = (r.standard_normal((B, H, T, Dh)).astype(np.float32)
                    for _ in range(4))
    mask = r.random((B, T)) > 0.25
    mask[1] = False                                  # every key masked
    return q, k, v, mask, d_o


def as_np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("T,bq,bk,Dh,dtype", [
    (256, 64, 64, 32, "float32"),
    (200, 128, 128, 32, "float32"),
    (200, 64, 128, 64, "float32"),
    (256, 128, 64, 128, "float32"),
    (200, 128, 128, 32, "bfloat16"),
    (200, 64, 64, 128, "bfloat16"),
    (64, 64, 64, 256, "float32"),      # the widest head of one chunk
    (100, 64, 64, 12, "float32"),      # not a multiple of 8
    (48, 16, 16, 320, "float32"),      # two 256-wide chunks on the card
])
def test_forward_and_grads_match_pallas_interpret(T, bq, bk, Dh, dtype):
    q, k, v, mask, d_o = case(T, Dh)
    scale = (H * Dh) ** -0.5
    jd = jnp.dtype(dtype)
    bias = j_mask_to_bias(jnp.asarray(mask))
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    want_o, want_lse = _padded_fwd(jq, jk, jv, bias, scale, bq, bk, True)
    _, vjp = jax.vjp(lambda a, b, c: j_blocked(a, b, c, bias, scale, bq, bk,
                                               True), jq, jk, jv)
    want_g = vjp(jnp.asarray(d_o, jd))

    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    tbias = at.mask_to_bias(torch.from_numpy(mask))
    o, lse = ab.blocked_attention_forward_plain(tq.detach(), tk.detach(),
                                                tv.detach(), tbias, scale,
                                                bq, bk)
    got = ab.flash_mhsa_blocked(tq, tk, tv, tbias, scale, bq, bk)
    got_g = torch.autograd.grad(got, (tq, tk, tv),
                                torch.from_numpy(d_o).to(td))
    tol = TOL[dtype]
    assert got.dtype == td and torch.equal(got, o)
    np.testing.assert_allclose(as_np(got), np.asarray(want_o, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse, np.float32)[..., 0],
                               rtol=tol, atol=tol)
    for a, b in zip(got_g, want_g):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(as_np(a), b, rtol=tol,
                                   atol=tol * np.abs(b).max())


def test_all_masked_sequence_averages_over_the_padded_length():
    """T 200 padded to 256: a sequence with every key masked gets
    sum(v) / 256, not the einsum composition's sum(v) / 200."""
    q, k, v, mask, _ = case(200, 32, seed=1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    bias = at.mask_to_bias(torch.from_numpy(mask))
    o, lse = ab.blocked_attention_forward_plain(tq, tk, tv, bias, 0.1)
    want = tv[1].sum(dim=1, keepdim=True) / 256
    np.testing.assert_allclose(o[1].numpy(), want.expand_as(o[1]).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert bool((lse[1] == -1e30).all())
    comp = at.reference_mhsa(tq, tk, tv, bias, 0.1)
    assert not torch.allclose(comp[1], o[1])
    assert ab.padded_length(200) == 256 and ab.padded_length(256) == 256
    assert ab.padded_length(200, 64, 96) == 384


def test_mhsa_layer_takes_the_tiled_branch_and_matches_flax(monkeypatch):
    """At (dim 64, T 400, batch 2) the table's long row says
    "flash_blocked" with the dropout off; with the kernel paths taken on
    the CPU the layer goes through the wrapper (and nothing else), and its
    output and input gradient match flax's einsum path at f32 (1e-4, the
    tolerance of the other MHSA paths)."""
    from ishara_tpu_torch.ops import selection

    T = 400
    assert selection.train_attention(64, T, False, 2) == "flash_blocked"
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, T, 64)).astype(np.float32)
    mask = rng.random((2, T)) > 0.2
    dy = rng.standard_normal((2, T, 64)).astype(np.float32)
    jm = jlayers.MultiHeadSelfAttention(64, 4, dropout=0.0)
    variables = perturb(jm.init(jax.random.key(0), jnp.asarray(x),
                                jnp.asarray(mask)))
    want, vjp = jax.vjp(
        lambda a: jm.apply(variables, a, jnp.asarray(mask),
                           deterministic=False), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))

    calls = []
    wrapper = ab.flash_mhsa_blocked

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return wrapper(*a, **kw)

    def no_flash(*a, **kw):
        raise AssertionError("the single-block kernel was taken")

    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers.attention_blocked, "flash_mhsa_blocked", spy)
    monkeypatch.setattr(tlayers.attention, "flash_mhsa", no_flash)
    tm = tlayers.MultiHeadSelfAttention(64, 4, dropout=0.0)
    tm.load_state_dict(flax_to_state_dict(variables))
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, torch.from_numpy(mask), training=True)
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(dy))
    assert calls == [(2, 4, T, 16)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-4)
    # eval keeps the composition
    calls.clear()
    tm(tx, torch.from_numpy(mask), training=False)
    assert calls == []
