"""The attention kernel K3's plan and keep bits
(``ishara_tpu_torch/ops/attention.py``): ``attention_plan``, the rule on
(dtype, T, Dh, aligned) that sends both directions to the wgmma design
(the forward of ``csrc/attention_fwd_wg.cuh``, the backward of
``csrc/attention_bwd.cuh``) or to the general kernels of
``csrc/attention_tc.cuh`` (its C rule is held to it on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``); ``pack_keep_bits`` /
``unpack_keep_bits``, the layout of the bits that the forward writes for the
wgmma backward; and the plain backward on those bits against the JAX
package's ``_bwd_kernel`` in interpret mode, fed the same mask. Tolerances
as ``tests/test_torch_attention.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.ops import attention as jat
from test_torch_attention import SCALE, TOL, as_np, as_torch, case

from ishara_tpu_torch.ops import attention as at
from ishara_tpu_torch.ops.dropout import keep_mask

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,T,Dh,aligned,design", [
    # the flagship (baseline_config(4): 8 heads of 32 at T 176)
    (BF16, 176, 32, True, "wgmma"),
    # presets 1 and 2 (4 heads of 64)
    (BF16, 176, 64, True, "wgmma"),
    # the card tests' lengths
    (BF16, 1, 32, True, "wgmma"), (BF16, 23, 64, True, "wgmma"),
    (BF16, 64, 32, True, "wgmma"),
    (BF16, 193, 32, True, "wgmma"),
    (BF16, 384, 32, True, "wgmma"),
    (BF16, 384, 64, True, "wgmma"),
    (BF16, 128, 64, True, "wgmma"),
    (BF16, 129, 64, True, "wgmma"),
    # the general passes: f32 (the tensor-parallel step), other widths,
    # strides TMA cannot read, T past K3's range
    (F32, 176, 32, True, "general"),
    (F32, 384, 64, True, "general"),
    (BF16, 176, 16, True, "general"),
    (BF16, 176, 36, True, "general"),
    (BF16, 176, 48, True, "general"),
    (BF16, 176, 128, True, "general"),
    (BF16, 45, 320, True, "general"),
    (BF16, 176, 32, False, "general"),
    (BF16, 385, 32, True, "general"),
    (torch.float16, 176, 32, True, "general"),
])
def test_attention_plan_takes_each_shape_by_the_rule(dtype, T, Dh, aligned,
                                                     design):
    assert at.attention_plan(dtype, T, Dh, aligned) == design
    assert design in at.DESIGNS


def test_attention_plan_is_a_rule_on_the_shape_alone():
    """The same plan for every call, and the wgmma design exactly at bf16,
    heads of 32 or 64, 1 <= T <= 384 and rows TMA can read (the C plan
    alone sizes that design's blocks; the card test holds it to the
    limits)."""
    for dh in (8, 16, 32, 36, 48, 64, 96, 128, 256):
        for T in range(1, 400):
            plan = at.attention_plan(BF16, T, dh, True)
            assert plan == at.attention_plan(BF16, T, dh, True)
            fits = dh in (32, 64) and T <= 384
            assert (plan == "wgmma") == fits, (T, dh)
            assert at.attention_plan(BF16, T, dh, False) == "general"
            assert at.attention_plan(F32, T, dh, True) == "general"


@pytest.mark.parametrize("Dh,rows_ok", [(32, True), (64, True), (36, False),
                                        (48, True), (12, False)])
def test_tma_aligned_takes_the_layers_views(Dh, rows_ok):
    """q, k, v as the layer makes them -- views of one ``[B, T, H, 3 Dh]``
    projection -- are TMA-able exactly when their strides and offsets are
    16-byte multiples; a copy with a unit stride elsewhere is not."""
    qkv = torch.zeros((2, 23, 4, 3 * Dh), dtype=BF16)
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    assert at.tma_aligned(q, k, v) == rows_ok
    assert at.plan_of(q, k, v) == (
        "wgmma" if rows_ok and Dh in (32, 64) else "general")
    assert not at.tma_aligned(qkv.reshape(-1)[1:1 + 2 * 4 * 23 * 8].reshape(
        2, 4, 23, 8))


@pytest.mark.parametrize("T", [1, 23, 32, 33, 64, 70, 174, 177])
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_keep_bits_round_trip_the_philox_mask(T, rate):
    """``unpack_keep_bits(pack_keep_bits(keep))`` is ``keep_mask``'s mask, at
    T not a multiple of 32, from an element offset, and on a
    tensor-parallel rank's heads (``runs``); the words hold ``ceil(T /
    32)`` a row, key k at bit k % 32 of word k // 32, zero past T."""
    seed = torch.tensor([19], dtype=torch.int32)
    B, H = 2, 3
    shape = (B, H, T, T)
    cases = [keep_mask(seed, shape, rate),
             keep_mask(seed, shape, rate, start=5 * H * T * T),
             keep_mask(seed, shape, rate, start=H * T * T,
                       runs=(H * T * T, 2 * H * T * T))]
    for keep in cases:
        bits = at.pack_keep_bits(keep)
        assert bits.dtype == torch.int32
        assert bits.shape == (B, H, T, at.keep_words(T))
        assert torch.equal(at.unpack_keep_bits(bits, T), keep)
        words = bits.to(torch.int64) & 0xFFFFFFFF
        for key in sorted({0, min(5, T - 1), T // 2, T - 1}):
            assert torch.equal((words[..., key // 32] >> (key % 32)) & 1,
                               keep[..., key].to(torch.int64))
        if T % 32:  # the bits of keys past T
            assert not bool((words[..., -1] >> (T % 32)).any())
    assert at.keep_words(176) == 6 and at.keep_words(384) == 12


def _mulhi(m, c):
    """The high 32 bits of ``m * c`` for uint32 ``c``, in uint32 halves."""
    m_hi, m_lo = jnp.uint32(m >> 16), jnp.uint32(m & 0xFFFF)
    c_hi, c_lo = c >> 16, c & 0xFFFF
    mid1, mid2 = m_hi * c_lo, m_lo * c_hi
    carry = ((mid1 & 0xFFFF) + (mid2 & 0xFFFF) + ((m_lo * c_lo) >> 16)) >> 16
    return m_hi * c_hi + (mid1 >> 16) + (mid2 >> 16) + carry


def _philox_keep(seed, flat, rate):
    """The port's keep decision of flat index ``flat`` (int32 < 2**31) under
    ``seed``, in jnp: word ``flat % 4`` of Philox4x32-10 block ``flat // 4``
    (``ops/dropout.py``), computed where it is needed so that a Pallas kernel
    in interpret mode can draw it."""
    M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c0 = (flat >> 2).astype(jnp.uint32)
    c1 = c2 = c3 = jnp.zeros_like(c0)
    k0, k1 = seed, 0
    for _ in range(10):
        hi0, lo0 = _mulhi(M0, c0), jnp.uint32(M0) * c0
        hi1, lo1 = _mulhi(M1, c2), jnp.uint32(M1) * c2
        c0, c1, c2, c3 = hi1 ^ c1 ^ jnp.uint32(k0), lo1, \
            hi0 ^ c3 ^ jnp.uint32(k1), lo0
        k0, k1 = (k0 + W0) & 0xFFFFFFFF, (k1 + W1) & 0xFFFFFFFF
    word = flat & 3
    bits = jnp.where(word == 0, c0, jnp.where(word == 1, c1,
                                              jnp.where(word == 2, c2, c3)))
    return bits >= jnp.uint32(int(rate * 2 ** 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_on_the_bits_matches_pallas_interpret(dtype,
                                                             monkeypatch):
    """The plain backward given the forward's bits (unpacked) as ``keep``
    equals it given the seed, bit for bit, and both match the JAX package's
    ``_bwd_kernel`` (and ``_fwd_kernel``) in interpret mode on the same mask:
    the kernels' TPU PRNG draw is replaced, for the test, by the port's
    Philox function of (seed, flat index), rate 0.4."""
    q, k, v, mask, d_o = case(7)
    B, H, T, _ = q.shape
    rate, seed_v = 0.4, 23
    seed = torch.tensor([seed_v], dtype=torch.int32)
    keep = keep_mask(seed, (B, H, T, T), rate)
    bits = at.pack_keep_bits(keep)

    def flat(b, h):
        r = jnp.arange(T, dtype=jnp.int32)
        return ((b * H + h) * T + r[:, None]) * T + r[None, :]

    # the jnp draw is the port's mask
    drawn = np.stack([np.stack([np.asarray(_philox_keep(seed_v, flat(b, h),
                                                        rate))
                                for h in range(H)]) for b in range(B)])
    assert np.array_equal(drawn, keep.numpy())
    monkeypatch.setattr(jat, "_keep_mask", lambda seed_ref, b, h, shape, r:
                        _philox_keep(seed_v, flat(b, h), r).astype(
                            jnp.float32))
    jd = jnp.dtype(dtype)
    jbias = jat.mask_to_bias(jnp.asarray(mask))
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    want_o, vjp = jax.vjp(
        lambda a, b_, c: jat.flash_mhsa(a, b_, c, jbias, scale=SCALE,
                                        interpret=True, dropout_rate=rate),
        jq, jk, jv)
    want_g = vjp(jnp.asarray(d_o, jd))

    tq, tk, tv = (as_torch(a, dtype) for a in (q, k, v))
    tbias = at.mask_to_bias(torch.from_numpy(mask))
    tdo = as_torch(d_o, dtype)
    o, lse = at.mhsa_forward_plain(tq, tk, tv, tbias, seed, SCALE, rate)
    by_seed = at.mhsa_backward_plain(tq, tk, tv, tbias, seed, o, lse, tdo,
                                     SCALE, rate)
    by_bits = at.mhsa_backward_plain(tq, tk, tv, tbias, None, o, lse, tdo,
                                     SCALE, rate,
                                     keep=at.unpack_keep_bits(bits, T))
    for a, b in zip(by_seed, by_bits):
        assert torch.equal(a, b)
    f_tol, g_tol = TOL[dtype]
    np.testing.assert_allclose(as_np(o), np.asarray(want_o, np.float32),
                               rtol=f_tol, atol=f_tol)
    for a, b, name in zip(by_bits, want_g, "qkv"):
        np.testing.assert_allclose(as_np(a), np.asarray(b, np.float32),
                                   rtol=g_tol, atol=g_tol, err_msg=name)


@pytest.mark.parametrize("dtype,T,Dh,view,design", [
    (BF16, 176, 32, "layer", "wgmma"), (BF16, 176, 64, "layer", "wgmma"),
    (BF16, 1, 32, "layer", "wgmma"), (BF16, 384, 32, "layer", "wgmma"),
    (BF16, 385, 32, "layer", "general"), (BF16, 176, 48, "layer", "general"),
    (BF16, 176, 128, "layer", "general"), (F32, 176, 32, "layer", "general"),
    (F32, 384, 64, "layer", "general"), (BF16, 176, 32, "unaligned",
                                         "general"),
    (BF16, 177, 32, "contiguous", "wgmma")])
def test_forward_takes_the_plan_s_design(dtype, T, Dh, view, design):
    """The forward takes the design ``attention_plan`` names for its q, k,
    v (``plan_of``), the backward's: the wgmma forward exactly where the
    wgmma backward runs, so that the keep bits it writes are there for it;
    q, k, v as the layer makes them (views of one ``[B, T, H, 3 Dh]``
    projection), contiguous, or at an offset TMA cannot read."""
    B, H = 2, 3
    if view == "unaligned":
        flat = torch.zeros(1 + 3 * B * H * T * Dh, dtype=dtype)[1:]
        q, k, v = flat.reshape(3, B, H, T, Dh)
    elif view == "layer":
        qkv = torch.zeros((B, T, H, 3 * Dh), dtype=dtype)
        q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    else:
        q = k = v = torch.zeros((B, H, T, Dh), dtype=dtype)
    assert at.plan_of(q, k, v) == design
    assert at.attention_plan(dtype, T, Dh, at.tma_aligned(q, k, v)) \
        == design


def test_wrapper_counts_forward_launches_by_design():
    """``flash_mhsa.launches_by_design`` has a count for each design, as
    ``launches_bwd_by_design``; a CPU tensor runs the plain versions and
    launches nothing."""
    assert set(at.flash_mhsa.launches_by_design) == set(at.DESIGNS)
    before = dict(at.flash_mhsa.launches_by_design)
    launches = at.flash_mhsa.launches
    q = torch.randn((1, 2, 8, 32))
    at.flash_mhsa(q, q, q, torch.zeros((1, 8)), None, 0.1, 0.3)
    assert at.flash_mhsa.launches_by_design == before
    assert at.flash_mhsa.launches == launches


def test_wrapper_counts_backward_launches_by_design():
    """``flash_mhsa.launches_bwd_by_design`` has a count for each design; a
    CPU tensor runs the plain versions and launches nothing."""
    assert set(at.flash_mhsa.launches_bwd_by_design) == set(at.DESIGNS)
    before = dict(at.flash_mhsa.launches_bwd_by_design)
    q = torch.randn((1, 2, 8, 32), requires_grad=True)
    at.flash_mhsa(q, q, q, torch.zeros((1, 8)), None, 0.1, 0.3).sum() \
        .backward()
    assert at.flash_mhsa.launches_bwd_by_design == before
