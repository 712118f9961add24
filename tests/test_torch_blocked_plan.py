"""The tiled attention kernel K8's plan and exponent arithmetic
(``ishara_tpu_torch/ops/attention_blocked.py``): ``blocked_plan``, the rule
on (dtype, T, Dh, aligned) that sends each direction to the wgmma designs
(``csrc/attention_fwd_wg.cuh``'s forward, ``csrc/attention_bwd.cuh``'s one
pass without keep bits) or to the general core of ``csrc/attention_tc.cuh``
(its C rule is held to it on the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``, with each wgmma design's shared memory); the
wrapper's launch counts by design; and, in f32 torch code, the wgmma
forward's exponent arithmetic (a natural-units max, a base-2 argument made
by one FMA) on an all-masked row and against the plain forward. The plain
versions' parity with the JAX package's Pallas kernels is
``tests/test_torch_attention_blocked.py``'s."""

import math

import numpy as np
import pytest
import torch

from ishara_tpu_torch.ops import attention_blocked as ab
from ishara_tpu_torch.ops.attention import mask_to_bias, tma_aligned

BF16, F32 = torch.bfloat16, torch.float32
WG, GEN = "wgmma", "general"


def _layer_views(B, T, H, Dh, dtype=BF16):
    """q, k, v as the MHSA layer makes them: views of one ``[B, T, H, 3 Dh]``
    projection."""
    qkv = torch.zeros((B, T, H, 3 * Dh), dtype=dtype)
    return qkv.transpose(1, 2).split(Dh, dim=-1)


@pytest.mark.parametrize("dtype,T,Dh,aligned,forward,backward", [
    # the long step (baseline_config(4) at frame_len 512: 8 heads of 32)
    (BF16, 512, 32, True, WG, WG),
    # heads of 64: the backward's layout fits a block up to T 384
    (BF16, 384, 64, True, WG, WG),
    (BF16, 385, 64, True, WG, GEN),
    (BF16, 512, 64, True, WG, GEN),
    # heads of 32 up to T 640
    (BF16, 640, 32, True, WG, WG),
    (BF16, 641, 32, True, WG, GEN),
    (BF16, 1, 32, True, WG, WG), (BF16, 65, 32, True, WG, WG),
    (BF16, 200, 64, True, WG, WG),
    # the general core: f32, other widths, strides TMA cannot read
    (F32, 512, 32, True, GEN, GEN),
    (F32, 200, 64, True, GEN, GEN),
    (BF16, 512, 12, True, GEN, GEN),
    (BF16, 512, 128, True, GEN, GEN),
    (BF16, 512, 48, True, GEN, GEN),
    (BF16, 512, 32, False, GEN, GEN),
    (torch.float16, 512, 32, True, GEN, GEN),
])
def test_blocked_plan_takes_each_shape_by_the_rule(dtype, T, Dh, aligned,
                                                   forward, backward):
    assert ab.blocked_plan(dtype, T, Dh, aligned) == (forward, backward)
    assert {forward, backward} <= set(ab.DESIGNS)


@pytest.mark.parametrize("Dh,plan", [(32, (WG, WG)), (64, (WG, GEN)),
                                     (12, (GEN, GEN)), (128, (GEN, GEN))])
def test_the_long_steps_views_take_the_plan(Dh, plan):
    """The long step's q, k, v at T 512 (8 heads; one batch row, whose
    strides over h and t are the step's) as the launches see them: TMA can
    read the views of heads of 32, 64 and 128 (16-byte strides), not of 12
    (24-byte ones)."""
    q, k, v = _layer_views(1, 512, 8, Dh)
    assert tma_aligned(q, k, v) == (Dh != 12)
    assert ab.plan_of(q, k, v) == plan
    # a copy whose rows start off 16 bytes takes the general core
    flat = torch.zeros(512 * Dh + 4, dtype=BF16)[4:].reshape(1, 1, 512, Dh)
    assert ab.plan_of(flat, flat, flat) == (GEN, GEN)


def test_wgmma_designs_fit_shared_memory_wherever_the_plan_takes_them():
    """The rule over every T from 1 to 4096, every head width, aligned or
    not and both dtypes: the forward takes ``"wgmma"`` on bf16 heads of 32
    and 64 that TMA can read, at any T; the backward on those up to its
    width's longest T; the general core everywhere else. The C plan's
    shared memory for each of these is held to a block's 232448 bytes on
    the card (``test_blocked_plan_matches_the_c_plan``)."""
    t_max = {32: 640, 64: 384}
    for dtype in (BF16, F32):
        for Dh in (8, 12, 16, 32, 48, 64, 96, 128, 256):
            for aligned in (False, True):
                shape = dtype == BF16 and Dh in t_max and aligned
                for T in range(1, 4097):
                    plan = ab.blocked_plan(dtype, T, Dh, aligned)
                    assert plan.forward == (WG if shape else GEN)
                    assert plan.backward == (
                        WG if shape and T <= t_max[Dh] else GEN), (dtype, T,
                                                                  Dh)


@pytest.mark.parametrize("Dh,t_max", [(32, 640), (64, 384)])
def test_the_wgmma_backward_stops_at_its_widths_longest_T(Dh, t_max):
    """The long step's T 512 is inside the bound of heads of 32 and past
    that of heads of 64; one key tile past the bound, the backward leaves
    for the general core while the forward stays on wgmma."""
    assert ab.blocked_plan(BF16, t_max, Dh, True) == (WG, WG)
    assert ab.blocked_plan(BF16, t_max + 1, Dh, True) == (WG, GEN)
    assert ab.blocked_plan(BF16, 512, Dh, True).backward == \
        (WG if Dh == 32 else GEN)


def _fake_launches(monkeypatch):
    """Sends the wrapper's kernel branch through the plain versions, so
    that its counters run on CPU tensors."""
    monkeypatch.setattr(ab, "_runs_plain", lambda q: False)
    monkeypatch.setattr(ab, "_launch_fwd",
                        lambda q, k, v, bias, scale, Tp:
                        ab.blocked_attention_forward_plain(q, k, v, bias,
                                                           scale, Tp, Tp))
    monkeypatch.setattr(ab, "_launch_bwd",
                        lambda q, k, v, bias, o, lse, d_o, scale:
                        ab.blocked_attention_backward_plain(
                            q, k, v, bias, o, lse, d_o, scale))


@pytest.mark.parametrize("dtype,T,Dh,plan", [(BF16, 40, 32, (WG, WG)),
                                             (BF16, 512, 64, (WG, GEN)),
                                             (F32, 40, 32, (GEN, GEN)),
                                             (BF16, 40, 12, (GEN, GEN))])
def test_wrapper_counts_launches_by_design(monkeypatch, dtype, T, Dh, plan):
    """With the launchers replaced by the plain versions, one forward and
    one backward add one launch each, counted under the plan's designs; a
    CPU call as it is launches nothing."""
    assert set(ab.flash_mhsa_blocked.launches_by_design) == set(ab.DESIGNS)
    assert set(ab.flash_mhsa_blocked.launches_bwd_by_design) \
        == set(ab.DESIGNS)
    g = torch.Generator().manual_seed(T + Dh)
    qkv = torch.randn((1, T, 2, 3 * Dh), generator=g).to(dtype) \
        .requires_grad_()
    bias = torch.zeros((1, T))
    before = (dict(ab.flash_mhsa_blocked.launches_by_design),
              dict(ab.flash_mhsa_blocked.launches_bwd_by_design))
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    ab.flash_mhsa_blocked(q, k, v, bias, 0.1).float().sum().backward()
    assert (ab.flash_mhsa_blocked.launches_by_design,
            ab.flash_mhsa_blocked.launches_bwd_by_design) == before
    _fake_launches(monkeypatch)
    n = (ab.flash_mhsa_blocked.launches, ab.flash_mhsa_blocked.launches_bwd)
    ab.flash_mhsa_blocked(q, k, v, bias, 0.1).float().sum().backward()
    assert (ab.flash_mhsa_blocked.launches,
            ab.flash_mhsa_blocked.launches_bwd) == (n[0] + 1, n[1] + 1)
    want_f, want_b = dict(before[0]), dict(before[1])
    want_f[plan[0]] += 1
    want_b[plan[1]] += 1
    assert ab.flash_mhsa_blocked.launches_by_design == want_f
    assert ab.flash_mhsa_blocked.launches_bwd_by_design == want_b


def _fma(a, b, c):
    """f32 fused multiply-add: the product and sum exact in f64, rounded
    once to f32 (f32 products are exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def wgmma_forward_arithmetic(q, k, v, bias, scale, Tc):
    """The wgmma forward's arithmetic in f32 torch: 64-key tiles up to Tc
    (keys in [T, Tc) zero with the bias -1e30, keys past Tc at -inf), s =
    fma(q.k, scale, bias), the row max m in natural units, the correction
    c = 2^((m_old - m_new) log2 e), the weights 2^fma(s, L, -fl(m L)) with
    L = log2 e, or 2^-100 for a row whose max is below -1e20; o = (sum p
    v) / l, lse = m + log l. Returns (o, lse, the last tile's weights)."""
    B, H, T, Dh = q.shape
    nt = -(-Tc // 64)
    keys = nt * 64
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, keys - T))
                  for t in (q, k, v))
    idx = torch.arange(keys)
    bp = torch.where(idx < T, torch.nn.functional.pad(bias.float(),
                                                      (0, keys - T)),
                     torch.where(idx < Tc, -1e30, -math.inf)).float()
    log2e = torch.tensor(1.4426950408889634, dtype=F32)
    m = torch.full((B, H, keys, 1), -math.inf)[:, :, :T]
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, Dh))
    for j in range(nt):
        sl = slice(64 * j, 64 * j + 64)
        raw = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, :T], kf[:, :, sl])
        s = _fma(raw, torch.tensor(scale, dtype=F32),
                 bp[:, None, None, sl].expand_as(raw))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp2((m - m_new) * log2e)
        L = torch.where(m_new < -1e20, torch.tensor(2.0 ** -100), log2e)
        p = torch.exp2(_fma(s, L.expand_as(s), (-(m_new * L)).expand_as(s)))
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, sl])
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0], p


@pytest.mark.parametrize("T,blocks", [(200, (128, 128)), (200, (16, 16)),
                                      (23, (64, 64)), (1, (16, 16))])
def test_exponent_arithmetic_on_an_all_masked_row(T, blocks):
    """A sequence whose keys are all masked: with the max in natural units
    the kernel's arithmetic gives every one of the Tp keys the weight 1 (so
    1 / Tp after the division, padded zeros included), 0 past Tp, and an lse
    of exactly -1e30, the plain version's bits; a max kept in base 2 and
    converted back does not give -1e30."""
    g = torch.Generator().manual_seed(T)
    B, H, Dh = 2, 2, 32
    q, k, v = (torch.randn((B, H, T, Dh), generator=g) for _ in range(3))
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[0] = False
    bias = mask_to_bias(mask)
    Tp = ab.padded_length(T, *blocks)
    o, lse, p_last = wgmma_forward_arithmetic(q, k, v, bias, 0.125, Tp)
    ro, rlse = ab.blocked_attention_forward_plain(q, k, v, bias, 0.125,
                                                  *blocks)
    assert torch.equal(lse[0], torch.full((H, T), -1e30))
    assert torch.equal(lse[0], rlse[0])
    # the last tile: weight 1 below Tp, 0 past it
    first = 64 * (-(-Tp // 64) - 1)
    want = (torch.arange(first, first + 64) < Tp).float()
    assert torch.equal(p_last[0], want.expand_as(p_last[0]))
    # o: V averaged over the Tp keys, the padded (zero) ones included
    avg = v[0].float().sum(-2, keepdim=True) / Tp
    torch.testing.assert_close(o[0], avg.expand_as(o[0]), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse[1], rlse[1], rtol=1e-6, atol=1e-5)
    # the base-2 max: m2 = max(s log2 e), lse = m2 ln 2 + log l
    m2 = torch.tensor(-1e30, dtype=F32) * torch.tensor(1.4426950408889634,
                                                       dtype=F32)
    back = m2 * torch.tensor(math.log(2.0), dtype=F32) \
        + torch.log(torch.tensor(float(Tp)))
    assert float(back) != -1e30


@pytest.mark.parametrize("T,Dh,blocks", [(130, 32, (128, 128)),
                                         (77, 64, (16, 16))])
def test_exponent_arithmetic_matches_the_plain_forward(T, Dh, blocks):
    """On random scores with a random key mask (some rows' first tiles all
    masked), the kernel's arithmetic agrees with the plain recurrence to f32
    rounding: o and lse."""
    rng = np.random.default_rng(T)
    B, H = 3, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, Dh))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(rng.random((B, T)) > 0.3)
    mask[1, :70] = False
    mask[2] = False
    bias = mask_to_bias(mask)
    Tp = ab.padded_length(T, *blocks)
    o, lse, _ = wgmma_forward_arithmetic(q, k, v, bias, Dh ** -0.5, Tp)
    ro, rlse = ab.blocked_attention_forward_plain(q, k, v, bias, Dh ** -0.5,
                                                  *blocks)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=2e-6, atol=2e-5)
    assert torch.equal(lse[2], rlse[2])
