"""The port's dropout (``ishara_tpu_torch/ops/dropout.py``): the Philox mask
function in plain PyTorch and the wrappers' plain version, which is what a
CPU tensor runs. The JAX package draws its CPU masks with ``jax.random``, so
parity with it is in law, not in bits: the keep rate, the scaling, the
backward's use of the forward's mask, determinism in (seed, index)."""

import numpy as np
import pytest
import torch

from ishara_tpu_torch.models.layers import RowDropout
from ishara_tpu_torch.ops import dropout as dr


def seed_of(v):
    return torch.tensor([v], dtype=torch.int32)


def philox4x32_10(counter, key):
    """Reference Philox4x32-10 on Python integers (Salmon et al., SC'11)."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
        k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
    return c


def test_philox_matches_the_integer_reference():
    """The int64 tensor arithmetic gives Philox4x32-10 exactly, including
    the generator's published test vector (counter and key all ones)."""
    assert philox4x32_10([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == \
        [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    for seed, group in ((0, 0), (123456789, 5), (0x7FFFFFFF, 2 ** 33 + 17)):
        got = dr.philox_block(seed_of(seed).reshape(()),
                              torch.tensor(group, dtype=torch.int64))
        want = philox4x32_10([group & 0xFFFFFFFF, group >> 32, 0, 0],
                             [seed, 0])
        assert got.tolist() == want
    # element i takes word i & 3 of block i >> 2
    bits = dr.philox_bits(seed_of(99), 11, start=6)
    want = [philox4x32_10([i >> 2, 0, 0, 0], [99, 0])[i & 3]
            for i in range(6, 17)]
    assert bits.tolist() == want


@pytest.mark.parametrize("rate", [0.1, 0.4])
def test_keep_rate_within_band(rate):
    """Over 2^20 elements the keep share is 1 - rate within 5 standard
    deviations of a fair draw (sqrt(r (1 - r) / n) each)."""
    n = 1 << 20
    keep = dr.keep_mask(seed_of(7), (n,), rate)
    band = 5 * np.sqrt(rate * (1 - rate) / n)
    assert abs(float(keep.float().mean()) - (1 - rate)) < band


def test_mask_is_a_function_of_seed_and_index():
    a = dr.keep_mask(seed_of(5), (64, 48), 0.4)
    assert torch.equal(a, dr.keep_mask(seed_of(5), (64, 48), 0.4))
    # the shape does not matter, only the flat index
    assert torch.equal(a.reshape(-1), dr.keep_mask(seed_of(5), (3072,), 0.4))
    assert torch.equal(a.reshape(-1)[:1000],
                       dr.keep_mask(seed_of(5), (1000,), 0.4))
    b = dr.keep_mask(seed_of(6), (64, 48), 0.4)
    assert 0.3 < float((a != b).float().mean()) < 0.7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_backward_share_the_mask(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 9, 32)).astype(np.float32)
                         ).to(dtype).requires_grad_()
    seed = seed_of(11)
    y = dr.fast_dropout(x, seed, 0.4)
    keep = dr.keep_mask(seed, x.shape, 0.4)
    want = (x.detach().float() * keep * (1 / 0.6)).to(dtype)
    assert y.dtype == dtype and torch.equal(y.detach(), want)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)
                          ).to(dtype)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(dx, (dy.float() * keep * (1 / 0.6)).to(dtype))


def test_dropout_add():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32)
                         ).requires_grad_()
    res = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32)
                           ).requires_grad_()
    seed = seed_of(3)
    out = dr.fast_dropout_add(res, x, seed, 0.25)
    torch.testing.assert_close(
        out, res + dr.fast_dropout(x, seed, 0.25), rtol=0, atol=1e-6)
    dy = torch.ones_like(out)
    dres, dx = torch.autograd.grad(out, (res, x), dy)
    assert torch.equal(dres, dy)
    assert torch.equal(dx, dr.keep_mask(seed, x.shape, 0.25) / 0.75)


def test_rate_zero_passes_through():
    x = torch.randn(3, 5)
    res = torch.randn(3, 5)
    assert dr.fast_dropout(x, seed_of(1), 0.0) is x
    assert torch.equal(dr.fast_dropout_add(res, x, seed_of(1), 0.0), res + x)
    with pytest.raises(ValueError, match="rate"):
        dr.threshold_of(1.0)


def test_site_and_step_seeds():
    step = dr.step_seeds(42, torch.tensor(3, dtype=torch.int32))
    assert step.shape == (2,) and step.dtype == torch.int32
    assert torch.equal(step, dr.step_seeds(42, torch.tensor(3)))
    assert not torch.equal(step, dr.step_seeds(42, torch.tensor(4)))
    assert not torch.equal(step, dr.step_seeds(43, torch.tensor(3)))
    table = dr.site_seed_table(step[0:1], 40)
    assert table.shape == (40, 4) and table.dtype == torch.int32
    assert bool((table >= 0).all())
    assert len({tuple(r) for r in table.tolist()}) == 40
    # a site's row does not depend on how many sites the table has
    assert torch.equal(table[:8], dr.site_seed_table(step[0:1], 8))
    for site in (0, 7, 39):
        s = dr.site_seeds(table, 2, site)
        assert s.shape == (2,) and torch.equal(s, table[site, :2])
    with pytest.raises(ValueError, match="seeds"):
        dr.site_seeds(table, 5)
    with pytest.raises(ValueError, match="table"):
        dr.site_seeds(step[0:1], 2)


def test_row_dropout_drops_whole_samples():
    drop = RowDropout(0.5)
    drop.site = 2
    x = torch.ones(64, 6, 4)
    seed = dr.site_seed_table(seed_of(9), 3)
    y = drop(x, training=True, seed=seed)
    per_row = y.reshape(64, -1)
    assert bool(((per_row == 0).all(1) | (per_row == 2.0).all(1)).all())
    assert 10 < int((per_row[:, 0] == 0).sum()) < 54
    assert torch.equal(y, drop(x, training=True, seed=seed))
    assert drop(x, training=False, seed=seed) is x
