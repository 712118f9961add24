"""The port's preprocess (PyTorch, CPU) against the JAX package's, on the
same raw sequences made with numpy from a seed. Tolerance: atol 1e-6 (both
compute in f32; the bilinear lerp may fuse into an FMA on one side only).

The JAX side runs op by op, not under ``jit``: XLA's CPU compiler rewrites
the resample's ``length / frame_len`` and moves source positions by an ulp
(about 4e-6 at 40 frames), which is XLA's rounding, not the contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.data import landmarks as lm
from ishara_tpu.preprocess import pipeline as jp

from ishara_tpu_torch.preprocess import pipeline as tp

from torch_port_helpers import raw_sequence

FRAME_LEN = 24
TMAX = 64


def _stats(seed):
    rng = np.random.default_rng(seed)
    mean = {g: (0.1 * rng.standard_normal((1, 1, 3))).astype(np.float32)
            for g in lm.GROUPS}
    std = {g: (0.5 + rng.random((1, 1, 3))).astype(np.float32)
           for g in lm.GROUPS}
    return (jp.GroupStats({g: jnp.asarray(v) for g, v in mean.items()},
                          {g: jnp.asarray(v) for g, v in std.items()}),
            tp.GroupStats({g: torch.from_numpy(v) for g, v in mean.items()},
                          {g: torch.from_numpy(v) for g, v in std.items()}))


@pytest.mark.parametrize("dominant_hand", [False, True])
@pytest.mark.parametrize("T,kind", [
    (10, "plain"), (FRAME_LEN, "plain"), (40, "plain"), (TMAX, "plain"),
    (30, "left_dominant"), (17, "nan_hands"), (50, "nan_hands"),
    (20, "all_nan")])
def test_preprocess_matches_jax(T, kind, dominant_hand):
    rng = np.random.default_rng(T)
    if kind == "all_nan":
        seq = np.full((T, lm.N_COLS), np.nan, np.float32)
    else:
        seq = raw_sequence(rng, T, nan_hands=kind == "nan_hands",
                           left_dominant=kind == "left_dominant")
    buf = np.zeros((TMAX, lm.N_COLS), np.float32)
    buf[:T] = seq
    jstats, tstats = _stats(0)

    want = jp.preprocess(jnp.asarray(buf), jnp.int32(T), jstats, FRAME_LEN,
                         thin=True, dominant_hand=dominant_hand)
    got = tp.preprocess(torch.from_numpy(buf),
                        torch.tensor(T, dtype=torch.int32), tstats,
                        FRAME_LEN, thin=True, dominant_hand=dominant_hand)
    assert got.shape == (FRAME_LEN, lm.N_COLS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("T", [5, FRAME_LEN, 41])
def test_thin_resample_and_mask_match_jax(T):
    """The stages one by one: thinning (compacted rows and new length),
    resample/pad and the Masking(0.0) frame mask."""
    rng = np.random.default_rng(100 + T)
    buf = np.zeros((TMAX, lm.N_COLS), np.float32)
    buf[:T] = raw_sequence(rng, T)
    jx, jlen = jp.thin_frames(jnp.asarray(buf), jnp.int32(T))
    tx, tlen = tp.thin_frames(torch.from_numpy(buf), torch.tensor(T))
    n = int(jlen)
    assert int(tlen) == n
    np.testing.assert_array_equal(tx.numpy()[:n], np.asarray(jx)[:n])

    want = jp.resample_or_pad(jnp.asarray(buf), jnp.int32(T), FRAME_LEN)
    got = tp.resample_or_pad(torch.from_numpy(buf), torch.tensor(T),
                             FRAME_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6, equal_nan=True)

    frames = np.nan_to_num(buf[:FRAME_LEN])
    frames[3] = 0.0
    np.testing.assert_array_equal(
        tp.frame_mask(torch.from_numpy(frames)).numpy(),
        np.asarray(jp.frame_mask(jnp.asarray(frames))))


def test_mirror_is_an_involution_and_matches_jax():
    rng = np.random.default_rng(7)
    x = raw_sequence(rng, 12)
    got = tp.mirror_lr(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.mirror_lr(jnp.asarray(x))))
    # 1 - (1 - x) rounds back to x within an ulp of 1
    np.testing.assert_allclose(tp.mirror_lr(got).numpy(), x, rtol=0,
                               atol=6e-8)
