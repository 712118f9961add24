"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``):
build a JAX model at a small size, give it non-trivial weights and BN
statistics from a numpy seed, and bridge them into the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ishara_tpu.config import EncoderConfig
from ishara_tpu.models.encoder import build_model

from ishara_tpu_torch.bridge import flax_to_state_dict


def small_config(variant: str = "hybrid", **kw) -> EncoderConfig:
    """dim 64, 4 heads, frame_len 24, 2+2 blocks, dw kernel 15."""
    base = dict(variant=variant, dim=64, num_squeeze_blocks=2,
                num_conform_blocks=2, num_heads=4, frame_len=24,
                transformer_kernel_size=15, dropout=0.0, top_dropout=0.0,
                top_mult=1)
    base.update(kw)
    return EncoderConfig(**base)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def perturb(variables, seed: int = 1):
    """Non-trivial LN/BN affine parameters, biases and BN running stats
    (init leaves them at 0/1, which would hide a mix-up of the two)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float32)
        if "'var'" in name:
            return rng.standard_normal(a.shape).astype(np.float32) ** 2 \
                * 0.5 + 0.2
        if "'kernel'" in name:
            return a
        return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, to_numpy(variables))


def jax_model(cfg, seed: int = 0):
    """(flax model, perturbed numpy variables) for ``cfg``."""
    model = build_model(cfg)
    x = jnp.zeros((1, cfg.frame_len, cfg.input_dim), jnp.float32)
    return model, perturb(model.init(jax.random.key(seed), x))


def port_model(cfg_jax, variables):
    """The port's IsharaEncoder on the CPU with the bridged weights."""
    import ishara_tpu_torch.config as tcfg
    from ishara_tpu_torch.models.encoder import build_model as tbuild

    import dataclasses

    cfg = tcfg.EncoderConfig(**dataclasses.asdict(cfg_jax))
    model = tbuild(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return model


def raw_sequence(rng, T: int, nan_hands: bool = False,
                 left_dominant: bool = False) -> np.ndarray:
    """A raw [T, 276] landmark sequence in [0, 1] with the reference's
    missing-hand NaNs."""
    from ishara_tpu.data import landmarks as lm

    x = rng.random((T, lm.N_COLS)).astype(np.float32)
    r = lm.GROUP_IDX["rhand"].ravel()
    l_ = lm.GROUP_IDX["lhand"].ravel()
    # each hand is missing in some frames; the dominant hand in fewer
    miss_r = rng.random(T) < (0.7 if left_dominant else 0.2)
    miss_l = rng.random(T) < (0.2 if left_dominant else 0.7)
    x[np.ix_(miss_r, r)] = np.nan
    x[np.ix_(miss_l, l_)] = np.nan
    if nan_hands:
        x[:, np.concatenate([r, l_])] = np.nan
    return x
