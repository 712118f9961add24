"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``):
build a JAX model at a small size, give it non-trivial weights and BN
statistics from a numpy seed, and bridge them into the port."""

from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ishara_tpu.config import EncoderConfig
from ishara_tpu.models.encoder import build_model

from ishara_tpu_torch.bridge import flax_to_state_dict


def cap_torch_threads() -> int:
    """Share the host's cores among pytest-xdist's workers: each worker's
    torch otherwise starts one intra-op thread per core, and six workers on
    eight cores then spend most of their time waiting for each other.
    Every worker collects every test module, so importing this module caps
    the whole process. Returns the thread count set."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n


cap_torch_threads()


def small_config(variant: str = "hybrid", **kw) -> EncoderConfig:
    """dim 64, 4 heads, frame_len 24, 2+2 blocks, dw kernel 15; for the
    conv families two Conv1DBlocks of kernel sizes 7 and 3 before each
    attention block."""
    base = dict(variant=variant, dim=64, num_squeeze_blocks=2,
                num_conform_blocks=2, num_heads=4, frame_len=24,
                transformer_kernel_size=15, kernel_sizes=(7, 3),
                num_conv_per_block=2, dropout=0.0, top_dropout=0.0,
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


# A depthwise conv's bias right in front of a training-mode BatchNorm (the
# Conformer conv module's, the U-Net block's) has a gradient of exactly
# zero: the batch mean takes it out. Both packages leave rounding noise in
# its place (~1e-7 of the largest gradient entry).
ZERO_GRADIENT = re.compile(r"(conv\.dw|block\.\d+\.dw)\.bias$")


def assert_grads_match(got: dict, want: dict, tol: float = 1e-4):
    """The port's gradients ``got`` (name -> tensor) against JAX's bridged
    ``want`` (name -> tensor), same keys: each entry within ``tol`` of its
    leaf's largest entry (of 1e-3 of the largest over all leaves, where
    that is more); a leaf whose true gradient is zero (ZERO_GRADIENT) within
    1e-5 of the largest in both."""
    assert set(got) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name].detach().numpy()
        w = w.numpy()
        if ZERO_GRADIENT.search(name):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * largest, \
                name
            continue
        scale = max(float(np.abs(w).max()), 1e-3 * largest)
        np.testing.assert_allclose(g / scale, w / scale, rtol=tol, atol=tol,
                                   err_msg=name)


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


def translation_models(encoder_type: str = "squeezeformer", dim: int = 32,
                       heads: int = 4, classes: int = 30, T: int = 12,
                       S: int = 7, seed: int = 0):
    """(flax ASLTranslationModel, perturbed numpy variables, the port's
    model with the bridged weights, x [2, T, 92, 3], mask [2, T] -- row 0
    with a padded tail, row 1 all padding --, tgt [2, S]) at 2 + 2
    layers."""
    from ishara_tpu.models import seq2seq as jsq

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, 92, 3)).astype(np.float32)
    mask = np.ones((2, T), bool)
    mask[0, T - 3:] = False
    mask[1, :] = False
    tgt = rng.integers(0, classes, (2, S)).astype(np.int32)
    kw = dict(num_classes=classes, feature_dim=dim, num_layers=2,
              num_decoder_layers=2, num_heads=heads,
              encoder_type=encoder_type)
    jm = jsq.ASLTranslationModel(dropout=0.0, **kw)
    v = perturb(jm.init(jax.random.key(seed), jnp.asarray(x),
                        jnp.asarray(mask), jnp.asarray(tgt)))
    return jm, v, port_translation_model(v, **kw), x, mask, tgt


def port_translation_model(variables, **kw):
    """The port's ASLTranslationModel on the CPU with bridged weights."""
    from ishara_tpu_torch.models import seq2seq as tsq

    pm = tsq.ASLTranslationModel(**kw).eval()
    pm.load_state_dict(flax_to_state_dict(variables))
    return pm


def with_eos_bias(variables, bias: float, eos: int = 2):
    """A copy of ``variables`` with ``bias`` added to the classifier's eos
    logit."""
    v = jax.tree_util.tree_map(lambda a: a, variables)
    b = np.array(v["params"]["classifier"]["bias"])
    b[eos] += bias
    v["params"]["classifier"]["bias"] = b
    return v
