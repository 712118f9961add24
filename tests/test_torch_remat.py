"""``cfg.remat`` in the port: every Squeezeformer, Conformer and Transformer
block of a training forward recomputed in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``nn.remat``.

Recomputation changes no value: with dropout, augmentation and BatchNorm
active, two fused steps of a ``remat=True`` model equal those of the same
model without it bit for bit -- loss, gradients, parameters and BatchNorm
statistics (which the recomputation must not move a second time) -- also
on the kernel paths (their plain versions here). And one ``remat=True``
step matches JAX's ``remat=True`` step at ``test_torch_train_step.py``'s
tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from ishara_tpu.preprocess import GroupStats as JGroupStats
from ishara_tpu.train import make_fused_ctc_train_step as j_make_fused

from ishara_tpu_torch.models import layers as tlayers
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.train import TrainState, make_fused_ctc_train_step

from test_torch_train_step import (
    FRAME_LEN,
    assert_metrics_match,
    assert_states_match,
    setup,
)


def _twin(state, remat: bool):
    """A state like ``state`` whose model has ``cfg.remat = remat``."""
    cfg = dataclasses.replace(state.model.cfg, remat=remat)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state.model.state_dict())
    return TrainState.create(model, state.tx, device="cpu")


@pytest.mark.parametrize("variant,on_card", [
    ("hybrid", False), ("conformer", False), ("hybrid", True)])
def test_remat_steps_equal_plain_steps_bit_for_bit(variant, on_card,
                                                   monkeypatch):
    if on_card:
        monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    _, tstate, batch, _ = setup(variant, dropout=0.2, top_dropout=0.2)
    plain, remat = _twin(tstate, False), _twin(tstate, True)
    assert remat.model.cfg.remat and not plain.model.cfg.remat
    step = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                     aug_prob=0.5, with_grads=True)
    for _ in range(2):
        plain, pm = step(plain, batch, seed=7)
        remat, rm = step(remat, batch, seed=7)
        assert torch.equal(pm["loss"], rm["loss"])
        assert torch.equal(pm["grad_norm"], rm["grad_norm"])
        for name, g in pm["grads"].items():
            assert torch.equal(g, rm["grads"][name]), name
    assert torch.equal(plain.params, remat.params)
    assert torch.equal(plain.slow_params, remat.slow_params)
    stats = plain.batch_stats
    assert any("conv.bn" in k for k in stats)   # the Conformer's BatchNorm
    for name, b in stats.items():
        assert torch.equal(b, remat.batch_stats[name]), name
    # the statistics moved (once a step, not twice)
    assert not torch.equal(stats["stem_bn.running_mean"],
                           tstate.batch_stats["stem_bn.running_mean"])


def test_remat_step_matches_jax_remat_step():
    jstate, tstate, batch, _ = setup(remat=True)
    assert tstate.model.cfg.remat
    jstep = jax.jit(j_make_fused(JGroupStats.identity(), FRAME_LEN,
                                 aug_prob=0.0, blank_id=59))
    tstep = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                      aug_prob=0.0, blank_id=59)
    jb = {k: jnp.asarray(batch[k]) for k in ("raw", "lengths", "labels")}
    jstate, jm = jstep(jstate, jb, jax.random.key(0))
    tstate, tm = tstep(tstate, batch, seed=0)
    assert_metrics_match(tm, jm)
    assert_states_match(tstate, jstate)
