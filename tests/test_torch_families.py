"""The parallel-branches and Temporal U-Net families, and a causal hybrid,
through the machinery around the model, on the CPU against the JAX
package: one fused CTC train step leaf by leaf, the unfused
``InferenceEngine`` and ``BatchedEngine`` (greedy and beam) id for id, the
fused modes refused as JAX's ``fused_encoder_forward`` refuses them, the
bridge both ways with ``load_train_state``, and the ``Trainer`` on the
U-Net against JAX's. Tolerances as ``test_torch_train_step.py`` and
``test_torch_trainer.py`` state them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.preprocess import GroupStats as JGroupStats
from ishara_tpu.serve.engine import BatchedEngine as JBatchedEngine
from ishara_tpu.serve.engine import InferenceEngine as JEngine
from ishara_tpu.train import make_fused_ctc_train_step as j_make_fused

from ishara_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.serve.engine import BatchedEngine, InferenceEngine
from ishara_tpu_torch.train import make_fused_ctc_train_step

from test_torch_train_step import (
    FRAME_LEN,
    assert_metrics_match,
    assert_states_match,
    setup,
)
from torch_port_helpers import (
    jax_model,
    port_model,
    raw_sequence,
    small_config,
)


@pytest.mark.parametrize("variant", ["squeezeformer_unet",
                                     "parallel_branches"])
def test_new_family_fused_train_step_matches_jax(variant):
    """One fused CTC train step of each new family from the same weights,
    leaf by leaf (the U-Net at 2 blocks: reduction at 1, recovery at 2 is
    past its last block, so no recovery, as in JAX)."""
    jstate, tstate, batch, _ = setup(variant)
    jstep = jax.jit(j_make_fused(JGroupStats.identity(), FRAME_LEN,
                                 aug_prob=0.0, blank_id=59))
    tstep = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                      aug_prob=0.0, blank_id=59)
    jb = {k: jnp.asarray(batch[k]) for k in ("raw", "lengths", "labels")}
    jstate, jm = jstep(jstate, jb, jax.random.key(0))
    tstate, tm = tstep(tstate, batch, seed=0)
    assert_metrics_match(tm, jm)
    assert_states_match(tstate, jstate)


def _requests():
    rng = np.random.default_rng(21)
    return [raw_sequence(rng, 10), raw_sequence(rng, 40),
            raw_sequence(rng, 80), raw_sequence(rng, 20, nan_hands=True),
            np.full((15, 276), np.nan, np.float32)]


@pytest.mark.parametrize("variant,kw", [
    ("squeezeformer_unet", {}),
    ("squeezeformer_unet", {"decode": "beam", "beam_width": 3,
                            "beam_top_k": 4}),
    ("parallel_branches", {}),
    ("parallel_branches", {"decode": "beam", "beam_width": 3,
                           "beam_top_k": 4}),
    ("hybrid_causal", {}),
    ("hybrid_causal", {"decode": "beam", "beam_width": 3, "beam_top_k": 4}),
])
def test_unfused_engines_match_jax(variant, kw):
    """``InferenceEngine`` and ``BatchedEngine`` (unfused, greedy and beam)
    give JAX's ids and counts for each new family and a causal model; the
    classifier is scaled so that frame argmax margins dwarf f32 rounding."""
    extra = dict(causal=True, attn_context=9) if variant == "hybrid_causal" \
        else {}
    cfg = small_config(variant.replace("_causal", ""), frame_len=24,
                       **extra)
    model, variables = jax_model(cfg)
    v = jax.tree_util.tree_map(np.array, variables)
    head = v["params"]["unet"]["fc"] if "unet" in v["params"] \
        else v["params"]["classifier"]
    head["kernel"] *= 20.0
    want = JEngine(model, v, max_raw_frames=64, **kw)
    port = InferenceEngine(port_model(cfg, v), max_raw_frames=64,
                           device="cpu", **kw)
    reqs = _requests()
    for raw in reqs:
        ids, count = want(raw)
        got_ids, got_count = port(raw)
        assert got_count == count
        np.testing.assert_array_equal(got_ids, ids)
    jb = JBatchedEngine(model, v, batch_size=4, max_raw_frames=64, **kw)
    tb = BatchedEngine(port_model(cfg, v), batch_size=4, max_raw_frames=64,
                       device="cpu", **kw)
    want_ids, want_counts = jb(reqs[:4])
    got_ids, got_counts = tb(reqs[:4])
    np.testing.assert_array_equal(got_counts, np.asarray(want_counts))
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))


@pytest.mark.parametrize("variant,extra", [
    ("squeezeformer_unet", {}), ("parallel_branches", {}),
    ("hybrid", dict(causal=True, attn_context=9)),
])
@pytest.mark.parametrize("kw", [{"fused": True}, {"fused": "int8"},
                                {"fused": True, "dma": True}, {"dma": True}])
def test_fused_serving_refuses_what_its_kernels_do_not_implement(
        variant, extra, kw):
    """The fused kernels implement the bidirectional families they were
    written for: a causal model or a new family raises ValueError, as
    JAX's ``fused_encoder_forward`` does, and so does ``FusedEncoder``."""
    from ishara_tpu.ops.fused_block import fused_encoder_forward as jfused
    from ishara_tpu_torch.models.fused import FusedEncoder

    cfg = small_config(variant, frame_len=24, **extra)
    model, variables = jax_model(cfg)
    with pytest.raises(ValueError):
        jfused(cfg, variables, jnp.zeros((24, 276)), interpret=True)
    port = port_model(cfg, variables)
    with pytest.raises(ValueError):
        InferenceEngine(port, max_raw_frames=64, device="cpu", **kw)
    with pytest.raises(ValueError):
        BatchedEngine(port, batch_size=2, max_raw_frames=64, device="cpu",
                      fused=kw.get("fused", True))
    with pytest.raises(ValueError):
        FusedEncoder(port.cfg, port.state_dict(), device="cpu")


@pytest.mark.parametrize("variant", ["squeezeformer_unet",
                                     "parallel_branches"])
def test_bridge_round_trip_and_train_state(variant):
    """``state_dict_to_flax`` inverts ``flax_to_state_dict`` for each new
    family (the U-Net's ``u_bias`` / ``v_bias`` and ``block_{i}`` names
    included), and ``load_train_state`` carries the variables and Adam
    moments into a port ``TrainState``."""
    import ishara_tpu_torch.config as tcfg
    from ishara_tpu_torch.bridge import load_train_state
    from ishara_tpu_torch.train import TrainState, make_optimizer

    cfg = small_config(variant)
    _, v = jax_model(cfg)
    back = {k: t for k, t in state_dict_to_flax(
        flax_to_state_dict(v)).items() if t}
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    mu = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        v["params"])
    tx, _ = make_optimizer(tcfg.TrainConfig())
    state = TrainState.create(port_model(cfg, jax_model(cfg, seed=1)[1]), tx,
                              device="cpu")
    load_train_state(state, v, mu=mu, count=3)
    want = flax_to_state_dict(v)
    for name, p in state.param_dict().items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=0)
    got_mu = state.moment_dicts()[0]
    for name, m in flax_to_state_dict({"params": mu}).items():
        torch.testing.assert_close(got_mu[name], m, rtol=0, atol=0)
    assert int(state.opt_state["count"]) == 3


def test_trainer_trains_the_unet_as_jax(tmp_path):
    """The ``Trainer`` builds its model with the family factory, so it
    trains the U-Net: one epoch of two steps and a validation from the JAX
    Trainer's own initial weights, against JAX's ``Trainer`` (losses rtol
    1e-3, the three validation scores exactly, as
    ``test_torch_trainer.py`` holds the hybrid)."""
    import dataclasses

    from ishara_tpu.config import IsharaConfig as JIsharaConfig
    from ishara_tpu.config import TrainConfig as JTrainConfig
    from ishara_tpu.data.synthetic import SyntheticASLFR as JSynthetic
    from ishara_tpu.data.tokenizer import CTCTokenizer as JTokenizer
    from ishara_tpu.train import Trainer as JTrainer

    import ishara_tpu_torch.config as tcfg
    from ishara_tpu_torch.bridge import load_train_state
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import _SpeechUNetAdapter
    from ishara_tpu_torch.train import Trainer

    model = dataclasses.asdict(small_config(
        "squeezeformer_unet", num_squeeze_blocks=3, frame_len=32))
    train = dict(batch_size=8, num_epochs=1, warmup_epochs=0, lr_max=4e-3,
                 validate_every_epochs=1, checkpoint_every_epochs=100,
                 aug_prob=0.0)
    kw = dict(frames_per_char=5, min_phrase=2, max_phrase=4)
    jt = JTrainer(
        JIsharaConfig(model=JIsharaConfig().model.__class__(**model),
                      train=JTrainConfig(**train)),
        JSynthetic(num_sequences=16, seed=3, **kw),
        JSynthetic(num_sequences=8, seed=4, **kw), JTokenizer(),
        workdir=tmp_path / "jax", max_raw_frames=64)
    tt = Trainer(
        tcfg.IsharaConfig(model=tcfg.EncoderConfig(**model),
                          train=tcfg.TrainConfig(**train)),
        SyntheticASLFR(num_sequences=16, seed=3, **kw),
        SyntheticASLFR(num_sequences=8, seed=4, **kw), CTCTokenizer(),
        workdir=tmp_path / "port", max_raw_frames=64, device="cpu")
    assert isinstance(tt.model, _SpeechUNetAdapter)
    load_train_state(tt.state, jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params,
                     "batch_stats": jt.state.batch_stats}))
    (j,), (t,) = jt.train(), tt.train()
    np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-3)
    np.testing.assert_allclose(t["val_loss"], j["val_loss"], rtol=1e-3)
    for k in ("val_score", "val_score_maxlen", "val_score_pooled"):
        assert t[k] == j[k], k
