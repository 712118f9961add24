"""The training slice as a whole: the port's ``TrainState`` and train steps
against the JAX package's from the same bridged weights on the same numpy
batch, with every dropout rate 0 and ``aug_prob=0`` (training mode still on,
for BatchNorm): loss, gradient norm, and every parameter, slow weight, batch
statistic and optimizer moment, leaf by leaf, after one step and after six
(Lookahead's sync at step 5 crossed). Then the non-finite guard and the
update-count rule, the (seed, step) contract with dropout on, and a short
overfit run.

Tolerances (f32 against f32): loss and gradient norm rtol 1e-4 (1e-3 from
the second of several steps on); parameters
and slow weights atol 2e-6 where one step moves a parameter by up to ~1e-3
(so a 0.2% error of an update would show), 1e-5 on 99.5% of every leaf
after six steps; moments rtol 1e-3 with atol
1e-3 of the leaf's largest value (plus 1e-6 of the tree's), 3e-2 after six
steps; batch
statistics rtol = atol = 1e-4.
RAdam's first rectified update (count 6) carries the ~1% ill-conditioning
of optax's float32 ``ro`` (see ``test_torch_train_modules.py``), which is
1e-7 here and inside the tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.config import TrainConfig as JTrainConfig
from ishara_tpu.data.synthetic import SyntheticASLFR
from ishara_tpu.data.tokenizer import CTCTokenizer
from ishara_tpu.preprocess import GroupStats as JGroupStats
from ishara_tpu.preprocess import preprocess_batch
from ishara_tpu.train import TrainState as JTrainState
from ishara_tpu.train import ctc_train_step as j_ctc_train_step
from ishara_tpu.train import make_fused_ctc_train_step as j_make_fused
from ishara_tpu.train import make_optimizer as j_make_optimizer

from ishara_tpu_torch import config as tconfig
from ishara_tpu_torch.bridge import flax_to_state_dict, load_train_state
from ishara_tpu_torch.decode import greedy_decode_batch
from ishara_tpu_torch.evaluation import normalized_levenshtein
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.train import (
    TrainState,
    ctc_eval_step,
    ctc_train_step,
    make_fused_ctc_eval_step,
    make_fused_ctc_train_step,
    make_optimizer,
)

from torch_port_helpers import jax_model, port_model, small_config, to_numpy

FRAME_LEN, MAX_RAW, BATCH = 32, 64, 4
TCFG = dict(lr_max=4e-3, warmup_epochs=0, num_epochs=2, steps_per_epoch=1000)


# The Conformer conv module's depthwise bias sits in front of a BatchNorm,
# which cancels it: its gradient is exactly zero and rounding noise (~1e-10)
# stands in its place. RAdam's unrectified first five updates leave it where
# it is, but from the sixth on Adam divides the noise by its own size and
# moves the leaf by lr * r (4e-3 * 0.017) in a direction that is noise in
# both packages. After six steps that leaf is held to twice that.
ZERO_GRADIENT = "conv.dw.bias"
ADAM_STEP_ATOL = 2e-4


def setup(variant="hybrid", frame_len=FRAME_LEN, max_raw=MAX_RAW,
          frames_per_char=5, **cfg_kw):
    """(JAX state, port state, raw batch, preprocessed x) from one set of
    perturbed weights."""
    cfg = small_config(variant, frame_len=frame_len, num_squeeze_blocks=1,
                       num_conform_blocks=1, **cfg_kw)
    model, variables = jax_model(cfg)
    jtx, _ = j_make_optimizer(JTrainConfig(**TCFG))
    sample = jnp.zeros((1, frame_len, cfg.input_dim), jnp.float32)
    jstate = JTrainState.create(model, jtx, sample)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jstate.replace(
        params=params, slow_params=jax.tree_util.tree_map(jnp.array, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jtx.init(params))
    ttx, _ = make_optimizer(tconfig.TrainConfig(**TCFG))
    tstate = TrainState.create(port_model(cfg, variables), ttx, device="cpu")
    ds = SyntheticASLFR(num_sequences=BATCH, frames_per_char=frames_per_char,
                        min_phrase=2, max_phrase=4, seed=3)
    batch = ds.batch(range(BATCH), CTCTokenizer(), max_frames=max_raw,
                     max_phrase=12)
    x = np.asarray(preprocess_batch(
        jnp.asarray(batch["raw"]), jnp.asarray(batch["lengths"]),
        JGroupStats.identity(), frame_len=frame_len))
    return jstate, tstate, batch, x


def assert_leaves(got: dict, want_tree, what, rtol, atol, scaled=False,
                  share=1.0):
    want = flax_to_state_dict({"params": want_tree}) if what != "stats" \
        else flax_to_state_dict({"batch_stats": want_tree})
    checked = 0
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        w = w.numpy()
        # scaled: against the leaf's largest value, and 1e-3 of that again
        # against the tree's (a bias in front of a BatchNorm has a gradient
        # of exactly zero, and rounding noise in its place)
        a = atol * (float(np.abs(w).max()) + 1e-3 * top) if scaled else atol
        g = got[name].detach().numpy()
        if name.endswith(ZERO_GRADIENT) and what in ("params", "slow"):
            a = max(a, ADAM_STEP_ATOL)
        if share < 1.0:
            # all but a few elements within atol, every one within the
            # size of an Adam update
            within = np.abs(g - w) <= a + rtol * np.abs(w)
            assert within.mean() >= share, f"{what}: {name}"
            a = max(a, ADAM_STEP_ATOL)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=a,
                                   err_msg=f"{what}: {name}")
        checked += 1
    assert checked == len([k for k in got
                           if not k.endswith("num_batches_tracked")])


def assert_states_match(tstate, jstate, atol=2e-6, share=1.0,
                        moment_tol=1e-3):
    assert int(tstate.step) == int(jstate.step)
    assert int(tstate.nonfinite_count) == int(jstate.nonfinite_count)
    assert_leaves(tstate.param_dict(), jstate.params, "params", 0, atol,
                  share=share)
    assert_leaves(tstate.slow_param_dict(), jstate.slow_params, "slow", 0,
                  atol, share=share)
    assert_leaves(tstate.batch_stats, jstate.batch_stats, "stats", 1e-4, 1e-4)
    adam, sched = jstate.opt_state[1], jstate.opt_state[3]
    mu, nu = tstate.moment_dicts()
    assert_leaves(mu, adam.mu, "mu", moment_tol, moment_tol, scaled=True)
    assert_leaves(nu, adam.nu, "nu", moment_tol, moment_tol, scaled=True)
    assert int(tstate.opt_state["count"]) == int(adam.count)
    assert int(tstate.opt_state["schedule_count"]) == int(sched.count)


def assert_metrics_match(tm, jm, rtol=1e-4):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=rtol)


@pytest.mark.parametrize("variant", ["hybrid", "conv_hybrid"])
def test_one_ctc_train_step_matches_jax(variant):
    jstate, tstate, batch, x = setup(variant)
    before = tstate.params.clone()
    jstate, jm = j_ctc_train_step(
        jstate, {"x": jnp.asarray(x), "labels": jnp.asarray(batch["labels"])},
        jax.random.key(0))
    tstate, tm = ctc_train_step(tstate, {"x": x, "labels": batch["labels"]},
                                seed=0)
    assert_metrics_match(tm, jm)
    assert float((tstate.params - before).abs().max()) > 1e-4
    assert_states_match(tstate, jstate)
    # the model's parameters are views of the flat tensor: it moved too
    sd = tstate.model.state_dict()
    for name, p in tstate.param_dict().items():
        assert torch.equal(sd[name], p)


def fused_steps(n):
    jstate, tstate, batch, _ = setup()
    jstep = jax.jit(j_make_fused(JGroupStats.identity(), FRAME_LEN,
                                 aug_prob=0.0, blank_id=59))
    tstep = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                      aug_prob=0.0, blank_id=59)
    jb = {k: jnp.asarray(batch[k]) for k in ("raw", "lengths", "labels")}
    for i in range(n):
        jstate, jm = jstep(jstate, jb, jax.random.key(0))
        tstate, tm = tstep(tstate, batch, seed=0)
        # after the first step each forward amplifies the last update's
        # rounding differences (lr 4e-3): 1e-3 from the second step on
        assert_metrics_match(tm, jm, 1e-4 if i == 0 else 1e-3)
    return jstate, tstate


def test_one_fused_train_step_matches_jax():
    jstate, tstate = fused_steps(1)
    assert_states_match(tstate, jstate)


def test_long_sequence_fused_step_on_the_kernels_matches_jax(monkeypatch):
    """The long-sequence slice at a narrow width: hybrid 1 + 1, dim 64, 4
    heads, T 400, dropout 0, batch 4 -- the table's long row, so with the
    kernel paths taken (as on a CUDA tensor) every attention runs the tiled
    kernel's wrapper and the Squeezeformer conv module the conv-module
    kernel's (their plain versions, here), and one fused step matches JAX's
    compositions leaf by leaf."""
    from ishara_tpu_torch.models import layers as tlayers

    calls = {"conv": 0, "attention": 0}
    conv, blocked = (tlayers.conv_kernel.conv_module_residual,
                     tlayers.attention_blocked.flash_mhsa_blocked)

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers.conv_kernel, "conv_module_residual",
                        count("conv", conv))
    monkeypatch.setattr(tlayers.attention_blocked, "flash_mhsa_blocked",
                        count("attention", blocked))
    jstate, tstate, batch, _ = setup(frame_len=400, max_raw=600,
                                     frames_per_char=120)
    assert int(batch["lengths"].max()) > 384
    jstep = jax.jit(j_make_fused(JGroupStats.identity(), 400, aug_prob=0.0,
                                 blank_id=59))
    tstep = make_fused_ctc_train_step(GroupStats.identity(), 400,
                                      aug_prob=0.0, blank_id=59)
    jb = {k: jnp.asarray(batch[k]) for k in ("raw", "lengths", "labels")}
    jstate, jm = jstep(jstate, jb, jax.random.key(0))
    tstate, tm = tstep(tstate, batch, seed=0)
    assert calls == {"conv": 1, "attention": 2}
    assert_metrics_match(tm, jm)
    assert_states_match(tstate, jstate)


def test_six_fused_train_steps_match_jax():
    """Six steps cross Lookahead's sync (the 5th step) and RAdam's
    rectification threshold (the 6th update)."""
    jstate, tstate = fused_steps(6)
    assert int(tstate.step) == 6
    assert not torch.equal(tstate.slow_params, tstate.params)
    # the sixth update is Adam's: each element moves by about lr * r = 7e-5
    # whatever its gradient's size, so the few elements whose gradient is
    # small against its rounding error move differently in the two
    # packages. 99.5% of every leaf within 1e-5 (the parameters have moved
    # by ~5e-3), every element within the size of such an update
    # (and the gradients of the later steps, hence the moments, carry the
    # earlier updates' differences: 3e-2 of a leaf's largest value)
    assert_states_match(tstate, jstate, atol=1e-5, share=0.995,
                        moment_tol=3e-2)


def snapshot(state):
    return (state.params.clone(), state.slow_params.clone(),
            {k: v.clone() for k, v in state.opt_state.items()},
            {k: v.clone() for k, v in state.batch_stats.items()})


def test_nonfinite_batch_leaves_every_leaf_unchanged():
    """A non-finite batch changes nothing but ``step`` and
    ``nonfinite_count`` -- in both packages -- and the learning-rate
    schedule counts updates, not steps."""
    jstate, tstate, batch, x = setup()
    good = {"x": x, "labels": batch["labels"]}
    bad = {"x": np.full_like(x, np.nan), "labels": batch["labels"]}
    fresh, _ = ctc_train_step(tstate.clone(), good, seed=0)

    before = snapshot(tstate)
    tstate, tm = ctc_train_step(tstate, bad, seed=0)
    jstate, jm = j_ctc_train_step(
        jstate, {k: jnp.asarray(v) for k, v in bad.items()},
        jax.random.key(0))
    assert not np.isfinite(float(tm["loss"]))
    assert not np.isfinite(float(jm["loss"]))
    after = snapshot(tstate)
    assert torch.equal(after[0], before[0])
    assert torch.equal(after[1], before[1])
    for k in before[2]:
        assert torch.equal(after[2][k], before[2][k]), k
    for k in before[3]:
        assert torch.equal(after[3][k], before[3][k]), k
    assert int(tstate.step) == int(jstate.step) == 1
    assert int(tstate.nonfinite_count) == int(jstate.nonfinite_count) == 1
    assert int(tstate.opt_state["schedule_count"]) \
        == int(jstate.opt_state[3].count) == 0
    assert int(tstate.opt_state["count"]) == int(jstate.opt_state[1].count) \
        == 0
    assert_states_match(tstate, jstate)

    # the next good step is the first update: the same as from a fresh state
    tstate, _ = ctc_train_step(tstate, good, seed=0)
    assert int(tstate.step) == 2
    assert int(tstate.opt_state["schedule_count"]) == 1
    assert torch.equal(tstate.params, fresh.params)


def test_same_seed_and_step_give_the_same_step_with_dropout_on():
    _, tstate, batch, _ = setup(dropout=0.3, top_dropout=0.3)
    step = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                     aug_prob=0.5, blank_id=59)
    a, ma = step(tstate.clone(), batch, seed=3)
    b, mb = step(tstate.clone(), batch, seed=3)
    c, mc = step(tstate.clone(), batch, seed=4)
    assert float(ma["loss"]) == float(mb["loss"])
    assert torch.equal(a.params, b.params)
    assert float(ma["loss"]) != float(mc["loss"])
    # the step number is part of the seed: the second step draws other masks
    a2, ma2 = step(a, batch, seed=3)
    b2, mb2 = step(b, batch, seed=3)
    assert float(ma2["loss"]) == float(mb2["loss"])
    assert float(ma2["loss"]) != float(ma["loss"])
    # ... and the kernel path's plain version (use_flash) is as repeatable
    _, fstate, _, _ = setup(dropout=0.3, top_dropout=0.3, use_flash=True)
    _, m1 = step(fstate.clone(), batch, seed=3)
    _, m2 = step(fstate.clone(), batch, seed=3)
    assert float(m1["loss"]) == float(m2["loss"])
    assert np.isfinite(float(m1["loss"]))


def test_options_and_eval_steps():
    _, tstate, batch, x = setup()
    # QAT is ported: both steps build and run, the eval step's forward on
    # the fake-quantized weights (tests/test_torch_qat.py holds them to JAX)
    qstate, qm = make_fused_ctc_train_step(
        GroupStats.identity(), FRAME_LEN, aug_prob=0.0, qat=True)(
        tstate.clone(), batch, seed=0)
    assert np.isfinite(float(qm["loss"])) and int(qstate.step) == 1
    qev = make_fused_ctc_eval_step(GroupStats.identity(), FRAME_LEN,
                                   qat=True)(tstate, batch)
    assert qev["ids"].shape == (BATCH, 64)
    # a mesh must be a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                  mesh=object())
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState.create(tstate.model, tstate.tx)   # no card here
    step = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                     aug_prob=0.0, with_grads=True)
    state, m = step(tstate.clone(), batch, seed=0)
    assert set(m["grads"]) == set(state.param_dict())
    norm = torch.sqrt(sum((g ** 2).sum() for g in m["grads"].values()))
    np.testing.assert_allclose(float(norm), float(m["grad_norm"]), rtol=1e-5)

    ev = make_fused_ctc_eval_step(GroupStats.identity(), FRAME_LEN)(
        tstate, batch)
    ev2 = ctc_eval_step(tstate, {"x": x, "labels": batch["labels"]})
    assert ev["loss_per_seq"].shape == (BATCH,)
    assert ev["ids"].shape == (BATCH, 64) and ev["counts"].shape == (BATCH,)
    np.testing.assert_allclose(float(ev["loss"]), float(ev2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ev["loss_per_seq"].mean()),
                               float(ev["loss"]), rtol=1e-6)
    assert ev2["logits"].shape == (BATCH, FRAME_LEN, 60)


def test_load_train_state_carries_moments():
    """``bridge.load_train_state``: flax params, batch statistics and optax
    moments from a JAX state that has taken two steps land in the port's
    state, after which a step of each agrees."""
    jstate, tstate, batch, x = setup()
    jb = {"x": jnp.asarray(x), "labels": jnp.asarray(batch["labels"])}
    for _ in range(2):
        jstate, _ = j_ctc_train_step(jstate, jb, jax.random.key(0))
    adam = jstate.opt_state[1]
    load_train_state(
        tstate, to_numpy({"params": jstate.params,
                          "batch_stats": jstate.batch_stats}),
        mu=to_numpy(adam.mu), nu=to_numpy(adam.nu), count=int(adam.count))
    tstate.step.fill_(int(jstate.step))
    tstate.slow_params.copy_(torch.cat([
        flax_to_state_dict({"params": to_numpy(jstate.slow_params)})[n]
        .reshape(-1) for n in tstate.slices]))
    assert_states_match(tstate, jstate)
    jstate, jm = j_ctc_train_step(jstate, jb, jax.random.key(0))
    tstate, tm = ctc_train_step(tstate, {"x": x, "labels": batch["labels"]})
    assert_metrics_match(tm, jm)
    assert_states_match(tstate, jstate)


def test_overfit_tiny_batch():
    """In the manner of ``tests/test_train.py``: 250 steps on one batch of
    eight short phrases bring the loss under a fifth of its start and the
    greedy decode recovers most phrases."""
    frame_len = 48
    ds = SyntheticASLFR(num_sequences=8, frames_per_char=6, min_phrase=2,
                        max_phrase=4, nan_frac=0.02)
    tok = CTCTokenizer()
    batch = ds.batch(range(8), tok, max_frames=96, max_phrase=16)
    x = np.asarray(preprocess_batch(
        jnp.asarray(batch["raw"]), jnp.asarray(batch["lengths"]),
        JGroupStats.identity(), frame_len=frame_len))
    cfg = small_config("squeezeformer", dim=64, num_squeeze_blocks=1,
                       frame_len=frame_len)
    model, _ = jax_model(cfg)
    variables = to_numpy(model.init(
        jax.random.key(0), jnp.zeros((1, frame_len, 276), jnp.float32)))
    tx, _ = make_optimizer(tconfig.TrainConfig(
        lr_max=3e-3, warmup_epochs=0, num_epochs=1, steps_per_epoch=10_000,
        optimizer="radam_lookahead"))
    state = TrainState.create(port_model(cfg, variables), tx, device="cpu")
    tb = {"x": torch.from_numpy(x), "labels": torch.from_numpy(batch["labels"])}
    losses = []
    for _ in range(250):
        state, metrics = ctc_train_step(state, tb, seed=0)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.2, losses[::25]
    assert int(state.nonfinite_count) == 0
    logits = ctc_eval_step(state, tb)["logits"]
    ids, ns = greedy_decode_batch(logits)
    preds = [tok.decode(i.numpy()[: int(n)]) for i, n in zip(ids, ns)]
    score = normalized_levenshtein(preds, batch["phrases"])
    assert score >= 0.6, (score, list(zip(preds, batch["phrases"])))
