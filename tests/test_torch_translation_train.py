"""Translation training on the port against the JAX package, at a small size
on the CPU: the device Levenshtein, ``token_lengths``, ``translation_loss``,
the model's training forward, the fused train and eval steps and a
``Trainer(task="translation")`` epoch.

Size: the JAX Trainer's translation model at dim 32 (4 heads, 2 RoPE
Squeezeformer blocks, 2 decoder layers, 62 classes), T 24, raw batches of
4 sequences of up to 48 frames with labels of 64 tokens. The train and eval
steps are compared on the JAX Trainer's own compiled steps, so that the
file compiles each JAX program once. Weights from a numpy seed in the
structure of the JAX model's init, bridged. The JAX side draws threefry
masks on the CPU, so every comparison with it runs at dropout 0 (training
mode still on, for BatchNorm); dropout is held by the port's (seed, step)
contract.

Tolerances (f32 against f32, the same arithmetic in another order): edit
distances and similarities exactly; ``translation_loss`` rtol 1e-6; the
training forward's logits and confidence 1e-5, its BatchNorm running
statistics 1e-4; a train step's loss and gradient norm rtol 1e-4 (1e-3
from the second step on), every gradient leaf 1e-4 of its largest entry,
the parameters atol 2e-6 after one step and 1e-5 after three, the first
and second moments 1e-3 of their leaf's largest entry; the eval step's ids
exactly and its losses rtol 1e-5; the Trainer's losses rtol 1e-3, its
three scores exactly. Two allowances, each for an exact zero or a
cancellation that rounds differently in the two packages: see
``TINY_GRAD`` and ``FLOOR``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.config import EncoderConfig as JEncoderConfig
from ishara_tpu.config import IsharaConfig as JIsharaConfig
from ishara_tpu.config import TrainConfig as JTrainConfig
from ishara_tpu.data.synthetic import SyntheticASLFR as JSyntheticASLFR
from ishara_tpu.data.tokenizer import Seq2SeqTokenizer as JSeq2SeqTokenizer
from ishara_tpu.models import seq2seq as jsq
from ishara_tpu.ops import levenshtein as jlev
from ishara_tpu.train import Trainer as JTrainer
from ishara_tpu.train import translation as jtr

import ishara_tpu_torch.config as tconfig
from ishara_tpu_torch.bridge import flax_to_state_dict, load_train_state
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer
from ishara_tpu_torch.models.seq2seq import translation_loss
from ishara_tpu_torch.ops import levenshtein as tlev
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.train import (
    Trainer,
    TrainState,
    make_fused_translation_eval_step,
    make_fused_translation_train_step,
    make_optimizer,
    token_lengths,
)

from torch_port_helpers import port_translation_model, to_numpy

D, H, T, B, MAX_RAW = 32, 4, 24, 4, 48
C = Seq2SeqTokenizer().vocab_size
MODEL_KW = dict(num_classes=C, feature_dim=D, num_layers=2,
                num_decoder_layers=2, num_heads=H)
# AdamW's one-cycle starts at lr_max / 25 = 8e-5: every parameter moves by
# up to that in a step, 40x the one-step atol.
LR_MAX = 2e-3
# Adam divides an entry's first moment by about its own size (|g| + 1e-8),
# so an entry whose gradient is small against its rounding error -- a bias
# in front of a BatchNorm, whose gradient is rounding noise around an exact
# zero; a key bias of the decoder's attention, which the softmax cancels; a
# sum that cancels -- turns that error into a move of up to lr either way,
# in either package. After one step an entry whose two gradients differ by
# more than TINY_GRAD of its size (so that its update may be off by more
# than that share of lr, 8e-7) is held to 2 lr more; the rest, at least 95%
# of the parameters, to the plain atol.
TINY_GRAD = 1e-2
# A leaf whose exact gradient is zero carries the rounding noise of a sum
# over B * T * L rows (the extractors' conv biases): a few 1e-6 of the
# tree's largest gradient. Gradients and moments are held to this share of
# their tree's largest entry besides their own leaf's tolerance.
FLOOR = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Levenshtein, token lengths and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,M,vocab", [(9, 9, 4), (12, 7, 3), (5, 13, 6)])
def test_edit_distance_and_similarity_match_jax(N, M, vocab):
    """16 random cases a shape (48 in all): small vocabularies so that
    matches are common, ``len_a`` over [0, N], ``len_b`` over [-2, M + 3]
    (clipped to [0, M] for the distance, not for the divisor)."""
    rng = np.random.default_rng(N * 100 + M)
    a = rng.integers(0, vocab, (16, N)).astype(np.int32)
    b = rng.integers(0, vocab, (16, M)).astype(np.int32)
    la = rng.integers(0, N + 1, 16).astype(np.int32)
    lb = rng.integers(-2, M + 4, 16).astype(np.int32)
    la[:2], lb[:2] = 0, [0, M]                       # empty prefixes
    want_d, want_s = map(np.asarray, jax.jit(lambda *r: (
        jlev.batched_edit_distance(*r), jlev.normalized_similarity(*r)))(
            a, b, la, lb))
    got_d = tlev.batched_edit_distance(_t(a), _t(b), _t(la), _t(lb))
    got_s = tlev.normalized_similarity(_t(a), _t(b), _t(la), _t(lb))
    assert got_d.dtype == torch.int32 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    for i in range(3):                               # the unbatched form
        one = tlev.edit_distance(_t(a[i]), _t(b[i]), int(la[i]), int(lb[i]))
        assert int(one) == int(want_d[i])


def test_token_lengths_match_jax():
    """The first eos or pad ends a row; a row with neither is full."""
    ids = np.array([[5, 6, 2, 7, 0], [2, 4, 4, 4, 4], [3, 4, 5, 6, 7],
                    [3, 0, 2, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    want = np.asarray(jtr.token_lengths(jnp.asarray(ids), 2, 0))
    got = token_lengths(_t(ids), 2, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [2, 0, 5, 1, 0]


def test_translation_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((B, 12, C)).astype(np.float32) * 3
    targets = rng.integers(0, C, (B, 12)).astype(np.int32)
    targets[0, 4:] = 0
    targets[1, :] = 0                                # all pad
    conf = rng.standard_normal(B).astype(np.float32)
    conf_t = rng.random(B).astype(np.float32)
    want = float(jsq.translation_loss(logits, targets, conf, conf_t))
    got = float(translation_loss(_t(logits), _t(targets), _t(conf),
                                 _t(conf_t)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The JAX Trainer, whose compiled steps every comparison below shares
# ---------------------------------------------------------------------------

def numpy_init(model, init, seed: int = 0) -> dict:
    """Variables in the structure of the flax ``model``'s ``init`` (the
    unbound method; ``jax.eval_shape``, nothing compiled) filled from a
    numpy seed: matrices N(0, 1/fan_in), biases and norm offsets 0.1 N,
    scales 1 + 0.1 N, running means 0.1 N and variances 0.5 + U(0, 1)."""
    shapes = jax.eval_shape(
        functools.partial(init, model), jax.random.key(0),
        jnp.zeros((1, T, 92, 3)), jnp.ones((1, T), bool),
        jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(a.shape).astype(np.float32)
        if "'var'" in name:
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if "'kernel'" in name or "'embedding'" in name:
            return n / np.sqrt(np.prod(a.shape[:-1]))
        if "'scale'" in name:
            return 1.0 + 0.1 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _configs():
    """(JAX config, port config): the translation recipe's AdamW at dim 32,
    dropout and augmentation off, batch 4, a schedule of 4 epochs (optax's
    one-cycle divides by zero below 4 steps) validated every epoch, the
    instrumented step (gradients returned) at every step."""
    model = dict(dim=D, num_heads=H, frame_len=T, dropout=0.0,
                 num_classes=C)
    train = dict(batch_size=B, num_epochs=4, warmup_epochs=0, lr_max=LR_MAX,
                 optimizer="adamw", validate_every_epochs=1,
                 checkpoint_every_epochs=100, aug_prob=0.0,
                 histogram_every_steps=1)
    return (JIsharaConfig(task="translation", model=JEncoderConfig(**model),
                          train=JTrainConfig(**train)),
            tconfig.IsharaConfig(task="translation",
                                 model=tconfig.EncoderConfig(**model),
                                 train=tconfig.TrainConfig(**train)))


def _data(pkg):
    kw = dict(frames_per_char=5, min_phrase=2, max_phrase=4)
    return (pkg(num_sequences=2 * B, seed=3, **kw),
            pkg(num_sequences=B + 1, seed=4, **kw))


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX ``Trainer(task="translation")``, not yet trained, and its
    initial variables (numpy). It initialises its model op by op, which
    takes longer than this whole file; its weights come from numpy_init."""
    init = jsq.ASLTranslationModel.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsq.ASLTranslationModel, "init",
                   lambda self, *a: numpy_init(self, init))
        jt = JTrainer(_configs()[0], *_data(JSyntheticASLFR),
                      JSeq2SeqTokenizer(),
                      workdir=tmp_path_factory.mktemp("jax"),
                      max_raw_frames=MAX_RAW, task="translation")
    v = to_numpy({"params": jt.state.params,
                  "batch_stats": jt.state.batch_stats})
    return jt, v


def _states(jt, v, dropout=0.0):
    """(JAX TrainState, port TrainState) at the variables ``v``; the JAX
    one shaped as the Trainer's, so that its compiled steps take it."""
    js = jt.state
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = js.replace(
        step=jnp.zeros((), jnp.int32), params=params,
        slow_params=jax.tree_util.tree_map(jnp.array, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=js.tx.init(params),
        nonfinite_count=jnp.zeros((), jnp.int32))
    tcfg = _configs()[1].train
    tcfg.steps_per_epoch = jt.cfg.train.steps_per_epoch
    tstate = TrainState.create(
        port_translation_model(v, dropout=dropout, **MODEL_KW),
        make_optimizer(tcfg)[0], device="cpu", lookahead_sync_period=1)
    load_train_state(tstate, v)
    return jstate, tstate


def _batch(jt, seed=3):
    """A raw batch as the Trainer collates it (host numpy) and as its JAX
    steps take it."""
    ds = SyntheticASLFR(num_sequences=B, frames_per_char=5, min_phrase=2,
                        max_phrase=4, seed=seed)
    batch = ds.batch(range(B), Seq2SeqTokenizer(), max_frames=MAX_RAW)
    return batch, jt._device_batch(batch)


def _named(tree):
    return {k: v.numpy() for k, v in
            flax_to_state_dict({"params": to_numpy(tree)}).items()}


def tree_tolerance(want: dict, rtol) -> dict:
    """Each leaf's tolerance: ``rtol`` of its largest entry plus FLOOR of
    the tree's largest."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {n: rtol * float(np.abs(w).max()) + FLOOR * top
            for n, w in want.items()}


def assert_tree_close(got: dict, want: dict, rtol, what):
    assert set(got) >= set(want)
    for name, lim in tree_tolerance(want, rtol).items():
        err = float(np.abs(got[name].detach().numpy() - want[name]).max())
        assert err <= lim, (what, name, err, lim)


def assert_params_close(tstate, jstate, noise, atol, share):
    """The parameters and slow weights of the whole tree within ``noise +
    atol``, and a ``share`` of them within ``atol``."""
    for got, tree in ((tstate.param_dict(), jstate.params),
                      (tstate.slow_param_dict(), jstate.slow_params)):
        want = _named(tree)
        err = np.concatenate([np.abs(got[n].detach().numpy() - w).ravel()
                              for n, w in want.items()])
        assert err.max() <= noise + atol
        assert (err <= atol).mean() >= share


def assert_stats_and_moments(tstate, jstate, moment_tol, stats_tol=1e-4):
    """Counters, batch statistics (rtol = atol = ``stats_tol``) and both
    Adam moments (``moment_tol`` of their leaf's largest entry)."""
    assert int(tstate.step) == int(jstate.step)
    assert int(tstate.nonfinite_count) == int(jstate.nonfinite_count)
    want = flax_to_state_dict({"batch_stats": to_numpy(jstate.batch_stats)})
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                tstate.batch_stats[name].numpy(), w.numpy(), rtol=stats_tol,
                atol=stats_tol, err_msg=name)
    adam = jstate.opt_state[1]
    mu, nu = tstate.moment_dicts()
    assert_tree_close(mu, _named(adam.mu), moment_tol, "mu")
    assert_tree_close(nu, _named(adam.nu), moment_tol, "nu")
    assert int(tstate.opt_state["count"]) == int(adam.count)


def adam_noise(schedule, steps) -> float:
    """The most that rounding noise on a tiny gradient can move an entry
    apart in the two packages over ``steps`` updates: 2 lr a step."""
    return 2.0 * sum(float(schedule(i)) for i in range(steps))


# ---------------------------------------------------------------------------
# The training forward and the steps
# ---------------------------------------------------------------------------

def test_training_forward_matches_jax(jax_trainer):
    """Training mode at dropout 0: logits and confidence, and both
    BatchNorms' running statistics after the batch (the extractor's
    statistics over every B * T * L row, padded frames included)."""
    jt, v = jax_trainer
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, 92, 3)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[0, T - 5:] = False
    x[0, T - 5:] = 0.0
    tgt = rng.integers(0, C, (B, 11)).astype(np.int32)
    (want, want_conf), upd = jax.jit(
        lambda v, x, m, t: jt.model.apply(v, x, m, t, training=True,
                                          mutable=["batch_stats"]))(
        v, x, mask, tgt)
    pm = port_translation_model(v, dropout=0.0, **MODEL_KW)
    got, conf = pm(_t(x), _t(mask), _t(tgt), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conf.detach().numpy(), np.asarray(want_conf),
                               rtol=1e-5, atol=1e-5)
    stats = {k: b for k, b in pm.named_buffers() if "running" in k}
    want_stats = flax_to_state_dict({"batch_stats": to_numpy(
        upd["batch_stats"])})
    assert len(stats) == 2 * 4 + 2 * 2
    for k, b in stats.items():
        np.testing.assert_allclose(b.numpy(), want_stats[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
def test_fused_translation_train_steps_match_jax(jax_trainer, steps):
    """``make_fused_translation_train_step`` (aug_prob 0, gradients
    returned) against the JAX Trainer's compiled step from one state on one
    raw batch: loss, gradient norm and confidence at every step; every
    gradient leaf at the first; after the last step every parameter, batch
    statistic and Adam moment. After one step the parameters are held
    element by element (those of tiny gradient, TINY_GRAD, to Adam's noise
    more); from then on each package's noise moves the next steps'
    activations, and the parameters are held as ``test_torch_train_step.py``
    holds them after six steps (99.5% within 1e-5, every one within the
    noise more), the moments to 3e-2 and the batch statistics to 1e-3."""
    jt, v = jax_trainer
    jstate, tstate = _states(jt, v)
    batch, jb = _batch(jt)
    tstep = make_fused_translation_train_step(GroupStats.identity(), T,
                                              aug_prob=0.0, with_grads=True)
    for i in range(steps):
        jstate, jm = jt._hist_step(jstate, jb, jax.random.key(0))
        tstate, tm = tstep(tstate, batch, seed=0)
        rtol = 1e-4 if i == 0 else 1e-3
        for k in ("loss", "grad_norm", "confidence_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, atol=1e-6, err_msg=k)
        if i == 0:
            grads = _named(jm["grads"])
            assert_tree_close(tm["grads"], grads, 1e-4, "grads")
            tiny = {n: np.abs(tm["grads"][n].numpy() - g)
                    > TINY_GRAD * (np.abs(g) + 1e-8)
                    for n, g in grads.items()}
    noise = adam_noise(tstate.tx.schedule, steps)
    if steps > 1:
        assert_params_close(tstate, jstate, noise, 1e-5, 0.995)
        assert_stats_and_moments(tstate, jstate, 3e-2, stats_tol=1e-3)
        return
    assert np.mean(np.concatenate([t.ravel() for t in tiny.values()])) \
        <= 0.05
    for what, got, tree in (("params", tstate.param_dict(), jstate.params),
                            ("slow", tstate.slow_param_dict(),
                             jstate.slow_params)):
        for name, w in _named(tree).items():
            lim = np.where(tiny[name], noise + 2e-6, 2e-6)
            err = np.abs(got[name].detach().numpy() - w)
            assert (err <= lim).all(), (what, name, float(err.max()))
    assert_stats_and_moments(tstate, jstate, 1e-3)


def test_fused_translation_eval_step_matches_jax(jax_trainer):
    """Preprocess, the encoder once, the uncached greedy decode of 64
    tokens and the teacher-forced loss, against the JAX Trainer's compiled
    eval step: ids exactly, losses and confidence rtol 1e-5."""
    jt, v = jax_trainer
    jstate, tstate = _states(jt, v)
    batch, jb = _batch(jt, seed=5)
    want = jt._eval_step(jstate, jb)
    got = make_fused_translation_eval_step(GroupStats.identity(), T)(
        tstate, batch)
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    for k in ("loss", "loss_per_seq", "confidence"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_dropout_follows_the_seed_and_step_contract(jax_trainer):
    """Dropout on (0.3), on the port alone: the same (seed, step) gives the
    same step bit for bit; another seed or another step other masks; and
    the masks do drop (the loss differs from the dropout-0 step's). The
    numbered sites: 7 an encoder block, 4 a decoder layer, the target
    embedding's."""
    jt, v = jax_trainer
    _, plain = _states(jt, v)
    _, tstate = _states(jt, v, dropout=0.3)
    assert tstate.model.num_sites == 7 * 2 + 4 * 2 + 1
    step = make_fused_translation_train_step(GroupStats.identity(), T,
                                             aug_prob=0.0)
    batch, _ = _batch(jt)
    a, ma = step(tstate.clone(), batch, seed=0)
    b, mb = step(tstate.clone(), batch, seed=0)
    _, mc = step(tstate.clone(), batch, seed=1)
    later = tstate.clone()
    later.step = later.step + 1
    _, md = step(later, batch, seed=0)
    _, m0 = step(plain, batch, seed=0)
    assert float(ma["loss"]) == float(mb["loss"])
    assert torch.equal(a.params, b.params)
    losses = {float(m["loss"]) for m in (ma, mc, md, m0)}
    assert len(losses) == 4
    assert all(np.isfinite(x) for x in losses)


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------

def test_translation_trainer_epoch_matches_jax_trainer(jax_trainer,
                                                       tmp_path):
    """One epoch of two steps and its validation, from the JAX Trainer's
    initial weights carried over by ``bridge.load_train_state``: the train
    and validation losses, the three scores, the gradient and parameter
    histograms of every step, the final state. (Trains the shared JAX
    Trainer: the last test of the file that uses it.)"""
    jt, _ = jax_trainer
    tt = Trainer(_configs()[1], *_data(SyntheticASLFR), Seq2SeqTokenizer(),
                 workdir=tmp_path, max_raw_frames=MAX_RAW,
                 task="translation", device="cpu")
    assert tt.model.encoder_type == "squeezeformer"
    assert tt.model.num_sites == 7 * 2 + 4 * 2 + 1
    load_train_state(tt.state, to_numpy({
        "params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    jh, th = jt.train(num_epochs=1), tt.train(num_epochs=1)
    assert len(jh) == len(th) == 1
    j, t = jh[0], th[0]
    np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-3)
    np.testing.assert_allclose(t["val_loss"], j["val_loss"], rtol=1e-3)
    for k in ("val_score", "val_score_maxlen", "val_score_pooled"):
        assert t[k] == j[k], k
    # the final state as after several steps above
    assert_params_close(tt.state, jt.state,
                        adam_noise(tt.schedule, int(jt.state.step)), 1e-5,
                        0.995)
    assert_stats_and_moments(tt.state, jt.state, 3e-2)
    assert tt.ckpt.latest_step() == jt.ckpt.latest_step() == 2
    hist = [ln for ln in (tmp_path / "train_metrics.jsonl").read_text()
            .splitlines() if '"histograms"' in ln]
    assert len(hist) == 2 * 2       # gradients and parameters, each step


def test_translation_gate_runner_reaches_its_harness_line(tmp_path, capsys):
    """``tools/train_translation_hard_torch.py`` end to end on the CPU at
    dim 32 and T 24: a step, a validation, the harness through a
    ``TranslationEngine``, the JSON verdict."""
    import json
    import math
    import sys
    from pathlib import Path

    tools = str(Path(__file__).resolve().parents[1] / "tools")
    sys.path.insert(0, tools)
    try:
        import train_translation_hard_torch as runner
    finally:
        sys.path.remove(tools)
    runner.main(["--device", "cpu", "--epochs", "1", "--sequences", "4",
                 "--batch-size", "4", "--val-sequences", "2", "--dim", "32",
                 "--frame-len", "24", "--max-raw-frames", "48",
                 "--workdir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "harness:" in out
    gate = json.loads(out.strip().splitlines()[-1])["gate"]
    assert gate["steps"] == 1 and gate["gate_passed"] is False
    assert math.isfinite(gate["harness"])
    assert gate["val_curve"] and gate["harness"] <= 1.0
