"""The port's checkpoints and resume, on the port alone (a port of
``tests/test_resume.py``'s three tests, at a tiny size on the CPU), and the
``CheckpointManager``'s own contract: the main chain keeps the newest three,
the best chain one, renames leave no temporary file, ``restore`` writes into
the state in place -- the model's parameters are views of ``state.params``,
so a restore that swapped tensors would leave the model computing with the
old weights."""

import numpy as np
import pytest
import torch

from ishara_tpu_torch.config import EncoderConfig, IsharaConfig, TrainConfig
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.train import CheckpointManager, Trainer


def _cfg():
    return IsharaConfig(
        model=EncoderConfig(dim=32, variant="squeezeformer",
                            num_squeeze_blocks=1, num_heads=4, frame_len=32,
                            dropout=0.1, top_dropout=0.0),
        train=TrainConfig(batch_size=8, num_epochs=4, warmup_epochs=0,
                          lr_max=3e-3, validate_every_epochs=2,
                          checkpoint_every_epochs=100, aug_prob=0.2),
    )


def _data():
    kw = dict(frames_per_char=4, min_phrase=2, max_phrase=3, nan_frac=0.02)
    return (CTCTokenizer(), SyntheticASLFR(num_sequences=16, **kw),
            SyntheticASLFR(num_sequences=8, **kw))


def _trainer(train_ds, val_ds, tok, workdir):
    return Trainer(_cfg(), train_ds, val_ds, tok, workdir=workdir,
                   max_raw_frames=64, device="cpu")


def _tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor a checkpoint carries, by name."""
    out = {"params": state.params, "slow_params": state.slow_params,
           "step": state.step}
    out.update({f"opt_state.{k}": v for k, v in state.opt_state.items()})
    out.update({f"batch_stats.{k}": v for k, v in state.batch_stats.items()})
    return out


class _PreemptedData:
    """Wraps a dataset; ``batch`` raises after ``fail_after`` calls: a
    preemption in the middle of an epoch."""

    def __init__(self, inner, fail_after):
        self._inner, self._fail, self._n = inner, fail_after, 0

    def __len__(self):
        return len(self._inner)

    def batch(self, idx, tok, max_frames=None):
        if self._n >= self._fail:
            raise RuntimeError("simulated preemption")
        self._n += 1
        return self._inner.batch(idx, tok, max_frames=max_frames)


def test_interrupted_plus_resumed_equals_uninterrupted(tmp_path):
    tok, train_ds, val_ds = _data()
    hist_full = _trainer(train_ds, val_ds, tok, tmp_path / "full").train(
        num_epochs=4)

    t_a = _trainer(train_ds, val_ds, tok, tmp_path / "resumed")
    hist_a = t_a.train(num_epochs=2)
    assert t_a.completed_epochs == 2
    step_after_a = int(t_a.state.step)

    t_b = _trainer(train_ds, val_ds, tok, tmp_path / "resumed")
    assert t_b.resume()
    assert t_b.completed_epochs == 2
    assert int(t_b.state.step) == step_after_a
    assert t_b.best_score == t_a.best_score
    hist_b = t_b.train(num_epochs=4)

    assert [r["epoch"] for r in hist_b] == [2, 3]
    np.testing.assert_allclose(
        [r["train_loss"] for r in hist_a + hist_b],
        [r["train_loss"] for r in hist_full], rtol=1e-6,
        err_msg="train-loss history diverges from the uninterrupted run")
    assert [r.get("val_score") for r in hist_a + hist_b] \
        == [r.get("val_score") for r in hist_full]


def test_mid_epoch_resume_is_bit_identical(tmp_path):
    """A crash mid-epoch resumes at the exact interrupted batch: the final
    step, parameters, slow weights, optimizer state and batch statistics
    equal the uninterrupted run's bit for bit."""
    tok, train_ds, val_ds = _data()
    t_full = _trainer(train_ds, val_ds, tok, tmp_path / "full")
    t_full.train(num_epochs=3)

    # 16 sequences / batch 8 = 2 batches an epoch; the 4th batch load fails
    # -> the crash lands inside epoch 1
    t_a = _trainer(_PreemptedData(train_ds, 3), val_ds, tok, tmp_path / "mid")
    with pytest.raises(RuntimeError, match="simulated preemption"):
        t_a.train(num_epochs=3)
    assert t_a.completed_epochs == 1
    consumed = t_a._epoch_batches_done
    assert 0 < consumed < 2

    t_b = _trainer(train_ds, val_ds, tok, tmp_path / "mid")
    assert t_b.resume()
    assert t_b._resume_skip == consumed
    t_b.train(num_epochs=3)

    got, want = _tensors(t_b.state), _tensors(t_full.state)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_resume_does_not_regress_best_checkpoint(tmp_path):
    """A post-resume score below the restored best must not overwrite the
    best chain."""
    tok, train_ds, val_ds = _data()
    t_a = _trainer(train_ds, val_ds, tok, tmp_path)
    t_a.train(num_epochs=2)
    best_step_before = t_a.ckpt.best_step()

    t_b = _trainer(train_ds, val_ds, tok, tmp_path)
    assert t_b.resume()
    assert np.isfinite(t_b.best_score)
    t_b.best_score = 2.0   # above the largest score there is
    t_b.train(num_epochs=3)
    assert t_b.ckpt.best_step() == best_step_before
    assert [p.name for p in (tmp_path / "ckpt" / "best").glob("*.pt")] \
        == [f"step_{best_step_before}.pt"]


def test_restore_writes_in_place_and_the_model_computes_with_it(tmp_path):
    tok, train_ds, val_ds = _data()
    tr = _trainer(train_ds, val_ds, tok, tmp_path)
    tr.train_epoch(0, seed=0)
    state = tr.state
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 276)).astype(np.float32))
    saved_out = state.model(x)
    saved = {k: v.clone() for k, v in _tensors(state).items()}
    tr.ckpt.save(int(state.step), state, metrics={"val_score": 0.5})

    tr.train_epoch(1, seed=0)                       # move every leaf on
    assert not torch.equal(state.params, saved["params"])
    flat = state.params
    restored = tr.ckpt.restore(state)
    assert restored is state and state.params is flat
    for name, t in _tensors(state).items():
        assert torch.equal(t, saved[name]), name
    # every parameter of the model is still a view of the flat tensor, and
    # a forward computes with the restored weights
    base = state.params.untyped_storage().data_ptr()
    for p in state.model.parameters():
        assert p.untyped_storage().data_ptr() == base
    for name, p in state.param_dict().items():
        assert torch.equal(dict(state.model.named_parameters())[name], p)
    assert torch.equal(state.model(x), saved_out)


def test_checkpoint_manager_retention_meta_and_errors(tmp_path):
    tok, train_ds, val_ds = _data()
    state = _trainer(train_ds, val_ds, tok, tmp_path / "run").state
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.latest_step() is None and mgr.best_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, best=True)
    for step, score in ((1, 0.2), (2, 0.5), (3, 0.4), (4, None), (5, None)):
        state.step.fill_(step)
        mgr.save(step, state, best=score is not None and score >= 0.5,
                 metrics=None if score is None else {"val_score": score,
                                                     "epochs": step})
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert names == ["best", "meta.json", "step_3.pt", "step_4.pt",
                     "step_5.pt"]
    assert [p.name for p in (tmp_path / "ckpt" / "best").iterdir()] \
        == ["step_2.pt"]
    assert mgr.latest_step() == 5 and mgr.best_step() == 2
    assert mgr.best_step(mode="min") == 1
    assert mgr.step_meta(3) == {"val_score": 0.4, "epochs": 3}
    assert mgr.step_meta(4) == {} and set(mgr.read_meta()) == {"1", "2", "3"}
    mgr.restore(state, best=True)
    assert int(state.step) == 2
    mgr.restore(state, step=4)
    assert int(state.step) == 4
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, step=1)                  # pruned
    mgr.close()
    # a new manager over the same directory sees the same chains
    again = CheckpointManager(tmp_path / "ckpt")
    assert again.latest_step() == 5 and again.best_step() == 2
