"""Data-parallel training in the port (``ishara_tpu_torch/parallel/``,
the steps' and the ``Trainer``'s ``mesh=``) on gloo groups of 2 and 4 CPU
processes (``torch_dist_worker.py``, one torch thread each), against the
same steps in one process on the whole batch; and against the JAX
package's step on its 8-device CPU mesh (``tests/test_distributed.py``,
``__graft_entry__.dryrun_multichip``).

With dropout, augmentation and BatchNorm active, each rank's step draws
the masks and augmentations of its global rows and takes BatchNorm's
statistics over the global batch, so the sharded step computes the
unsharded one's function: the loss within rtol 1e-5 and the parameters
within atol 1e-5 (the reference's multislice test's tolerances; the sums
run in another order), and every replica the same bit for bit. The port's
step against JAX's runs at dropout 0 (JAX's masks are not the port's), at
``test_torch_train_step.py``'s tolerances. Then the plain versions of the
three mask-drawing kernels and the augmentation's draws on rows ``[r0,
r1)`` with the offset against the full call's rows, bit for bit; and the
single-process degradation and the guards.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ishara_tpu.config import TrainConfig as JTrainConfig
from ishara_tpu.preprocess import GroupStats as JGroupStats
from ishara_tpu.train import TrainState as JTrainState
from ishara_tpu.train import make_fused_ctc_train_step as j_make_fused
from ishara_tpu.train import make_optimizer as j_make_optimizer

from ishara_tpu_torch.bridge import flax_to_state_dict
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer, Seq2SeqTokenizer
from ishara_tpu_torch.ops import attention as at
from ishara_tpu_torch.ops import dropout as dr
from ishara_tpu_torch.ops import ffn_kernel as fk
from ishara_tpu_torch.parallel import (
    initialize_distributed,
    make_multislice_mesh,
    process_shard,
)
from ishara_tpu_torch.preprocess.augment import draws_from_seed

import torch_dist_worker as worker
from test_torch_train_step import assert_leaves
from torch_port_helpers import jax_model, perturb, small_config

ROOT = Path(__file__).resolve().parents[1]
B, FRAME_LEN, MAX_RAW = 8, 16, 24
TCFG = dict(lr_max=4e-3, warmup_epochs=0, num_epochs=2, steps_per_epoch=1000)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, spec: dict, tmp: Path) -> list[dict]:
    """Run ``spec`` on ``world`` gloo ranks; each rank's results."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(spec, tmp / "spec.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(world), str(port), str(tmp / "spec.pt"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode()[-4000:])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def ctc_case(name, variant="hybrid", dropout=0.1, aug_prob=0.5, **kw):
    """A CTC case: the port's weights bridged from a perturbed JAX init,
    a synthetic batch of ``B`` raw sequences, two fused steps."""
    cfg = small_config(variant, dim=32, num_squeeze_blocks=1,
                       num_conform_blocks=1, frame_len=FRAME_LEN,
                       transformer_kernel_size=7, dropout=dropout,
                       top_dropout=dropout)
    _, variables = jax_model(cfg)
    ds = SyntheticASLFR(num_sequences=B, frames_per_char=4, min_phrase=2,
                        max_phrase=4, seed=3)
    batch = ds.batch(range(B), CTCTokenizer(), max_frames=MAX_RAW,
                     max_phrase=12)
    return dict(name=name, task="ctc",
                model=("encoder", dataclasses.asdict(cfg)),
                state_dict=flax_to_state_dict(variables), frame_len=FRAME_LEN,
                batch={k: batch[k] for k in ("raw", "lengths", "labels")},
                steps=2, seed=3, aug_prob=aug_prob, tcfg=TCFG, lookahead=5,
                variables=variables, **kw)


def translation_case():
    from ishara_tpu.models import seq2seq as jsq

    kw = dict(num_classes=Seq2SeqTokenizer().vocab_size, feature_dim=32,
              num_layers=2, num_decoder_layers=2, num_heads=4)
    x = jnp.zeros((1, FRAME_LEN, 92, 3), jnp.float32)
    v = perturb(jsq.ASLTranslationModel(dropout=0.1, **kw).init(
        jax.random.key(0), x, jnp.ones((1, FRAME_LEN), bool),
        jnp.zeros((1, 4), jnp.int32)))
    ds = SyntheticASLFR(num_sequences=B, frames_per_char=4, min_phrase=2,
                        max_phrase=4, seed=4)
    batch = ds.batch(range(B), Seq2SeqTokenizer(), max_frames=MAX_RAW,
                     max_phrase=8)
    return dict(name="translation", task="translation",
                model=("translation", dict(dropout=0.1, **kw)),
                state_dict=flax_to_state_dict(v), frame_len=FRAME_LEN,
                batch={k: batch[k] for k in ("raw", "lengths", "labels")},
                steps=2, seed=3, aug_prob=0.5, tcfg=dict(TCFG, lr_max=2e-3),
                lookahead=1)


def _cases():
    return {"hybrid": ctc_case("hybrid", dtensor=True),
            "nodrop": ctc_case("nodrop", dropout=0.0, aug_prob=0.0),
            "unet": ctc_case("unet", "squeezeformer_unet"),
            "translation": translation_case()}


def _spec(cases, runs, trainer=None):
    strip = [{k: v for k, v in c.items() if k != "variables"}
             for c in cases.values()]
    return {"runs": [(layout, [c for c in strip if c["name"] in names])
                     for layout, names in runs], "trainer": trainer}


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def references(cases):
    """Each case in one process on the whole batch."""
    return {name: worker.run_case(c) for name, c in cases.items()}


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    return spawn(2, _spec(cases, [("1d", cases)], str(tmp / "trainer")),
                 tmp)


@pytest.fixture(scope="module")
def four_ranks(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    return spawn(4, _spec(cases, [("1d", ["hybrid"]),
                                  ("2x2", ["hybrid", "translation"])]), tmp)


def assert_matches_one_process(ranks, layout, name, ref):
    first = ranks[0][layout][name]
    for got in (r[layout][name] for r in ranks):
        # every replica the same, bit for bit
        for key in ("params", "slow", "mu", "nu"):
            assert torch.equal(got[key], first[key]), (name, key)
        for k, v in got["stats"].items():
            assert torch.equal(v, first["stats"][k]), (name, k)
        for k in ("loss", "grad_norm"):
            assert all(torch.equal(a, b) for a, b in zip(got[k], first[k]))
        for k, v in got["eval"].items():
            assert torch.equal(v, first["eval"][k]), (name, k)
    # ... and the unsharded step's function
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([float(v) for v in first[k]],
                                   [float(v) for v in ref[k]], rtol=1e-5,
                                   err_msg=f"{name}: {k}")
    for key in ("params", "slow"):
        np.testing.assert_allclose(first[key].numpy(), ref[key].numpy(),
                                   rtol=0, atol=1e-5, err_msg=f"{name}: {key}")
    for k, v in ref["stats"].items():
        np.testing.assert_allclose(first["stats"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert torch.equal(first["eval"]["ids"], ref["eval"]["ids"])
    np.testing.assert_allclose(first["eval"]["loss_per_seq"].numpy(),
                               ref["eval"]["loss_per_seq"].numpy(), rtol=1e-4)


@pytest.mark.parametrize("name", ["hybrid", "unet", "translation"])
def test_two_rank_step_matches_one_process(two_ranks, references, name):
    assert_matches_one_process(two_ranks, "1d", name, references[name])
    assert two_ranks[1]["1d"]["mesh"] == ((2,), ("data",))
    assert [r["process_shard"] for r in two_ranks] == [(0, 2), (1, 2)]
    assert all(r["initialized"] for r in two_ranks)


@pytest.mark.parametrize("layout,name", [
    ("1d", "hybrid"), ("2x2", "hybrid"), ("2x2", "translation")])
def test_four_rank_step_matches_one_process(four_ranks, references, layout,
                                            name):
    assert_matches_one_process(four_ranks, layout, name, references[name])
    assert four_ranks[3]["2x2"]["mesh"] == ((2, 2), ("dcn", "data"))
    # the placements, and a distributed batch's local rows = the rank's
    assert four_ranks[3]["2x2"]["placements"] == (
        ["S(0)", "S(0)"], ["R", "R"])
    assert all(r[layout]["shard_batch"] for r in four_ranks)


def test_two_rank_step_matches_jax_on_the_eight_device_mesh(two_ranks,
                                                            cases):
    """The port's 2-rank step (4 rows a rank) against JAX's sharded step on
    8 CPU devices (1 row a device), from the same weights, dropout 0."""
    case = cases["nodrop"]
    variables = case["variables"]
    model, _ = jax_model(small_config(**case["model"][1]))
    jtx, _ = j_make_optimizer(JTrainConfig(**TCFG))
    jstate = JTrainState.create(
        model, jtx, jnp.zeros((1, FRAME_LEN, 276), jnp.float32))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jstate.replace(
        params=params, slow_params=jax.tree_util.tree_map(jnp.array, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jtx.init(params))
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    rep, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    step = jax.jit(j_make_fused(JGroupStats.identity(), FRAME_LEN,
                                aug_prob=0.0, blank_id=59),
                   in_shardings=(rep, {k: bsh for k in case["batch"]}, rep),
                   out_shardings=(rep, rep))
    jb = {k: jax.device_put(jnp.asarray(v), bsh)
          for k, v in case["batch"].items()}
    jstate = jax.device_put(jstate, rep)
    got = two_ranks[0]["1d"]["nodrop"]
    for i in range(case["steps"]):
        jstate, jm = step(jstate, jb, jax.device_put(jax.random.key(0), rep))
        np.testing.assert_allclose(float(got["loss"][i]), float(jm["loss"]),
                                   rtol=1e-4 if i == 0 else 1e-3)
    sd = worker._model(case).state_dict()
    names = [n for n in sd if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    flat, at_ = {}, 0
    for n in names:
        flat[n] = got["params"][at_:at_ + sd[n].numel()].view(sd[n].shape)
        at_ += sd[n].numel()
    assert at_ == got["params"].numel()
    # two steps (the sixth-update rule of test_torch_train_step.py does not
    # apply): every parameter within 1e-5
    assert_leaves(flat, jstate.params, "params", 0, 1e-5)
    assert_leaves(got["stats"], jstate.batch_stats, "stats", 1e-4, 1e-4)


def test_trainer_on_two_ranks_reproduces_one_process_and_resumes(
        two_ranks, tmp_path):
    """``Trainer(mesh=...)`` on 2 ranks (2 rows a rank) against one process
    over 2 epochs with one validation, then a second ``Trainer`` resumes
    from rank 0's checkpoint on every rank and trains a third epoch."""
    ref = worker.run_trainer(str(tmp_path / "one"))
    got = [r["trainer"] for r in two_ranks]
    for g in got:
        assert torch.equal(g["params"], got[0]["params"])
        assert torch.equal(g["params2"], got[0]["params2"])
        # the resume restores every rank exactly
        assert torch.equal(g["resumed"], g["params"])
        assert g["resumed_epochs"] == 2
    for a, b in zip(got[0]["history"] + got[0]["history2"],
                    ref["history"] + ref["history2"]):
        assert a["epoch"] == b["epoch"]
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-5)
        assert ("val_score" in a) == ("val_score" in b)
        if "val_score" in a:
            assert a["val_score"] == b["val_score"]
            np.testing.assert_allclose(a["val_loss"], b["val_loss"],
                                       rtol=1e-4)
    for key in ("params", "params2"):
        np.testing.assert_allclose(got[0][key].numpy(), ref[key].numpy(),
                                   rtol=0, atol=1e-5)
    assert "divisible" in two_ranks[0]["indivisible"]


def test_offset_plain_versions_equal_the_full_calls_rows():
    """K2 / K3 / K4's plain versions and the augmentation's draws on rows
    ``[r0, r1)`` with the offset equal the full call's rows, bit for
    bit."""
    g = torch.Generator().manual_seed(0)
    seed = torch.tensor([12345], dtype=torch.int32)
    Bf, r0, r1 = 6, 2, 5
    # K2: inverted dropout and dropout-add on [B, T, C]
    x = torch.randn(Bf, 7, 9, generator=g)
    res = torch.randn(Bf, 7, 9, generator=g)
    per = 7 * 9
    for r in (None, res):
        full = dr.dropout_plain(x, seed, 0.3, r)
        part = dr.dropout_plain(x[r0:r1], seed, 0.3,
                                None if r is None else r[r0:r1], r0 * per)
        assert torch.equal(part, full[r0:r1])
    # K3: attention probabilities' mask over [B, H, T, T]
    H, T, Dh = 2, 5, 4
    q, k, v = (torch.randn(Bf, H, T, Dh, generator=g) for _ in range(3))
    bias = torch.zeros(Bf, T)
    o, lse = at.mhsa_forward_plain(q, k, v, bias, seed, 0.3, 0.25)
    po, plse = at.mhsa_forward_plain(q[r0:r1], k[r0:r1], v[r0:r1],
                                     bias[r0:r1], seed, 0.3, 0.25,
                                     offset=r0 * H * T * T)
    assert torch.equal(po, o[r0:r1]) and torch.equal(plse, lse[r0:r1])
    d_o = torch.randn(Bf, H, T, Dh, generator=g)
    full = at.mhsa_backward_plain(q, k, v, bias, seed, o, lse, d_o, 0.3,
                                  0.25)
    part = at.mhsa_backward_plain(q[r0:r1], k[r0:r1], v[r0:r1], bias[r0:r1],
                                  seed, po, plse, d_o[r0:r1], 0.3, 0.25,
                                  offset=r0 * H * T * T)
    for a, b in zip(part, full):
        assert torch.equal(a, b[r0:r1])
    # K4: the FFN's two masks over its [N, K] rows (N = B * T)
    K, M = 8, 16
    x2 = torch.randn(Bf * T, K, generator=g)
    res2 = torch.randn(Bf * T, K, generator=g)
    w1, w2 = torch.randn(K, M, generator=g), torch.randn(M, K, generator=g)
    b1, b2 = torch.randn(M, generator=g), torch.randn(K, generator=g)
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    rows = slice(r0 * T, r1 * T)
    full = fk.ffn_forward_plain(x2, res2, w1, b1, w2, b2, seeds, 0.2, 0.3)
    part = fk.ffn_forward_plain(x2[rows], res2[rows], w1, b1, w2, b2, seeds,
                                0.2, 0.3, row_offset=r0 * T)
    assert torch.equal(part, full[rows])
    dy = torch.randn(Bf * T, K, generator=g)
    fdx = fk.ffn_backward_plain(x2, dy, w1, b1, w2, seeds, 0.2, 0.3)[0]
    pdx = fk.ffn_backward_plain(x2[rows], dy[rows], w1, b1, w2, seeds, 0.2,
                                0.3, row_offset=r0 * T)[0]
    assert torch.equal(pdx, fdx[rows])
    m1, m2 = fk.debug_masks(Bf * T, M, K, seeds, 0.2, 0.3)
    p1, p2 = fk.debug_masks((r1 - r0) * T, M, K, seeds, 0.2, 0.3,
                            row_offset=r0 * T)
    assert torch.equal(p1, m1[rows]) and torch.equal(p2, m2[rows])
    # the augmentation's draws
    full = draws_from_seed(seed, Bf)
    part = draws_from_seed(seed, r1 - r0, row0=r0)
    for name, val in full.items():
        assert torch.equal(part[name], val[r0:r1]), name


def test_single_process_degradation_and_guards(monkeypatch):
    for var in ("ISHARA_COORDINATOR", "ISHARA_NUM_PROCESSES", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert process_shard() == (0, 1)
    with pytest.raises(ValueError):
        make_multislice_mesh()          # one host: num_slices required
    with pytest.raises(ValueError):
        make_multislice_mesh(num_slices=16)   # more slices than ranks
    with pytest.raises(ValueError, match="needs"):
        initialize_distributed(num_processes=2)   # no coordinator, no id
