"""Tensor parallelism in the port (``ishara_tpu_torch/parallel/tp.py``)
against the JAX package's (``ishara_tpu/parallel/tp.py``,
``tests/test_tensor_parallel.py``).

The rules shard exactly the reference's leaves, at the reference's dims,
on three models and two model axes. On a 2 x 2 ``(data, model)`` gloo mesh
of 4 CPU processes (``torch_dist_worker.py``, layout ``"tp2x2"``) one
``ctc_train_step`` at the reference test's geometry (hybrid 1 + 1, dim 64,
T 16, batch 8, dropout 0) equals JAX's ``shard_state_tp`` step on its 4 x 2
mesh of 8 CPU devices and the port's unsharded step, at the reference's
tolerances (loss rtol 1e-4, every parameter rtol 1e-3 / atol 1e-4); a
dropout-0.4 CTC case and a translation case equal the port's unsharded
steps at ``test_torch_distributed.py``'s tolerances; the replicated leaves
are the same bit for bit on every process of the ``model`` group. Then the
strided masks of a slice, and the selection under a model axis, on one
process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ishara_tpu.config import EncoderConfig as JEncoderConfig
from ishara_tpu.config import IsharaConfig as JIsharaConfig
from ishara_tpu.config import TrainConfig as JTrainConfig
from ishara_tpu.config import baseline_config as j_baseline_config
from ishara_tpu.models import IsharaEncoder
from ishara_tpu.parallel.tp import make_2d_mesh as j_make_2d_mesh
from ishara_tpu.parallel.tp import shard_state_tp as j_shard_state_tp
from ishara_tpu.parallel.tp import tp_param_shardings as j_tp_param_shardings
from ishara_tpu.serve.export import build_task_model as j_build_task_model
from ishara_tpu.train import TrainState as JTrainState
from ishara_tpu.train import ctc_train_step as j_ctc_train_step
from ishara_tpu.train import make_optimizer as j_make_optimizer

from ishara_tpu_torch import config as tconfig
from ishara_tpu_torch.bridge import flax_to_state_dict
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.ops import dropout as dr
from ishara_tpu_torch.ops import selection
from ishara_tpu_torch.parallel.shard import BatchShard, batch_shard, split_offset
from ishara_tpu_torch.parallel.tp import flax_path, tp_param_shardings
from ishara_tpu_torch.serve.export import build_task_model

import torch_dist_worker as worker
from test_torch_distributed import B, ctc_case, spawn, translation_case

T_REF, F = 16, 276
REF_TCFG = dict(steps_per_epoch=100, warmup_epochs=0)


def _reference_encoder_kw() -> dict:
    return dict(dim=64, variant="hybrid", num_squeeze_blocks=1,
                num_conform_blocks=1, num_heads=4, frame_len=T_REF,
                dropout=0.0, top_dropout=0.0)


def _models(name):
    """(JAX model, its init function, the port's model) of one of the
    three models the rules are held on."""
    if name == "reference":
        jm = IsharaEncoder(JEncoderConfig(**_reference_encoder_kw()))
        x = jnp.zeros((1, T_REF, F), jnp.float32)
        return (lambda k: jm.init(k, x)), build_model(
            tconfig.EncoderConfig(**_reference_encoder_kw()), device="cpu")
    if name == "baseline4":
        jcfg, cfg = j_baseline_config(4), tconfig.baseline_config(4)
        jm = IsharaEncoder(jcfg.model)
        x = jnp.zeros((1, jcfg.model.frame_len, F), jnp.float32)
        return (lambda k: jm.init(k, x)), build_model(cfg.model,
                                                      device="cpu")
    kw = dict(dim=64, num_heads=4, num_classes=62)
    jcfg = JIsharaConfig(model=JEncoderConfig(**kw), task="translation")
    cfg = tconfig.IsharaConfig(model=tconfig.EncoderConfig(**kw),
                               task="translation")
    _, init = j_build_task_model(jcfg)
    return init, build_task_model(cfg, device="cpu")


def _jax_rules(init, parts):
    """{flax path: the torch dim JAX shards over ``model``, or None} from
    the reference's ``tp_param_shardings`` on a (8 / parts, parts) mesh of
    the CPU devices (shapes only: ``eval_shape``)."""
    params = jax.eval_shape(init, jax.random.key(0))["params"]
    mesh = j_make_2d_mesh(8 // parts if 8 % parts == 0 else 2, parts)
    flat = jax.tree_util.tree_flatten_with_path(
        j_tp_param_shardings(params, mesh))[0]
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for (path, sh), (_, leaf) in zip(flat, leaves):
        key = "/".join(getattr(k, "key", str(k)) for k in path)
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        dims = [i for i, a in enumerate(spec) if a == "model"]
        # a flax Dense kernel [in, out] is the torch weight [out, in]
        out[key] = None if not dims else (
            leaf.ndim - 1 - dims[0] if leaf.ndim == 2 else dims[0])
    return out


@pytest.mark.parametrize("name,parts,count", [
    ("reference", 2, (16, 58)), ("reference", 3, None),
    ("baseline4", 2, (64, 211)), ("baseline4", 3, None),
    ("translation", 2, (40, 149)), ("translation", 3, None)])
def test_rules_shard_the_reference_leaves(name, parts, count):
    """The port's sharded leaves and dims are the reference's, leaf for
    leaf (through the bridge's names), on a model axis of 2 and on one of
    3 that divides some leaves and not others."""
    init, model = _models(name)
    want = _jax_rules(init, parts)
    got = {flax_path(n, p.dim()): d
           for (n, d), p in zip(tp_param_shardings(model, parts).items(),
                                model.parameters())}
    assert set(got) == set(want)
    assert got == want
    sharded = sum(d is not None for d in got.values())
    if count is not None:
        assert (sharded, len(got)) == count
    else:
        # 3 divides some ruled leaves (the encoders' QKV rows) and not
        # others: fewer are sharded
        assert sharded < sum(
            d is not None for d in _jax_rules(init, 2).values())
        assert (sharded > 0) == (name != "translation")


def _reference_case():
    """The reference test's model and batch: the JAX state's initial
    weights (bridged), x standard normal, labels 7 7 7 then blanks."""
    jm = IsharaEncoder(JEncoderConfig(**_reference_encoder_kw()))
    tx, _ = j_make_optimizer(JTrainConfig(**REF_TCFG))
    jstate = JTrainState.create(jm, tx, jnp.zeros((1, T_REF, F)),
                                rng=jax.random.key(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T_REF, F)).astype(np.float32)
    labels = np.full((B, 8), 59, np.int32)
    labels[:, :3] = 7
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats})
    cfg = tconfig.EncoderConfig(**_reference_encoder_kw())
    return dict(name="reference", task="ctc_x",
                model=("encoder", dataclasses.asdict(cfg)),
                state_dict=flax_to_state_dict(variables), frame_len=T_REF,
                batch={"x": torch.from_numpy(x),
                       "labels": torch.from_numpy(labels)},
                steps=1, seed=0, aug_prob=0.0, tcfg=REF_TCFG, lookahead=5,
                jstate=jstate, jbatch={"x": x, "labels": labels})


@pytest.fixture(scope="module")
def cases():
    return {"reference": _reference_case(),
            "dropout": ctc_case("dropout", dropout=0.4, aug_prob=0.5),
            "kernels": ctc_case("kernels", dropout=0.4, aug_prob=0.5,
                                kernels=True),
            "translation": translation_case()}


@pytest.fixture(scope="module")
def references(cases):
    """Each case in one process on the whole batch, unsharded."""
    return {n: worker.run_case(c) for n, c in cases.items()}


@pytest.fixture(scope="module")
def tp_ranks(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ranks")
    strip = [{k: v for k, v in c.items()
              if k not in ("variables", "jstate", "jbatch")}
             for c in cases.values()]
    return spawn(4, {"runs": [("tp2x2", strip)], "trainer": None}, tmp)


def _by_name(case, flat):
    sd = worker._model(case).state_dict()
    names = [n for n in sd if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    out, at = {}, 0
    for n in names:
        out[n] = flat[at:at + sd[n].numel()].view(sd[n].shape)
        at += sd[n].numel()
    assert at == flat.numel()
    return out


def test_tp_step_matches_jax_on_its_4x2_mesh_and_the_unsharded_step(
        tp_ranks, references, cases):
    case = cases["reference"]
    mesh = j_make_2d_mesh(4, 2)
    jstate = j_shard_state_tp(case["jstate"], mesh)
    bsh = NamedSharding(mesh, P("data"))
    jb = {k: jax.device_put(jnp.asarray(v), bsh)
          for k, v in case["jbatch"].items()}
    js, jm = jax.jit(j_ctc_train_step)(
        jstate, jb, jax.device_put(jax.random.key(1), NamedSharding(mesh,
                                                                    P())))
    got = tp_ranks[0]["tp2x2"]["reference"]
    ref = references["reference"]
    np.testing.assert_allclose(float(got["loss"][0]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got["loss"][0]), float(ref["loss"][0]),
                               rtol=1e-4)
    want = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, js.params)})
    for name, v in _by_name(case, got["params"]).items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["params"].numpy(), ref["params"].numpy(),
                               rtol=1e-3, atol=1e-4)
    # the rules' 16 leaves are slices; the hybrid's attention and FFNs
    # compute on them (nothing gathered)
    assert len(got["tp_dims"]) == 16 and got["tp_gather"] == ()


@pytest.mark.parametrize("name", ["dropout", "kernels", "translation"])
def test_tp_step_matches_the_unsharded_step(tp_ranks, references, name):
    """Dropout 0.4 and augmentation (CTC; on the compositions, and on the
    kernel paths: the attention kernel on a rank's heads, the FFN kernel's
    partial sums), the translation model (its sharded leaves gathered for
    the compute): two steps and the eval step at the data-parallel tests'
    tolerances."""
    got = tp_ranks[0]["tp2x2"][name]
    ref = references[name]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([float(v) for v in got[k]],
                                   [float(v) for v in ref[k]], rtol=1e-5,
                                   err_msg=k)
    for key in ("params", "slow", "mu", "nu"):
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)
    for k, v in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert torch.equal(got["eval"]["ids"], ref["eval"]["ids"])
    np.testing.assert_allclose(got["eval"]["loss_per_seq"].numpy(),
                               ref["eval"]["loss_per_seq"].numpy(),
                               rtol=1e-4)
    assert (len(got["tp_gather"]) > 0) == (name == "translation")
    if name == "kernels":
        # both ranks of a model group took both kernels, as the unsharded
        # step did: the table's choice stands on a slice
        assert got["kernel_calls"] == ref["kernel_calls"]
        assert min(got["kernel_calls"].values()) > 0


@pytest.mark.parametrize("name", ["reference", "dropout", "kernels",
                                  "translation"])
def test_replicated_leaves_are_bit_equal_across_the_model_group(tp_ranks,
                                                                name):
    """Ranks 2d and 2d + 1 form a ``model`` group: the same rows, the same
    replicated elements bit for bit; the whole state is the same on all
    four."""
    assert [r["tp2x2"]["coordinate"] for r in tp_ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert tp_ranks[0]["tp2x2"]["mesh"] == ((2, 2), ("data", "model"))
    runs = [r["tp2x2"][name] for r in tp_ranks]
    for r in runs:
        assert torch.equal(r["replicated"], runs[0]["replicated"])
        for key in ("params", "slow", "mu", "nu"):
            assert torch.equal(r[key], runs[0][key]), key
        for k in ("loss", "grad_norm"):
            assert all(torch.equal(a, b) for a, b in zip(r[k], runs[0][k]))


def test_strided_masks_are_the_full_tensors_slices():
    """A slice's mask (``runs``) is the unsharded tensor's mask at its
    positions: a rank's heads of ``[B, H, T, T]`` and its hidden columns
    of ``[B, T, 4 dim]``, on rows ``[r0, r1)``; plain version and the
    layer's offsets."""
    g = torch.Generator().manual_seed(0)
    seed = torch.tensor([4242], dtype=torch.int32)
    Bf, H, T, hid, parts = 6, 4, 5, 12, 2
    r0, r1 = 2, 5
    att = torch.randn(Bf, H, T, T, generator=g)
    full = dr.dropout_plain(att, seed, 0.4)
    shard = BatchShard(row0=r0, local=r1 - r0, rows=Bf)
    for part in range(parts):
        h = slice(part * H // parts, (part + 1) * H // parts)
        x = att[r0:r1, h]
        with batch_shard(shard):
            off, runs = split_offset(x.shape, parts, part, trailing=3)
        assert torch.equal(dr.dropout_plain(x, seed, 0.4, None, off, runs),
                           full[r0:r1, h])
    hidden = torch.randn(Bf, T, hid, generator=g)
    res = torch.randn(Bf, T, hid // parts, generator=g)
    full = dr.dropout_plain(hidden, seed, 0.3)
    for part in range(parts):
        c = slice(part * hid // parts, (part + 1) * hid // parts)
        x = hidden[r0:r1, :, c]
        with batch_shard(shard):
            off, runs = split_offset(x.shape, parts, part)
        assert torch.equal(dr.dropout_plain(x, seed, 0.3, None, off, runs),
                           full[r0:r1, :, c])
        assert torch.equal(
            dr.dropout_plain(x, seed, 0.3, res[r0:r1], off, runs),
            (res[r0:r1] + full[r0:r1, :, c]))
        # the autograd wrappers take the same runs, backward too
        xg = x.clone().requires_grad_(True)
        y = dr.fast_dropout(xg, seed, 0.3, off, runs)
        y.sum().backward()
        assert torch.equal(y, full[r0:r1, :, c])
        assert torch.equal(xg.grad, (full[r0:r1, :, c] != 0).float()
                           / (1.0 - 0.3))
    # one slice of one part is the contiguous call
    with batch_shard(shard):
        assert split_offset(hidden[r0:r1].shape, 1, 0) \
            == (r0 * T * hid, None)


def test_selection_under_a_model_axis():
    """A slice of the heads or of the hidden reads the table's row as the
    whole layer does (the kernels take a slice's masks); at the reference
    test's geometry (batch 8) every kernel's row is on."""
    for T in (176, 512):
        assert selection.train_attention(256, T, True, 256) == "flash"
        assert selection.ffn_fused_when_dropout(256, T, 256) is True
    assert selection.train_attention(64, 16, False, 8) == "flash"
    assert selection.train_attention(64, 16, True, 8) == "flash"
    assert selection.ffn_fused_when_dropout(64, 16, 8) is True
    assert selection.conv_module_fused(64, 16, 8) is True


def test_kernel_plain_versions_on_a_slice_are_the_whole_launch_s():
    """The attention kernel's plain version on a rank's heads (``runs``)
    gives the whole call's heads, forward and gradients; the FFN kernel's
    plain partial sums (``hidden``) summed over the ranks, with the bias,
    give the whole branch, on rows ``[r0, r1)``."""
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import ffn_kernel as fk

    g = torch.Generator().manual_seed(1)
    Bf, H, T, Dh, parts, r0 = 4, 4, 9, 8, 2, 1
    q, k, v, d_o = (torch.randn(Bf, H, T, Dh, generator=g) for _ in range(4))
    bias = at.mask_to_bias(torch.rand(Bf, T, generator=g) > 0.3)
    seed = torch.tensor([12], dtype=torch.int32)
    o, lse = at.mhsa_forward_plain(q, k, v, bias, seed, 0.3, 0.4)
    full = at.mhsa_backward_plain(q, k, v, bias, seed, o, lse, d_o, 0.3, 0.4)
    shard = BatchShard(row0=r0, local=Bf - r0, rows=Bf)
    hl = H // parts
    for part in range(parts):
        sl = (slice(r0, None), slice(part * hl, (part + 1) * hl))
        with batch_shard(shard):
            off, runs = split_offset((Bf - r0, hl, T, T), parts, part, 3)
        os_, ls = at.mhsa_forward_plain(q[sl], k[sl], v[sl], bias[r0:], seed,
                                        0.3, 0.4, offset=off, runs=runs)
        grads = at.mhsa_backward_plain(q[sl], k[sl], v[sl], bias[r0:], seed,
                                       os_, ls, d_o[sl], 0.3, 0.4,
                                       offset=off, runs=runs)
        torch.testing.assert_close(os_, o[sl], rtol=1e-6, atol=1e-6)
        for a, b in zip(grads, full):
            torch.testing.assert_close(a, b[sl], rtol=1e-6, atol=1e-6)

    n, kk, m, roff = 10, 8, 16, 3
    x, dy = torch.randn(n, kk, generator=g), torch.randn(n, kk, generator=g)
    w1, b1 = torch.randn(kk, m, generator=g), torch.randn(m, generator=g)
    w2, b2 = torch.randn(m, kk, generator=g), torch.randn(kk, generator=g)
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    want = fk.ffn_forward_plain(x, None, w1, b1, w2, b2, seeds, 0.4, 0.0,
                                row_offset=roff)
    wdx = fk.ffn_backward_plain(x, dy, w1, b1, w2, seeds, 0.4, 0.0,
                                row_offset=roff)
    total, dx = b2, 0.0
    ml = m // parts
    for part in range(parts):
        c = slice(part * ml, (part + 1) * ml)
        hidden = (m, part * ml)
        total = total + fk.ffn_forward_plain(
            x, None, w1[:, c], b1[c], w2[c], None, seeds, 0.4, 0.0,
            row_offset=roff, hidden=hidden)
        got = fk.ffn_backward_plain(x, dy, w1[:, c], b1[c], w2[c], seeds,
                                    0.4, 0.0, row_offset=roff,
                                    hidden=hidden)
        dx = dx + got[0]
        for a, b in ((got[1], wdx[1][:, c]), (got[2], wdx[2][c]),
                     (got[3], wdx[3][c])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, wdx[0], rtol=1e-5, atol=1e-5)
