"""Quantization-aware training in the port (``ishara_tpu_torch/train/
qat.py``) against the JAX package's (``tests/test_qat.py``): the
fake-quantizer against the int8 export's quantize -> dequantize on every
leaf the export quantizes, the straight-through gradient, one QAT train
step and the QAT eval step against JAX's from the same bridged weights, and
a short overfit run.

Tolerances: the fake-quantized weights bit for bit (the reference test's
``atol=1e-7`` is not needed); the step at ``test_torch_train_step.py``'s
(loss and gradient norm rtol 1e-4, parameters atol 2e-6, ...); ids and
counts exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.preprocess import GroupStats as JGroupStats
from ishara_tpu.serve.export import _dequantize_tree, _quantize_tree
from ishara_tpu.train import make_fused_ctc_eval_step as j_make_eval
from ishara_tpu.train import make_fused_ctc_train_step as j_make_fused

from ishara_tpu_torch import config as tconfig
from ishara_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.models import layers as tlayers
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.serve import export as texport
from ishara_tpu_torch.train import (
    TrainState,
    make_fused_ctc_eval_step,
    make_fused_ctc_train_step,
    make_optimizer,
)
from ishara_tpu_torch.train.qat import (
    channel_axis,
    fake_quant,
    fake_quant_params,
    qat_weights,
)

from test_torch_train_step import (
    FRAME_LEN,
    assert_metrics_match,
    assert_states_match,
    setup,
)
from torch_port_helpers import jax_model, port_model, small_config, to_numpy


@pytest.mark.parametrize("variant", ["hybrid", "squeezeformer_unet"])
def test_fake_quant_matches_the_int8_export_bit_for_bit(variant):
    """Every >=2-D leaf, fake-quantized in the port's layout, equals the
    export's quantize -> dequantize of the flax tree bridged back: the
    bridged kernels per dim 0, the U-Net's ``u_bias`` / ``v_bias`` (kept
    in flax's layout) per last dim. 1-D leaves pass untouched."""
    cfg = small_config(variant, num_squeeze_blocks=3)
    _, variables = jax_model(cfg)
    want = flax_to_state_dict({"params": to_numpy(_dequantize_tree(
        _quantize_tree(variables["params"])))})
    params = dict(port_model(cfg, variables).named_parameters())
    got = fake_quant_params(params)
    assert set(got) == set(want)
    as_is = [n for n in params if n.endswith(("u_bias", "v_bias"))]
    if variant == "squeezeformer_unet":
        assert as_is and all(channel_axis(n) == -1 for n in as_is)
    quantized = 0
    for name, w in want.items():
        g = got[name].detach()
        assert torch.equal(g, w), name
        if params[name].dim() >= 2:
            quantized += 1
            assert not torch.equal(g, params[name].detach()), name
        else:
            assert got[name] is params[name], name
    assert quantized >= 10
    # the same leaves per dim 0 would not match (quantize_serving_weights'
    # rule, right for its stacks, wrong for these)
    for name in as_is:
        assert not torch.equal(fake_quant(params[name], 0), want[name])


def test_ste_gradient_is_exactly_the_cotangent():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 8)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 8)).astype(np.float32))
    (fake_quant(w, 0) * g).sum().backward()
    assert torch.equal(w.grad, g)
    # and through the swap of a model's parameters: the master weight
    lin = tlayers.Dense(8, 4)
    with qat_weights(lin):
        assert not isinstance(lin.weight, torch.nn.Parameter)
        lin(torch.ones(2, 8)).sum().backward()
    assert isinstance(lin.weight, torch.nn.Parameter)
    assert torch.equal(lin.weight.grad, torch.full((4, 8), 2.0))


def test_one_qat_train_step_matches_jax(monkeypatch):
    """From the same bridged weights, one fused QAT step of each package:
    loss, gradient norm, every parameter, slow weight, statistic and
    moment. The kernel paths are taken (as on a card): the fake-quantized
    weights reach the FFN and conv-module kernels' wrappers."""
    seen = {"ffn": [], "conv": []}
    ffn, conv = tlayers.ffn_residual, tlayers.conv_kernel.conv_module_residual

    def spy_ffn(x, res, w1, *a, **kw):
        seen["ffn"].append(w1.detach().clone())
        return ffn(x, res, w1, *a, **kw)

    def spy_conv(x, m, ln_s, ln_b, w1, *a, **kw):
        seen["conv"].append(w1.detach().clone())
        return conv(x, m, ln_s, ln_b, w1, *a, **kw)

    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers, "ffn_residual", spy_ffn)
    monkeypatch.setattr(tlayers.conv_kernel, "conv_module_residual", spy_conv)
    jstate, tstate, batch, _ = setup(dropout=0.0)
    for m in tstate.model.modules():   # f32 takes the composition unforced
        if isinstance(m, tlayers.SqueezeformerConvModule):
            m.fused = True
    master = tstate.param_dict()
    w1 = master["squeezeformer.0.ffn1.fc1.weight"].detach().clone()
    cw1 = master["squeezeformer.0.conv.pw1.weight"].detach().clone()
    jstep = jax.jit(j_make_fused(JGroupStats.identity(), FRAME_LEN,
                                 aug_prob=0.0, blank_id=59, qat=True))
    tstep = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                      aug_prob=0.0, blank_id=59, qat=True)
    jb = {k: jnp.asarray(batch[k]) for k in ("raw", "lengths", "labels")}
    jstate, jm = jstep(jstate, jb, jax.random.key(0))
    tstate, tm = tstep(tstate, batch, seed=0)
    assert_metrics_match(tm, jm)
    assert_states_match(tstate, jstate)
    # the kernels' wrappers saw the fake-quantized weights, not the master
    # ones (FusedFFN is not reached at dropout 0: only the conv module)
    assert seen["conv"], seen
    assert torch.equal(seen["conv"][0], fake_quant(cw1, 0)[:, :, 0].t())
    assert not torch.equal(seen["conv"][0], cw1[:, :, 0].t())
    # the master weights hold no quantized values after the step
    assert not torch.equal(tstate.param_dict()[
        "squeezeformer.0.ffn1.fc1.weight"], fake_quant(w1, 0))


def test_qat_step_reaches_the_ffn_kernel_with_quantized_weights(monkeypatch):
    """With dropout on, FusedFFN takes its kernel's wrapper, which reads the
    fake-quantized fc1 / fc2."""
    seen = []
    ffn = tlayers.ffn_residual

    def spy(x, res, w1, *a, **kw):
        seen.append(w1.detach().clone())
        return ffn(x, res, w1, *a, **kw)

    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers, "ffn_residual", spy)
    _, tstate, batch, _ = setup(dropout=0.1)
    w1 = tstate.param_dict()["squeezeformer.0.ffn1.fc1.weight"] \
        .detach().clone()
    step = make_fused_ctc_train_step(GroupStats.identity(), FRAME_LEN,
                                     aug_prob=0.0, qat=True)
    step(tstate, batch, seed=0)
    assert len(seen) == 4
    assert torch.equal(seen[0], fake_quant(w1, 0).t())


def test_qat_overfit_halves_the_loss():
    """``tests/test_qat.py``'s overfit: 60 QAT steps on eight short phrases
    halve the loss."""
    cfg = small_config("hybrid", dim=32, num_squeeze_blocks=1,
                       num_conform_blocks=1, frame_len=32,
                       transformer_kernel_size=7)
    jmodel, _ = jax_model(cfg)
    # the reference test's initial weights: flax's initialisation
    model = port_model(cfg, to_numpy(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 32, 276), jnp.float32))))
    ds = SyntheticASLFR(num_sequences=8, seed=0, max_phrase=4)
    batch = ds.batch(range(8), CTCTokenizer(), max_frames=48)
    tx, _ = make_optimizer(tconfig.TrainConfig(steps_per_epoch=5,
                                               lr_max=3e-3))
    state = TrainState.create(model, tx, device="cpu")
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=0.0, blank_id=cfg.blank_id,
                                     qat=True)
    losses = []
    for _ in range(60):
        state, m = step(state, batch, seed=0)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses[::10]


def test_qat_eval_step_is_the_int8_export_and_matches_jax():
    """The QAT eval step's ids and counts equal the plain eval step on the
    export's dequantized int8 weights, and JAX's QAT eval step."""
    jstate, tstate, batch, _ = setup(variant="squeezeformer")
    out = make_fused_ctc_eval_step(GroupStats.identity(), FRAME_LEN,
                                   qat=True)(tstate, batch)
    # the export's int8 weights, dequantized, in a plain model
    sd = tstate.model.state_dict()
    deq = texport._dequantize_tree(texport._map_leaves(
        torch.as_tensor, texport._quantize_tree(state_dict_to_flax(sd))))
    cfg = tstate.model.cfg
    qmodel = build_model(cfg, device="cpu")
    qmodel.load_state_dict(flax_to_state_dict(texport._map_leaves(
        lambda t: t.numpy(), deq)))
    qstate = TrainState.create(qmodel, tstate.tx, device="cpu")
    plain = make_fused_ctc_eval_step(GroupStats.identity(), FRAME_LEN)(
        qstate, batch)
    assert torch.equal(out["ids"], plain["ids"])
    assert torch.equal(out["counts"], plain["counts"])
    torch.testing.assert_close(out["loss_per_seq"], plain["loss_per_seq"],
                               rtol=0, atol=0)
    jout = j_make_eval(JGroupStats.identity(), FRAME_LEN, 59, qat=True)(
        jstate, {k: jnp.asarray(batch[k])
                 for k in ("raw", "lengths", "labels")})
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(jout["ids"]))
    np.testing.assert_array_equal(out["counts"].numpy(),
                                  np.asarray(jout["counts"]))
    np.testing.assert_allclose(out["loss_per_seq"].numpy(),
                               np.asarray(jout["loss_per_seq"]), rtol=1e-4)
