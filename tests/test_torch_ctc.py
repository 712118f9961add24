"""The port's CTC loss (``ishara_tpu_torch/ops/ctc.py``, the composite, and
``ops/ctc_kernel.py``, the forward-backward module whose plain version runs
here on the CPU) against the JAX package's ``ctc_loss(impl="scan")`` and its
Pallas kernel in interpret mode, on the same numpy inputs: value and
gradient. Tolerances are the JAX package's own for kernel against scan
(``tests/test_ctc_kernel.py``): value rtol = atol = 2e-5, gradient rtol 2e-4,
atol 2e-5 (f32 on both sides; the recursions sum in another order). Against
``torch.nn.functional.ctc_loss`` rtol 1e-4, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.ops.ctc import ctc_loss as j_ctc_loss
from ishara_tpu.ops.ctc_kernel import ctc_loss_kernel as j_ctc_loss_kernel

from ishara_tpu_torch.ops.ctc import ctc_loss
from ishara_tpu_torch.ops.ctc_kernel import ctc_loss_kernel

BLANK = 7
C = 8


def rand_case(rng, B, T, U, repeat_heavy=False):
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    label_lens = rng.integers(0, U + 1, size=B).astype(np.int32)
    labels = np.full((B, U), BLANK, np.int32)
    for b in range(B):
        alphabet = [0, 1] if repeat_heavy else list(range(C - 1))
        labels[b, : label_lens[b]] = rng.choice(alphabet, size=label_lens[b])
    return logits, labels


def port_value_and_grad(fn, logits):
    x = torch.from_numpy(logits).requires_grad_()
    val = fn(x)
    (grad,) = torch.autograd.grad(val.sum(), x)
    return val.detach().numpy(), grad.numpy()


CASES = [
    (4, 12, 5, False),
    (4, 12, 5, True),     # repeated labels: skip transitions disallowed
    (2, 9, 4, False),
    (8, 16, 1, False),    # includes empty-label rows
]


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("B,T,U,repeat_heavy", CASES)
def test_loss_and_grad_match_jax_scan(B, T, U, repeat_heavy, impl):
    rng = np.random.default_rng(42 + B + T + int(repeat_heavy))
    logits, labels = rand_case(rng, B, T, U, repeat_heavy)
    want, want_g = jax.value_and_grad(
        lambda lg: j_ctc_loss(lg, jnp.asarray(labels), blank_id=BLANK,
                              impl="scan"))(jnp.asarray(logits))
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss(lg, torch.from_numpy(labels), blank_id=BLANK,
                            impl=impl), logits)
    np.testing.assert_allclose(got, float(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=2e-4,
                               atol=2e-5)


def test_kernel_module_at_1024_frames_matches_jax_scan():
    """T 1024 (B 2, C 8, U 16), beyond the ~950 frames the card kernel's
    earlier [T, C] slab in shared memory allowed: the module's plain
    version against the JAX scan and the JAX package's own Pallas kernel on
    the same inputs. The value holds the module's 2e-5. The gradient is
    the occupancy identity exp(alpha + beta - logP) in f32, and at this
    length |logP| ~ 2300, where one f32 ulp is 2.4e-4: the reference's own
    kernel is 1.01e-3 from its scan (measured), so the gradient is held to
    the reference kernel at the module's tolerances (rtol 2e-4, atol
    2e-5; measured 5.7e-6) and to the scan at atol 2e-3."""
    rng = np.random.default_rng(1024)
    logits, labels = rand_case(rng, 2, 1024, 16)
    want, want_g = jax.value_and_grad(
        lambda lg: j_ctc_loss(lg, jnp.asarray(labels), blank_id=BLANK,
                              impl="scan"))(jnp.asarray(logits))
    want_k = jax.grad(
        lambda lg: j_ctc_loss_kernel(lg, jnp.asarray(labels),
                                     blank_id=BLANK))(jnp.asarray(logits))
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss_kernel(lg, torch.from_numpy(labels),
                                   blank_id=BLANK), logits)
    np.testing.assert_allclose(got, float(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_k), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=0, atol=2e-3)


@pytest.mark.parametrize("B,T,U,repeat_heavy", CASES[:2])
def test_kernel_module_matches_pallas_interpret(B, T, U, repeat_heavy):
    """The port's forward-backward module against the Pallas kernel itself
    (interpret mode, as the JAX package's tests run it on the CPU)."""
    rng = np.random.default_rng(7 + int(repeat_heavy))
    logits, labels = rand_case(rng, B, T, U, repeat_heavy)
    want, want_g = jax.value_and_grad(
        lambda lg: j_ctc_loss_kernel(lg, jnp.asarray(labels),
                                     blank_id=BLANK))(jnp.asarray(logits))
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss_kernel(lg, torch.from_numpy(labels),
                                   blank_id=BLANK), logits)
    np.testing.assert_allclose(got, float(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_reductions_match(reduction, impl):
    rng = np.random.default_rng(0)
    logits, labels = rand_case(rng, 4, 12, 5)
    want = j_ctc_loss(jnp.asarray(logits), jnp.asarray(labels),
                      blank_id=BLANK, reduction=reduction, impl="scan")
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                   blank_id=BLANK, reduction=reduction, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_all_blank_labels_row(impl):
    """A row whose label is entirely blank gives the JAX package's loss and
    gradient (the port needs no padded batch for it)."""
    rng = np.random.default_rng(1)
    logits, labels = rand_case(rng, 2, 8, 3)
    labels[0] = BLANK
    want, want_g = jax.value_and_grad(
        lambda lg: j_ctc_loss(lg, jnp.asarray(labels), blank_id=BLANK,
                              impl="scan"))(jnp.asarray(logits))
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss(lg, torch.from_numpy(labels), blank_id=BLANK,
                            impl=impl), logits)
    assert np.isfinite(got) and np.isfinite(got_g).all()
    np.testing.assert_allclose(got, float(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=2e-4,
                               atol=2e-5)


def test_explicit_lengths_match():
    """Explicit logit and label lengths go through the composite, whatever
    ``impl="auto"`` would choose for the training contract."""
    rng = np.random.default_rng(3)
    logits, labels = rand_case(rng, 4, 14, 5)
    labels = rng.integers(0, C - 1, size=labels.shape).astype(np.int32)
    logit_lens = np.array([14, 10, 7, 12], np.int32)
    label_lens = np.array([3, 5, 0, 2], np.int32)
    want, want_g = jax.value_and_grad(
        lambda lg: j_ctc_loss(lg, jnp.asarray(labels),
                              jnp.asarray(logit_lens),
                              jnp.asarray(label_lens), blank_id=BLANK,
                              reduction="sum"))(jnp.asarray(logits))
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss(lg, torch.from_numpy(labels),
                            torch.from_numpy(logit_lens),
                            torch.from_numpy(label_lens), blank_id=BLANK,
                            reduction="sum"), logits)
    np.testing.assert_allclose(got, float(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_matches_torch_ctc_loss(impl):
    rng = np.random.default_rng(4)
    logits, labels = rand_case(rng, 6, 20, 6, repeat_heavy=True)
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss(lg, torch.from_numpy(labels), blank_id=BLANK,
                            reduction="none", impl=impl), logits)
    x = torch.from_numpy(logits).requires_grad_()
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.full((6,), 20),
        torch.from_numpy((labels != BLANK).sum(1)), blank=BLANK,
        reduction="none")
    (want_g,) = torch.autograd.grad(want.sum(), x)
    np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_g, want_g.numpy(), rtol=1e-4, atol=1e-4)


def test_auto_uses_the_composite_on_a_cpu_tensor():
    rng = np.random.default_rng(2)
    logits, labels = rand_case(rng, 2, 8, 3)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    auto = ctc_loss(x, y, blank_id=BLANK)
    scan = ctc_loss(x, y, blank_id=BLANK, impl="scan")
    assert float(auto) == float(scan)
    with pytest.raises(ValueError, match="impl"):
        ctc_loss(x, y, blank_id=BLANK, impl="pallas")
