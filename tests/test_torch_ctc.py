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


def short_labels_case(rng, B, T, U, lengths):
    """Rows with the given label lengths under a long U (a row's 2L + 1
    states far below S = 2U + 1), repeats among them."""
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = np.full((B, U), BLANK, np.int32)
    for b, n in enumerate(lengths):
        labels[b, :n] = rng.choice([0, 1, 2], size=n)
    return logits, labels


@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("T,lengths", [(40, (0, 1, 2, 3, 5, 4)),
                                       (17, (3, 0, 8, 2))])
def test_kernel_module_on_short_labels_under_a_long_U(T, lengths, ref):
    """The plain recursions, which step every state and hold the states past
    2L at -1e30 (occupancy 0), give what the JAX package gives on rows that
    use a few of U = 24 labels, an all-blank row and repeats: the kernels
    step only a row's own states, so these are the rows where the two
    designs part."""
    rng = np.random.default_rng(T + len(lengths))
    logits, labels = short_labels_case(rng, len(lengths), T, 24, lengths)
    if ref == "scan":
        fn = lambda lg: j_ctc_loss(lg, jnp.asarray(labels),  # noqa: E731
                                   blank_id=BLANK, impl="scan")
    else:
        fn = lambda lg: j_ctc_loss_kernel(  # noqa: E731
            lg, jnp.asarray(labels), blank_id=BLANK)
    want, want_g = jax.value_and_grad(fn)(jnp.asarray(logits))
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss_kernel(lg, torch.from_numpy(labels),
                                   blank_id=BLANK), logits)
    np.testing.assert_allclose(got, float(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=2e-4,
                               atol=2e-5)


def test_kernel_module_at_512_frames_matches_jax_scan():
    """T 512, the long training step's frames (B 2, C 8, U 16): value at the
    module's 2e-5, gradient at the 2e-3 the 1024-frame test states for rows
    beyond a few hundred frames (|logP| ~ 1100 here, where one f32 ulp of
    gamma is 1.2e-4)."""
    rng = np.random.default_rng(512)
    logits, labels = rand_case(rng, 2, 512, 16)
    want, want_g = jax.value_and_grad(
        lambda lg: j_ctc_loss(lg, jnp.asarray(labels), blank_id=BLANK,
                              impl="scan"))(jnp.asarray(logits))
    got, got_g = port_value_and_grad(
        lambda lg: ctc_loss_kernel(lg, torch.from_numpy(labels),
                                   blank_id=BLANK), logits)
    np.testing.assert_allclose(got, float(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=0, atol=2e-3)


def test_plain_backward_reads_alpha_at_the_valid_states_only():
    """The forward kernel writes alpha at a row's 2L + 1 states and leaves
    the rest of its [B, T, S] buffer unwritten: the plain backward gives the
    same gradient whatever lies there."""
    from ishara_tpu_torch.ops import ctc_kernel as ck

    rng = np.random.default_rng(5)
    logits, labels = short_labels_case(rng, 3, 20, 6, (2, 0, 6))
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    nll, alpha = ck.ctc_forward_plain(x, y, BLANK)
    dy = torch.tensor([0.5, 1.0, 2.0])
    want = ck.ctc_backward_plain(x, y, alpha, nll, dy, BLANK)
    n = 2 * (y != BLANK).sum(1) + 1
    dead = torch.arange(alpha.shape[2])[None, None, :] >= n[:, None, None]
    junk = torch.where(dead, torch.tensor(float("nan")), alpha)
    junk2 = torch.where(dead, torch.tensor(3e38), alpha)
    assert torch.equal(ck.ctc_backward_plain(x, y, junk, nll, dy, BLANK), want)
    assert torch.equal(ck.ctc_backward_plain(x, y, junk2, nll, dy, BLANK),
                       want)


def first_design_fits(T, C, U):
    """The guard of the first card kernel (lse [T], the states' and the
    classes' buffers in one block's shared memory, 1024 threads of up to 32
    states)."""
    S = 2 * U + 1
    words = T + 2 * (S + 2) + 2 * S + 2 * S + C + 1 + 32
    return T >= 1 and S <= 1024 * 32 and words * 4 <= 227 * 1024


@pytest.mark.parametrize("T,C", [(1, 1), (176, 60), (512, 60), (2048, 60),
                                 (20, 1000), (1, 2)])
def test_guard_takes_every_geometry_the_first_design_took(T, C):
    """Every label count the first kernel took at these T and C (it took at
    most S = 9677 states, at T 1 and C 1), and the widest C and T it took
    with few labels, the new guard takes too: T and C no longer bound shared
    memory."""
    from ishara_tpu_torch.ops import ctc_kernel as ck

    took = [U for U in range(0, 16384) if first_design_fits(T, C, U)]
    assert took and all(ck.ctc_fits(T, C, U) for U in took)
    U = 5
    widest_c = 58112 - 37 - T - 6 * (2 * U + 1)
    assert first_design_fits(T, widest_c, U) and ck.ctc_fits(T, widest_c, U)
    longest_t = 58112 - 37 - C - 6 * (2 * U + 1)
    assert first_design_fits(longest_t, C, U)
    assert ck.ctc_fits(longest_t, C, U) and ck.ctc_fits(10 ** 6, C, U)


@pytest.mark.parametrize("U", [0, 5, 15, 31, 63, 64, 127, 128, 600, 1152,
                               2000, 4838])
@pytest.mark.parametrize("backward", [False, True])
def test_plan_fits_a_block(U, backward):
    """The launch plan's shared memory fits a block (two an SM at the
    training step's 64 labels, where the logits are staged in 16-frame
    chunks four deep), its threads fit a block, and its chain covers 2U + 1
    states."""
    from ishara_tpu_torch.ops import ctc_kernel as ck

    for C in (8, 60, 1000, 40000):
        K, W, tc, ns, stage, nbytes = ck.ctc_plan(U, C, backward)
        helpers = ns + (ck.GRAD_WARPS if backward else 0)
        assert nbytes <= ck.SMEM_LIMIT and 32 * (W + helpers) <= 1024
        assert 32 * K * W >= 2 * U + 1 and (K, W) == ck.chain_shape(2 * U + 1)
        assert ns in (2, 4) and tc in (1, 2, 4, 8, 16)
        if U == 64 and C == 60:
            assert (K, W, tc, ns, stage) == (5, 1, 16, 4, 1)
            assert nbytes <= ck.SMEM_PAIR
