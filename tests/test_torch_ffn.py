"""The port's feed-forward module (``ishara_tpu_torch/ops/ffn_kernel.py``,
whose plain version runs here on the CPU) against the JAX package's
``ffn_residual(interpret=True)`` at rate 0 on the same numpy inputs --
forward and all gradients, 2-D and 3-D -- and, with explicit masks, against
the oracle of ``tests/test_ffn_kernel.py``. Tolerances are that file's:
forward rtol 1e-5, atol 1e-6; gradients rtol 2e-4, atol 1e-5 (f32 on both
sides). At bf16 both sides round the hidden, g, d and dh to bf16 at the
same points: rtol = atol = 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.ops.ffn_kernel import ffn_residual as j_ffn_residual

from ishara_tpu_torch.ops import ffn_kernel as fk

NAMES = ["x", "res", "w1", "b1", "w2", "b2"]


def make_case(rng, shape=(32, 16), m=24):
    k = shape[-1]
    return [rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal((k, m)) * 0.3).astype(np.float32),
            (rng.standard_normal(m) * 0.1).astype(np.float32),
            (rng.standard_normal((m, k)) * 0.3).astype(np.float32),
            (rng.standard_normal(k) * 0.1).astype(np.float32)]


def oracle(x, res, w1, b1, w2, b2, keep1=None, keep2=None, rate1=0.0,
           rate2=0.0):
    """``reference`` of tests/test_ffn_kernel.py in PyTorch."""
    cd = x.dtype
    h = (x @ w1.to(cd)).float() + b1
    a = h * torch.sigmoid(h)
    if keep1 is not None:
        a = a * keep1 / (1.0 - rate1)
    y = (a.to(cd) @ w2.to(cd)).float() + b2
    if keep2 is not None:
        y = y * keep2 / (1.0 - rate2)
    return (res.float() + y).to(cd)


@pytest.mark.parametrize("shape", [(32, 16), (2, 8, 16)])
def test_rate0_forward_and_all_grads_match_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    args = make_case(rng, shape)
    dy = rng.standard_normal(shape).astype(np.float32)
    seeds = jnp.zeros((2,), jnp.int32)
    want, vjp = jax.vjp(
        lambda *a: j_ffn_residual(*a, seeds, 0.0, 0.0, True),
        *(jnp.asarray(a) for a in args))
    want_g = vjp(jnp.asarray(dy))

    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = fk.ffn_residual(*targs, torch.zeros(2, dtype=torch.int32), 0.0, 0.0)
    got_g = torch.autograd.grad(got, targs, torch.from_numpy(dy))
    assert got.shape == tuple(shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for a, b, name in zip(got_g, want_g, NAMES):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-5, err_msg=name)


def test_rate0_bf16_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    args = make_case(rng)
    seeds = jnp.zeros((2,), jnp.int32)
    jargs = [jnp.asarray(a, jnp.bfloat16 if i < 2 else jnp.float32)
             for i, a in enumerate(args)]
    want = j_ffn_residual(*jargs, seeds, 0.0, 0.0, True)
    targs = [torch.from_numpy(a).to(torch.bfloat16 if i < 2
                                    else torch.float32)
             for i, a in enumerate(args)]
    got = fk.ffn_residual(*targs, torch.zeros(2, dtype=torch.int32), 0.0, 0.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("rates", [(0.3, 0.2), (0.4, 0.0), (0.0, 0.25)])
def test_explicit_masks_match_the_oracle(rates):
    """Forward and all gradients of the plain kernels with given keep masks
    against autograd through the composition with the same masks."""
    r1, r2 = rates
    rng = np.random.default_rng(2)
    args = make_case(rng)
    n, k = args[0].shape
    m = args[2].shape[1]
    keep1 = torch.from_numpy(rng.random((n, m)) >= r1).float()
    keep2 = torch.from_numpy(rng.random((n, k)) >= r2).float()
    dy = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    want = oracle(*targs, keep1 if r1 else None, keep2 if r2 else None,
                  r1, r2)
    want_g = torch.autograd.grad(want, targs, dy)
    x, res, w1, b1, w2, b2 = (t.detach() for t in targs)
    got = fk.ffn_forward_plain(x, res, w1, b1, w2, b2, None, r1, r2,
                               keep1=keep1, keep2=keep2)
    dx, dw1, db1, dw2, db2 = fk.ffn_backward_plain(
        x, dy, w1, b1, w2, None, r1, r2, keep1=keep1, keep2=keep2)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b, name in zip((dx, dy, dw1, db1, dw2, db2), want_g, NAMES):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=name)


def test_philox_masks_drive_forward_and_backward_alike():
    """With dropout on, the wrapper equals the oracle fed ``debug_masks``
    of the same seeds, forward and every gradient: the backward regenerates
    the forward's masks."""
    r1, r2 = 0.4, 0.4
    rng = np.random.default_rng(3)
    args = make_case(rng, (4, 8, 16))
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    keep1, keep2 = fk.debug_masks(32, 24, 16, seeds, r1, r2)
    assert 0.4 < float(keep1.mean()) < 0.8 and not torch.equal(
        keep1[:, :16], keep2)
    dy = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = fk.ffn_residual(*targs, seeds, r1, r2)
    got_g = torch.autograd.grad(got, targs, dy)
    flat = [targs[0].reshape(32, 16), targs[1].reshape(32, 16)] + targs[2:]
    want = oracle(*flat, keep1, keep2, r1, r2).reshape(4, 8, 16)
    want_g = torch.autograd.grad(want, targs, dy)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b, name in zip(got_g, want_g, NAMES):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=name)


def test_kernel_takes_and_argument_checks():
    # the kernel takes f32 and bf16 at any widths, and nothing else
    seeds = torch.zeros(2, dtype=torch.int32)
    for dtype, k, m in ((torch.bfloat16, 256, 512), (torch.float32, 256, 512),
                        (torch.bfloat16, 64, 128), (torch.float32, 20, 36)):
        fk._check_cuda(torch.zeros(4, k, dtype=dtype), torch.zeros(k, m),
                       seeds)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fk._check_cuda(torch.zeros(4, 16, dtype=torch.float16),
                       torch.zeros(16, 24), seeds)
    with pytest.raises(ValueError, match="seeds"):
        fk._check_cuda(torch.zeros(4, 16), torch.zeros(16, 24), seeds[:1])
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="res"):
        fk.ffn_residual(x, torch.zeros(4, 8), torch.zeros(16, 24),
                        torch.zeros(24), torch.zeros(24, 16), torch.zeros(16),
                        torch.zeros(2, dtype=torch.int32), 0.0, 0.0)
