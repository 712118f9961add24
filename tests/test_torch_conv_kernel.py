"""The port's conv-module kernel (``ishara_tpu_torch/ops/conv_kernel.py``,
whose plain versions run here on the CPU) against the JAX package's
``conv_module_residual(interpret=True)`` on the same numpy inputs, at the
small shapes of ``tests/test_conv_kernel.py``: the forward and all twelve
gradients (x and the eleven parameters), K 3 to 63, a partial, a full and
an empty mask, f32 and bf16. f32: 2e-5 on the output (the JAX package's
own tolerance for its kernel against the composition), 2e-4 of the largest
entry on the gradients (sums over every row in another order); bf16: both
sides round xn, s, dp and du to bf16 at the same points, a last bit apart
before a rounding moves a value by a bf16 ulp (2^-8): 2e-2.

Then the layer: the port's ``SqueezeformerConvModule`` hands its own
parameters to the kernel in the reference's layouts (``kernel_args``), and
with the kernel paths taken on the CPU, ``fused=True`` reaches the wrapper
and never the composition, matching the JAX module's composition on the same
bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.models.layers import SqueezeformerConvModule as JModule
from ishara_tpu.ops.conv_kernel import conv_module_residual as j_conv

from ishara_tpu_torch.bridge import flax_to_state_dict
from ishara_tpu_torch.models import layers as tlayers
from ishara_tpu_torch.ops import conv_kernel as ck

from torch_port_helpers import perturb

NAMES = ("gamma", "beta", "w1", "b1", "wdw", "w2", "b2", "wf1", "bf1", "wf2",
         "bf2")
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-2)}


def make_case(rng, B, T, D, E, K, r, mask_kind):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    if mask_kind == "partial":
        lengths = rng.integers(T // 2, T + 1, size=B)
        lengths[-1] = 0                           # one empty sequence
    else:
        lengths = np.full(B, T if mask_kind == "full" else 0)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    p = {"gamma": 1.0 + 0.1 * rng.standard_normal(D),
         "beta": 0.1 * rng.standard_normal(D),
         "w1": rng.standard_normal((D, E)) / np.sqrt(D),
         "b1": 0.1 * rng.standard_normal(E),
         "wdw": rng.standard_normal((K, E)) / np.sqrt(K),
         "w2": rng.standard_normal((E, D)) / np.sqrt(E),
         "b2": 0.1 * rng.standard_normal(D),
         "wf1": rng.standard_normal((D, r)) / np.sqrt(D),
         "bf1": 0.1 * rng.standard_normal(r),
         "wf2": rng.standard_normal((r, D)) / np.sqrt(r),
         "bf2": 0.1 * rng.standard_normal(D)}
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    return x, mask, {k: v.astype(np.float32) for k, v in p.items()}, dy


def as_np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("B,T,D,E,K,r,mask_kind,dtype", [
    (4, 32, 64, 128, 7, 8, "partial", "float32"),
    (3, 16, 32, 64, 3, 4, "full", "float32"),
    (2, 24, 32, 64, 15, 4, "empty", "float32"),
    (4, 32, 64, 128, 15, 8, "partial", "bfloat16"),
    (3, 16, 32, 64, 3, 4, "full", "bfloat16"),
    # depthwise kernels wider than 32 taps (halos of 48 and 64 rows)
    (2, 40, 32, 64, 33, 4, "partial", "float32"),
    (2, 48, 32, 64, 63, 4, "partial", "bfloat16"),
])
def test_forward_and_all_gradients_match_pallas_interpret(
        B, T, D, E, K, r, mask_kind, dtype):
    x, mask, p, dy = make_case(np.random.default_rng(K + T), B, T, D, E, K, r,
                               mask_kind)
    jd = jnp.dtype(dtype)
    jm = jnp.asarray(mask)

    def jf(xx, *ps):
        return j_conv(xx, jm, *ps, True)

    want, vjp = jax.vjp(jf, jnp.asarray(x, jd),
                        *(jnp.asarray(p[n]) for n in NAMES))
    want_g = vjp(jnp.asarray(dy, jd))

    td = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tp = [torch.from_numpy(p[n]).requires_grad_() for n in NAMES]
    got = ck.conv_module_residual(tx, torch.from_numpy(mask), *tp)
    got_g = torch.autograd.grad(got, [tx] + tp, torch.from_numpy(dy).to(td))
    f_tol, g_tol = TOL[dtype]
    assert got.dtype == td and got_g[0].dtype == td
    np.testing.assert_allclose(as_np(got), np.asarray(want, np.float32),
                               rtol=f_tol, atol=f_tol)
    assert len(got_g) == len(want_g) == 12
    for name, a, b in zip(("x",) + NAMES, got_g, want_g):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(as_np(a), b, rtol=g_tol,
                                   atol=g_tol * max(np.abs(b).max(), 1e-6),
                                   err_msg=name)


def test_empty_sequence_pools_to_zero():
    """msum = max(sum mask, 1): an all-masked sequence gets the SE gate of
    a zero pool, finite, and its mask no gradient."""
    x, mask, p, dy = make_case(np.random.default_rng(5), 2, 12, 16, 32, 3, 4,
                               "empty")
    tp = [torch.from_numpy(p[n]) for n in NAMES]
    tm = torch.from_numpy(mask).requires_grad_()
    out = ck.conv_module_residual(torch.from_numpy(x), tm, *tp)
    args = ck._prep(torch.from_numpy(x), torch.from_numpy(mask), *tp)
    r = ck._branch(ck._ln(torch.from_numpy(x), args[1], args[2])[2], args[0],
                   torch.float32, *args[3:])
    assert bool(out.isfinite().all())
    assert torch.equal(r["pool"], torch.zeros_like(r["pool"]))
    assert torch.autograd.grad(out.sum(), tm, allow_unused=True)[0] is None


def _modules(D, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 20, D)).astype(np.float32)
    mask = np.arange(20)[None, :] < np.array([20, 9, 0])[:, None]
    jm = JModule(D, K, 2)
    variables = perturb(jm.init(jax.random.key(0), jnp.asarray(x),
                                mask=jnp.asarray(mask)))
    tm = tlayers.SqueezeformerConvModule(D, K, 2)
    tm.load_state_dict(flax_to_state_dict(variables))
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return jm, variables, tm, x, mask, dy


@pytest.mark.parametrize("K", [3, 15])
def test_layout_mapping_feeds_the_kernel_the_reference_weights(K):
    """``kernel_args`` of the port's module, fed to the plain version, gives
    the JAX module's composition (forward 2e-5) on the same bridged
    weights, and the gradients reach the module's parameters."""
    jm, variables, tm, x, mask, dy = _modules(32, K)
    want = jm.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask))
    tx = torch.from_numpy(x)
    args = tm.kernel_args(tx, torch.from_numpy(mask))
    assert tuple(args[3].shape) == (32, 64) and tuple(args[5].shape) == (K, 64)
    assert tuple(args[6].shape) == (64, 32) and tuple(args[8].shape) == (32, 4)
    got = ck.conv_module_residual(tx, *args)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    got.backward(torch.from_numpy(dy))
    for name, p in tm.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
    ones = tm.kernel_args(tx)[0]
    assert torch.equal(ones, torch.ones((3, 20)))


def test_fused_module_reaches_the_wrapper_and_never_the_composition(
        monkeypatch):
    """With the kernel paths taken (as on a CUDA tensor), ``fused=True``
    in training calls the wrapper once with the module's parameters and
    runs none of the composition's layers; output and input gradient match
    the JAX module (2e-5 / 2e-4). ``fused=False``, ``fused=None`` where
    the table says False, and eval keep the composition."""
    jm, variables, tm, x, mask, dy = _modules(32, 15, seed=1)
    want, vjp = jax.vjp(lambda a: jm.apply(variables, a,
                                           mask=jnp.asarray(mask)),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    calls = []
    wrapper = ck.conv_module_residual

    def spy(*a):
        calls.append(a[0].shape)
        return wrapper(*a)

    def composition(*a, **kw):
        raise AssertionError("the composition ran")

    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers.conv_kernel, "conv_module_residual", spy)
    tm.fused = True
    for m in (tm.norm, tm.pw1, tm.dw, tm.pw2, tm.se):
        monkeypatch.setattr(m, "forward", composition)
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, torch.from_numpy(mask), training=True)
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(dy))
    assert calls == [(3, 20, 32)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(AssertionError, match="composition"):
        tm(tx, torch.from_numpy(mask), training=False)
    # every row of the table takes the kernel: None reads a table that says
    # False here
    monkeypatch.setattr(tlayers.selection, "conv_module_fused",
                        lambda *a: False)
    for fused in (False, None):
        tm.fused = fused
        with pytest.raises(AssertionError, match="composition"):
            tm(tx, torch.from_numpy(mask), training=True)
    assert calls == [(3, 20, 32)]


# ---------------------------------------------------------------------------
# The tile plan of csrc/conv_module.cu (which tile, halo, channel chunk and
# shared memory each launch takes) and the row splits of the weight products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,D,K,dtype,backward,want", [
    # the long step's geometry: 64-row tiles, a 16-row halo
    (512, 256, 15, torch.bfloat16, False, (0, 64, 16, 64, 8)),
    (512, 256, 15, torch.bfloat16, True, (0, 64, 16, 32, 8)),
    # the flagship's T, a tile that T does not divide, T below the halo
    (176, 256, 15, torch.bfloat16, True, (0, 64, 16, 32, 3)),
    (13, 256, 15, torch.bfloat16, False, (0, 64, 16, 64, 1)),
    (1, 64, 15, torch.bfloat16, True, (0, 64, 16, 32, 1)),
    # the halo is K rounded up to 16: 31 taps 32 rows, 17 taps 32, 3 taps
    # and one tap 16
    (200, 256, 31, torch.bfloat16, True, (0, 64, 32, 32, 4)),
    (200, 256, 17, torch.bfloat16, False, (0, 64, 32, 64, 4)),
    (77, 48, 3, torch.bfloat16, False, (0, 64, 16, 64, 2)),
    (40, 64, 1, torch.float32, False, (0, 64, 16, 32, 1)),
    # f32 backward: 32-row tiles; with 31 taps shared memory takes 16 rows
    (512, 256, 15, torch.float32, True, (0, 32, 16, 16, 16)),
    (512, 256, 31, torch.float32, True, (1, 16, 32, 16, 32)),
    # D above 256: 16-row tiles, the accumulator 512 wide
    (512, 512, 15, torch.bfloat16, True, (1, 16, 16, 32, 32)),
    (512, 144, 15, torch.bfloat16, True, (0, 64, 16, 32, 8)),
])
def test_tile_plan(T, D, K, dtype, backward, want):
    plan = ck.tile_plan(T, D, K, dtype, backward)
    got = tuple(plan[k] for k in ("config", "tile_rows", "halo", "chunk",
                                  "tiles"))
    assert got == want
    assert plan["smem"] <= ck.SMEM_LIMIT
    assert plan["tiles"] * plan["tile_rows"] >= T


def test_tile_plan_shared_memory_and_the_general_path():
    # bf16 forward at [*, 512, 256], K 15: xn 80 x 264 bf16, a 80 x 65 f32,
    # s 64 x 72 bf16, the w1 chunk 256 x 72, the w2 chunk 64 x 264, the
    # chunk's 32 x 64 f32 taps and 64 biases, each region rounded up to 128
    # bytes
    assert ck.tile_smem(torch.bfloat16, False, 4, 64, 256, 15) == \
        42240 + 20864 + 9216 + 36864 + 33792 + 8192 + 256
    assert ck.tile_plan(512, 256, 15, torch.bfloat16, True)["smem"] == 192384
    # widths that no tile holds take the chain of row kernels, both ways in
    # the backward when either plan is missing
    assert ck.tile_plan(512, 768, 15, torch.bfloat16, False) is None
    assert ck.tile_plan(512, 512, 15, torch.float32, True) is None
    x = torch.zeros((2, 40, 512), dtype=torch.float32)
    assert ck._configs(x, 15, False) == (1, -1)
    assert ck._configs(x, 15, True) == (-1, -1)
    x = torch.zeros((2, 40, 256), dtype=torch.bfloat16)
    assert ck._configs(x, 15, True) == (0, 0)


@pytest.mark.parametrize("K", [33, 48, 63])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
def test_tile_plan_takes_wide_depthwise_kernels(K, dtype, backward):
    """Beyond 32 taps the halo is K rounded up to 16 rows and the taps
    buffer K rounded up to 32 (so at K <= 32 every plan is the one the
    kernel took before); each plan fits in shared memory and has a halo of
    at most twice its tile's rows, or there is none and the call takes the
    general path, which takes any K."""
    assert ck.halo_rows(K) == -(-K // 16) * 16 and ck.taps_rows(K) == 64
    assert ck.taps_rows(15) == ck.taps_rows(32) == 32
    for D in (32, 64, 144, 256, 512, 768):
        plan = ck.tile_plan(176, D, K, dtype, backward)
        if plan is None:
            continue
        mtp, _, ec = ck._TILE_CONFIGS[(dtype, backward)][plan["config"]]
        assert plan["smem"] == ck.tile_smem(dtype, backward, mtp, ec, D, K)
        assert plan["smem"] <= ck.SMEM_LIMIT
        assert plan["halo"] == ck.halo_rows(K)
        assert plan["halo"] <= 2 * plan["tile_rows"]
    # the flagship's width in bf16: the 64-row tile forward; backward the
    # 16-row tile fits but its halo of 48 or 64 rows is too tall
    if dtype == torch.bfloat16:
        assert ck.tile_plan(176, 256, K, dtype, False)["tile_rows"] == 64
        assert ck.tile_plan(176, 256, K, dtype, True) is None
    x = torch.zeros((2, 40, 768), dtype=dtype)
    assert ck._configs(x, K, backward) == (-1, -1)


@pytest.mark.parametrize("n,p,q,want", [
    (131072, 256, 512, 33),     # K7's dw1 / dw2 at the long step
    (45056, 256, 512, 33),      # K4's at the flagship step
    (40, 128, 256, 2),          # one split a 32-row step at most
    (64, 4096, 4096, 1),        # more tiles than the target: one split
])
def test_weight_product_splits(n, p, q, want):
    from ishara_tpu_torch.ops.ffn_kernel import wgrad_splits

    assert wgrad_splits(n, p, q) == want == wgrad_splits(n, q, p)
