"""The port's CUDA kernels on the card against their plain PyTorch versions.

These tests need a CUDA card and skip without one. They import neither
``jax`` nor the JAX package, so they also run on a machine that has only
PyTorch (``conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small shapes (dim 64, 4 heads of 16, T = 24 or 23 with a padded tail, conv
kernel sizes 7 and 3) that the main paths' widths do not reach, and the
published Squeezeformer widths that are not multiples of 32 (dim 144 with 4
heads of 36, dim 196 with 4 heads of 49), for every kernel form: block
stacks and conv groups, f32 / bf16 / int8 storage, one launch a stage or the
persistent ``dma=True`` kernel, and dim 324 (M: an FFN of 1296, deeper
than a GEMM tile's panel, runs in chunks); a second launch gives the same
bits, and the kernel's report (stages counted on the device) is
``stack_plan``'s. Tolerances, per element |got - want| <=
tol + tol * |want|: kernel against plain version 1e-3 at f32 storage (f32
on both sides, sums in another order) and 1e-2 at bf16 (the same bf16
rounding points, where a last-bit difference before a rounding can move a
value by one bf16 ulp); the whole fused forward against the unfused model
1e-3 at f32 storage and 5e-2 at bf16 and int8 (int8 against the model on the
dequantized weights), the JAX package's own tolerance for its fused forward.
"""

import math
import re

import numpy as np
import pytest
import torch

from ishara_tpu_torch.config import EncoderConfig
from ishara_tpu_torch.models import fused
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.ops import fused_block as fb

DTYPES = {"f32": (torch.float32, 1e-3, 1e-3),
          "bf16": (torch.bfloat16, 1e-2, 5e-2),
          "int8": ("int8", 1e-2, 5e-2)}
SEGMENTS = {"hybrid": ("squeezeformer", "conformer"),
            "conv_hybrid": ("squeezeformer", "conformer"),
            "conv_transformer": ("transformer",)}


def _model(variant, T, dim=64):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EncoderConfig(variant=variant, dim=dim, num_heads=4,
                        num_squeeze_blocks=2, num_conform_blocks=2,
                        kernel_sizes=(7, 3), num_conv_per_block=2,
                        frame_len=T)
    m = build_model(cfg, device="cuda")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            n = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                n = 0.5 + torch.rand(t.shape, generator=g)
            elif name.endswith("weight") and t.dim() >= 2:
                n = n / math.sqrt(t[0].numel())
            elif name.endswith("weight"):
                n = 1.0 + 0.1 * n
            else:
                n = 0.1 * n
            t.copy_(n)
    return m


def _inputs(T, dim):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, dim)).astype(np.float32))
    return x.cuda(), (torch.arange(T) < T - 5).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 144, 196, 324])
@pytest.mark.parametrize("T", [24, 23])
@pytest.mark.parametrize("dma", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("variant,kind", [
    (v, k) for v, kinds in SEGMENTS.items() for k in kinds])
def test_kernel_matches_plain(variant, kind, dt, dma, T, dim):
    """Every stack kernel -- block stacks and conv groups, each storage, as
    launches and as the persistent kernel, even and odd T, widths that are
    and are not multiples of 32 -- against its plain version; a second
    launch equals the first and the persistent form equals the launches, bit
    for bit; the kernel ran the stages and launches of its plan."""
    tdt, tol, _ = DTYPES[dt]
    model = _model(variant, T, dim)
    sd = model.state_dict()
    if dt == "int8":
        sd = fb.quantize_serving_weights(sd)
    conv, leaves = fused.encoder_segment_args(model.cfg, sd, kind, tdt)
    x, mask = _inputs(T, model.cfg.dim)
    heads = model.cfg.num_heads
    if variant == "hybrid":
        fn = {"squeezeformer": fb.fused_squeezeformer_stack,
              "conformer": fb.fused_conformer_stack}[kind]

        def run(dma):
            return fn(x, mask, leaves, num_heads=heads, dma=dma)
    else:
        fn = fb.fused_conv_group_stack

        def run(dma):
            return fn(x, mask, (conv, leaves), kind, num_heads=heads, dma=dma)
    before = fn.launches
    got = run(dma)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    report = fb.stack_report()  # stages counted on the device
    plan = report["plan"]
    assert (report["stages"], report["launches"]) == (
        plan["stages"], 1 if dma else plan["stages"])
    want = fb.group_stack_plain(x, mask, (conv, leaves), kind, heads)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(got, run(dma))
    if dma:
        assert torch.equal(got, run(False))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 144, 196])
@pytest.mark.parametrize("dma", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("variant", list(SEGMENTS))
def test_fused_forward_matches_model(variant, dt, dma, dim):
    T = 24
    tdt, _, tol = DTYPES[dt]
    model = _model(variant, T, dim)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, model.cfg.input_dim)).astype(np.float32)
    x[T - 5:] = 0.0  # padding frames
    x = torch.from_numpy(x).cuda()
    sd = model.state_dict()
    if dt == "int8":  # against the model on the dequantized weights
        sd = fb.quantize_serving_weights(sd)
        model.load_state_dict(fb.dequantize_serving_weights(sd))
    got = fused.fused_encoder_forward(model.cfg, sd, x, compute_dtype=tdt,
                                   dma=dma, device="cuda")
    with torch.no_grad():
        want = model(x[None])[0]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,heads", [(256, 8), (144, 4)])
@pytest.mark.parametrize("dma", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("variant,kind", [
    (v, k) for v, kinds in SEGMENTS.items() for k in kinds])
def test_kernel_reports_its_plan(variant, kind, dt, dma, dim, heads):
    """At the main paths' widths (dim 256, 8 heads, T 176, 2 groups) and at
    dim 144 the launch reports what ``stack_plan`` of the geometry says:
    the stages as the kernel counted them on the device, the launches and
    the largest shared memory of a stage as its C side issued them, and at
    ``dma=True`` a grid no larger than the card holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = EncoderConfig(variant=variant, dim=dim, num_heads=heads,
                        num_squeeze_blocks=2, num_conform_blocks=2,
                        kernel_sizes=(11, 5, 3), num_conv_per_block=3)
    model = build_model(cfg, device="cuda")
    sd = model.state_dict()
    if dt == "int8":
        sd = fb.quantize_serving_weights(sd)
    conv, leaves = fused.encoder_segment_args(cfg, sd, kind, DTYPES[dt][0])
    x, mask = _inputs(176, dim)
    fb.fused_conv_group_stack(x, mask, (conv, leaves), kind,
                              num_heads=heads, dma=dma)
    report = fb.stack_report()
    by_name = dict(zip((n for n, _, _ in fb.INNER[kind][1]), leaves))

    def width(w):
        return 0 if w is None else (w[0] if isinstance(w, tuple) else w
                                    ).shape[-1]

    plan = fb.stack_plan(
        kind, T=176, dim=dim, heads=heads,
        ffn=width(by_name.get("f1w1", by_name.get("f1w"))),
        expand=width(by_name.get("pw1w")) if kind == "squeezeformer" else 0,
        se=width(by_name.get("se1w")),
        conv_width=width(conv[0][0]) if conv else 0, nconv=len(conv),
        nblocks=2, storage=DTYPES[dt][0])
    assert report["plan"] == plan
    assert report["stages"] == report["stages_issued"] == plan["stages"]
    assert report["launches"] == (1 if dma else plan["launches"])
    assert report["smem_bytes"] == plan["smem_bytes"]
    assert report["cluster"] == plan["cluster"] == 1
    if dma:
        blocks, per_sm = report["grid"]
        props = torch.cuda.get_device_properties(0)
        assert 1 <= blocks <= per_sm * props.multi_processor_count


# ---------------------------------------------------------------------------
# Training kernels, at shapes the training step does not reach. Tolerances
# as chip_smoke.py's: |kernel - plain| <= tol * (max|plain| + |plain|) with
# tol 2e-4 at f32 (another summation order, the card's expf / logf), 2e-2 at
# bf16 (one bf16 ulp where a last bit differs before a rounding); dropout
# exact.
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert bool(got.isfinite().all())
    bound = tol * (want.abs().max() + want.abs())
    assert bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max())


def _ctc_case(ck, logits, labels, dy, blank):
    """One forward and backward launch of K1, held to the plain recursions
    (the gradient's tolerance: 2e-4 up to T 256, 2e-3 beyond, see below) and
    to a second launch bit for bit; the wrapper counts one launch each."""
    T = logits.shape[1]
    before = (ck.ctc_loss_kernel.launches, ck.ctc_loss_kernel.launches_bwd)
    nll = ck.ctc_loss_kernel(logits, labels, blank_id=blank, reduction="none")
    (grad,) = torch.autograd.grad(nll, logits, dy)
    nll2 = ck.ctc_loss_kernel(logits, labels, blank_id=blank,
                              reduction="none")
    (grad2,) = torch.autograd.grad(nll2, logits, dy)
    torch.cuda.synchronize()
    assert (ck.ctc_loss_kernel.launches, ck.ctc_loss_kernel.launches_bwd) \
        == (before[0] + 2, before[1] + 2)
    assert torch.equal(nll, nll2) and torch.equal(grad, grad2)
    x = logits.detach()
    want, alpha = ck.ctc_forward_plain(x, labels, blank)
    _close(nll, want, 2e-5)
    # the gradient is exp(alpha + beta - logP) in f32 on both sides; beyond
    # a few hundred frames |logP| is in the thousands, where an f32 ulp is
    # ~2.4e-4, and one ulp of gamma moves an occupancy by as much (3.1e-4
    # measured on an H100 at T 1024; the JAX package's own kernel is 1.0e-3
    # from its scan there): 2e-3 for T > 256, 2e-4 below
    _close(grad, ck.ctc_backward_plain(x, labels, alpha, want, dy, blank),
           2e-4 if T <= 256 else 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,C", [(3, 12, 5, 8), (2, 9, 1, 8),
                                     (5, 40, 17, 33), (3, 1024, 64, 60),
                                     (3, 2048, 64, 60), (2, 30, 600, 12),
                                     (2, 20, 5, 1000), (2, 40, 1500, 8),
                                     (2, 12, 3, 30000)])
def test_ctc_kernels_match_plain(B, T, U, C):
    """Alpha and beta kernels (odd sizes, repeats, an all-blank row) against
    the plain recursions; T 1024 and 2048, 1201 states (a chain of five
    warps of 8 states a lane), 3001 (six of 16), 1000 classes and 30000
    (too wide to stage in shared memory); a second launch gives the same
    bits."""
    _card()
    from ishara_tpu_torch.ops import ctc_kernel as ck

    blank = C - 1
    rng = np.random.default_rng(B + T)
    labels = np.full((B, U), blank, np.int32)
    for b in range(1, B):
        n = int(rng.integers(0, U + 1))
        labels[b, :n] = rng.choice([0, 1], size=n)
    if U >= 600:  # every state valid: the whole multi-warp chain steps
        labels[1] = rng.choice([0, 1], size=U)
    logits = torch.from_numpy(rng.standard_normal((B, T, C)).astype(
        np.float32)).cuda().requires_grad_()
    labels = torch.from_numpy(labels).cuda()
    dy = torch.from_numpy(rng.random(B).astype(np.float32)).cuda()
    _ctc_case(ck, logits, labels, dy, blank)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [176, 512])
def test_ctc_kernels_on_the_training_steps_labels(T):
    """The training step's geometry (B 256, U 64, C 60, logits 2 N(0, 1)):
    labels of 3-10 characters, so that a row's 7-21 states are far fewer
    than its 129, one row of all 64 labels (129 states, 8 a lane), one of
    repeats and one all blank; T 176 and the long step's 512."""
    _card()
    from ishara_tpu_torch.ops import ctc_kernel as ck

    rng = np.random.default_rng(T)
    labels = np.full((256, 64), 59, np.int32)
    for b in range(256):
        n = int(rng.integers(3, 11))
        labels[b, :n] = rng.integers(0, 59, n)
    labels[0] = 59
    labels[1, :6] = [7, 7, 7, 3, 3, 7]
    labels[2] = rng.integers(0, 59, 64)
    logits = torch.from_numpy(2.0 * rng.standard_normal((256, T, 60)).astype(
        np.float32)).cuda().requires_grad_()
    dy = torch.from_numpy(rng.random(256).astype(np.float32) + 0.5).cuda()
    _ctc_case(ck, logits, torch.from_numpy(labels).cuda(), dy, 59)


@pytest.mark.cuda
def test_ctc_plan_and_guard_match_their_mirrors():
    """ctc_plan and ctc_fits, which the wrapper and the CPU tests use, give
    what the kernels' own plan and guard give."""
    _card()
    import ctypes

    from ishara_tpu_torch.ops import _build
    from ishara_tpu_torch.ops import ctc_kernel as ck

    plan = _build.function("ctc", "ishara_ctc_plan",
                           [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    fits = _build.function("ctc", "ishara_ctc_fits", [ctypes.c_int] * 3)
    out = (ctypes.c_int * 6)()
    for U in [0, 1, 5, 15, 16, 31, 63, 64, 127, 128, 600, 1151, 1152, 2000,
              4838, 5200, 5300, 6400, 7000]:
        for C in (8, 60, 1000, 30000):
            for backward in (False, True):
                got = tuple(out) if plan(U, C, int(backward), out) else None
                assert got == ck.ctc_plan(U, C, backward), (U, C, backward)
        for T, C in [(1, 1), (176, 60), (50000, 1000)]:
            assert bool(fits(T, C, U)) == ck.ctc_fits(T, C, U), (T, C, U)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1003,), (7, 33), (4, 16, 64)])
def test_dropout_kernels_equal_plain(shape, dtype):
    """Ragged and unaligned sizes: the kernel equals the plain Philox
    version exactly, forward, add form and backward."""
    _card()
    from ishara_tpu_torch.ops import dropout as dr

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    res = torch.randn(shape, generator=g, device="cuda").to(dtype)
    seed = torch.tensor([321], dtype=torch.int32, device="cuda")
    xr = x.clone().requires_grad_()
    out = dr.fast_dropout(xr, seed, 0.3)
    assert torch.equal(out, dr.dropout_plain(x, seed, 0.3))
    (dx,) = torch.autograd.grad(out, xr, res)
    assert torch.equal(dx, dr.dropout_plain(res, seed, 0.3))
    assert torch.equal(dr.fast_dropout_add(res, x, seed, 0.3),
                       dr.dropout_plain(x, seed, 0.3, res))
    # a view that starts off a 16-byte boundary takes the scalar path
    if x.numel() > 8:
        flat = x.reshape(-1)[1:]
        assert torch.equal(dr.fast_dropout(flat, seed, 0.3),
                           dr.dropout_plain(flat, seed, 0.3))
    with pytest.raises(ValueError, match="f32 or bf16"):
        dr.fast_dropout(x.to(torch.float16), seed, 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dim", [((5, 4, 7, 7), 1), ((3, 9, 24), 2),
                                       ((3, 9, 22), 2)])
def test_dropout_kernel_on_a_strided_slice(shape, dim, dtype):
    """A tensor-parallel rank's slice (heads of ``[B, H, T, T]``, hidden
    columns of ``[B, T, K]``; runs of 98 and 11 values take the scalar
    path) with ``runs``: the kernel equals the plain version and the whole
    launch's slice, forward, add form and backward, rows offset too."""
    _card()
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.parallel.shard import (
        BatchShard,
        batch_shard,
        split_offset,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    seed = torch.tensor([777], dtype=torch.int32, device="cuda")
    full, full_dx = dr.fast_dropout(x, seed, 0.3), dr.fast_dropout(dy, seed,
                                                                   0.3)
    w, r0 = shape[dim] // 2, 1
    for part in range(2):
        sl = [slice(r0, None)] + [slice(None)] * (len(shape) - 1)
        sl[dim] = slice(part * w, (part + 1) * w)
        sl = tuple(sl)
        xs, dys = x[sl].contiguous(), dy[sl].contiguous()
        with batch_shard(BatchShard(row0=r0, local=shape[0] - r0,
                                    rows=shape[0])):
            off, runs = split_offset(xs.shape, 2, part, len(shape) - dim)
        xr = xs.clone().requires_grad_()
        out = dr.fast_dropout(xr, seed, 0.3, off, runs)
        (dx,) = torch.autograd.grad(out, xr, dys)
        assert torch.equal(out, full[sl])
        assert torch.equal(out, dr.dropout_plain(xs, seed, 0.3, None, off,
                                                 runs))
        assert torch.equal(dx, full_dx[sl])
        assert torch.equal(dr.fast_dropout_add(dys, xs, seed, 0.3, off,
                                               runs),
                           dr.dropout_plain(xs, seed, 0.3, dys, off, runs))
    with pytest.raises(ValueError, match="runs"):
        dr.fast_dropout(xs, seed, 0.3, 0, (7, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,Dh", [(23, 16), (24, 8), (200, 32), (384, 16),
                                  (176, 64), (301, 64), (384, 64),
                                  (176, 128), (384, 128), (45, 256),
                                  (33, 12), (176, 48), (1, 32), (1, 64),
                                  (23, 32), (23, 64), (64, 32), (64, 64),
                                  (176, 32), (193, 32), (193, 64),
                                  (384, 32)])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_attention_kernels_match_plain(T, Dh, rate, dtype, tol):
    """T not a multiple of 4 (masks straddle Philox blocks), one to six
    64-key tiles, heads of 8 to 256 (each zero-padded to 32, 64, 128 or
    256; 12 takes the narrow copy path), a fully masked row; forward and
    dq, dk, dv. Both directions take the wgmma design at bf16 heads of 32
    and 64 (the forward of csrc/attention_fwd_wg.cuh, one or two units of
    three query tiles; the backward of csrc/attention_bwd.cuh, one to three
    key-tile groups from T 1 to 384), the backward there on the keep bits
    that the forward wrote (bit for bit ``keep_mask``'s, zero past T), and
    the general kernels otherwise (f32; bf16 48 pads to 64 there). At T 1 the softmax over one key has no
    gradient: dq and dk are 0 up to the rounding of ``delta = dO . O``
    against ``dP``, so there both are held within the tolerance of the
    size of those terms, max |dO . O| * max |k| * scale, instead of to each
    other's residue."""
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops.dropout import keep_mask

    B, H = 2, 3
    g = torch.Generator(device="cuda").manual_seed(T)
    qkv = torch.randn((B, T, H, 3 * Dh), generator=g, device="cuda").to(
        dtype).requires_grad_()
    d_o = torch.randn((B, H, T, Dh), generator=g, device="cuda").to(dtype)
    mask = torch.rand((B, T), generator=g, device="cuda") > 0.2
    mask[1] = False
    bias = at.mask_to_bias(mask)
    seed = torch.tensor([55], dtype=torch.int32, device="cuda")
    scale = (H * Dh) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    design = "wgmma" if dtype == torch.bfloat16 and Dh in (32, 64) \
        else "general"
    assert at.plan_of(q, k, v) == design
    before = dict(at.flash_mhsa.launches_bwd_by_design)
    before_fwd = dict(at.flash_mhsa.launches_by_design)
    o = at.flash_mhsa(q, k, v, bias, seed, scale, rate)
    grads = torch.autograd.grad(o, (q, k, v), d_o)
    torch.cuda.synchronize()
    assert at.flash_mhsa.launches_bwd_by_design == dict(
        before, **{design: before[design] + 1})
    assert at.flash_mhsa.launches_by_design == dict(
        before_fwd, **{design: before_fwd[design] + 1})
    with torch.no_grad():
        _, _, bits = at._launch_fwd(q, k, v, bias, seed, scale, rate)
        ro, lse = at.mhsa_forward_plain(q, k, v, bias, seed, scale, rate)
        rgrads = at.mhsa_backward_plain(q, k, v, bias, seed, ro, lse, d_o,
                                        scale, rate)
    if design == "wgmma" and rate > 0.0:
        assert torch.equal(bits, at.pack_keep_bits(
            keep_mask(seed, (B, H, T, T), rate)))
    else:
        assert bits is None
    _close(o, ro, tol)
    if T == 1:
        terms = float((d_o.float() * ro.float()).sum(-1).abs().max()
                      * k.detach().float().abs().max()) * scale
        for a, b in zip(grads[:2], rgrads[:2]):
            assert float(a.float().abs().max()) <= tol * terms
            assert float(b.float().abs().max()) <= tol * terms
        grads, rgrads = grads[2:], rgrads[2:]
    for a, b in zip(grads, rgrads):
        _close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T", [176, 23])
def test_attention_kernel_on_a_rank_s_heads(T, dtype, tol):
    """A tensor-parallel rank's heads (``runs``, rows offset too) and a
    data-parallel shard's rows (an offset alone): the kernel equals the
    plain version with the same offset and runs, and the whole launch's
    rows and heads, forward and dq, dk, dv; heads of 16 (the general
    backward) and of 32 (in bf16 the wgmma backward, on the bits that the
    forward drew at those offsets)."""
    for Dh in (16, 32):
        _rank_s_heads(T, Dh, dtype, tol)


def _rank_s_heads(T, Dh, dtype, tol):
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.parallel.shard import (
        BatchShard,
        batch_shard,
        split_offset,
    )

    B, H, parts, r0 = 3, 4, 2, 1
    design = "wgmma" if dtype == torch.bfloat16 and Dh == 32 else "general"
    g = torch.Generator(device="cuda").manual_seed(T)
    qkv = torch.randn((B, T, H, 3 * Dh), generator=g, device="cuda").to(
        dtype).requires_grad_()
    d_o = torch.randn((B, H, T, Dh), generator=g, device="cuda").to(dtype)
    bias = at.mask_to_bias(torch.rand((B, T), generator=g, device="cuda")
                           > 0.2)
    seed = torch.tensor([56], dtype=torch.int32, device="cuda")
    scale = (H * Dh) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    o = at.flash_mhsa(q, k, v, bias, seed, scale, 0.3)
    full = torch.autograd.grad(o, (q, k, v), d_o)
    hl = H // parts
    shards = [((slice(r0, None), slice(None)), r0 * H * T * T, None)]
    for part in range(parts):
        with batch_shard(BatchShard(row0=r0, local=B - r0, rows=B)):
            off, runs = split_offset((B - r0, hl, T, T), parts, part, 3)
        shards.append(((slice(r0, None), slice(part * hl, (part + 1) * hl)),
                       off, runs))
    for sl, off, runs in shards:
        qs, ks, vs = (t.detach()[sl].clone().requires_grad_()
                      for t in (q, k, v))
        before = at.flash_mhsa.launches_bwd_by_design[design]
        os_ = at.flash_mhsa(qs, ks, vs, bias[r0:], seed, scale, 0.3, off,
                            runs)
        grads = torch.autograd.grad(os_, (qs, ks, vs), d_o[sl])
        assert at.flash_mhsa.launches_bwd_by_design[design] == before + 1
        with torch.no_grad():
            ro, lse = at.mhsa_forward_plain(qs, ks, vs, bias[r0:], seed,
                                            scale, 0.3, offset=off,
                                            runs=runs)
            rgrads = at.mhsa_backward_plain(qs, ks, vs, bias[r0:], seed, ro,
                                            lse, d_o[sl], scale, 0.3,
                                            offset=off, runs=runs)
        _close(os_, ro, tol)
        _close(os_, o[sl], tol)
        for a, b, c in zip(grads, rgrads, full):
            _close(a, b, tol)
            _close(a, c[sl], tol)
    with pytest.raises(ValueError, match="whole heads"):
        at.flash_mhsa(qs, ks, vs, bias[r0:], seed, scale, 0.3, 0, (7, 9))


@pytest.mark.cuda
def test_attention_plan_matches_the_c_plan():
    """``attention_plan`` mirrors csrc/attention_bwd.cuh's own rule
    (``ishara_attention_plan``) at every T of K3's range and the widths
    around the wgmma design's; the C plan's wgmma layout covers every key
    tile, fits a block's shared memory, and its registers (setmaxnreg) fit
    a thread; its forward takes three consumer warpgroups of 160 registers
    (with the producer's 24, within an SM's 65536) and a shared memory
    independent of T."""
    _card()
    from ishara_tpu_torch.ops import attention as at

    last = {}
    for dtype in (torch.bfloat16, torch.float32):
        for Dh in (16, 32, 48, 64, 128):
            for T in range(1, 386):
                for aligned in (True, False):
                    c = at.c_plan(dtype, T, Dh, aligned)
                    assert at.attention_plan(dtype, T, Dh, aligned) \
                        == c["design"], (dtype, T, Dh)
                    if c["design"] != "wgmma":
                        continue
                    keys = c["groups"] * c["consumers"] * 64
                    assert keys >= T > keys - c["consumers"] * 64, c
                    assert last.get(Dh, 0) <= c["smem"] <= 227 * 1024, c
                    assert c["reg_limit"] <= 255, c
                    last[Dh] = c["smem"]
                    assert (c["fwd_consumers"], c["fwd_reg_limit"]) \
                        == (3, 160), c
                    assert 128 * (3 * 160 + 24) <= 65536
                    assert c["fwd_smem"] == at.c_plan(
                        dtype, 1, Dh, aligned)["fwd_smem"] <= 227 * 1024


@pytest.mark.cuda
def test_attention_wgmma_kernels_fit_their_registers():
    """ptxas's own report (``-Xptxas -v``, kept in the build's log) of the
    wgmma backward's instances (heads of 32 and 64) and of the wgmma
    forward's (heads of 32 and 64, with and without dropout): at most 255
    registers a thread, no stack frame, no spills and no serialised wgmma
    (C7512, C7513, C7515, C7520)."""
    _card()
    from ishara_tpu_torch.ops import _build

    _build.build()
    log = _build.build_log("attention")
    assert not [line for line in log.splitlines()
                if re.search(r"\(C75(12|13|15|20)\)", line)
                and "wg_kernel" in line]
    reports = {}
    for entry in log.split("Function properties for ")[1:]:
        name = entry.split(maxsplit=1)[0]
        if "wg_kernel" in name:
            reports[name] = entry.split("Compile time")[0]
    assert len(reports) == 6
    for name, report in reports.items():
        assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill " \
            "loads" in report, (name, report)
        regs = int(re.search(r"Used (\d+) registers", report).group(1))
        assert regs <= 255, (name, report)


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_cannot_take():
    _card()
    from ishara_tpu_torch.ops import attention as at

    q = torch.zeros((1, 1, 385, 8), device="cuda")
    with pytest.raises(ValueError, match="T <= 384"):
        at.flash_mhsa(q, q, q, torch.zeros((1, 385), device="cuda"))
    assert at.kernel_takes(torch.bfloat16, 384, 256)
    assert at.kernel_takes(torch.bfloat16, 176, 32)
    assert at.kernel_takes(torch.bfloat16, 176, 257)     # any head width
    assert at.kernel_takes(torch.bfloat16, 176, 512)
    assert not at.kernel_takes(torch.bfloat16, 176, 0)
    q = torch.zeros((1, 1, 8, 8), device="cuda")
    with pytest.raises(ValueError, match="bias"):
        at.flash_mhsa(q, q, q, torch.zeros((1, 4), device="cuda"))
    q = torch.zeros((1, 1, 8, 8), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        at.flash_mhsa(q, q, q, torch.zeros((1, 8), device="cuda"))
    # the wgmma forward refuses a dropout launch without keep bits, and the
    # general one a launch with them: nothing falls back
    q = torch.zeros((1, 2, 40, 32), device="cuda", dtype=torch.bfloat16)
    bias, seed = torch.zeros((1, 40), device="cuda"), torch.zeros(
        (1,), dtype=torch.int32, device="cuda")
    for wrong in ("general", "wgmma"):
        qw = q if wrong == "general" else q.float()
        real = at.plan_of
        at.plan_of = lambda *a, wrong=wrong: wrong
        try:
            with pytest.raises(RuntimeError, match="forward kernel failed"):
                at._launch_fwd(qw, qw, qw, bias, seed, 0.1, 0.3)
        finally:
            at.plan_of = real


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,Dh,offset", [
    (256, 8, 176, 32, 0), (256, 8, 384, 32, 0), (256, 4, 176, 64, 0),
    (16, 8, 177, 32, 0), (16, 8, 176, 32, 3 * 8 * 176 * 176),
    (16, 4, 176, 64, 5)])
def test_attention_wgmma_forward_matches_plain(B, H, T, Dh, offset):
    """The wgmma forward (csrc/attention_fwd_wg.cuh, K3's unit of three
    query tiles) at the flagship's shape, K3's longest T, heads of 64, an
    odd T and offsets (a data-parallel shard's rows; an offset not a
    multiple of 4 and the odd T take the slow Philox path), each with a
    fully masked row, rate 0.4 and 0: o and lse within bf16's tolerance
    (0.02) of ``mhsa_forward_plain``, the keep bits equal to
    ``pack_keep_bits(keep_mask(...))`` bit for bit, the wgmma backward on
    them within the same tolerance of the plain backward, and a second
    forward the same bits."""
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops.dropout import keep_mask

    g = torch.Generator(device="cuda").manual_seed(T + Dh)
    qkv = torch.randn((B, T, H, 3 * Dh), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    d_o = torch.randn((B, H, T, Dh), generator=g, device="cuda").to(
        torch.bfloat16)
    lengths = torch.randint(40, T + 1, (B,), generator=g, device="cuda")
    lengths[0] = 0                                   # every key masked
    bias = at.mask_to_bias(torch.arange(T, device="cuda")[None, :]
                           < lengths[:, None])
    seed = torch.tensor([977], dtype=torch.int32, device="cuda")
    scale = (H * Dh) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    assert at.plan_of(q, k, v) == "wgmma"
    for rate in (0.4, 0.0):
        before = at.flash_mhsa.launches_by_design["wgmma"]
        o = at.flash_mhsa(q, k, v, bias, seed, scale, rate, offset)
        assert at.flash_mhsa.launches_by_design["wgmma"] == before + 1
        with torch.no_grad():
            o2, lse, bits = at._launch_fwd(q, k, v, bias, seed, scale, rate,
                                           offset)
            assert torch.equal(o, o2)
            ro, rlse = at.mhsa_forward_plain(q, k, v, bias, seed, scale,
                                             rate, offset=offset)
        _close(o, ro, 2e-2)
        _close(lse, rlse, 2e-2)
        if rate > 0.0:
            assert torch.equal(bits, at.pack_keep_bits(
                keep_mask(seed, (B, H, T, T), rate, offset)))
        else:
            assert bits is None
        del o2, bits
        grads = torch.autograd.grad(o, (q, k, v), d_o)
        with torch.no_grad():
            rgrads = at.mhsa_backward_plain(q, k, v, bias, seed, ro, rlse,
                                            d_o, scale, rate, offset=offset)
        for a, b in zip(grads, rgrads):
            _close(a, b, 2e-2)
        del ro, rlse, rgrads, grads
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,k,m", [
    (torch.bfloat16, 40, 128, 256), (torch.bfloat16, 96, 128, 128),
    (torch.bfloat16, 515, 256, 512),
    # the general kernels: f32, and bf16 at widths off the 128 grid
    (torch.float32, 40, 128, 256), (torch.float32, 515, 256, 512),
    (torch.float32, 77, 20, 36), (torch.bfloat16, 96, 64, 128),
    (torch.bfloat16, 33, 70, 100),
    # row counts off the 64-row tile, widths of 384 and 768 (tensor cores
    # where shared memory holds the tile, the general kernels past that)
    (torch.bfloat16, 100, 384, 384), (torch.bfloat16, 70, 256, 768),
    (torch.bfloat16, 130, 768, 256), (torch.bfloat16, 64, 384, 768)])
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.3, 0.2), (0.4, 0.0)])
def test_ffn_kernels_match_plain(dtype, n, k, m, rates):
    """Row counts that need padding to the 64-row tile, the narrowest
    widths of the tensor-core kernels, f32 and odd widths on the general
    ones; forward, all gradients, and the masks bit for bit."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk
    from ishara_tpu_torch.ops.dropout import keep_mask

    r1, r2 = rates
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator(device="cuda").manual_seed(n)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    x = rand(n, k).to(dtype).requires_grad_()
    res = rand(n, k).to(dtype).requires_grad_()
    dy = rand(n, k).to(dtype)
    params = [rand(k, m, scale=k ** -0.5), rand(m, scale=0.1),
              rand(m, k, scale=m ** -0.5), rand(k, scale=0.1)]
    for p in params:
        p.requires_grad_()
    seeds = torch.tensor([9, 10], dtype=torch.int32, device="cuda")
    before = (fk.ffn_residual.launches, fk.ffn_residual.launches_bwd)
    out = fk.ffn_residual(x, res, *params, seeds, r1, r2)
    grads = torch.autograd.grad(out, [x, res] + params, dy)
    torch.cuda.synchronize()
    assert (fk.ffn_residual.launches, fk.ffn_residual.launches_bwd) \
        == (before[0] + 1, before[1] + 1)
    w1, b1, w2, b2 = (p.detach() for p in params)
    w1c, w2c = w1.to(dtype), w2.to(dtype)
    want = fk.ffn_forward_plain(x.detach(), res.detach(), w1c, b1, w2c, b2,
                                seeds, r1, r2)
    rdx, rdw1, rdb1, rdw2, rdb2 = fk.ffn_backward_plain(
        x.detach(), dy, w1c, b1, w2c, seeds, r1, r2)
    _close(out, want, tol)
    for a, b in zip(grads, (rdx, dy, rdw1, rdb1, rdw2, rdb2)):
        _close(a, b, tol)
    k1, k2 = fk.debug_masks(n, m, k, seeds, 0.3, 0.2)
    assert torch.equal(k1.bool(), keep_mask(seeds[0:1], (n, m), 0.3))
    assert torch.equal(k2.bool(), keep_mask(seeds[1:2], (n, k), 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_backward_gives_the_same_bits_twice(dtype):
    """No atomics: a second forward and backward of K4 (dropout on both
    sites) on the same inputs equal the first bit for bit."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    n, k, m = 333, 256, 512
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((n, k), generator=g, device="cuda").to(dtype)
    x.requires_grad_()
    dy = torch.randn((n, k), generator=g, device="cuda").to(dtype)
    params = [torch.randn(s, generator=g, device="cuda") * 0.1
              for s in ((k, m), (m,), (m, k), (k,))]
    for p in params:
        p.requires_grad_()
    seeds = torch.tensor([4, 5], dtype=torch.int32, device="cuda")

    def run():
        out = fk.ffn_residual(x, x, *params, seeds, 0.4, 0.4)
        return (out, *torch.autograd.grad(out, [x] + params, dy))

    first, second = run(), run()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,k,m", [
    (torch.bfloat16, 100, 128, 256), (torch.float32, 100, 128, 256),
    (torch.float32, 77, 20, 40)])
def test_ffn_kernel_on_a_slice_of_the_hidden(dtype, n, k, m):
    """A tensor-parallel rank's hidden columns (``hidden``, no residual, no
    ``b2``, rows offset): the partial sums equal the plain version's, and
    summed over the ranks with the bias they are the whole launch's
    branch, forward and every gradient."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    tol = 2e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator(device="cuda").manual_seed(n)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    x = rand(n, k).to(dtype).requires_grad_()
    dy = rand(n, k).to(dtype)
    w1, b1 = rand(k, m, scale=k ** -0.5), rand(m, scale=0.1)
    w2, b2 = rand(m, k, scale=m ** -0.5), rand(k, scale=0.1)
    seeds = torch.tensor([9, 10], dtype=torch.int32, device="cuda")
    roff, parts, ml = 5, 2, m // 2
    zero = torch.zeros_like(x)
    full = fk.ffn_residual(x, zero, w1, b1, w2, b2, seeds, 0.3, 0.0, roff)
    fdx = torch.autograd.grad(full, x, dy)[0]
    total, dx_sum = 0.0, 0.0
    for part in range(parts):
        cols = slice(part * ml, (part + 1) * ml)
        p = [w1[:, cols].clone().requires_grad_(),
             b1[cols].clone().requires_grad_(),
             w2[cols].clone().requires_grad_()]
        hidden = (m, part * ml)
        out = fk.ffn_residual(x, None, p[0], p[1], p[2], None, seeds, 0.3,
                              0.0, roff, hidden)
        grads = torch.autograd.grad(out, [x] + p, dy)
        xd = x.detach()
        w1c, w2c = p[0].detach().to(dtype), p[2].detach().to(dtype)
        want = fk.ffn_forward_plain(xd, None, w1c, p[1].detach(), w2c, None,
                                    seeds, 0.3, 0.0, row_offset=roff,
                                    hidden=hidden)
        rdx, rdw1, rdb1, rdw2, _ = fk.ffn_backward_plain(
            xd, dy, w1c, p[1].detach(), w2c, seeds, 0.3, 0.0,
            row_offset=roff, hidden=hidden)
        _close(out, want, tol)
        for a, b in zip(grads, (rdx, rdw1, rdb1, rdw2)):
            _close(a, b, tol)
        total = total + out.float()
        dx_sum = dx_sum + grads[0].float()
    _close(total + b2, full.float(), tol)
    _close(dx_sum, fdx.float(), tol)
    with pytest.raises(ValueError, match="partial sum"):
        fk.ffn_residual(x, zero, w1, b1, w2, b2, seeds, 0.3, 0.0, 0,
                        (2 * m, 0))


def _k4_by_design(fk):
    return (dict(fk.ffn_residual.launches_by_design),
            dict(fk.ffn_residual.launches_bwd_by_design))


def _k4_took(fk, before, design):
    """The launches since ``before`` were one forward and one backward, both
    on ``design``."""
    after = _k4_by_design(fk)
    for b, a in zip(before, after):
        assert {d: a[d] - b[d] for d in a} == {
            d: int(d == design) for d in a}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [45056, 100, 515, 45056 - 37])
def test_ffn_wgmma_design_matches_plain(n):
    """K4's wgmma design at the flagship's widths (bf16, K 256, hidden 512,
    rates 0.4 / 0.4): the flagship step's 45056 rows and row counts off the
    128-row tile (TMA reads the rows past N as zeros; nothing is padded);
    forward and every gradient against the plain version, a second launch
    bit for bit, and both launches on the wgmma design."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    k, m, tol = 256, 512, 2e-2
    assert fk.ffn_plan(torch.bfloat16, k, m).design == "wgmma"
    g = torch.Generator(device="cuda").manual_seed(n)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    x = rand(n, k).to(torch.bfloat16).requires_grad_()
    res = rand(n, k).to(torch.bfloat16).requires_grad_()
    dy = rand(n, k).to(torch.bfloat16)
    params = [rand(k, m, scale=k ** -0.5), rand(m, scale=0.1),
              rand(m, k, scale=m ** -0.5), rand(k, scale=0.1)]
    for p in params:
        p.requires_grad_()
    seeds = torch.tensor([11, 12], dtype=torch.int32, device="cuda")
    before = _k4_by_design(fk)
    out = fk.ffn_residual(x, res, *params, seeds, 0.4, 0.4)
    grads = torch.autograd.grad(out, [x, res] + params, dy)
    torch.cuda.synchronize()
    _k4_took(fk, before, "wgmma")
    w1, b1, w2, b2 = (p.detach() for p in params)
    w1c, w2c = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    want = fk.ffn_forward_plain(x.detach(), res.detach(), w1c, b1, w2c, b2,
                                seeds, 0.4, 0.4)
    rdx, rdw1, rdb1, rdw2, rdb2 = fk.ffn_backward_plain(
        x.detach(), dy, w1c, b1, w2c, seeds, 0.4, 0.4)
    _close(out, want, tol)
    for a, b in zip(grads, (rdx, dy, rdw1, rdb1, rdw2, rdb2)):
        _close(a, b, tol)
    out2 = fk.ffn_residual(x, res, *params, seeds, 0.4, 0.4)
    again = torch.autograd.grad(out2, [x] + params, dy)
    assert torch.equal(out, out2)
    for a, b in zip(again, (grads[0],) + grads[2:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ffn_wgmma_design_on_a_slice_of_the_hidden():
    """A tensor-parallel rank's half of the flagship's hidden (256 of 512
    columns, bf16, rows offset) on the wgmma design: the partial sums equal
    the plain version's, and summed over the ranks with the bias they are
    the whole launch's branch, forward and dx."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    n, k, m, tol, roff = 300, 256, 512, 2e-2, 37
    assert fk.ffn_plan(torch.bfloat16, k, m // 2).design == "wgmma"
    g = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    x = rand(n, k).to(torch.bfloat16).requires_grad_()
    dy = rand(n, k).to(torch.bfloat16)
    w1, b1 = rand(k, m, scale=k ** -0.5), rand(m, scale=0.1)
    w2, b2 = rand(m, k, scale=m ** -0.5), rand(k, scale=0.1)
    seeds = torch.tensor([9, 10], dtype=torch.int32, device="cuda")
    zero = torch.zeros_like(x)
    full = fk.ffn_residual(x, zero, w1, b1, w2, b2, seeds, 0.3, 0.0, roff)
    fdx = torch.autograd.grad(full, x, dy)[0]
    total, dx_sum = 0.0, 0.0
    for part in range(2):
        cols = slice(part * m // 2, (part + 1) * m // 2)
        p = [w1[:, cols].clone().requires_grad_(),
             b1[cols].clone().requires_grad_(),
             w2[cols].clone().requires_grad_()]
        hidden = (m, part * m // 2)
        before = _k4_by_design(fk)
        out = fk.ffn_residual(x, None, p[0], p[1], p[2], None, seeds, 0.3,
                              0.0, roff, hidden)
        grads = torch.autograd.grad(out, [x] + p, dy)
        torch.cuda.synchronize()
        _k4_took(fk, before, "wgmma")
        xd = x.detach()
        w1c, w2c = p[0].detach().to(torch.bfloat16), \
            p[2].detach().to(torch.bfloat16)
        want = fk.ffn_forward_plain(xd, None, w1c, p[1].detach(), w2c, None,
                                    seeds, 0.3, 0.0, row_offset=roff,
                                    hidden=hidden)
        rdx, rdw1, rdb1, rdw2, _ = fk.ffn_backward_plain(
            xd, dy, w1c, p[1].detach(), w2c, seeds, 0.3, 0.0,
            row_offset=roff, hidden=hidden)
        _close(out, want, tol)
        for a, b in zip(grads, (rdx, rdw1, rdb1, rdw2)):
            _close(a, b, tol)
        total = total + out.float()
        dx_sum = dx_sum + grads[0].float()
    _close(total + b2, full.float(), tol)
    _close(dx_sum, fdx.float(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,p,q,design", [
    # the flagship's K4 dw1 / dw2 and K7 dw1 / dw2 (xn^T du, s^T dp)
    (torch.bfloat16, 45056, 256, 512, "wgmma"),
    (torch.bfloat16, 45056, 512, 256, "wgmma"),
    # rows off the 64-row step, widths off the 128 tile
    (torch.bfloat16, 45056 - 37, 256, 512, "wgmma"),
    (torch.bfloat16, 515, 72, 200, "wgmma"),
    (torch.bfloat16, 40, 8, 136, "wgmma"),
    # the general kernel: f32 and widths off the 8-grid
    (torch.float32, 515, 256, 512, "general"),
    (torch.bfloat16, 515, 36, 20, "general")])
def test_weight_product_matches_f32_matmul(dtype, n, p, q, design):
    """``csrc/wgrad.cuh``'s product and fixed-order sum (``weight_product``,
    as K4's and K7's backwards run it) against an f32 matmul of the widened
    operands, within 1e-4 of the largest entry (the same products in
    another order of f32 sums); a second launch gives the same bits; the
    launch is counted on its design."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    g = torch.Generator(device="cuda").manual_seed(n + p)
    a = torch.randn((n, p), generator=g, device="cuda").to(dtype)
    b = torch.randn((n, q), generator=g, device="cuda").to(dtype)
    assert fk.product_design(dtype, p, q) == design
    before = dict(fk.weight_product.launches_by_design)
    got = fk.weight_product(a, b)
    assert fk.weight_product.launches_by_design == dict(
        before, **{design: before[design] + 1})
    want = a.float().T @ b.float()
    assert got.shape == (p, q) and got.dtype == torch.float32
    _close(got, want, 1e-4)
    assert torch.equal(got, fk.weight_product(a, b))


@pytest.mark.cuda
def test_ffn_plan_matches_the_c_plan():
    """``ffn_plan`` mirrors csrc/ffn.cu's own rule (``ishara_ffn_plan``)
    at every shape of the CPU tests' table."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    for dtype in (torch.bfloat16, torch.float32):
        for k in (20, 36, 64, 70, 128, 192, 256, 320, 384, 512, 768):
            for m in (36, 64, 96, 100, 128, 256, 512, 768, 1024):
                assert fk.ffn_plan(dtype, k, m) == fk.c_plan(dtype, k, m)


@pytest.mark.cuda
def test_ffn_wgmma_kernels_fit_their_registers():
    """ptxas's own report (``-Xptxas -v``, kept in the build's log) of every
    instance of the wgmma design's two kernels and of the wgmma weight
    product (csrc/wgrad.cuh): at most 255 registers a thread, no stack
    frame, no spills and no serialised wgmma (C7512), so the accumulators
    that ``ffn_plan``'s ``acc_regs`` counts stay in the registers setmaxnreg
    gives a consumer."""
    _card()
    from ishara_tpu_torch.ops import _build

    _build.build()
    log = _build.build_log("ffn")
    assert not [line for line in log.splitlines()
                if "C7512" in line and "_wg_kernel" in line]
    reports = {}
    for entry in log.split("Function properties for ")[1:]:
        name = entry.split(maxsplit=1)[0]
        if "ffn_fwd_wg_kernel" in name or "ffn_bwd_wg_kernel" in name \
                or "product_wg_kernel" in name:
            reports[name] = entry.split("Compile time")[0]
    # two kernels at K 64, 128, 192 and 256, and the weight product
    assert len(reports) == 9
    for name, report in reports.items():
        assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill " \
            "loads" in report, (name, report)
        regs = int(re.search(r"Used (\d+) registers", report).group(1))
        assert regs <= 255, (name, report)


@pytest.mark.cuda
def test_ffn_kernel_refuses_what_it_cannot_take():
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    seeds = torch.zeros(2, dtype=torch.int32, device="cuda")
    x = torch.zeros((32, 128), device="cuda", dtype=torch.float16)
    w1, w2 = torch.zeros((128, 256), device="cuda"), \
        torch.zeros((256, 128), device="cuda")
    with pytest.raises(ValueError, match="f32 or bf16"):
        fk.ffn_residual(x, x, w1, torch.zeros(256, device="cuda"), w2,
                        torch.zeros(128, device="cuda"), seeds, 0.1, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,Dh,blocks", [(512, 32, (128, 128)),
                                         (200, 32, (128, 128)),
                                         (200, 64, (64, 128)),
                                         (130, 128, (64, 64)),
                                         (23, 8, (128, 128)),
                                         (200, 32, (16, 16)),
                                         (130, 136, (64, 64)),
                                         (70, 256, (16, 64)),
                                         (41, 12, (16, 16))])
def test_blocked_attention_kernels_match_plain(T, Dh, blocks, dtype, tol):
    """K8: padding to the blocks' multiple (blocks of 16, whose Tp the
    core's 64-key tile does not divide), heads of 8 to 256 (12 takes the
    narrow copy path), a fully masked sequence (every one of the Tp keys
    weighted alike, as in the reference); forward, lse and dq, dk, dv."""
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab

    B, H = 2, 3
    g = torch.Generator(device="cuda").manual_seed(T + Dh)
    qkv = torch.randn((B, T, H, 3 * Dh), generator=g, device="cuda").to(
        dtype).requires_grad_()
    d_o = torch.randn((B, H, T, Dh), generator=g, device="cuda").to(dtype)
    mask = torch.rand((B, T), generator=g, device="cuda") > 0.2
    mask[1] = False
    bias = at.mask_to_bias(mask)
    scale = (H * Dh) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    before = (ab.flash_mhsa_blocked.launches,
              ab.flash_mhsa_blocked.launches_bwd)
    o = ab.flash_mhsa_blocked(q, k, v, bias, scale, *blocks)
    grads = torch.autograd.grad(o, (q, k, v), d_o)
    torch.cuda.synchronize()
    assert (ab.flash_mhsa_blocked.launches,
            ab.flash_mhsa_blocked.launches_bwd) \
        == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        ro, lse = ab.blocked_attention_forward_plain(q, k, v, bias, scale,
                                                     *blocks)
        rgrads = ab.blocked_attention_backward_plain(q, k, v, bias, ro, lse,
                                                     d_o, scale)
        _, klse = ab._launch_fwd(q, k, v, bias, scale,
                                 ab.padded_length(T, *blocks))
    _close(o, ro, tol)
    _close(klse[0], lse[0], 1e-5)
    assert torch.equal(klse[1], lse[1])      # all masked: -1e30 exactly
    for a, b in zip(grads, rgrads):
        _close(a, b, tol)


@pytest.mark.cuda
def test_blocked_attention_kernel_refuses_what_it_cannot_take():
    _card()
    from ishara_tpu_torch.ops import attention_blocked as ab

    bias = torch.zeros((1, 16), device="cuda")
    q = torch.zeros((1, 1, 16, 8), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ab.flash_mhsa_blocked(q, q, q, bias, 1.0)
    q = torch.zeros((1, 1, 16, 8), device="cuda")
    with pytest.raises(ValueError, match="bias"):
        ab.flash_mhsa_blocked(q, q, q, bias[:, :8], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,Dh,blocks", [
    (256, 8, 512, 32, (128, 128)),      # the long step's shape
    (4, 4, 512, 64, (128, 128)),        # heads of 64: the general backward
    (4, 4, 384, 64, (128, 128)), (3, 2, 640, 32, (128, 128)),
    (3, 2, 1, 32, (128, 128)), (3, 2, 65, 32, (128, 128)),
    (3, 2, 1, 64, (16, 16)), (3, 2, 65, 64, (64, 64)),
    (3, 4, 200, 32, (128, 128)), (3, 4, 200, 32, (64, 64)),
    (3, 4, 200, 32, (16, 16)), (3, 4, 200, 64, (16, 16))])
def test_blocked_attention_wgmma_designs_match_plain(B, H, T, Dh, blocks):
    """K8's wgmma designs (csrc/attention_fwd_wg.cuh's forward, the one-pass
    backward of csrc/attention_bwd.cuh without keep bits) on bf16 views of
    one projection, each launch counted under ``blocked_plan``'s design:
    o, lse and dq, dk, dv against the plain versions (chip_smoke.py's
    tolerances: 2e-2 of the largest element, lse 1e-5), a sequence with
    every key masked (its lse -1e30 bit for bit, V averaged over the Tp
    keys), padded lengths the 64-key tile does not divide (blocks of 16:
    Tp 16, 80, 208), and a second backward bit for bit."""
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab

    g = torch.Generator(device="cuda").manual_seed(T + Dh)
    qkv = torch.randn((B, T, H, 3 * Dh), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    d_o = torch.randn((B, H, T, Dh), generator=g, device="cuda").to(
        torch.bfloat16)
    mask = torch.rand((B, T), generator=g, device="cuda") > 0.2
    mask[1] = False
    bias = at.mask_to_bias(mask)
    scale = (H * Dh) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    plan = ab.plan_of(q, k, v)
    assert plan == ("wgmma", "general" if Dh == 64 and T > 384 else "wgmma")
    fwd = dict(ab.flash_mhsa_blocked.launches_by_design)
    bwd = dict(ab.flash_mhsa_blocked.launches_bwd_by_design)
    o = ab.flash_mhsa_blocked(q, k, v, bias, scale, *blocks)
    grads = torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)
    again = torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)
    torch.cuda.synchronize()
    assert ab.flash_mhsa_blocked.launches_by_design == dict(
        fwd, wgmma=fwd["wgmma"] + 1)
    assert ab.flash_mhsa_blocked.launches_bwd_by_design == dict(
        bwd, **{plan.backward: bwd[plan.backward] + 2})
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    with torch.no_grad():
        ro, lse = ab.blocked_attention_forward_plain(q, k, v, bias, scale,
                                                     *blocks)
        rgrads = ab.blocked_attention_backward_plain(q, k, v, bias, ro, lse,
                                                     d_o, scale)
        _, klse = ab._launch_fwd(q, k, v, bias, scale,
                                 ab.padded_length(T, *blocks))
    _close(o, ro, 2e-2)
    live = mask.any(1)                       # rows with a key not masked
    _close(klse[live], lse[live], 1e-5)
    assert torch.equal(klse[1], lse[1])      # all masked: -1e30 exactly
    assert bool((klse[1] == -1e30).all())
    for a, b in zip(grads, rgrads):
        _close(a, b, 2e-2)


@pytest.mark.cuda
def test_blocked_plan_matches_the_c_plan():
    """``blocked_plan`` mirrors csrc/attention_fwd_wg.cuh's own rule
    (``ishara_blocked_attention_plan``) for both directions over T 1 to
    1100 and the widths around the wgmma designs', and the C layouts of
    the designs it takes fit a block's shared memory."""
    _card()
    from ishara_tpu_torch.ops import attention_blocked as ab

    for dtype in (torch.bfloat16, torch.float32):
        for Dh in (12, 16, 32, 48, 64, 128):
            for T in range(1, 1101):
                for aligned in (True, False):
                    c = ab.c_plan(dtype, T, Dh, aligned)
                    assert ab.blocked_plan(dtype, T, Dh, aligned) \
                        == (c["forward"], c["backward"]), (dtype, T, Dh)
                    if c["forward"] == "wgmma":
                        assert 0 < c["fwd_smem"] <= 232448, c
                    if c["backward"] == "wgmma":
                        assert 0 < c["smem"] <= 232448, c
                        keys = c["groups"] * c["consumers"] * 64
                        assert keys >= T > keys - c["consumers"] * 64, c
                        assert c["reg_limit"] <= 255, c


@pytest.mark.cuda
def test_blocked_attention_wgmma_kernels_fit_their_registers():
    """ptxas's own report (``-Xptxas -v``, kept in the build's log) of K8's
    wgmma instances (the forward and the backward without keep bits, heads
    of 32 and 64): at most 255 registers a thread, no stack frame, no
    spills and no serialised wgmma (C7512, C7513, C7515, C7520)."""
    _card()
    from ishara_tpu_torch.ops import _build

    _build.build()
    log = _build.build_log("attention_blocked")
    assert not [line for line in log.splitlines()
                if re.search(r"\(C75(12|13|15|20)\)", line)
                and "wg_kernel" in line]
    reports = {}
    for entry in log.split("Function properties for ")[1:]:
        name = entry.split(maxsplit=1)[0]
        if "wg_kernel" in name:
            reports[name] = entry.split("Compile time")[0]
    assert len(reports) == 4
    for name, report in reports.items():
        assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill " \
            "loads" in report, (name, report)
        regs = int(re.search(r"Used (\d+) registers", report).group(1))
        assert regs <= 255, (name, report)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Dh", [257, 320, 512])
@pytest.mark.parametrize("kernel,rate", [("flash_mhsa", 0.0),
                                         ("flash_mhsa", 0.25),
                                         ("flash_mhsa_blocked", 0.0)])
def test_wide_head_attention_kernels_match_plain(kernel, rate, Dh, dtype,
                                                 tol):
    """K3 (with and without dropout) and K8 at heads wider than 256, which
    run in 256-wide column chunks: forward, lse and dq, dk, dv against the
    plain versions; a fully masked sequence; T not a multiple of 4."""
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab

    B, H, T = 2, 1, 45
    g = torch.Generator(device="cuda").manual_seed(Dh)
    qkv = torch.randn((B, T, H, 3 * Dh), generator=g, device="cuda").to(
        dtype).requires_grad_()
    d_o = torch.randn((B, H, T, Dh), generator=g, device="cuda").to(dtype)
    mask = torch.rand((B, T), generator=g, device="cuda") > 0.2
    mask[1] = False
    bias = at.mask_to_bias(mask)
    seed = torch.tensor([77], dtype=torch.int32, device="cuda")
    scale = (H * Dh) ** -0.5
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    if kernel == "flash_mhsa":
        o = at.flash_mhsa(q, k, v, bias, seed, scale, rate)
    else:
        o = ab.flash_mhsa_blocked(q, k, v, bias, scale, 16, 16)
    grads = torch.autograd.grad(o, (q, k, v), d_o)
    torch.cuda.synchronize()
    with torch.no_grad():
        if kernel == "flash_mhsa":
            ro, lse = at.mhsa_forward_plain(q, k, v, bias, seed, scale, rate)
            rgrads = at.mhsa_backward_plain(q, k, v, bias, seed, ro, lse,
                                            d_o, scale, rate)
        else:
            ro, lse = ab.blocked_attention_forward_plain(q, k, v, bias,
                                                         scale, 16, 16)
            rgrads = ab.blocked_attention_backward_plain(q, k, v, bias, ro,
                                                         lse, d_o, scale)
    _close(o, ro, tol)
    for a, b in zip(grads, rgrads):
        _close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_mhsa", "flash_mhsa_blocked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_gives_the_same_bits_twice(kernel, dtype):
    """No atomics: a second backward (and a second forward) of K3 (dropout
    on; heads of 64 and 32, which take the wgmma backward in bf16, dQ
    summed over the key tiles in a fixed order) and K8 on the same inputs
    equal the first bit for bit."""
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab

    for Dh in ((64, 32) if kernel == "flash_mhsa" else (64,)):
        B, H, T = 3, 2, 176
        g = torch.Generator(device="cuda").manual_seed(7)
        qkv = torch.randn((B, T, H, 3 * Dh), generator=g, device="cuda").to(
            dtype).requires_grad_()
        d_o = torch.randn((B, H, T, Dh), generator=g, device="cuda").to(
            dtype)
        bias = at.mask_to_bias(torch.rand((B, T), generator=g,
                                          device="cuda") > 0.2)
        seed = torch.tensor([31], dtype=torch.int32, device="cuda")

        def run():
            q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
            o = at.flash_mhsa(q, k, v, bias, seed, 0.1, 0.3) \
                if kernel == "flash_mhsa" \
                else ab.flash_mhsa_blocked(q, k, v, bias, 0.1, 64, 64)
            return (o, *torch.autograd.grad(o, (q, k, v), d_o))

        first, second = run(), run()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def _conv_case(B, T, D, E, K, r, dtype, g):
    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    x = rand(B, T, D).to(dtype).requires_grad_()
    lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    lengths[0] = 0                                   # an empty sequence
    mask = (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()
    params = [1 + rand(D, scale=0.1), rand(D, scale=0.1),
              rand(D, E, scale=D ** -0.5), rand(E, scale=0.1),
              rand(K, E, scale=K ** -0.5), rand(E, D, scale=E ** -0.5),
              rand(D, scale=0.1), rand(D, r, scale=D ** -0.5),
              rand(r, scale=0.1), rand(r, D, scale=r ** -0.5),
              rand(D, scale=0.1)]
    return x, mask, [p.requires_grad_() for p in params]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,D,E,K,r", [(3, 40, 64, 128, 15, 8),
                                         (2, 77, 48, 96, 3, 6),
                                         (4, 130, 32, 64, 31, 4),
                                         (1, 1, 64, 128, 15, 4),
                                         (2, 13, 64, 128, 15, 4),
                                         (2, 200, 256, 512, 15, 8),
                                         (2, 50, 144, 288, 15, 8),
                                         (2, 70, 256, 512, 31, 8),
                                         (2, 40, 512, 256, 15, 8),
                                         (2, 24, 768, 96, 3, 4)])
def test_conv_module_kernels_match_plain(B, T, D, E, K, r, dtype, tol):
    """K7: ragged masks and an all-masked sequence, one sequence, T of 1
    and 13 (shorter than the halo) and not a multiple of the time tile,
    widths off the tensor-core grid (D 144, E 288), 3 to 31 taps, D 512
    (16-row tiles) and 768 (the general path); forward, dx and the eleven
    parameter gradients, and the same gradients on a second run."""
    _card()
    from ishara_tpu_torch.ops import conv_kernel as ck

    g = torch.Generator(device="cuda").manual_seed(T)
    x, mask, params = _conv_case(B, T, D, E, K, r, dtype, g)
    dy = torch.randn((B, T, D), generator=g, device="cuda").to(dtype)
    before = (ck.conv_module_residual.launches,
              ck.conv_module_residual.launches_bwd)
    out = ck.conv_module_residual(x, mask, *params)
    grads = torch.autograd.grad(out, [x] + params, dy)
    again = torch.autograd.grad(ck.conv_module_residual(x, mask, *params),
                                [x] + params, dy)
    torch.cuda.synchronize()
    assert (ck.conv_module_residual.launches,
            ck.conv_module_residual.launches_bwd) \
        == (before[0] + 2, before[1] + 2)
    with torch.no_grad():
        args = ck._prep(x, mask, *params)
        want = ck.conv_module_forward_plain(x, *args)
        rgrads = ck.conv_module_backward_plain(x, args[0], dy, *args[1:])
    _close(out, want, tol)
    assert len(grads) == len(rgrads) == 12
    for a, b, c in zip(grads, rgrads, again):
        _close(a, b, tol)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("K", [33, 63])
@pytest.mark.parametrize("path,B,T,D,E,r", [("tile", 3, 200, 64, 128, 8),
                                            ("general", 2, 40, 768, 96, 4)])
def test_conv_module_kernel_takes_wide_depthwise_kernels(path, B, T, D, E,
                                                         r, K, dtype, tol):
    """K7 beyond 32 taps (a halo of 48 and of 64 rows): on the tile path
    (D 64) and on the general path (D 768, which no tile holds), forward,
    dx and the eleven parameter gradients against the plain version, and
    the same gradients on a second run."""
    _card()
    from ishara_tpu_torch.ops import conv_kernel as ck

    for backward in (False, True):
        plan = ck.tile_plan(T, D, K, dtype, backward)
        assert (plan is not None) == (path == "tile")
        if plan is not None:
            assert plan["halo"] == ck.halo_rows(K) and \
                plan["smem"] == ck.c_tile_smem(dtype, backward,
                                               plan["config"], D, K)
    g = torch.Generator(device="cuda").manual_seed(K)
    x, mask, params = _conv_case(B, T, D, E, K, r, dtype, g)
    dy = torch.randn((B, T, D), generator=g, device="cuda").to(dtype)
    out = ck.conv_module_residual(x, mask, *params)
    grads = torch.autograd.grad(out, [x] + params, dy)
    again = torch.autograd.grad(ck.conv_module_residual(x, mask, *params),
                                [x] + params, dy)
    with torch.no_grad():
        args = ck._prep(x, mask, *params)
        want = ck.conv_module_forward_plain(x, *args)
        rgrads = ck.conv_module_backward_plain(x, args[0], dy, *args[1:])
    _close(out, want, tol)
    assert len(grads) == len(rgrads) == 12
    for a, b, c in zip(grads, rgrads, again):
        _close(a, b, tol)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,E,K", [(256, 176, 256, 512, 15),
                                       (256, 512, 256, 512, 15),
                                       (8, 200, 256, 512, 15),
                                       (8, 200, 128, 256, 3),
                                       (8, 200, 128, 256, 15),
                                       (4, 65, 64, 128, 16),
                                       (6, 100, 192, 384, 1),
                                       (3, 1, 256, 512, 15)])
def test_conv_wgmma_design_matches_plain(B, T, D, E, K):
    """K7's wgmma design (bf16, ``conv_plan``): the flagship's and the long
    step's shapes, T 200 (off the 48- and 32-row tiles), T 65 and T 1, D 64
    to 256, E 128 to 512, 1 to 16 taps, an all-masked sequence; forward,
    dx and the eleven parameter gradients against the plain version at
    2e-2, a second backward bit for bit, and one launch each way counted
    by design."""
    _card()
    from ishara_tpu_torch.ops import conv_kernel as ck

    assert ck.conv_plan(torch.bfloat16, D, E, K) == "wgmma"
    g = torch.Generator(device="cuda").manual_seed(T + K)
    x, mask, params = _conv_case(B, T, D, E, K, max(D // 8, 4),
                                 torch.bfloat16, g)
    dy = torch.randn((B, T, D), generator=g, device="cuda").to(torch.bfloat16)
    fwd = dict(ck.conv_module_residual.launches_by_design)
    bwd = dict(ck.conv_module_residual.launches_bwd_by_design)
    out = ck.conv_module_residual(x, mask, *params)
    grads = torch.autograd.grad(out, [x] + params, dy, retain_graph=True)
    torch.cuda.synchronize()
    assert ck.conv_module_residual.launches_by_design == dict(
        fwd, wgmma=fwd["wgmma"] + 1)
    assert ck.conv_module_residual.launches_bwd_by_design == dict(
        bwd, wgmma=bwd["wgmma"] + 1)
    again = torch.autograd.grad(out, [x] + params, dy)
    with torch.no_grad():
        args = ck._prep(x, mask, *params)
        want = ck.conv_module_forward_plain(x, *args)
        rgrads = ck.conv_module_backward_plain(x, args[0], dy, *args[1:])
    _close(out, want, 2e-2)
    assert len(grads) == len(rgrads) == 12
    for a, b, c in zip(grads, rgrads, again):
        _close(a, b, 2e-2)
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_conv_plan_matches_the_c_plan():
    """``conv_kernel.conv_plan``'s design equals ``csrc/conv_module.cu``'s
    ``ishara_conv_plan``'s on both sides of every limit of the rule, and
    the C plan's wgmma layout (which it alone owns) fits: 48 / 32 own rows
    a tile, rings of 3 or more slots forward and 4 backward, each block
    within the 227 KiB an H100 block may take."""
    _card()
    from ishara_tpu_torch.ops import conv_kernel as ck

    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128, 144, 192, 256, 320, 512):
            for E in (64, 96, 128, 256, 512, 1024, 2048):
                for K in (1, 3, 15, 16, 17, 33):
                    c = ck.c_plan(dtype, D, E, K)
                    assert ck.conv_plan(dtype, D, E, K) == c["design"], \
                        (dtype, D, E, K)
                    if c["design"] != "wgmma":
                        continue
                    assert (c["fwd_rows"], c["bwd_rows"]) == (48, 32)
                    assert c["fwd_slots"] >= 3 and c["bwd_slots"] == 4
                    assert max(c["fwd_smem"], c["bwd_smem"]) \
                        <= ck.SMEM_LIMIT, (D, E, K, c)


def _off_alignment(t):
    """A contiguous copy of ``t`` two bytes off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["w1", "x", "dy"])
def test_conv_wgmma_launch_it_refuses_raises(what):
    """A launch the wgmma design refuses raises, and no other design takes
    it: W1 two bytes off the 16-byte alignment a TMA tensor map needs (the
    C call refuses it), or x or dy two bytes off the 16-byte vectors the
    kernels read (the wrapper refuses them before any launch); the context
    stays usable."""
    _card()
    from ishara_tpu_torch.ops import conv_kernel as ck

    g = torch.Generator(device="cuda").manual_seed(1)
    x, mask, params = _conv_case(2, 40, 64, 128, 15, 4, torch.bfloat16, g)
    x, params = x.detach(), [p.detach() for p in params]
    if what == "w1":         # in the compute type, so _prep keeps it
        params[2] = _off_alignment(params[2].to(torch.bfloat16))
    if what == "x":
        x = _off_alignment(x)
    before = (ck.conv_module_residual.launches,
              ck.conv_module_residual.launches_bwd,
              dict(ck.conv_module_residual.launches_by_design),
              dict(ck.conv_module_residual.launches_bwd_by_design))
    if what == "dy":
        x.requires_grad_()
        out = ck.conv_module_residual(x, mask, *params)
        dy = _off_alignment(torch.ones_like(out))
        with pytest.raises(ValueError, match="dy on 16 bytes"):
            torch.autograd.grad(out, [x], dy)
        assert ck.conv_module_residual.launches == before[0] + 1
        assert ck.conv_module_residual.launches_bwd == before[1]
    else:
        err = RuntimeError if what == "w1" else ValueError
        match = "conv-module forward" if what == "w1" else "x on 16 bytes"
        with pytest.raises(err, match=match):
            ck.conv_module_residual(x, mask, *params)
        assert (ck.conv_module_residual.launches,
                ck.conv_module_residual.launches_by_design) \
            == (before[0], before[2])
    torch.cuda.synchronize()
    assert torch.isfinite(torch.ones(4, device="cuda").sum())


@pytest.mark.cuda
def test_conv_wgmma_kernels_fit_their_registers():
    """ptxas's report of the wgmma design's kernels (every D it takes) and
    of the wgmma weight product (csrc/wgrad.cuh): no spills, and no product
    serialised (no C75xx warning)."""
    _card()
    from ishara_tpu_torch.ops import _build
    from ishara_tpu_torch.ops import conv_kernel as ck

    ck.c_plan(torch.bfloat16, 256, 512, 15)    # builds the library
    text = _build.build_log("conv_module")
    assert "C75" not in text
    blocks = re.split(r"ptxas info\s+: Compiling entry function", text)
    wg = [b for b in blocks if "wg_kernel" in b.split("\n")[0]]
    assert len(wg) == 9   # forward and backward at D 64 to 256, the product
    assert sum("product_wg_kernel" in b.split("\n")[0] for b in wg) == 1
    for b in wg:
        assert "0 bytes spill stores" in b, b[:300]


@pytest.mark.cuda
def test_conv_tile_smem_mirrors_the_kernel():
    """``conv_kernel.tile_smem`` equals the shared memory
    ``csrc/conv_module.cu`` computes for every tile configuration, at
    widths on and off the tensor-core grid and 1 to 63 taps."""
    _card()
    from ishara_tpu_torch.ops import conv_kernel as ck

    for (dtype, backward), configs in ck._TILE_CONFIGS.items():
        for cfg, (mtp, _, ec) in enumerate(configs):
            for D in (48, 64, 144, 256, 512):
                for K in (1, 3, 15, 16, 17, 31, 32, 33, 48, 63, 64, 65):
                    assert ck.tile_smem(dtype, backward, mtp, ec, D, K) \
                        == ck.c_tile_smem(dtype, backward, cfg, D, K), \
                        (dtype, backward, cfg, D, K)


@pytest.mark.cuda
def test_wide_depthwise_training_step_matches_plain(monkeypatch):
    """One training step of ``baseline_config(4)`` with
    ``transformer_kernel_size=33`` (bf16, dropout 0.4, batch 32) on the
    card runs K7 at every Squeezeformer block and matches the same step
    with K7 replaced by its plain version, from the same state and seeds:
    the loss to 5e-3 of itself, the gradient norm to 1e-3, and every
    gradient entry to 1e-1 of its leaf's largest entry (of 1e-3 of the
    largest over all leaves where a leaf's true gradient is zero): the bf16
    tolerance of ``test_training_step_on_the_card_matches_the_cpu``. One
    kernel call holds 2e-2; a gradient that crosses the eight blocks sums
    the roundings of each (measured on an H100: 3.5e-2 of
    ``squeezeformer.0.norm1.weight``'s largest entry)."""
    _card()
    import dataclasses

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.ops import conv_kernel as ck
    from ishara_tpu_torch.preprocess import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = dataclasses.replace(baseline_config(4).model,
                              transformer_kernel_size=33)
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    batch = SyntheticASLFR(num_sequences=32, seed=3).batch(
        range(32), CTCTokenizer(), max_frames=96)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=0.2, with_grads=True)
    state = TrainState.create(model, tx, device="cuda")
    before = (ck.conv_module_residual.launches,
              ck.conv_module_residual.launches_bwd)
    _, mk = step(state.clone(), batch, seed=1)
    assert (ck.conv_module_residual.launches,
            ck.conv_module_residual.launches_bwd) \
        == (before[0] + 4, before[1] + 4)
    monkeypatch.setattr(ck, "_launch_fwd", lambda x, args:
                        ck.conv_module_forward_plain(x, *args, with_p=True))
    monkeypatch.setattr(ck, "_launch_bwd", lambda x, dy, args, p:
                        ck.conv_module_backward_plain(x, args[0], dy,
                                                      *args[1:], p=p))
    _, mp = step(state.clone(), batch, seed=1)
    assert abs(float(mk["loss"]) - float(mp["loss"])) \
        <= 5e-3 * abs(float(mp["loss"]))
    assert abs(float(mk["grad_norm"]) - float(mp["grad_norm"])) \
        <= 1e-3 * float(mp["grad_norm"])
    largest = max(float(g.abs().max()) for g in mp["grads"].values())
    for name, want in mp["grads"].items():
        err = float((mk["grads"][name] - want).abs().max())
        scale = max(float(want.abs().max()), 1e-3 * largest)
        assert err <= 1e-1 * scale, (name, err, scale)


@pytest.mark.cuda
def test_conv_module_kernel_refuses_what_it_cannot_take():
    _card()
    from ishara_tpu_torch.ops import conv_kernel as ck

    g = torch.Generator(device="cuda").manual_seed(0)
    x, mask, params = _conv_case(2, 8, 16, 32, 3, 2, torch.float32, g)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ck.conv_module_residual(x.detach().half(), mask, *params)
    bad = list(params)
    bad[2] = torch.zeros((16, 30), device="cuda")       # w1 against b1
    with pytest.raises(ValueError, match="b1"):
        ck.conv_module_residual(x, mask, *bad)


@pytest.mark.cuda
def test_long_sequence_step_on_the_card_matches_the_cpu():
    """One fused training step of a narrow long-sequence hybrid (T 400,
    attention dropout 0: the table's long row, so the card runs the tiled
    attention kernel; the conv-module kernel, which the table leaves to the
    composition at f32, runs by ``fused=True``) on the card and on the CPU
    (compositions), from the same weights and seeds, at f32: loss, gradient
    norm and every gradient."""
    _card()
    import copy

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.ops import attention_blocked as ab
    from ishara_tpu_torch.ops import conv_kernel as ck
    from ishara_tpu_torch.preprocess import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    # 400 frames a sequence give f32 sums over 12x the rows of the step
    # above, run in another order on each side. Measured on an H100: 8e-8
    # on the loss, 2.1e-5 on the norm and 3.4e-4 of a leaf's largest entry
    # -- and 8e-8, 6.9e-5, 3.4e-4 with every kernel swapped for its plain
    # version on the card: the compositions around the kernels set it
    LOSS_TOL, NORM_TOL, GRAD_TOL = 1e-6, 1e-4, 1e-3
    cfg = EncoderConfig(variant="hybrid", dim=64, num_heads=4,
                        num_squeeze_blocks=1, num_conform_blocks=1,
                        frame_len=400, dropout=0.0, top_dropout=0.2)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    _force_conv_kernel(model)
    batch = SyntheticASLFR(num_sequences=4, frames_per_char=16,
                           seed=3).batch(range(4), CTCTokenizer(),
                                         max_frames=600)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), 400,
                                     aug_prob=0.2, with_grads=True)
    cpu = TrainState.create(copy.deepcopy(model), tx, device="cpu")
    card = TrainState.create(copy.deepcopy(model), tx, device="cuda")
    before = (ck.conv_module_residual.launches_bwd,
              ab.flash_mhsa_blocked.launches_bwd)
    _, mc = step(cpu, batch, seed=1)
    _, mg = step(card, batch, seed=1)
    assert (ck.conv_module_residual.launches_bwd,
            ab.flash_mhsa_blocked.launches_bwd) \
        == (before[0] + 1, before[1] + 2)
    assert abs(float(mg["loss"]) - float(mc["loss"])) \
        <= LOSS_TOL * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        <= NORM_TOL * float(mc["grad_norm"])
    largest = max(float(g.abs().max()) for g in mc["grads"].values())
    for name, want in mc["grads"].items():
        err = float((mg["grads"][name].cpu() - want).abs().max())
        scale = max(float(want.abs().max()), 1e-3 * largest)
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_step_on_the_card_matches_the_cpu(dtype):
    """One fused training step of a small hybrid model with dropout and
    augmentation on, on the card (the kernels, chosen by the selection
    table) and on the CPU (compositions and plain versions), from the same
    weights and seeds. A site's masks are a function of its seeds and the
    element's position whichever path runs, so the two steps are the same
    computation: the loss, the gradient norm and every parameter's gradient
    agree to LOSS_TOL, NORM_TOL and, per entry, GRAD_TOL of the leaf's
    largest entry (of the largest over all leaves where a leaf's true
    gradient is zero). At f32 the two differ in summation order and in
    expf / logf; at bf16 the CPU's and the card's matmuls also round
    apart."""
    _card()
    import copy

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import ffn_kernel as fk
    from ishara_tpu_torch.preprocess import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    # measured on an H100: 7e-8, 7e-7, 5e-5 at f32; 2e-5, 2e-4, 7e-2 at bf16
    LOSS_TOL, NORM_TOL, GRAD_TOL = {"float32": (1e-6, 1e-5, 2e-4),
                                    "bfloat16": (1e-3, 2e-3, 1e-1)}[dtype]
    cfg = EncoderConfig(variant="hybrid", dim=128, num_heads=4,
                        num_squeeze_blocks=1, num_conform_blocks=1,
                        frame_len=32, dropout=0.2, top_dropout=0.2,
                        dtype=dtype)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    batch = SyntheticASLFR(num_sequences=8, seed=3).batch(
        range(8), CTCTokenizer(), max_frames=64)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), 32, aug_prob=0.2,
                                     with_grads=True)
    cpu = TrainState.create(copy.deepcopy(model), tx, device="cpu")
    card = TrainState.create(copy.deepcopy(model), tx, device="cuda")
    before = (fk.ffn_residual.launches_bwd, at.flash_mhsa.launches_bwd)
    _, mc = step(cpu, batch, seed=1)
    _, mg = step(card, batch, seed=1)
    # both dtypes run the feed-forward and attention kernels on the card
    assert (fk.ffn_residual.launches_bwd, at.flash_mhsa.launches_bwd) \
        == (before[0] + 4, before[1] + 2)
    assert abs(float(mg["loss"]) - float(mc["loss"])) \
        <= LOSS_TOL * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        <= NORM_TOL * float(mc["grad_norm"])
    largest = max(float(g.abs().max()) for g in mc["grads"].values())
    for name, want in mc["grads"].items():
        err = float((mg["grads"][name].cpu() - want).abs().max())
        scale = max(float(want.abs().max()), 1e-3 * largest)
        assert err <= GRAD_TOL * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# Translation training: K2 on the attention probabilities of the
# encoder-decoder model at the reference width (batch 256, 8 heads, T 176,
# labels of 64 tokens: encoder self-attention [256, 8, 176, 176], decoder
# self-attention [256, 8, 63, 63] and cross-attention [256, 8, 63, 176]),
# and one translation training step on the card against the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 8, 176, 176), (256, 8, 63, 63),
                                   (256, 8, 63, 176)])
def test_dropout_kernel_on_attention_probabilities(shape):
    """f32 probabilities at rate 0.1: forward and backward equal the plain
    Philox version exactly; the mask is a function of the flat index
    alone, so another factorisation of the same tensor drops the same
    elements; the keep share is 0.9."""
    _card()
    from ishara_tpu_torch.ops import dropout as dr

    g = torch.Generator(device="cuda").manual_seed(2)
    p = torch.softmax(torch.randn(shape, generator=g, device="cuda"), -1)
    dy = torch.randn(shape, generator=g, device="cuda")
    seed = torch.tensor([4321], dtype=torch.int32, device="cuda")
    pr = p.clone().requires_grad_()
    out = dr.fast_dropout(pr, seed, 0.1)
    (dx,) = torch.autograd.grad(out, pr, dy)
    assert torch.equal(out, dr.dropout_plain(p, seed, 0.1))
    assert torch.equal(dx, dr.dropout_plain(dy, seed, 0.1))
    flat = dr.fast_dropout(p.reshape(-1, shape[-1]), seed, 0.1)
    assert torch.equal(flat.reshape(shape), out)
    kept = float((out != 0).float().mean())
    assert abs(kept - 0.9) < 1e-3, kept


@pytest.mark.cuda
def test_translation_step_on_the_card_matches_the_cpu():
    """One fused translation training step (a narrow encoder-decoder: dim
    64, 4 heads, 2 + 2 layers, T 32, labels of 64 tokens, batch 8, dropout
    0.1 and augmentation on) on the card, where every dropout site is the
    kernel, and on the CPU (plain versions), from the same weights and
    seeds, at f32: the loss, the gradient norm and every parameter's
    gradient, per entry within GRAD_TOL of the leaf's largest entry (of 1e-2
    of the largest over all leaves, where a leaf's true gradient is zero:
    the conv biases in front of BatchNorms carry rounding noise of ~1e-6 of
    the largest gradient); each of the 23 sites launches the kernel once
    forward and once backward."""
    _card()
    import copy

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer
    from ishara_tpu_torch.models.seq2seq import ASLTranslationModel
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.preprocess import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_translation_train_step,
        make_optimizer,
    )

    # measured on an H100: loss 0 (3e-7 at dropout 0), norm 3.5e-5 (4.0e-5),
    # the largest gradient leaf 4.9e-5, the zero-gradient biases 1e-6 of
    # the largest gradient
    LOSS_TOL, NORM_TOL, GRAD_TOL = 1e-6, 1e-4, 2e-4
    tok = Seq2SeqTokenizer()
    torch.manual_seed(0)
    model = ASLTranslationModel(num_classes=tok.vocab_size, feature_dim=64,
                                num_heads=4, dropout=0.1)
    batch = SyntheticASLFR(num_sequences=8, seed=3).batch(
        range(8), tok, max_frames=64)
    tx, _ = make_optimizer(TrainConfig(optimizer="adamw", lr_max=1e-3,
                                       steps_per_epoch=10))
    step = make_fused_translation_train_step(GroupStats.identity(), 32,
                                             aug_prob=0.2, with_grads=True)
    cpu = TrainState.create(copy.deepcopy(model), tx, device="cpu",
                            lookahead_sync_period=1)
    card = TrainState.create(copy.deepcopy(model), tx, device="cuda",
                             lookahead_sync_period=1)
    before = (dr.fast_dropout.launches, dr.fast_dropout.launches_bwd)
    _, mc = step(cpu, batch, seed=1)
    _, mg = step(card, batch, seed=1)
    assert model.num_sites == 23
    assert (dr.fast_dropout.launches, dr.fast_dropout.launches_bwd) \
        == (before[0] + 23, before[1] + 23)
    assert abs(float(mg["loss"]) - float(mc["loss"])) \
        <= LOSS_TOL * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        <= NORM_TOL * float(mc["grad_norm"])
    largest = max(float(g.abs().max()) for g in mc["grads"].values())
    for name, want in mc["grads"].items():
        err = float((mg["grads"][name].cpu() - want).abs().max())
        scale = max(float(want.abs().max()), 1e-2 * largest)
        assert err <= GRAD_TOL * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# K9, the translation decode loop in one launch (ops/csrc/decoder.cu), at
# the reference width: dim 208, 8 heads of 26, 2 decoder layers, 62
# classes, T = 176 with a padded tail, max_out 64 (and 18). Tokens exactly;
# beam scores (sums of up to 63 log-probabilities, ~-150) within 1e-6 of
# their size: the same f32 arithmetic in another summation order. The eos
# bias makes the loop stop inside the kernel (greedy) and finishes one beam
# early while the others go on.
# ---------------------------------------------------------------------------

def _translation_model(dim=208, heads=8):
    from ishara_tpu_torch.models.seq2seq import ASLTranslationModel

    _card()
    m = ASLTranslationModel(num_classes=62, feature_dim=dim, num_layers=2,
                            num_decoder_layers=2, num_heads=heads).cuda()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in m.state_dict().items():
            n = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                n = 0.5 + torch.rand(t.shape, generator=g)
            elif t.dim() >= 2:
                n = n / math.sqrt(t.shape[-1])
            elif name.endswith("weight"):
                n = 1.0 + 0.1 * n
            else:
                n = 0.1 * n
            t.copy_(n)
    memory = torch.randn((1, 176, dim), generator=g).cuda()
    mask = (torch.arange(176) < 150)[None].cuda()
    return m, memory, mask


@pytest.mark.cuda
@pytest.mark.parametrize("max_len,width,eos_bias,dim,heads", [
    (64, 1, 0.0, 208, 8), (18, 1, 0.0, 208, 8), (64, 1, 6.0, 208, 8),
    (64, 4, 0.0, 208, 8), (64, 3, 0.0, 208, 8), (64, 4, 3.0, 208, 8),
    (64, 1, None, 208, 8), (64, 8, 0.0, 208, 8), (64, 12, 0.0, 208, 8),
    (64, 1, 0.0, 320, 2), (64, 4, 0.0, 320, 2)])
def test_decode_kernel_matches_plain(max_len, width, eos_bias, dim, heads):
    """Greedy (width 1) and beam decodes: the kernel's tokens and scores
    against its plain version on the card, one launch a decode; the last
    reference case is the beam form at width 1, against greedy. Beam 8
    and 12 (its caches in global memory) and heads of 160 (dim 320, 2
    heads) are geometries the first design refused."""
    from ishara_tpu_torch.ops import decoder_kernel as dk

    m, memory, mask = _translation_model(dim, heads)
    pack = dk.pack_decoder(m)
    if eos_bias:
        off = pack.numel() - 62 * dim - 62 + 2        # the eos logit's bias
        pack[off] += eos_bias
    beam = eos_bias is None or width > 1
    fn = dk.fused_beam_decode if beam else dk.fused_greedy_decode
    before = fn.launches
    if beam:
        got, scores = fn(m, memory, mask, max_len=max_len, beam_width=width,
                         pack=pack)
    else:
        got = fn(m, memory, mask, max_len=max_len, pack=pack)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want, wscores, steps = dk.decode_plain(
        pack, dk.cross_pack(m, memory), dk.memory_add(mask, 176, "cuda"),
        d=dim, H=heads, L=2, C=62, max_len=max_len, beam_width=width,
        beam=beam)
    assert torch.equal(got, want), (got, want)
    if beam:
        assert torch.allclose(scores[:, 0], wscores, rtol=1e-6, atol=1e-5)
    if eos_bias is None:
        assert torch.equal(got, dk.fused_greedy_decode(m, memory, mask,
                                                       pack=pack))
    if eos_bias and not beam:
        assert steps < max_len - 1 and int((got == 2).sum()) == 1


@pytest.mark.cuda
def test_decode_kernel_all_masked_memory():
    """An all-padding memory: uniform cross-attention weights, no NaN."""
    from ishara_tpu_torch.ops import decoder_kernel as dk

    m, memory, mask = _translation_model()
    mask = torch.zeros_like(mask)
    got, scores = dk.fused_beam_decode(m, memory, mask, beam_width=4)
    want, wscores, _ = dk.decode_plain(
        dk.pack_decoder(m), dk.cross_pack(m, memory),
        dk.memory_add(mask, 176, "cuda"), d=208, H=8, L=2, C=62,
        max_len=64, beam_width=4, beam=True)
    assert torch.equal(got, want)
    assert bool(scores.isfinite().all())
    assert torch.allclose(scores[:, 0], wscores, rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
def test_decode_kernel_vector_bytes_match_the_guard():
    """The shared memory the C side carves equals the Python guard's
    formula (``fused_decode_smem_bytes``)."""
    import ctypes

    from ishara_tpu_torch.ops import _build
    from ishara_tpu_torch.ops import decoder_kernel as dk

    _card()
    fn = _build.function("decoder", "ishara_decoder_vector_bytes",
                         [ctypes.c_int] * 7)
    for geo in [(208, 8, 2, 62, 176, 64, 1), (208, 8, 2, 62, 176, 64, 4),
                (32, 4, 1, 30, 12, 16, 3), (64, 2, 3, 10, 40, 8, 8),
                (208, 8, 2, 62, 176, 64, 12), (320, 2, 2, 62, 176, 64, 4)]:
        assert fn(*geo) == dk.fused_decode_smem_bytes(*geo), geo
        # the plan the card takes is decode_plan's at its cluster size
        got = dk.kernel_plan(torch.cuda.current_device(), *geo)
        want = dk.decode_plan(*geo, cluster=got["cluster"])
        for key in ("smem_bytes", "scratch_floats", "resident_bytes",
                    "streamed_bytes", "cache_smem", "cross_smem", "slots",
                    "slot_floats", "parts"):
            assert got[key] == int(want[key]), (geo, key)


@pytest.mark.cuda
@pytest.mark.parametrize("width,dim,heads", [(1, 208, 8), (4, 208, 8),
                                            (12, 208, 8), (4, 320, 2)])
def test_decode_kernel_is_deterministic(width, dim, heads):
    """Two launches on the same input give the same tokens and the same
    score bits: the partials are summed in rank order and a split head's
    partial scores in part order, never by atomics. The kernel's own
    counts of its exchanges are decode_plan's a step."""
    from ishara_tpu_torch.ops import decoder_kernel as dk

    m, memory, mask = _translation_model(dim, heads)
    pack = dk.pack_decoder(m)
    pack[pack.numel() - 62 * dim - 62 + 2] -= 1e4     # every step runs
    cross = dk.cross_pack(m, memory)
    madd = dk.memory_add(mask, 176, "cuda")
    args = (pack, cross, madd, dim, heads, 2, 62, 64, width, width > 1, 1, 2,
            0, 1e-6)
    first = dk._launch(*args)
    plan = dk.decode_plan(dim, heads, 2, 62, 176, 64, width,
                          cluster=first[3])
    assert first[2].tolist() == [
        63, 63 * plan["barriers_per_step"],
        63 * plan["score_exchanges_per_step"]]
    for _ in range(3):
        again = dk._launch(*args)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1].view(torch.int32),
                           first[1].view(torch.int32))
        assert torch.equal(again[2], first[2])


# ---------------------------------------------------------------------------
# The beam engines, bundles and the exported serving program on the card
# ---------------------------------------------------------------------------

def _serving_requests():
    rng = np.random.default_rng(8)
    reqs = [rng.random((T, 276)).astype(np.float32) for T in (10, 40, 90)]
    hands = rng.random((30, 276)).astype(np.float32)
    hands[:, :42] = np.nan
    hands[:, 92:134] = np.nan
    hands[:, 184:226] = np.nan
    return reqs + [hands, np.full((12, 276), np.nan, np.float32)]


def _cpu_beam(engine, raw, W, K, is_fused):
    """The request's log-probs from the card, copied off it, through the
    port's beam search on the CPU, then the fallback: (ids, count)."""
    from ishara_tpu_torch.decode.beam_device import beam_search_device
    from ishara_tpu_torch.preprocess.pipeline import preprocess
    from ishara_tpu_torch.serve.engine import FALLBACK_IDS

    buf = torch.zeros((engine.max_raw_frames, 276), device="cuda")
    n = min(len(raw), engine.max_raw_frames)
    buf[:n] = torch.from_numpy(raw[:n]).cuda()
    x = preprocess(buf, torch.tensor(max(n, 1), device="cuda"), engine.stats,
                   engine.frame_len, thin=True)
    with torch.no_grad():
        if is_fused:
            enc = fused.FusedEncoder(engine.model.cfg,
                                     engine.model.state_dict(),
                                     device="cuda")
            logits = enc(x)
        else:
            logits = engine.model(x[None])[0]
    lp = torch.log_softmax(logits.float(), dim=-1).cpu()
    ids, count, _ = beam_search_device(lp, beam_width=W, top_k=K,
                                       max_len=engine.max_out)
    ids, count = ids.numpy(), int(count)
    if count < 3:
        nfb = min(len(FALLBACK_IDS), engine.max_out)
        ids = np.full(engine.max_out, 59)
        ids[:nfb] = FALLBACK_IDS[:nfb]
        count = nfb
    return ids, count


@pytest.mark.cuda
@pytest.mark.parametrize("fused_mode", [False, True])
def test_beam_engine_on_the_card_matches_the_cpu_search(fused_mode):
    """The serving program's beam search on the card gives the ids and
    counts of the same search run on the CPU on the card's log-probs; the
    fused engine launches both stacks."""
    from ishara_tpu_torch.serve.engine import BatchedEngine, InferenceEngine

    m = _model("hybrid", 48)
    W, K = 4, 6
    eng = InferenceEngine(m, max_raw_frames=96, decode="beam",
                          beam_width=W, beam_top_k=K, fused=fused_mode,
                          device="cuda")
    fb.fused_squeezeformer_stack.launches = 0
    fb.fused_conformer_stack.launches = 0
    reqs = _serving_requests()
    got = [eng(r) for r in reqs]
    if fused_mode:
        assert fb.fused_squeezeformer_stack.launches == len(reqs)
        assert fb.fused_conformer_stack.launches == len(reqs)
    for raw, (ids, count) in zip(reqs, got):
        want_ids, want_count = _cpu_beam(eng, raw, W, K, fused_mode)
        assert count == want_count
        np.testing.assert_array_equal(ids, want_ids)
    batched = BatchedEngine(m, batch_size=len(reqs), max_raw_frames=96,
                            decode="beam", beam_width=W, beam_top_k=K,
                            fused=fused_mode, device="cuda")
    bids, bcounts = batched(reqs)
    for i, (ids, count) in enumerate(got):
        assert bcounts[i] == count
        np.testing.assert_array_equal(bids[i], ids)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_bundle_round_trip_on_the_card(tmp_path, form):
    """A bundle written on the card and read back with the port's codec
    serves the ids of an engine on the same (rounded or dequantized)
    weights, fused, with both stacks launched."""
    from ishara_tpu_torch.config import IsharaConfig
    from ishara_tpu_torch.serve.engine import InferenceEngine
    from ishara_tpu_torch.serve.export import export_model, load_engine

    m = _model("hybrid", 48)
    kw = {"f32": dict(half_precision=False), "bf16": {},
          "int8": dict(quantize_int8=True)}[form]
    export_model(tmp_path, IsharaConfig(model=m.cfg), m, **kw)
    sd = {k: v.detach().cpu() for k, v in m.state_dict().items()}
    if form == "bf16":
        sd = {k: v.to(torch.bfloat16).float() if v.is_floating_point()
              else v for k, v in sd.items()}
    elif form == "int8":
        sd = fb.dequantize_serving_weights(fb.quantize_serving_weights(sd))
    direct = build_model(m.cfg, device="cuda")
    direct.load_state_dict(sd)
    want = InferenceEngine(direct, max_raw_frames=96, fused=True,
                           device="cuda")
    got = load_engine(tmp_path, max_raw_frames=96, fused=True)
    fb.fused_squeezeformer_stack.launches = 0
    for raw in _serving_requests():
        ids, count = got(raw)
        want_ids, want_count = want(raw)
        assert count == want_count
        np.testing.assert_array_equal(ids, want_ids)
    assert fb.fused_squeezeformer_stack.launches > 0


@pytest.mark.cuda
def test_exported_fused_beam_program_on_the_card(tmp_path):
    """``export_serving_program`` of a fused beam engine on the card: the
    loaded program gives the engine's ids and launches the stack kernels
    (the stages the device counted)."""
    from ishara_tpu_torch.serve.engine import InferenceEngine
    from ishara_tpu_torch.serve.export import (
        export_serving_program,
        load_serving_program,
    )

    m = _model("hybrid", 48)
    eng = InferenceEngine(m, max_raw_frames=96, decode="beam", beam_width=4,
                          beam_top_k=6, fused=True, device="cuda")
    export_serving_program(tmp_path, eng)
    program = load_serving_program(tmp_path)
    for raw in _serving_requests():
        ids, count = eng(raw)
        buf = torch.zeros((96, 276), device="cuda")
        n = min(len(raw), 96)
        buf[:n] = torch.from_numpy(raw[:n]).cuda()
        for c in fb._COUNTERS.values():
            c.zero_()
        got_ids, got_count = program(buf, torch.tensor(max(n, 1),
                                                       dtype=torch.int32,
                                                       device="cuda"))
        assert int(got_count) == count
        np.testing.assert_array_equal(got_ids.cpu().numpy(), ids)
        assert sum(int(c.item()) for c in fb._COUNTERS.values()) > 0


# ---------------------------------------------------------------------------
# Causal mode, streaming and the parallel-branches and U-Net families
# ---------------------------------------------------------------------------

def _force_conv_kernel(model):
    """``fused=True`` on every Squeezeformer conv module: the selection
    table sends f32 to the composition, and these steps hold the kernel's
    f32 path to the CPU (a causal module keeps its composition)."""
    from ishara_tpu_torch.models.layers import SqueezeformerConvModule

    for m in model.modules():
        if isinstance(m, SqueezeformerConvModule):
            m.fused = True


def _step_on_card_and_cpu(cfg, dtype="float32"):
    """One fused training step (dropout and augmentation on) of ``cfg``'s
    model on the card and on the CPU from the same weights and seeds:
    (card metrics, CPU metrics, launches counted on the card by wrapper).
    The conv-module kernel is forced (:func:`_force_conv_kernel`)."""
    import copy

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab
    from ishara_tpu_torch.ops import conv_kernel as cm
    from ishara_tpu_torch.ops import ctc_kernel as ck
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.ops import ffn_kernel as fk
    from ishara_tpu_torch.preprocess import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    _force_conv_kernel(model)
    batch = SyntheticASLFR(num_sequences=8, seed=3).batch(
        range(8), CTCTokenizer(), max_frames=64)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=0.2, with_grads=True)
    cpu = TrainState.create(copy.deepcopy(model), tx, device="cpu")
    card = TrainState.create(copy.deepcopy(model), tx, device="cuda")
    wrappers = {"flash_mhsa": at.flash_mhsa,
                "flash_mhsa_blocked": ab.flash_mhsa_blocked,
                "conv_module_residual": cm.conv_module_residual,
                "ffn_residual": fk.ffn_residual,
                "fast_dropout": dr.fast_dropout,
                "fast_dropout_add": dr.fast_dropout_add,
                "ctc_loss_kernel": ck.ctc_loss_kernel}
    before = {n: w.launches_bwd for n, w in wrappers.items()}
    _, mc = step(cpu, batch, seed=1)
    _, mg = step(card, batch, seed=1)
    launched = {n: w.launches_bwd - before[n] for n, w in wrappers.items()}
    return mg, mc, launched


def _assert_step_matches(mg, mc, dtype):
    LOSS_TOL, NORM_TOL, GRAD_TOL = {"float32": (1e-6, 1e-5, 2e-4),
                                    "bfloat16": (1e-3, 2e-3, 1e-1)}[dtype]
    assert abs(float(mg["loss"]) - float(mc["loss"])) \
        <= LOSS_TOL * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        <= NORM_TOL * float(mc["grad_norm"])
    largest = max(float(g.abs().max()) for g in mc["grads"].values())
    for name, want in mc["grads"].items():
        err = float((mg["grads"][name].cpu() - want).abs().max())
        scale = max(float(want.abs().max()), 1e-3 * largest)
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_step_on_the_card_matches_the_cpu(dtype):
    """A causal hybrid's fused step on the card against the CPU's, at the
    tolerances of ``test_training_step_on_the_card_matches_the_cpu``: on
    the card the feed-forward, dropout and CTC kernels run, and neither
    attention kernel nor the conv-module kernel (which implement the
    bidirectional semantics) launches, though the selection table picks
    them for this geometry's bidirectional model."""
    _card()
    cfg = EncoderConfig(variant="hybrid", dim=128, num_heads=4,
                        num_squeeze_blocks=1, num_conform_blocks=1,
                        frame_len=32, dropout=0.2, top_dropout=0.2,
                        dtype=dtype, causal=True, attn_context=20)
    mg, mc, launched = _step_on_card_and_cpu(cfg, dtype)
    assert launched["flash_mhsa"] == launched["flash_mhsa_blocked"] \
        == launched["conv_module_residual"] == 0
    assert launched["ffn_residual"] == 4 and launched["ctc_loss_kernel"] == 1
    # the two attention sites' probabilities and the top dropout; the
    # Squeezeformer block's attention residual
    assert launched["fast_dropout"] == 3
    assert launched["fast_dropout_add"] == 1
    _assert_step_matches(mg, mc, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["parallel_branches",
                                     "squeezeformer_unet"])
def test_new_family_step_on_the_card_matches_the_cpu(variant):
    """One fused step of each new family on the card (its kernels) against
    the CPU's (their plain versions), f32, at the tolerances above:
    parallel_branches runs the attention, feed-forward, conv-module,
    dropout and CTC kernels; the U-Net's relative attention and plain FFNs
    run the dropout and CTC kernels only."""
    _card()
    cfg = EncoderConfig(variant=variant, dim=128, num_heads=4,
                        num_squeeze_blocks=4 if variant.endswith("unet")
                        else 1, num_conform_blocks=1, frame_len=32,
                        dropout=0.2, top_dropout=0.2)
    mg, mc, launched = _step_on_card_and_cpu(cfg)
    assert launched["ctc_loss_kernel"] == 1 and launched["fast_dropout"] > 0
    if variant == "parallel_branches":
        assert launched["flash_mhsa"] == 2
        assert launched["ffn_residual"] == 4
        assert launched["conv_module_residual"] == 1
    else:
        assert launched["fast_dropout"] == 12      # three sites a block
        assert launched["flash_mhsa"] == launched["ffn_residual"] \
            == launched["conv_module_residual"] == 0
    _assert_step_matches(mg, mc, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 8])
def test_streaming_on_the_card_matches_the_batch_causal_forward(chunk):
    """``StreamingEncoder`` on the card against the batch causal forward on
    the card (f32, unresampled frames with NaN hands and all-NaN frames
    mid-stream): logits to 1e-4, the same emitted ids as a greedy collapse
    of the batch logits."""
    _card()
    from ishara_tpu_torch.data import landmarks as lm
    from ishara_tpu_torch.preprocess.pipeline import _TABLES
    from ishara_tpu_torch.serve.streaming import StreamingEncoder

    T = 48
    cfg = EncoderConfig(variant="hybrid", dim=64, num_heads=4,
                        num_squeeze_blocks=2, num_conform_blocks=2,
                        frame_len=T, causal=True, attn_context=20)
    model = build_model(cfg, device="cuda")
    # the seeded weights and statistics of the same structure, bidirectional
    model.load_state_dict(_model("hybrid", T).state_dict())
    rng = np.random.default_rng(7)
    raw = rng.random((T, lm.N_COLS)).astype(np.float32) * 0.8 + 0.1
    raw[10:16, lm.GROUP_IDX["rhand"].ravel()] = np.nan
    raw[30:33] = np.nan
    x = torch.from_numpy(np.nan_to_num(raw[:, _TABLES["out"]])).cuda()
    with torch.no_grad():
        want = model(x[None])[0]
    eng = StreamingEncoder(cfg, model, chunk_size=chunk)
    state, got, emitted = eng.init_state(), [], []
    for i in range(0, T, chunk):
        state, ids, _, logits = eng.step(state, raw[i:i + chunk])
        got.append(logits)
        emitted.append(ids)
    got = torch.cat(got)
    assert got.is_cuda
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    collapsed, prev = [], cfg.blank_id
    for t in want.argmax(-1).tolist():
        if t != prev and t != cfg.blank_id:
            collapsed.append(t)
        prev = t
    assert StreamingEncoder.collect(emitted) == collapsed


# ---------------------------------------------------------------------------
# The element offsets of a data-parallel rank's rows; QAT and remat steps
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fast_dropout", "fast_dropout_add",
                                    "flash_mhsa", "ffn_residual"])
def test_offset_kernels_match_plain_and_the_full_launch(kernel, dtype):
    """Rows [3, 7) of a batch of 7 with the offset of those rows: the
    kernel equals the same rows of the whole batch's launch bit for bit
    (forward and input gradients) and its plain version with the offset
    (the dropout kernels bit for bit, the others to their kernel
    tolerance)."""
    _card()
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.ops import ffn_kernel as fk

    g = torch.Generator(device="cuda").manual_seed(4)
    seed = torch.tensor([99], dtype=torch.int32, device="cuda")
    B, T, D, r0 = 7, 21, 64, 3
    tol = 2e-4 if dtype == torch.float32 else 2e-2

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def run(fn, inputs, dy):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, dy)

    if kernel.startswith("fast_dropout"):
        add = kernel == "fast_dropout_add"
        w = getattr(dr, kernel)
        x, res, dy = rand(B, T, D), rand(B, T, D), rand(B, T, D)
        off = r0 * T * D

        def fn(*t, o=0):
            return w(t[0], t[1], seed, 0.3, o) if add else w(t[0], seed, 0.3,
                                                            o)
        ins = [res, x] if add else [x]
        full, fg = run(fn, ins, dy)
        part, pg = run(lambda *t: fn(*t, o=off), [t[r0:] for t in ins],
                       dy[r0:])
        plain = dr.dropout_plain(x[r0:], seed, 0.3,
                                 res[r0:] if add else None, off)
        assert torch.equal(part, plain)
    elif kernel == "flash_mhsa":
        H, Dh = 4, 16
        q, k, v, dy = (rand(B, H, T, Dh) for _ in range(4))
        mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
        mask[::2, T - 6:] = False
        bias = at.mask_to_bias(mask)
        off = r0 * H * T * T

        def fn(q, k, v, o=0, b=bias):
            return at.flash_mhsa(q, k, v, b, seed, 0.25, 0.3, offset=o)

        full, fg = run(fn, [q, k, v], dy)
        part, pg = run(lambda *t: fn(*t, o=off, b=bias[r0:]),
                       [q[r0:], k[r0:], v[r0:]], dy[r0:])
        po, lse = at.mhsa_forward_plain(q[r0:], k[r0:], v[r0:], bias[r0:],
                                        seed, 0.25, 0.3, offset=off)
        pgr = at.mhsa_backward_plain(q[r0:], k[r0:], v[r0:], bias[r0:], seed,
                                     po, lse, dy[r0:], 0.25, 0.3, offset=off)
        _close(part, po, tol)
        for a, b in zip(pg, pgr):
            _close(a, b, tol)
    else:
        M = 128
        x, res, dy = rand(B, T, D), rand(B, T, D), rand(B, T, D)
        w1 = torch.randn(D, M, generator=g, device="cuda") * D ** -0.5
        w2 = torch.randn(M, D, generator=g, device="cuda") * M ** -0.5
        b1 = torch.randn(M, generator=g, device="cuda") * 0.1
        b2 = torch.randn(D, generator=g, device="cuda") * 0.1
        seeds = torch.tensor([3, 4], dtype=torch.int32, device="cuda")

        def fn(x, res, r=0):
            return fk.ffn_residual(x, res, w1, b1, w2, b2, seeds, 0.3, 0.2, r)

        full, fg = run(fn, [x, res], dy)
        part, pg = run(lambda *t: fn(*t, r=r0 * T), [x[r0:], res[r0:]],
                       dy[r0:])
        n = (B - r0) * T
        want = fk.ffn_forward_plain(
            x[r0:].reshape(n, D), res[r0:].reshape(n, D), w1.to(dtype), b1,
            w2.to(dtype), b2, seeds, 0.3, 0.2, row_offset=r0 * T)
        _close(part.reshape(n, D), want, tol)
        m1, m2 = fk.debug_masks(n, M, D, seeds, 0.3, 0.2, r0 * T)
        c1, c2 = fk.debug_masks(n, M, D, seeds.cpu(), 0.3, 0.2, r0 * T)
        assert torch.equal(m1.cpu(), c1) and torch.equal(m2.cpu(), c2)
    assert torch.equal(part, full[r0:])
    for a, b in zip(pg, fg):
        assert torch.equal(a, b[r0:])


def _small_step_on_card_and_cpu(qat=False, remat=False):
    """One fused step of a small hybrid (dim 128, dropout and augmentation
    on, f32) on the card and on the CPU from the same weights and seeds."""
    import copy

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.preprocess import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = EncoderConfig(variant="hybrid", dim=128, num_heads=4,
                        num_squeeze_blocks=1, num_conform_blocks=1,
                        frame_len=32, dropout=0.2, top_dropout=0.2,
                        remat=remat)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    batch = SyntheticASLFR(num_sequences=8, seed=3).batch(
        range(8), CTCTokenizer(), max_frames=64)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), 32, aug_prob=0.2,
                                     with_grads=True, qat=qat)
    cpu = TrainState.create(copy.deepcopy(model), tx, device="cpu")
    card = TrainState.create(copy.deepcopy(model), tx, device="cuda")
    cpu, mc = step(cpu, batch, seed=1)
    card, mg = step(card, batch, seed=1)
    return (card, mg), (cpu, mc)


def _assert_small_step_close(mg, mc):
    # test_training_step_on_the_card_matches_the_cpu's f32 tolerances
    assert abs(float(mg["loss"]) - float(mc["loss"])) \
        <= 1e-6 * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        <= 1e-5 * float(mc["grad_norm"])
    largest = max(float(g.abs().max()) for g in mc["grads"].values())
    for name, want in mc["grads"].items():
        err = float((mg["grads"][name].cpu() - want).abs().max())
        assert err <= 2e-4 * max(float(want.abs().max()), 1e-3 * largest), \
            name


@pytest.mark.cuda
def test_qat_step_on_the_card_matches_the_cpu():
    """The QAT step on the kernels (the fake-quantized weights reach the
    feed-forward and attention kernels' wrappers) against the same step on
    the CPU's plain versions."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    before = fk.ffn_residual.launches
    (_, mg), (_, mc) = _small_step_on_card_and_cpu(qat=True)
    assert fk.ffn_residual.launches == before + 4
    _assert_small_step_close(mg, mc)


@pytest.mark.cuda
def test_remat_step_on_the_card_is_the_plain_step():
    """``remat=True`` on the card: the same step as ``remat=False`` bit for
    bit (the recomputation launches the forward kernels again), and within
    the CPU step's tolerances of its plain versions."""
    _card()
    from ishara_tpu_torch.ops import ffn_kernel as fk

    (a, ma), (_, mc) = _small_step_on_card_and_cpu(remat=False)
    before = fk.ffn_residual.launches
    (b, mb), _ = _small_step_on_card_and_cpu(remat=True)
    assert fk.ffn_residual.launches == before + 8
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(a.params, b.params)
    for x, y in zip(a.batch_stats.values(), b.batch_stats.values()):
        assert torch.equal(x, y)
    _assert_small_step_close(mb, mc)
