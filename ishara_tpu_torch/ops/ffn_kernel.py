"""The feed-forward branch with its residual as one training kernel (port of
``ishara_tpu/ops/ffn_kernel.py``).

:func:`ffn_residual` replaces the Pallas ``ffn_residual``:
``res + drop2(Dense2(drop1(swish(Dense1(x)))))`` with both dropout masks
regenerated in the backward pass and the hidden recomputed there. On a CUDA
tensor it launches ``csrc/ffn.cu`` (bf16 or f32 activations, any widths;
:func:`ffn_plan` names the design that takes a shape) or raises; on a CPU
tensor it runs the plain version beside it (:func:`ffn_forward_plain`,
:func:`ffn_backward_plain`), which repeats the kernels' arithmetic and
rounding points: operands in ``x``'s dtype with f32 accumulation, the hidden
rounded to that dtype before the second product; in the backward ``g``,
``d`` and ``dh`` rounded before theirs, swish' in f32, ``db`` from the
unrounded f32 values, ``dres = dy``.

The masks are the Philox function of :mod:`.dropout`: the hidden's is keyed
by ``seeds[0]`` (flat index into ``[N, M]``), the output's by ``seeds[1]``
(flat index into ``[N, K]``), each from row ``row_offset`` on: a process
holding rows ``[r0, r1)`` of the batch's ``[N, K]`` rows passes ``r0`` and
draws the whole batch's masks there. :func:`debug_masks` exposes them; a
test may instead pass explicit keep masks to the plain versions.

**A slice of the hidden.** A tensor-parallel rank holds hidden columns
``[col0, col0 + M)`` of a hidden of ``width`` (``hidden = (width, col0)``):
its hidden mask is the unsharded launch's at those columns, and it passes no
residual, no ``b2`` and no output dropout, so that the kernel gives its
partial sum ``drop1(swish(x . w1 + b1)) . w2``; the caller sums the ranks'
partial sums and adds the bias, the output's dropout and the residual
(:class:`ishara_tpu_torch.models.layers.FusedFFN`).

The weight gradients are per-block f32 partial sums added in a fixed order
(no atomics), so they are the same from run to run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .dropout import keep_mask, threshold_of

_SPLIT_BLOCKS = 132   # blocks the weight-gradient products aim for: 1 an SM
_WGRAD_TILE, _WGRAD_STEP = 128, 64   # csrc/wgrad.cuh's output tile, row step


def wgrad_splits(n: int, p: int, q: int) -> int:
    """Row splits of ``csrc/wgrad.cuh``'s product ``A^T . B`` over ``n``
    rows (``A`` ``[n, p]``, ``B`` ``[n, q]``): enough splits that the
    ``128 x 128`` output tiles make about ``_SPLIT_BLOCKS`` blocks (the
    wgmma product runs one block an SM), and no more than one split a
    64-row step."""
    tiles = -(-p // _WGRAD_TILE) * -(-q // _WGRAD_TILE)
    return max(1, min(-(-n // _WGRAD_STEP), _SPLIT_BLOCKS // tiles))


# the weight product's designs (csrc/wgrad.cuh): wgmma for bf16 operands
# whose rows TMA reads (16-byte multiples: p, q multiples of 8), general
# (f32 FMAs) otherwise
def product_design(dtype, p: int, q: int) -> str:
    """The kernel ``csrc/wgrad.cuh`` runs ``A^T . B`` on for contiguous
    ``A`` ``[n, p]`` and ``B`` ``[n, q]`` of ``dtype`` (as K4's and K7's
    backwards give it): ``"wgmma"`` at bf16 with ``p`` and ``q``
    multiples of 8, ``"general"`` otherwise."""
    if dtype == torch.bfloat16 and p % 8 == 0 and q % 8 == 0:
        return "wgmma"
    return "general"


def weight_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A^T . B``, f32 ``[p, q]``, for ``a`` ``[n, p]`` and ``b`` ``[n,
    q]`` of one dtype (f32 or bf16): on a CUDA tensor ``csrc/wgrad.cuh``'s
    product over :func:`wgrad_splits` row splits and their fixed-order sum,
    as K4's and K7's backwards run it (``ishara_weight_product``), on the
    design :func:`product_design` names; on a CPU tensor its plain version,
    an f32 matmul of the widened operands. Gradients do not flow."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] \
            or a.dtype != b.dtype or a.device != b.device:
        raise ValueError("a [n, p] and b [n, q] must agree in rows, dtype "
                         "and device")
    if a.device.type == "cpu":
        return a.float().T @ b.float()
    if a.dtype not in _DTYPE_CODE:
        raise ValueError(f"the weight product takes f32 or bf16, got "
                         f"{a.dtype}")
    a, b = a.contiguous(), b.contiguous()
    (n, p), q = a.shape, b.shape[1]
    splits = wgrad_splits(n, p, q)
    part = torch.empty((splits, p * q), dtype=torch.float32, device=a.device)
    out = torch.empty((p, q), dtype=torch.float32, device=a.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("ffn", "ishara_weight_product",
                         [I, I, P, P, P, P, I, I, I, I, P])
    rc = fn(_build.device_index(a), _DTYPE_CODE[a.dtype], a.data_ptr(),
            b.data_ptr(), part.data_ptr(), out.data_ptr(), n, p, q, splits,
            _build.stream_of(a))
    _build.check("ffn", rc, "weight product kernel")
    count_products(a.dtype, p, q, 1)
    return out


def count_products(dtype, p: int, q: int, n: int) -> None:
    """Adds ``n`` launches of the weight product at ``[., p] x [., q]`` of
    ``dtype`` to :func:`weight_product`'s counts (the wrappers of K4's and
    K7's backwards call it for the two products each runs)."""
    weight_product.launches += n
    weight_product.launches_by_design[product_design(dtype, p, q)] += n


# launches of the weight product kernel, in all and by design: its own
# wrapper's and those inside K4's and K7's backwards
weight_product.launches = 0
weight_product.launches_by_design = {"wgmma": 0, "general": 0}


# csrc/ffn.cu's designs and the rule that picks one, mirrored from its plan()
DESIGNS = ("general", "wgmma")
_SMEM_LIMIT = 227 * 1024      # shared memory a block can use on the H100
_GENERAL_ROWS, _GENERAL_PAD = 8, 64
_WG_ROWS, _WG_PART, _WG_BOX = 128, 16, 64 * 64 * 2
_WG_EXTRA, _WG_MAX_SLOTS = 2048, 8
_WG_REG_LIMIT = 240           # setmaxnreg of a consumer warpgroup


class FfnPlan(NamedTuple):
    """What :func:`ffn_plan` gives for a shape."""
    design: str       # "wgmma" or "general"
    pad_rows: int     # N is padded to a multiple of this (1: no padding)
    tile_rows: int    # rows a block tile holds
    part_rows: int    # rows a partial db row of the backward sums over
    fwd_slots: int    # wgmma: weight slots of the forward's ring
    bwd_slots: int    # ... and of the backward's
    fwd_smem: int     # shared memory of a forward block, bytes
    bwd_smem: int     # ... and of a backward row-kernel block
    acc_regs: int     # wgmma: accumulator and A-fragment registers a
    #                   consumer thread holds at most (the backward's dx
    #                   64 x K f32, h and dd 64 x 64 f32, a bf16 chunk as
    #                   A); 0 for the general design
    reg_limit: int    # wgmma: the registers a consumer thread may hold

    def parts(self, n_pad: int) -> int:
        """Partial db rows of a backward pass over ``n_pad`` rows."""
        return -(-n_pad // self.tile_rows) * (self.tile_rows
                                             // self.part_rows)


def ffn_plan(dtype, k: int, m: int) -> FfnPlan:
    """Which of ``csrc/ffn.cu``'s kernels take ``[N, k]`` rows with a hidden
    of ``m`` in ``dtype``: a rule on the shape alone, the same as the C
    ``plan`` (``ishara_ffn_plan``).

    * ``"wgmma"``: bf16, ``k`` a multiple of 64 up to 256, ``m`` a multiple
      of 64 -- warpgroup products, TMA weight rings, the hidden kept in
      registers; the output's 64 x ``k`` f32 accumulators are why ``k``
      stops at 256;
    * ``"general"``: everything else (f32 FMAs)."""
    if dtype == torch.bfloat16 and k % 64 == 0 and 64 <= k <= 256 \
            and m % 64 == 0 and m > 0:
        tile = (k // 64) * _WG_BOX

        def slots(fixed):
            return min(_WG_MAX_SLOTS,
                       (_SMEM_LIMIT - _WG_EXTRA - fixed * tile) // tile)

        fs, bs = slots(2), slots(4)
        return FfnPlan("wgmma", 1, _WG_ROWS, _WG_PART, fs, bs,
                       _WG_EXTRA + (2 + fs) * tile,
                       _WG_EXTRA + (4 + bs) * tile,
                       k // 2 + 2 * 32 + 16, _WG_REG_LIMIT)
    gr = _GENERAL_ROWS
    return FfnPlan("general", _GENERAL_PAD, gr, gr, 0, 0, gr * (k + m) * 4,
                   gr * (2 * k + m) * 4, 0, 0)


def c_plan(dtype, k: int, m: int) -> FfnPlan:
    """``csrc/ffn.cu``'s own plan of the shape (needs the built library),
    for holding :func:`ffn_plan` to it."""
    out = (ctypes.c_longlong * 10)()
    fn = _build.function("ffn", "ishara_ffn_plan",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    _build.check("ffn", fn(_DTYPE_CODE[dtype], k, m, ctypes.addressof(out)),
                 "FFN plan")
    return FfnPlan(DESIGNS[out[0]], *(int(v) for v in out[1:]))


def _scaled_keep(seeds, which, shape, rate, keep, device, row_offset=0,
                 hidden=None):
    """f32 ``keep / (1 - rate)`` of ``shape`` ``[n, w]``, or None at rate 0;
    ``keep`` (bool or 0/1) overrides the Philox mask of ``seeds[which]``
    (from row ``row_offset`` on; columns ``[col0, col0 + w)`` of rows of
    ``width`` with ``hidden = (width, col0)``)."""
    if rate <= 0.0:
        return None
    if keep is None:
        width, col0 = (shape[1], 0) if hidden is None else hidden
        keep = keep_mask(seeds[which:which + 1], shape, rate,
                         row_offset * width + col0,
                         None if width == shape[1] else (shape[1], width))
    return keep.to(device=device, dtype=torch.float32).reshape(shape) \
        * (1.0 / (1.0 - rate))


def _dot(a, b):
    """``a @ b`` with f32 accumulation of operands in their own dtype."""
    if a.dtype == torch.float32:
        return a @ b
    # bf16 values are exact in f32 and so are their products: an f32 product
    # of the widened operands accumulates as the tensor cores do
    return a.to(torch.float32) @ b.to(torch.float32)


def ffn_forward_plain(x2, res2, w1, b1, w2, b2, seeds, rate1, rate2,
                      keep1=None, keep2=None, row_offset=0, hidden=None):
    """Plain version of the forward kernel on ``[N, K]`` rows; ``w1``
    ``[K, M]`` and ``w2`` ``[M, K]`` already in ``x2``'s dtype, biases
    f32; ``res2`` and ``b2`` may be None (none added)."""
    n, k = x2.shape
    m = w1.shape[1]
    cd = x2.dtype
    k1 = _scaled_keep(seeds, 0, (n, m), rate1, keep1, x2.device, row_offset,
                      hidden)
    k2 = _scaled_keep(seeds, 1, (n, k), rate2, keep2, x2.device, row_offset)
    h = _dot(x2, w1) + b1
    a = h * torch.sigmoid(h)
    if k1 is not None:
        a = a * k1
    y = _dot(a.to(cd), w2)
    if b2 is not None:
        y = y + b2
    if k2 is not None:
        y = y * k2
    return (y if res2 is None else res2.to(torch.float32) + y).to(cd)


def ffn_backward_plain(x2, dy2, w1, b1, w2, seeds, rate1, rate2,
                       keep1=None, keep2=None, row_offset=0, hidden=None):
    """Plain version of the backward kernels: (dx ``[N, K]`` in ``x2``'s
    dtype, dw1 ``[K, M]``, db1 ``[M]``, dw2 ``[M, K]``, db2 ``[K]`` f32)."""
    n, k = x2.shape
    m = w1.shape[1]
    cd = x2.dtype
    k1 = _scaled_keep(seeds, 0, (n, m), rate1, keep1, x2.device, row_offset,
                      hidden)
    k2 = _scaled_keep(seeds, 1, (n, k), rate2, keep2, x2.device, row_offset)
    g = dy2.to(torch.float32)
    if k2 is not None:
        g = g * k2
    h = _dot(x2, w1) + b1
    sig = torch.sigmoid(h)
    a = h * sig
    d = a * k1 if k1 is not None else a
    gb = g.to(cd)
    dw2 = _dot(d.to(cd).t(), gb)
    db2 = g.sum(dim=0)
    dd = _dot(gb, w2.t())
    da = dd * k1 if k1 is not None else dd
    dh = da * (sig + a * (1.0 - sig))
    dhb = dh.to(cd)
    dw1 = _dot(x2.t(), dhb)
    db1 = dh.sum(dim=0)
    dx = _dot(dhb, w1.t()).to(cd)
    return dx, dw1, db1, dw2, db2


def _pad_rows(t, n_pad):
    if t.shape[0] == n_pad:
        return t
    return torch.cat([t, t.new_zeros((n_pad - t.shape[0], t.shape[1]))])


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda(x2, w1, seeds):
    if x2.dtype not in _DTYPE_CODE:
        raise ValueError(f"the FFN kernel takes f32 or bf16 activations, "
                         f"got {x2.dtype}")
    if seeds.dtype != torch.int32 or seeds.numel() < 2 \
            or seeds.device != x2.device:
        raise ValueError("seeds must be int32 [2] on x's device")


def _rates(rate1, rate2):
    return (threshold_of(rate1), 1.0 / (1.0 - rate1),
            threshold_of(rate2), 1.0 / (1.0 - rate2))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(x2, res2, w1, b1, w2, b2, seeds, rate1, rate2, row_offset=0,
                hidden=None):
    _check_cuda(x2, w1, seeds)
    n, k = x2.shape
    m = w1.shape[1]
    plan = ffn_plan(x2.dtype, k, m)
    n_pad = -(-n // plan.pad_rows) * plan.pad_rows
    xp = _pad_rows(x2, n_pad)
    rp = None if res2 is None else _pad_rows(res2, n_pad)
    out = torch.empty_like(xp)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    L = ctypes.c_longlong
    fn = _build.function("ffn", "ishara_ffn_fwd",
                         [I, I, P, P, P, P, P, P, P, P, I, I, I, U, F, U, F,
                          L, L, L, P])
    rc = fn(_build.device_index(x2), _DTYPE_CODE[x2.dtype], xp.data_ptr(),
            _ptr(rp), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), _ptr(b2),
            seeds.data_ptr(), out.data_ptr(), n_pad, k, m,
            *_rates(rate1, rate2), int(row_offset), *(hidden or (0, 0)),
            _build.stream_of(x2))
    _build.check("ffn", rc, "FFN forward kernel")
    return out[:n]


def _launch_bwd(x2, dy2, w1, b1, w2, seeds, rate1, rate2, row_offset=0,
                hidden=None):
    _check_cuda(x2, w1, seeds)
    n, k = x2.shape
    m = w1.shape[1]
    dev, cd = x2.device, x2.dtype
    plan = ffn_plan(cd, k, m)
    n_pad = -(-n // plan.pad_rows) * plan.pad_rows
    xp, dyp = _pad_rows(x2, n_pad), _pad_rows(dy2, n_pad)
    parts = plan.parts(n_pad)
    splits = wgrad_splits(n_pad, k, m)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(xp)
    d_g = torch.empty((n_pad, m), dtype=cd, device=dev)
    dh_g = torch.empty_like(d_g)
    g_g = torch.empty_like(xp)
    # the general design reads the weights through transposed copies
    wt = torch.empty((2, k * m), dtype=cd, device=dev) \
        if plan.design == "general" else None
    db1_part, db2_part = f32(parts, m), f32(parts, k)
    # the wgmma design adds its partial db rows in two passes
    db_tmp = f32(parts // 8, max(k, m)) if plan.design == "wgmma" else None
    dw1_part, dw2_part = f32(splits, k * m), f32(splits, k * m)
    dw1, db1, dw2, db2 = f32(k, m), f32(m), f32(m, k), f32(k)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    L = ctypes.c_longlong
    fn = _build.function("ffn", "ishara_ffn_bwd",
                         [I, I] + [P] * 20 + [I, I, I, I, L, U, F, U, F]
                         + [L] * 3 + [P])
    rc = fn(_build.device_index(x2), _DTYPE_CODE[cd], xp.data_ptr(),
            dyp.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            seeds.data_ptr(), dx.data_ptr(), d_g.data_ptr(), dh_g.data_ptr(),
            g_g.data_ptr(), _ptr(wt), db1_part.data_ptr(),
            db2_part.data_ptr(), _ptr(db_tmp), dw1_part.data_ptr(),
            dw2_part.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            n_pad, k, m, splits, parts, *_rates(rate1, rate2),
            int(row_offset), *(hidden or (0, 0)), _build.stream_of(x2))
    _build.check("ffn", rc, "FFN backward kernels")
    return dx[:n], dw1, db1, dw2, db2


class _FfnResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, w1, b1, w2, b2, seeds, rate1, rate2,
                row_offset, hidden):
        cd = x.dtype
        k = x.shape[-1]
        x2 = x.reshape(-1, k).contiguous()
        res2 = None if res is None else res.reshape(-1, k).contiguous()
        w1c, w2c = w1.to(cd).contiguous(), w2.to(cd).contiguous()
        b1f = b1.to(torch.float32).contiguous()
        b2f = None if b2 is None else b2.to(torch.float32).contiguous()
        if x.device.type == "cpu":
            out = ffn_forward_plain(x2, res2, w1c, b1f, w2c, b2f, seeds,
                                    rate1, rate2, row_offset=row_offset,
                                    hidden=hidden)
        else:
            out = _launch_fwd(x2, res2, w1c, b1f, w2c, b2f, seeds, rate1,
                              rate2, row_offset=row_offset, hidden=hidden)
            ffn_residual.launches += 1
            ffn_residual.launches_by_design[
                ffn_plan(cd, k, w1c.shape[1]).design] += 1
        ctx.save_for_backward(x2, w1c, b1f, w2c, seeds)
        ctx.rates, ctx.row_offset = (rate1, rate2), row_offset
        ctx.hidden, ctx.has = hidden, (res is not None, b2 is not None)
        ctx.dtypes = (w1.dtype, b1.dtype, w2.dtype,
                      None if b2 is None else b2.dtype)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w1c, b1f, w2c, seeds = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).to(x2.dtype).contiguous()
        if dy.device.type == "cpu":
            grads = ffn_backward_plain(x2, dy2, w1c, b1f, w2c, seeds,
                                       *ctx.rates, row_offset=ctx.row_offset,
                                       hidden=ctx.hidden)
        else:
            grads = _launch_bwd(x2, dy2, w1c, b1f, w2c, seeds, *ctx.rates,
                                row_offset=ctx.row_offset, hidden=ctx.hidden)
            ffn_residual.launches_bwd += 1
            count_products(x2.dtype, *w1c.shape, 2)
            ffn_residual.launches_bwd_by_design[
                ffn_plan(x2.dtype, *w1c.shape).design] += 1
        dx, dw1, db1, dw2, db2 = grads
        tw1, tb1, tw2, tb2 = ctx.dtypes
        has_res, has_b2 = ctx.has
        return (dx.reshape(dy.shape), dy if has_res else None, dw1.to(tw1),
                db1.to(tb1), dw2.to(tw2), db2.to(tb2) if has_b2 else None,
                None, None, None, None, None)


def ffn_residual(x: torch.Tensor, res: torch.Tensor | None,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor | None, seeds: torch.Tensor, rate1: float,
                 rate2: float, row_offset: int = 0, hidden=None):
    """``res + drop2(Dense2(drop1(swish(Dense1(x)))))`` as one kernel.

    ``x``/``res``: ``[..., K]``; ``w1`` ``[K, M]``, ``w2`` ``[M, K]`` (cast to
    ``x``'s dtype); biases ``[M]``/``[K]``; ``seeds`` int32 ``[2]``, one per
    dropout site; ``row_offset``: the index, among the ``[N, K]`` rows of the
    whole batch, of ``x``'s first row (0 unless the batch is split across
    processes). ``hidden = (width, col0)``: ``w1``'s columns are a slice of
    a hidden of ``width`` from column ``col0`` (a tensor-parallel rank's),
    and ``res``, ``b2`` are None and ``rate2`` is 0: the result is the
    slice's partial sum (see the module's docstring). Gradient flows to
    ``x``, ``res`` and the parameter tensors. Replaces
    ``ishara_tpu.ops.ffn_kernel.ffn_residual``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the FFN kernel runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype):
        raise ValueError("res must match x in shape and dtype")
    if hidden is not None:
        width, col0 = (int(v) for v in hidden)
        m = w1.shape[1]
        if res is not None or b2 is not None or rate2 != 0.0:
            raise ValueError("a slice of the hidden gives a partial sum: "
                             "no res, no b2, rate2 0")
        if not (0 <= col0 and col0 + m <= width and width % 4 == 0
                and col0 % 4 == 0):
            raise ValueError(f"hidden {hidden} does not hold {m} columns "
                             f"on Philox blocks of 4")
        hidden = (width, col0)
    return _FfnResidual.apply(x, res, w1, b1, w2, b2, seeds, float(rate1),
                              float(rate2), int(row_offset), hidden)


# launches of the forward kernel and of the backward kernels (one count for
# the row, weight and reduction kernels of one backward pass), in all and by
# the design (ffn_plan) that took them
ffn_residual.launches = 0
ffn_residual.launches_bwd = 0
ffn_residual.launches_by_design = dict.fromkeys(DESIGNS, 0)
ffn_residual.launches_bwd_by_design = dict.fromkeys(DESIGNS, 0)


def debug_masks(n: int, m: int, k: int, seeds: torch.Tensor, rate1: float,
                rate2: float, row_offset: int = 0):
    """The keep masks (f32 0/1, ``[n, m]`` and ``[n, k]``) the kernels draw
    for an ``[n, k]`` input with hidden width ``m`` whose first row is row
    ``row_offset`` of the batch: from the card's own Philox when ``seeds`` is
    a CUDA tensor, from the plain PyTorch one otherwise. The two must agree
    bit for bit."""
    if seeds.device.type == "cpu":
        return (keep_mask(seeds[0:1], (n, m), rate1, row_offset * m)
                .to(torch.float32),
                keep_mask(seeds[1:2], (n, k), rate2, row_offset * k)
                .to(torch.float32))
    if seeds.dtype != torch.int32 or seeds.numel() < 2:
        raise ValueError("seeds must be int32 [2]")
    k1 = torch.empty((n, m), dtype=torch.float32, device=seeds.device)
    k2 = torch.empty((n, k), dtype=torch.float32, device=seeds.device)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn = _build.function("ffn", "ishara_ffn_masks",
                         [I, P, P, P, I, I, I, U, U, ctypes.c_longlong, P])
    rc = fn(_build.device_index(seeds), seeds.data_ptr(), k1.data_ptr(),
            k2.data_ptr(), n, m, k, threshold_of(rate1), threshold_of(rate2),
            int(row_offset), _build.stream_of(seeds))
    _build.check("ffn", rc, "FFN mask kernel")
    return k1, k2
