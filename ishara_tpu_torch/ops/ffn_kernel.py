"""The feed-forward branch with its residual as one training kernel (port of
``ishara_tpu/ops/ffn_kernel.py``).

:func:`ffn_residual` replaces the Pallas ``ffn_residual``:
``res + drop2(Dense2(drop1(swish(Dense1(x)))))`` with both dropout masks
regenerated in the backward pass and the hidden recomputed there. On a CUDA
tensor it launches ``csrc/ffn.cu`` (bf16 or f32 activations, any widths: the
tensor cores at bf16 and widths that are multiples of 128, f32 FMAs otherwise)
or raises; on a CPU tensor it runs the plain version beside it (:func:`ffn_forward_plain`,
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

The weight gradients are per-block f32 partial sums added in a fixed order
(no atomics), so they are the same from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dropout import keep_mask, threshold_of

_ROWS = 64      # the most rows a block of csrc/ffn.cu owns
_SPLIT_BLOCKS = 264   # blocks the weight-gradient products aim for: 2 an SM
_WGRAD_TILE, _WGRAD_STEP = 128, 32   # csrc/wgrad.cuh's output tile, row step


def wgrad_splits(n: int, p: int, q: int) -> int:
    """Row splits of ``csrc/wgrad.cuh``'s product ``A^T . B`` over ``n``
    rows (``A`` ``[n, p]``, ``B`` ``[n, q]``): enough splits that the
    ``128 x 128`` output tiles make about ``_SPLIT_BLOCKS`` blocks, and no
    more than one split a 32-row step."""
    tiles = -(-p // _WGRAD_TILE) * -(-q // _WGRAD_TILE)
    return max(1, min(-(-n // _WGRAD_STEP), _SPLIT_BLOCKS // tiles))


def _scaled_keep(seeds, which, shape, rate, keep, device, row_offset=0):
    """f32 ``keep / (1 - rate)`` of ``shape`` ``[n, w]``, or None at rate 0;
    ``keep`` (bool or 0/1) overrides the Philox mask of ``seeds[which]``
    (from row ``row_offset`` on)."""
    if rate <= 0.0:
        return None
    if keep is None:
        keep = keep_mask(seeds[which:which + 1], shape, rate,
                         row_offset * shape[1])
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
                      keep1=None, keep2=None, row_offset=0):
    """Plain version of the forward kernel on ``[N, K]`` rows; ``w1``
    ``[K, M]`` and ``w2`` ``[M, K]`` already in ``x2``'s dtype, biases
    f32."""
    n, k = x2.shape
    m = w1.shape[1]
    cd = x2.dtype
    k1 = _scaled_keep(seeds, 0, (n, m), rate1, keep1, x2.device, row_offset)
    k2 = _scaled_keep(seeds, 1, (n, k), rate2, keep2, x2.device, row_offset)
    h = _dot(x2, w1) + b1
    a = h * torch.sigmoid(h)
    if k1 is not None:
        a = a * k1
    y = _dot(a.to(cd), w2) + b2
    if k2 is not None:
        y = y * k2
    return (res2.to(torch.float32) + y).to(cd)


def ffn_backward_plain(x2, dy2, w1, b1, w2, seeds, rate1, rate2,
                       keep1=None, keep2=None, row_offset=0):
    """Plain version of the backward kernels: (dx ``[N, K]`` in ``x2``'s
    dtype, dw1 ``[K, M]``, db1 ``[M]``, dw2 ``[M, K]``, db2 ``[K]`` f32)."""
    n, k = x2.shape
    m = w1.shape[1]
    cd = x2.dtype
    k1 = _scaled_keep(seeds, 0, (n, m), rate1, keep1, x2.device, row_offset)
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


def _launch_fwd(x2, res2, w1, b1, w2, b2, seeds, rate1, rate2, row_offset=0):
    _check_cuda(x2, w1, seeds)
    n, k = x2.shape
    m = w1.shape[1]
    n_pad = -(-n // _ROWS) * _ROWS
    xp, rp = _pad_rows(x2, n_pad), _pad_rows(res2, n_pad)
    out = torch.empty_like(xp)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    fn = _build.function("ffn", "ishara_ffn_fwd",
                         [I, I, P, P, P, P, P, P, P, P, I, I, I, U, F, U, F,
                          ctypes.c_longlong, P])
    rc = fn(_build.device_index(x2), _DTYPE_CODE[x2.dtype], xp.data_ptr(),
            rp.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), seeds.data_ptr(), out.data_ptr(), n_pad, k, m,
            *_rates(rate1, rate2), int(row_offset), _build.stream_of(x2))
    _build.check("ffn", rc, "FFN forward kernel")
    return out[:n]


def _launch_bwd(x2, dy2, w1, b1, w2, seeds, rate1, rate2, row_offset=0):
    _check_cuda(x2, w1, seeds)
    n, k = x2.shape
    m = w1.shape[1]
    n_pad = -(-n // _ROWS) * _ROWS
    xp, dyp = _pad_rows(x2, n_pad), _pad_rows(dy2, n_pad)
    dev, cd = x2.device, x2.dtype
    code = _DTYPE_CODE[cd]
    I = ctypes.c_int
    blocks = n_pad // _build.function("ffn", "ishara_ffn_bwd_rows",
                                      [I, I, I])(code, k, m)
    splits = wgrad_splits(n_pad, k, m)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(xp)
    d_g = torch.empty((n_pad, m), dtype=cd, device=dev)
    dh_g = torch.empty_like(d_g)
    g_g = torch.empty_like(xp)
    wt = torch.empty((2, k * m), dtype=cd, device=dev)
    db1_part, db2_part = f32(blocks, m), f32(blocks, k)
    dw1_part, dw2_part = f32(splits, k * m), f32(splits, k * m)
    dw1, db1, dw2, db2 = f32(k, m), f32(m), f32(m, k), f32(k)
    P, U, F = ctypes.c_void_p, ctypes.c_uint, ctypes.c_float
    fn = _build.function("ffn", "ishara_ffn_bwd",
                         [I, I] + [P] * 19 + [I, I, I, I, U, F, U, F,
                                                ctypes.c_longlong, P])
    rc = fn(_build.device_index(x2), code, xp.data_ptr(), dyp.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), seeds.data_ptr(),
            dx.data_ptr(), d_g.data_ptr(), dh_g.data_ptr(), g_g.data_ptr(),
            wt.data_ptr(), db1_part.data_ptr(), db2_part.data_ptr(),
            dw1_part.data_ptr(), dw2_part.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), n_pad, k, m,
            splits, *_rates(rate1, rate2), int(row_offset),
            _build.stream_of(x2))
    _build.check("ffn", rc, "FFN backward kernels")
    return dx[:n], dw1, db1, dw2, db2


class _FfnResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, w1, b1, w2, b2, seeds, rate1, rate2,
                row_offset):
        cd = x.dtype
        k = x.shape[-1]
        x2 = x.reshape(-1, k).contiguous()
        res2 = res.reshape(-1, k).contiguous()
        w1c, w2c = w1.to(cd).contiguous(), w2.to(cd).contiguous()
        b1f = b1.to(torch.float32).contiguous()
        b2f = b2.to(torch.float32).contiguous()
        if x.device.type == "cpu":
            out = ffn_forward_plain(x2, res2, w1c, b1f, w2c, b2f, seeds,
                                    rate1, rate2, row_offset=row_offset)
        else:
            out = _launch_fwd(x2, res2, w1c, b1f, w2c, b2f, seeds, rate1,
                              rate2, row_offset=row_offset)
            ffn_residual.launches += 1
        ctx.save_for_backward(x2, w1c, b1f, w2c, seeds)
        ctx.rates, ctx.row_offset = (rate1, rate2), row_offset
        ctx.dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w1c, b1f, w2c, seeds = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).to(x2.dtype).contiguous()
        if dy.device.type == "cpu":
            grads = ffn_backward_plain(x2, dy2, w1c, b1f, w2c, seeds,
                                       *ctx.rates, row_offset=ctx.row_offset)
        else:
            grads = _launch_bwd(x2, dy2, w1c, b1f, w2c, seeds, *ctx.rates,
                                row_offset=ctx.row_offset)
            ffn_residual.launches_bwd += 1
        dx, dw1, db1, dw2, db2 = grads
        tw1, tb1, tw2, tb2 = ctx.dtypes
        return (dx.reshape(dy.shape), dy, dw1.to(tw1), db1.to(tb1),
                dw2.to(tw2), db2.to(tb2), None, None, None, None)


def ffn_residual(x: torch.Tensor, res: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 seeds: torch.Tensor, rate1: float, rate2: float,
                 row_offset: int = 0):
    """``res + drop2(Dense2(drop1(swish(Dense1(x)))))`` as one kernel.

    ``x``/``res``: ``[..., K]``; ``w1`` ``[K, M]``, ``w2`` ``[M, K]`` (cast to
    ``x``'s dtype); biases ``[M]``/``[K]``; ``seeds`` int32 ``[2]``, one per
    dropout site; ``row_offset``: the index, among the ``[N, K]`` rows of the
    whole batch, of ``x``'s first row (0 unless the batch is split across
    processes). Gradient flows to ``x``, ``res`` and the four parameter
    tensors. Replaces ``ishara_tpu.ops.ffn_kernel.ffn_residual``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the FFN kernel runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if res.shape != x.shape or res.dtype != x.dtype:
        raise ValueError("res must match x in shape and dtype")
    return _FfnResidual.apply(x, res, w1, b1, w2, b2, seeds, float(rate1),
                              float(rate2), int(row_offset))


# launches of the forward kernel and of the backward kernels (one count for
# the row, weight and reduction kernels of one backward pass)
ffn_residual.launches = 0
ffn_residual.launches_bwd = 0


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
