"""The Squeezeformer conv-module branch with its residual as one training
kernel, forward and backward (port of ``ishara_tpu/ops/conv_kernel.py``).

:func:`conv_module_residual` replaces the Pallas ``conv_module_residual``:
``x + SE(pw2(swish(causal_dw(swish(pw1(LN(x)))))))`` with the masked SE
pool, no dropout inside the branch, and a backward that recomputes the
branch from ``x`` (all but ``p``, which the forward keeps). Precision as
the reference: the two pointwise products take operands of ``x``'s dtype
and accumulate in f32; LN (eps 1e-6), the swishes, the causal depthwise
conv and the SE run in f32, and so do the depthwise taps, the SE weights
and the biases; ``msum = max(sum mask, 1)``, so an all-masked sequence
pools to 0. dx comes
back in ``x``'s dtype, every weight gradient is summed in f32 and cast to
its parameter's dtype, and the mask gets none.

On a CUDA tensor the wrapper launches ``csrc/conv_module.cu`` behind one C
call each way, or raises; on a CPU tensor it runs the plain versions beside
it (:func:`conv_module_forward_plain`, :func:`conv_module_backward_plain`),
which repeat the reference's arithmetic and rounding points. The design is
chosen by :func:`conv_plan` (mirrored by the C ``ishara_conv_plan``):

* ``"wgmma"``: bf16, D a multiple of 64 up to 256, E a multiple of 64, at
  most 16 taps -- every preset's training geometry. Warpgroup products fed
  by TMA weight rings (``csrc/hopper.cuh``), time tiles whose conv halo is
  recomputed; 3 kernels forward, 10 backward;
* ``"tile"``: the other shapes a tile holds (:func:`tile_plan`): time tiles
  with a halo on ``mma.sync``, 3 kernels forward and 10 backward;
* ``"general"``: the rest, a chain of row kernels (6 forward, 19 backward).

The forward keeps ``p = pw2(...) + b2`` (f32) for the backward, which takes
the SE gate and its backward from it instead of running the forward again.
The weight gradients are partial sums added in a fixed order (no atomics),
so they are the same from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ffn_kernel import wgrad_splits

_P, _I = ctypes.c_void_p, ctypes.c_int

LN_EPS = 1e-6
SMEM_LIMIT = 232448      # bytes of shared memory a block may take (H100)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The tile kernels' plans in csrc/conv_module.cu (its Cfg table), by index,
# in order of preference for (dtype, backward): m-tiles of 16 rows in a
# time tile, n8-tiles a warp of the [rows, D] accumulator (so D <= 64 times
# that), channels a chunk.
_TILE_CONFIGS = {
    (torch.float32, False): ((4, 4, 32), (1, 8, 16)),
    (torch.float32, True): ((2, 4, 16), (1, 8, 16)),
    (torch.bfloat16, False): ((4, 4, 64), (1, 8, 32)),
    (torch.bfloat16, True): ((4, 4, 32), (1, 8, 32)),
}


def _rup(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def halo_rows(K: int) -> int:
    """The tile kernels' halo: ``K`` rounded up to 16 rows."""
    return -(-K // 16) * 16


def taps_rows(K: int) -> int:
    """Rows of the tile kernels' taps buffer (``csrc/conv_module.cu``'s
    ``taps_rows``): ``K`` rounded up to 32, so 32 at every K up to 32."""
    return -(-K // 32) * 32


def tile_smem(dtype: torch.dtype, backward: bool, mtp: int, ec: int,
              D: int, K: int) -> int:
    """Bytes of shared memory a tile kernel of ``csrc/conv_module.cu``
    takes (its ``tile_smem``): rows of ``D`` rounded up to 16 and of the
    chunk padded by 16 bytes for the products, f32 rows of the chunk padded
    by one float; the halo is ``K`` rounded up to 16 and the taps buffer
    ``K`` rounded up to 32 rows."""
    sz = 2 if dtype == torch.bfloat16 else 4
    tt, pad = 16 * mtp, 16 // sz
    dk, halo = -(-D // 16) * 16, halo_rows(K)
    ldd, ecl, ecf = dk + pad, ec + pad, ec + 1
    chunk = _rup(taps_rows(K) * ec * 4) + _rup(ec * 4)   # taps, b1
    if not backward:
        r = tt + halo
        return (_rup(r * ldd * sz) + _rup(r * ecf * 4) + _rup(tt * ecl * sz)
                + _rup(dk * ecl * sz) + _rup(ec * ldd * sz) + chunk)
    ru, rc = tt + 2 * halo, tt + halo
    return (_rup(ru * ldd * sz) + _rup(rc * ldd * sz) + _rup(ru * ecf * 4)
            + _rup(tt * ecf * 4) + _rup(rc * ecf * 4) + _rup(tt * ecl * sz)
            + 2 * _rup(dk * ecl * sz) + _rup(ec * ldd * sz) + _rup(8 * tt)
            + chunk)


def tile_plan(T: int, D: int, K: int, dtype: torch.dtype,
              backward: bool) -> dict | None:
    """The plan of the forward (or backward) tile kernel: the first
    configuration whose accumulator covers ``D`` and whose working set fits
    in shared memory -- ``config`` (the index the C call takes),
    ``tile_rows``, ``halo`` (rows before the tile, and after it in the
    backward), ``chunk`` (channels), ``tiles`` (of a sequence), ``smem``
    (bytes). None when no configuration fits: the call takes the general
    path (the chain of row kernels), which takes any ``K`` too.

    A tile whose halo is more than twice its own rows is not taken: it
    recomputes most of its rows (the backward tile 1 + 2H / TT times). On
    an H100 at ``[256, 176, 256]`` the 16-row tiles with halos of 48 and 64
    rows took 3.4-3.6x the general path's time (``tools/conv_paths.py``,
    ``PERF.md``); every halo of up to 32 rows passes."""
    dk, halo = -(-D // 16) * 16, halo_rows(K)
    for i, (mtp, ntp, ec) in enumerate(_TILE_CONFIGS[(dtype, backward)]):
        smem = tile_smem(dtype, backward, mtp, ec, D, K)
        rows = 16 * mtp
        if dk <= 64 * ntp and smem <= SMEM_LIMIT and halo <= 2 * rows:
            return {"config": i, "tile_rows": rows, "halo": halo,
                    "chunk": ec, "tiles": -(-T // rows), "smem": smem}
    return None


DESIGNS = ("tile", "wgmma")


def conv_plan(dtype, D: int, E: int, K: int) -> str:
    """Which design of ``csrc/conv_module.cu`` takes a branch of width
    ``D``, hidden ``E`` and ``K`` depthwise taps in ``dtype``: a rule on the
    shape alone, the same as the C ``plan`` (``ishara_conv_plan``), which
    alone owns the wgmma design's layout.

    * ``"wgmma"``: bf16, ``D`` a multiple of 64 up to 256 (a warpgroup's
      [64, D] f32 accumulator of p or dxn in its registers), ``E`` a multiple
      of 64, ``K`` up to 16 (a halo of one 16-row band);
    * ``"tile"``: everything else, which :func:`tile_plan` cuts into time
      tiles (or, where none fits, the general path)."""
    if dtype == torch.bfloat16 and D % 64 == 0 and 64 <= D <= 256 \
            and E % 64 == 0 and E > 0 and 1 <= K <= 16:
        return "wgmma"
    return "tile"


def c_plan(dtype, D: int, E: int, K: int) -> dict:
    """``csrc/conv_module.cu``'s own plan of the shape (needs the built
    library): ``design``, then for the wgmma design its forward and
    backward own rows a tile, channels a chunk, ring slots and shared memory
    (bytes), else zeros."""
    out = (ctypes.c_longlong * 9)()
    fn = _build.function("conv_module", "ishara_conv_plan",
                         [_I, _I, _I, _I, ctypes.c_void_p])
    _build.check("conv_module", fn(_DTYPE_CODE.get(dtype, -1), D, E, K,
                                   ctypes.addressof(out)), "conv-module plan")
    names = ("fwd_rows", "bwd_rows", "fwd_chunk", "bwd_chunk", "fwd_slots",
             "bwd_slots", "fwd_smem", "bwd_smem")
    return {"design": DESIGNS[out[0]],
            **{n: int(v) for n, v in zip(names, out[1:])}}


def design_of(x, E: int, K: int, backward: bool) -> str:
    """The design a launch on ``x`` ``[B, T, D]`` takes in one direction:
    "wgmma", "tile" or "general"."""
    if conv_plan(x.dtype, x.shape[2], E, K) == "wgmma":
        return "wgmma"
    return "general" if _configs(x, K, backward)[0] < 0 else "tile"


def _configs(x, K, backward):
    """The C calls' (cfg_f, cfg_b): the plans' indices, -1 for the
    general path (both, in the backward, unless both plans exist)."""
    B, T, D = x.shape
    f = tile_plan(T, D, K, x.dtype, False)
    if not backward:
        return (-1 if f is None else f["config"]), -1
    b = tile_plan(T, D, K, x.dtype, True)
    if f is None or b is None:
        return -1, -1
    return f["config"], b["config"]


def _prep(x, mask, gamma, beta, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2):
    """The operands as the kernels take them: products' weights in ``x``'s
    dtype, everything else f32, all contiguous."""
    cd, f = x.dtype, torch.float32
    return tuple(t.contiguous() for t in (
        mask.to(f), gamma.to(f), beta.to(f), w1.to(cd), b1.to(f), wdw.to(f),
        w2.to(cd), b2.to(f), wf1.to(f), bf1.to(f), wf2.to(f), bf2.to(f)))


def _dot(a, b):
    """``a @ b`` with f32 accumulation of operands in their own dtype (bf16
    values and their products are exact in f32)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _causal_dw(a, wdw):
    """``c[t] = sum_k wdw[k] * a[t - (K - 1) + k]``, zero before t = 0."""
    K, T = wdw.shape[0], a.shape[1]
    pad = torch.nn.functional.pad(a, (0, 0, K - 1, 0))
    return sum(pad[:, k:k + T] * wdw[k] for k in range(K))


def _anticausal_dw(dc, wdw):
    """The gradient of :func:`_causal_dw` with respect to ``a``."""
    K, T = wdw.shape[0], dc.shape[1]
    pad = torch.nn.functional.pad(dc, (0, 0, 0, K - 1))
    return sum(pad[:, K - 1 - k:K - 1 - k + T] * wdw[k] for k in range(K))


def _ln(xf, gamma, beta):
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xh = (xf - mu) * rstd
    return xh, rstd, xh * gamma + beta


def _dswish(h, sig):
    return sig + h * sig * (1.0 - sig)


def _branch(xn, m, cd, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2, p=None):
    """The forward recompute shared by both plain versions; every
    intermediate the backward needs. ``p``: the forward's own ``p`` where
    the caller kept it (the product is then not taken again)."""
    u = _dot(xn.to(cd), w1) + b1
    sig_u = torch.sigmoid(u)
    a = u * sig_u
    c = _causal_dw(a, wdw)
    sig_c = torch.sigmoid(c)
    s = c * sig_c
    if p is None:
        p = _dot(s.to(cd), w2) + b2
    msum = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)        # [B, 1]
    pool = (p * m[..., None]).sum(dim=1) / msum                      # [B, D]
    z1 = pool @ wf1 + bf1
    sig_z1 = torch.sigmoid(z1)
    g1 = z1 * sig_z1
    g = torch.sigmoid(g1 @ wf2 + bf2)
    return dict(u=u, sig_u=sig_u, a=a, c=c, sig_c=sig_c, s=s, p=p, msum=msum,
                pool=pool, z1=z1, sig_z1=sig_z1, g1=g1, g=g)


def conv_module_forward_plain(x, mask, gamma, beta, w1, b1, wdw, w2, b2, wf1,
                              bf1, wf2, bf2, with_p: bool = False):
    """Plain version of the forward kernels: ``[B, T, D]`` in ``x``'s
    dtype. Operands as :func:`_prep` gives them. ``with_p``: also return
    ``p = pw2(...) + b2`` (f32 ``[B, T, D]``), which the backward takes."""
    xf = x.to(torch.float32)
    _, _, xn = _ln(xf, gamma, beta)
    r = _branch(xn, mask, x.dtype, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2)
    out = (r["p"] * r["g"][:, None, :] + xf).to(x.dtype)
    return (out, r["p"]) if with_p else out


def conv_module_backward_plain(x, mask, dy, gamma, beta, w1, b1, wdw, w2, b2,
                               wf1, bf1, wf2, bf2, p=None):
    """Plain version of the backward kernels: (dx in ``x``'s dtype, then
    dgamma, dbeta, dw1, db1, dwdw, dw2, db2, dwf1, dbf1, dwf2, dbf2 in f32),
    recomputing the branch from ``x`` as the reference does; ``p``, the
    forward's (``conv_module_forward_plain(..., with_p=True)``), is taken
    as it is where given, with the same result."""
    cd = x.dtype
    xf = x.to(torch.float32)
    xh, rstd, xn = _ln(xf, gamma, beta)
    r = _branch(xn, mask, cd, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2, p)
    B, T, D = x.shape
    E = w1.shape[1]
    do = dy.to(torch.float32)
    m = mask[..., None]
    # out = p * g + x: the gate's backward, per sequence
    dp = do * r["g"][:, None, :]
    dgate = (do * r["p"]).sum(dim=1)
    dz2 = dgate * r["g"] * (1.0 - r["g"])
    dwf2 = r["g1"].t() @ dz2
    dbf2 = dz2.sum(dim=0)
    dz1 = (dz2 @ wf2.t()) * _dswish(r["z1"], r["sig_z1"])
    dwf1 = r["pool"].t() @ dz1
    dbf1 = dz1.sum(dim=0)
    dpool = dz1 @ wf1.t()
    dp = dp + dpool[:, None, :] * (m / r["msum"][:, None, :])
    # pw2
    dp2 = dp.reshape(B * T, D)
    dw2 = _dot(r["s"].reshape(B * T, E).to(cd).t(), dp2.to(cd))
    db2 = dp2.sum(dim=0)
    ds = _dot(dp2.to(cd), w2.t()).reshape(B, T, E)
    # depthwise conv
    dc = ds * _dswish(r["c"], r["sig_c"])
    da = _anticausal_dw(dc, wdw)
    K = wdw.shape[0]
    apad = torch.nn.functional.pad(r["a"], (0, 0, K - 1, 0))
    dwdw = torch.stack([(apad[:, k:k + T] * dc).sum(dim=(0, 1))
                        for k in range(K)])
    # pw1
    du = (da * _dswish(r["u"], r["sig_u"])).reshape(B * T, E)
    dw1 = _dot(xn.reshape(B * T, D).to(cd).t(), du.to(cd))
    db1 = du.sum(dim=0)
    dxn = _dot(du.to(cd), w1.t()).reshape(B, T, D)
    # LayerNorm
    dgam = (dxn * xh).reshape(B * T, D).sum(dim=0)
    dbet = dxn.reshape(B * T, D).sum(dim=0)
    dxh = dxn * gamma
    dx_ln = (dxh - dxh.mean(dim=-1, keepdim=True)
             - xh * (dxh * xh).mean(dim=-1, keepdim=True)) * rstd
    return ((do + dx_ln).to(cd), dgam, dbet, dw1, db1, dwdw, dw2, db2, dwf1,
            dbf1, dwf2, dbf2)


def _check_cuda(x, args):
    B, T, D = x.shape
    mask, gamma, beta, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2 = args
    E, K, r = w1.shape[1], wdw.shape[0], wf1.shape[1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the conv-module kernel takes f32 or bf16, got "
                         f"{x.dtype}")
    if B > 65535:
        raise ValueError(f"the conv-module kernel takes up to 65535 "
                         f"sequences, got B={B}")
    shapes = {"mask": (mask, (B, T)), "gamma": (gamma, (D,)),
              "beta": (beta, (D,)), "w1": (w1, (D, E)), "b1": (b1, (E,)),
              "wdw": (wdw, (K, E)), "w2": (w2, (E, D)), "b2": (b2, (D,)),
              "wf1": (wf1, (D, r)), "bf1": (bf1, (r,)), "wf2": (wf2, (r, D)),
              "bf2": (bf2, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {list(shape)} on x's device, "
                             f"got {list(t.shape)} on {t.device}")


def _check_aligned(name, t):
    """The kernels read and write x, dy and out in 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"the conv-module kernel takes {name} on 16 bytes, "
                         f"got an address {t.data_ptr() % 16} bytes past")


def _workspace(x, E, K, r, backward, splits, cfgs):
    B, T, D = x.shape
    fn = _build.function("conv_module", "ishara_conv_workspace", [_I] * 11)
    units = fn(B, T, D, E, K, r, _DTYPE_CODE[x.dtype], int(backward), splits,
               *cfgs)
    return torch.empty(units * 256, dtype=torch.uint8, device=x.device)


def _launch_fwd(x, args):
    """out, and the forward's p (f32 [B, T, D])."""
    _check_cuda(x, args)
    x = x.contiguous()
    _check_aligned("x", x)
    B, T, D = x.shape
    E, K, r = args[3].shape[1], args[5].shape[0], args[8].shape[1]
    out = torch.empty_like(x)
    p = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    cfgs = _configs(x, K, False)
    work = _workspace(x, E, K, r, False, 1, cfgs)
    fn = _build.function("conv_module", "ishara_conv_fwd",
                         [_I, _I] + [_P] * 16 + [_I] * 7 + [_P])
    rc = fn(_build.device_index(x), _DTYPE_CODE[x.dtype], x.data_ptr(),
            *(t.data_ptr() for t in args), out.data_ptr(), p.data_ptr(),
            work.data_ptr(), B, T, D, E, K, r, cfgs[0], _build.stream_of(x))
    _build.check("conv_module", rc, "conv-module forward kernels")
    return out, p


def _launch_bwd(x, dy, args, p):
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    _check_aligned("x", x)
    _check_aligned("dy", dy)
    B, T, D = x.shape
    E, K, r = args[3].shape[1], args[5].shape[0], args[8].shape[1]
    splits = wgrad_splits(B * T, D, E)
    dx = torch.empty_like(x)
    sizes = (D, D, D * E, E, K * E, E * D, D, D * r, r, r * D, D)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    cfgs = _configs(x, K, True)
    work = _workspace(x, E, K, r, True, splits, cfgs)
    mask, *params = args
    fn = _build.function("conv_module", "ishara_conv_bwd",
                         [_I, _I] + [_P] * 18 + [_I] * 9 + [_P])
    rc = fn(_build.device_index(x), _DTYPE_CODE[x.dtype], x.data_ptr(),
            mask.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in params),
            p.data_ptr(), dx.data_ptr(), grads.data_ptr(),
            work.data_ptr(), B, T, D, E, K, r, splits, *cfgs,
            _build.stream_of(x))
    _build.check("conv_module", rc, "conv-module backward kernels")
    shapes = ((D,), (D,), (D, E), (E,), (K, E), (E, D), (D,), (D, r), (r,),
              (r, D), (D,))
    return (dx, *(g.reshape(s) for g, s in
                  zip(grads.split(sizes), shapes)))


class _ConvModuleResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *params):
        args = _prep(x, *params)
        if x.device.type == "cpu":
            out, p = conv_module_forward_plain(x, *args, with_p=True)
        else:
            out, p = _launch_fwd(x, args)    # checks x first
            design = design_of(x, args[3].shape[1], args[5].shape[0], False)
            conv_module_residual.launches += 1
            conv_module_residual.launches_by_design[design] += 1
        ctx.save_for_backward(x, p, *args)
        ctx.dtypes = tuple(q.dtype for q in params[1:])
        return out

    @staticmethod
    def backward(ctx, dy):
        x, p, *args = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = conv_module_backward_plain(x, args[0], dy, *args[1:], p=p)
        else:
            grads = _launch_bwd(x, dy, args, p)
            design = design_of(x, args[3].shape[1], args[5].shape[0], True)
            conv_module_residual.launches_bwd += 1
            conv_module_residual.launches_bwd_by_design[design] += 1
        dx, *dparams = grads
        return (dx, None,
                *(g.to(t) for g, t in zip(dparams, ctx.dtypes)))


def conv_module_residual(x: torch.Tensor, mask: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor,
                         w1: torch.Tensor, b1: torch.Tensor,
                         wdw: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor, wf1: torch.Tensor,
                         bf1: torch.Tensor, wf2: torch.Tensor,
                         bf2: torch.Tensor):
    """``x + SE(pw2(swish(dwconv(swish(pw1(LN(x)))))))`` as one kernel.

    ``x`` ``[B, T, D]`` (f32 or bf16); ``mask`` ``[B, T]`` (float or bool,
    1 = valid frame) feeds the SE pool only; ``gamma``/``beta`` ``[D]``;
    ``w1`` ``[D, E]``, ``b1`` ``[E]``; ``wdw`` ``[K, E]`` the causal
    depthwise taps; ``w2`` ``[E, D]``, ``b2`` ``[D]``; ``wf1`` ``[D, r]``,
    ``bf1`` ``[r]``, ``wf2`` ``[r, D]``, ``bf2`` ``[D]`` the SqueezeExcite
    Denses. Gradients flow to ``x`` and every parameter. Replaces
    ``ishara_tpu.ops.conv_kernel.conv_module_residual``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the conv-module kernel runs on CUDA or CPU "
                         f"tensors, not {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    return _ConvModuleResidual.apply(x, mask, gamma, beta, w1, b1, wdw, w2,
                                     b2, wf1, bf1, wf2, bf2)


# launches of the forward kernels and of the backward kernels (one count for
# each C call, whatever number of kernels it runs), in all and by design
conv_module_residual.launches = 0
conv_module_residual.launches_bwd = 0
conv_module_residual.launches_by_design = {
    "wgmma": 0, "tile": 0, "general": 0}
conv_module_residual.launches_bwd_by_design = {
    "wgmma": 0, "tile": 0, "general": 0}


def c_tile_smem(dtype: torch.dtype, backward: bool, config: int, D: int,
                K: int) -> int:
    """The shared memory ``csrc/conv_module.cu`` computes for tile
    configuration ``config`` (its ``ishara_conv_tile_smem``; builds the
    library): what :func:`tile_smem` must equal."""
    fn = _build.function("conv_module", "ishara_conv_tile_smem", [_I] * 5)
    return fn(_DTYPE_CODE[dtype], int(backward), config, D, K)
