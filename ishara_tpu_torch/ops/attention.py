"""Multi-head self-attention for training as one kernel per direction (port
of ``ishara_tpu/ops/attention.py``).

:func:`flash_mhsa` replaces the Pallas ``flash_mhsa``: attention over
``T <= 384`` keys, heads of any width (up to 256 zero-padded to 32, 64, 128
or 256; wider ones in 256-wide column chunks, as ``csrc/attention_tc.cuh``
says); padding is an additive
``[B, T]`` key bias (0 valid / -1e30 masked); dropout acts on the
normalised weights with the row sum taken from the undropped ones; the
forward saves the row logsumexp and the backward recomputes the
probabilities from it (``dS = P * (keep' * dP - delta)``) instead of
storing them. On a CUDA tensor it launches ``csrc/attention.cu`` (on the
tensor-core core of ``csrc/attention_tc.cuh``) or raises; on a CPU tensor
it runs the plain version beside it (:func:`mhsa_forward_plain`,
:func:`mhsa_backward_plain`): the same arithmetic, f32 on values widened
from ``q``'s dtype, one rounding on the way out.

The dropout mask is the Philox function of :mod:`.dropout` under the site's
``seed``, with the flat index into ``[B, H, T, T]`` as the counter: every
(batch, head, query, key) has its own word, and the backward regenerates it.
``offset`` is added to every index: a process holding rows ``[r0, r1)`` of
the batch passes ``r0 * H * T * T`` and draws the whole batch's mask there.
A tensor-parallel rank holds some of each row's heads, a strided slice of
the global ``[B, H', T, T]``: it passes ``runs = (H * T * T, H' * T * T)``
(:func:`ishara_tpu_torch.parallel.shard.split_offset`) and draws the
unsharded launch's mask at its heads' positions.
Semantics match ``models.layers.MultiHeadSelfAttention``'s einsum path,
including the reference's full-width ``dim**-0.5`` scaling, passed in as
``scale``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dropout import keep_mask, threshold_of

NEG = -1e30
MAX_T = 384          # the reference's routing to this kernel
HEAD_CHUNK = 256     # heads wider than this run in chunks of this width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` bool -> additive float32 bias (0 valid / NEG masked)."""
    return torch.where(mask, 0.0, NEG).to(torch.float32)


def reference_mhsa(q, k, v, bias, scale):
    """Plain einsum attention -- the numerical oracle for the kernel."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def _scaled_keep(seed, shape, rate, keep, offset=0, runs=None):
    if rate <= 0.0:
        return None
    if keep is None:
        keep = keep_mask(seed, shape, rate, offset, runs)
    return keep.to(torch.float32).reshape(shape) * (1.0 / (1.0 - rate))


def mhsa_forward_plain(q, k, v, bias, seed, scale, rate=0.0, keep=None,
                       offset=0, runs=None):
    """Plain version of the forward kernel: (o in ``q``'s dtype, lse f32
    ``[B, H, T]``). ``keep`` (bool ``[B, H, T, T]``) overrides the Philox
    mask of ``seed`` (from flat index ``offset`` on, in ``runs``)."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale \
        + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    kp = _scaled_keep(seed, s.shape, rate, keep, offset, runs)
    p_used = p if kp is None else p * kp
    o = torch.einsum("bhqk,bhkd->bhqd", p_used, vf) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def mhsa_backward_plain(q, k, v, bias, seed, o, lse, d_o, scale, rate=0.0,
                        keep=None, offset=0, runs=None):
    """Plain version of the backward kernel: (dq, dk, dv) in ``q``'s
    dtype."""
    qf, kf, vf, of, dof = (t.to(torch.float32) for t in (q, k, v, o, d_o))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale \
        + bias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    kp = _scaled_keep(seed, s.shape, rate, keep, offset, runs)
    if kp is not None:
        dv = torch.einsum("bhqk,bhqd->bhkd", p * kp, dof)
        dp = dp * kp
    else:
        dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _strides3(t):
    """Element strides over (b, h, t) as the C functions take them; the
    last dimension must be dense."""
    if t.stride(3) != 1:
        raise ValueError("q, k, v and dO need unit stride over the head "
                         "dimension")
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def kernel_takes(dtype: torch.dtype, T: int, Dh: int) -> bool:
    """Whether ``csrc/attention.cu`` takes this geometry, forward and
    backward: f32 or bf16, ``T <= 384`` and any head dimension ``>= 1``."""
    return dtype in _DTYPE_CODE and 1 <= T <= MAX_T and Dh >= 1


def _check_cuda(q, k, v, bias, seed):
    B, H, T, Dh = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the attention kernel takes f32 or bf16, got "
                         f"{q.dtype}")
    if not kernel_takes(q.dtype, T, Dh):
        raise ValueError(f"the attention kernel takes T <= {MAX_T} and a "
                         f"head dimension >= 1, got T={T}, Dh={Dh}")
    if B > 65535 or H > 65535:
        raise ValueError(f"the attention kernel takes B and H up to 65535, "
                         f"got B={B}, H={H}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must agree in shape, dtype and device")
    if bias.shape != (B, T) or bias.dtype != torch.float32 \
            or bias.device != q.device:
        raise ValueError("bias must be f32 [B, T] on q's device")
    if seed.dtype != torch.int32 or seed.numel() < 1 \
            or seed.device != q.device:
        raise ValueError("seed must be an int32 tensor on q's device")


def _unit_last(t):
    return t if t.stride(3) == 1 else t.contiguous()


def _mask_heads(shape, runs) -> int:
    """The heads a batch row of the mask's tensor for ``runs`` (0: the
    tensor's own); ``runs`` must be whole rows of heads."""
    if runs is None:
        return 0
    B, H, T, _ = shape
    width, stride = runs
    if width != H * T * T or stride % (T * T) or stride < width:
        raise ValueError(f"runs {runs} are not a slice of whole heads of "
                         f"[{B}, H, {T}, {T}]")
    return stride // (T * T)


def _launch_fwd(q, k, v, bias, seed, scale, rate, offset=0, runs=None):
    _check_cuda(q, k, v, bias, seed)
    heads = _mask_heads(q.shape, runs)
    B, H, T, Dh = q.shape
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    bias = bias.contiguous()
    o = torch.empty((B, H, T, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    S3 = ctypes.POINTER(ctypes.c_longlong)
    fn = _build.function("attention", "ishara_attention_fwd", [
        I, P, P, P, S3, S3, S3, P, P, P, P, I, I, I, I, F, U, F,
        ctypes.c_ulonglong, I, I, P])
    rc = fn(_build.device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _strides3(q), _strides3(k), _strides3(v), bias.data_ptr(),
            seed.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, T, Dh,
            scale, threshold_of(rate), 1.0 / (1.0 - rate), int(offset),
            heads, _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check("attention", rc, "attention forward kernel")
    return o, lse


def _launch_bwd(q, k, v, bias, seed, o, lse, d_o, scale, rate, offset=0,
                runs=None):
    B, H, T, Dh = q.shape
    heads = _mask_heads(q.shape, runs)
    q, k, v, d_o = (_unit_last(t) for t in (q, k, v, d_o))
    d_o = d_o.to(q.dtype)
    dq, dk, dv = (torch.empty((B, H, T, Dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    S3 = ctypes.POINTER(ctypes.c_longlong)
    fn = _build.function("attention", "ishara_attention_bwd", [
        I, P, P, P, P, S3, S3, S3, S3, P, P, P, P, P, P, P, P, I, I, I, I, F,
        U, F, ctypes.c_ulonglong, I, I, P])
    rc = fn(_build.device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            d_o.data_ptr(), _strides3(q), _strides3(k), _strides3(v),
            _strides3(d_o), bias.data_ptr(), seed.data_ptr(), o.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, T, Dh, scale, threshold_of(rate),
            1.0 / (1.0 - rate), int(offset), heads, _DTYPE_CODE[q.dtype],
            _build.stream_of(q))
    _build.check("attention", rc, "attention backward kernel")
    return dq, dk, dv


class _FlashMhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, rate, offset, runs):
        if q.device.type == "cpu":
            o, lse = mhsa_forward_plain(q, k, v, bias, seed, scale, rate,
                                        offset=offset, runs=runs)
        else:
            o, lse = _launch_fwd(q, k, v, bias, seed, scale, rate,
                                 offset=offset, runs=runs)
            flash_mhsa.launches += 1
        ctx.save_for_backward(q, k, v, bias, seed, o, lse)
        ctx.scale, ctx.rate = scale, rate
        ctx.offset, ctx.runs = offset, runs
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, bias, seed, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = mhsa_backward_plain(q, k, v, bias, seed, o, lse, d_o,
                                        ctx.scale, ctx.rate,
                                        offset=ctx.offset, runs=ctx.runs)
        else:
            grads = _launch_bwd(q, k, v, bias.contiguous(), seed, o, lse,
                                d_o, ctx.scale, ctx.rate, offset=ctx.offset,
                                runs=ctx.runs)
            flash_mhsa.launches_bwd += 1
        return (*grads, None, None, None, None, None, None)


def flash_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor, seed: torch.Tensor | None = None,
               scale: float = 1.0, dropout_rate: float = 0.0,
               offset: int = 0, runs=None):
    """``q``, ``k``, ``v``: ``[B, H, T, Dh]`` (f32 or bf16); ``bias``:
    ``[B, T]`` additive f32 key bias (0 or -1e30); ``seed``: int32 ``[1]``
    driving the dropout of the attention weights when ``dropout_rate`` > 0,
    whose mask starts at flat index ``offset``, in ``runs = (H * T * T,
    stride)`` on a tensor-parallel rank's heads (see the module's
    docstring).
    Returns ``[B, H, T, Dh]``. Replaces
    ``ishara_tpu.ops.attention.flash_mhsa``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the attention kernel runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, Dh], got {tuple(q.shape)}")
    if seed is None:
        seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
    if runs is not None:
        runs = (int(runs[0]), int(runs[1]))
        _mask_heads(q.shape, runs)
    return _FlashMhsa.apply(q, k, v, bias, seed, float(scale),
                            float(dropout_rate), int(offset), runs)


# launches of the forward and of the backward kernel
flash_mhsa.launches = 0
flash_mhsa.launches_bwd = 0
