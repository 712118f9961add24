"""Tiled flash attention for long sequences, forward and backward (port of
``ishara_tpu/ops/attention_blocked.py``).

:func:`flash_mhsa_blocked` replaces the Pallas ``flash_mhsa_blocked``: the
single-block kernel of :mod:`.attention` holds a ``[T, T]`` score block and
stops at ``T = 384``; this one streams the keys in tiles with the
online-softmax recurrence, so it takes any ``T`` and any head width.
There is no dropout inside: the layer takes it only with the attention
dropout off. ``bias`` is the additive ``[B, T]`` key bias of
:func:`.attention.mask_to_bias` (0 valid / -1e30 masked). The forward saves
the row logsumexp; the backward recomputes the probabilities from it, with
``delta = rowsum(dO * O)`` taken in its own prologue (the reference takes
it outside its kernels).

**Padding**, as the reference: ``T`` is padded to a multiple of
``lcm(block_q, block_k)`` (128 by default), and padded keys get the bias
-1e30. It decides one case: a row whose keys are all masked has every score
at -1e30, so the forward averages V over all ``Tp`` keys, padded zeros
included (the einsum composition, which masks with ``finfo.min``, averages
over ``T``). In the backward, padded queries and keys add exact zeros to
the gradients that are kept, so the backward's plain version works on ``T``.

On a CUDA tensor the wrapper launches ``csrc/attention_blocked.cu`` or
raises; on a CPU tensor it runs the plain versions beside it
(:func:`blocked_attention_forward_plain`,
:func:`blocked_attention_backward_plain`): the reference's recurrence in
f32 on values widened from ``q``'s dtype, one rounding on the way out.
Each direction takes the design that :func:`blocked_plan` names, a rule on
(dtype, T, Dh, whether TMA can read q, k, v) alone: ``"wgmma"`` (bf16 heads
of 32 and 64: the forward of ``csrc/attention_fwd_wg.cuh`` on a TMA
key / value ring, one launch; the backward in one launch of
``csrc/attention_bwd.cuh``'s five-product pass with no keep bits, where its
shared memory holds T) or ``"general"`` (the tensor-core core of
``csrc/attention_tc.cuh``: one forward launch, a dQ and a dK / dV pass).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .attention import NEG, tma_aligned

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the designs and the rule that picks one for each direction, the same as
# csrc/attention_fwd_wg.cuh's k8wg::plan (which owns the kernels' layouts)
DESIGNS = ("general", "wgmma")
# head width -> the longest T whose wgmma backward (k3wg::layout_of: the f32
# partial dQ sums grow with T) fits a block's shared memory
_WG_BWD_T_MAX = {32: 640, 64: 384}


class BlockedPlan(NamedTuple):
    forward: str
    backward: str


def blocked_plan(dtype, T: int, Dh: int, aligned: bool) -> BlockedPlan:
    """The designs ``csrc/attention_blocked.cu`` runs for ``[B, H, T, Dh]``
    heads of ``dtype``: a rule on these alone, the same as the C
    ``k8wg::plan`` (``ishara_blocked_attention_plan``). ``aligned``: q, k, v
    start on 16 bytes with strides over b, h, t of 16-byte multiples
    (:func:`.attention.tma_aligned`).

    * forward ``"wgmma"``: bf16, ``Dh`` 32 or 64, aligned, any ``T``;
    * backward ``"wgmma"``: the same, up to the T its shared memory holds
      (heads of 32 up to T 640, of 64 up to T 384);
    * ``"general"`` otherwise (the mma.sync core)."""
    if dtype != torch.bfloat16 or Dh not in _WG_BWD_T_MAX or T < 1 \
            or not aligned:
        return BlockedPlan("general", "general")
    return BlockedPlan("wgmma", "wgmma" if T <= _WG_BWD_T_MAX[Dh]
                       else "general")


def plan_of(q, k, v) -> BlockedPlan:
    """:func:`blocked_plan` of a call on these q, k, v (as the launches take
    them: unit stride over the head dimension)."""
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    return blocked_plan(q.dtype, q.shape[2], q.shape[3],
                        tma_aligned(q, k, v))


def c_plan(dtype, T: int, Dh: int, aligned: bool) -> dict:
    """``csrc/attention_blocked.cu``'s own plan (needs the built library):
    ``forward`` and ``backward`` (designs as :func:`blocked_plan` names
    them), ``fwd_smem`` and, for the wgmma backward, ``consumers``,
    ``groups``, ``stages``, ``ds_bufs``, ``smem`` and ``reg_limit``."""
    out = (ctypes.c_longlong * 9)()
    fn = _build.function("attention_blocked", "ishara_blocked_attention_plan",
                         [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.check("attention_blocked",
                 fn(_DTYPE_CODE.get(dtype, 2), T, Dh, int(aligned),
                    ctypes.addressof(out)), "blocked attention plan")
    keys = ("consumers", "groups", "stages", "ds_bufs", "smem", "reg_limit")
    return {"forward": DESIGNS[out[0]], "fwd_smem": int(out[1]),
            "backward": DESIGNS[out[2]],
            **{key: int(v) for key, v in zip(keys, out[3:])}}


def padded_length(T: int, block_q: int = 128, block_k: int = 128) -> int:
    """``T`` rounded up to a multiple of ``lcm(block_q, block_k)``."""
    mult = math.lcm(block_q, block_k)
    return -(-T // mult) * mult


def blocked_attention_forward_plain(q, k, v, bias, scale, block_q=128,
                                    block_k=128):
    """Plain version of the forward kernel: (o in ``q``'s dtype, lse f32
    ``[B, H, T]``), by the reference's recurrence over key blocks of
    ``block_k`` on the padded length."""
    B, H, T, Dh = q.shape
    Tp = padded_length(T, block_q, block_k)
    qf, kf, vf = (F.pad(t.to(torch.float32), (0, 0, 0, Tp - T))
                  for t in (q, k, v))
    bp = F.pad(bias.to(torch.float32), (0, Tp - T), value=NEG)
    acc = torch.zeros((B, H, Tp, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tp, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tp, 1), dtype=torch.float32, device=q.device)
    for j in range(0, Tp, block_k):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, j:j + block_k]) \
            * scale + bp[:, None, None, j:j + block_k]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p,
                                        vf[:, :, j:j + block_k])
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
    o = (acc / l)[:, :, :T].to(q.dtype)
    return o, (m + torch.log(l))[:, :, :T, 0]


def blocked_attention_backward_plain(q, k, v, bias, o, lse, d_o, scale):
    """Plain version of the backward kernels: (dq, dk, dv) in ``q``'s
    dtype from the forward's ``o`` and ``lse``. Padding would add only
    zeros to these, so it works on ``T`` keys and queries."""
    qf, kf, vf, of, dof = (t.to(torch.float32) for t in (q, k, v, o, d_o))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale \
        + bias.to(torch.float32)[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _strides3(t):
    """Element strides over (b, h, t) as the C functions take them."""
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _unit_last(t):
    return t if t.stride(3) == 1 else t.contiguous()


def _check_cuda(q, k, v, bias):
    B, H, T, Dh = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the blocked attention kernel takes f32 or bf16, "
                         f"got {q.dtype}")
    if Dh < 1 or T < 1:
        raise ValueError(f"the blocked attention kernel takes T >= 1 and a "
                         f"head dimension >= 1, got T={T}, Dh={Dh}")
    if B > 65535 or H > 65535:
        raise ValueError(f"the blocked attention kernel takes B and H up to "
                         f"65535, got B={B}, H={H}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must agree in shape, dtype and device")
    if bias.shape != (B, T) or bias.dtype != torch.float32 \
            or bias.device != q.device:
        raise ValueError("bias must be f32 [B, T] on q's device")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S3 = ctypes.POINTER(ctypes.c_longlong)


def _launch_fwd(q, k, v, bias, scale, Tp):
    _check_cuda(q, k, v, bias)
    B, H, T, Dh = q.shape
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    bias = bias.contiguous()
    o = torch.empty((B, H, T, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = _build.function(
        "attention_blocked", "ishara_blocked_attention_fwd",
        [_I, _P, _P, _P, _S3, _S3, _S3, _P, _P, _P, _I, _I, _I, _I, _I, _F,
         _I, _P])
    rc = fn(_build.device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _strides3(q), _strides3(k), _strides3(v), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, H, T, Tp, Dh, scale,
            _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check("attention_blocked", rc, "blocked attention forward kernel")
    return o, lse


def _launch_bwd(q, k, v, bias, o, lse, d_o, scale):
    B, H, T, Dh = q.shape
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    d_o = _unit_last(d_o.to(q.dtype))
    wgmma = plan_of(q, k, v).backward == "wgmma"
    if wgmma and not tma_aligned(d_o):
        d_o = d_o.contiguous()
    delta = None if wgmma else torch.empty((B, H, T), dtype=torch.float32,
                                           device=q.device)
    dq, dk, dv = (torch.empty((B, H, T, Dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    fn = _build.function(
        "attention_blocked", "ishara_blocked_attention_bwd",
        [_I, _P, _P, _P, _P, _S3, _S3, _S3, _S3, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _F, _I, _P])
    rc = fn(_build.device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            d_o.data_ptr(), _strides3(q), _strides3(k), _strides3(v),
            _strides3(d_o), bias.contiguous().data_ptr(),
            o.contiguous().data_ptr(), lse.contiguous().data_ptr(),
            None if delta is None else delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, T, Dh, scale,
            _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check("attention_blocked", rc, "blocked attention backward kernels")
    return dq, dk, dv


def _runs_plain(q) -> bool:
    """Whether a call runs the plain versions: exactly when ``q`` lies on
    the CPU."""
    return q.device.type == "cpu"


class _FlashMhsaBlocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, block_q, block_k):
        if _runs_plain(q):
            o, lse = blocked_attention_forward_plain(q, k, v, bias, scale,
                                                     block_q, block_k)
        else:
            o, lse = _launch_fwd(q, k, v, bias, scale,
                                 padded_length(q.shape[2], block_q, block_k))
            flash_mhsa_blocked.launches += 1
            flash_mhsa_blocked.launches_by_design[plan_of(q, k, v)
                                                  .forward] += 1
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, bias, o, lse = ctx.saved_tensors
        if _runs_plain(q):
            grads = blocked_attention_backward_plain(q, k, v, bias, o, lse,
                                                     d_o, ctx.scale)
        else:
            grads = _launch_bwd(q, k, v, bias, o, lse, d_o, ctx.scale)
            flash_mhsa_blocked.launches_bwd += 1
            flash_mhsa_blocked.launches_bwd_by_design[plan_of(q, k, v)
                                                      .backward] += 1
        return (*grads, None, None, None, None)


def flash_mhsa_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, scale: float, block_q: int = 128,
                       block_k: int = 128):
    """``q``, ``k``, ``v``: ``[B, H, T, Dh]`` (f32 or bf16, ``Dh`` up to
    256 on the card); ``bias``: ``[B, T]`` additive f32 key bias. ``T`` is
    padded to a multiple of ``lcm(block_q, block_k)`` (padded keys
    masked). Returns ``[B, H, T, Dh]`` in ``q``'s dtype; gradients flow to
    q, k and v. Replaces
    ``ishara_tpu.ops.attention_blocked.flash_mhsa_blocked``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the blocked attention kernel runs on CUDA or CPU "
                         f"tensors, not {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, Dh], got {tuple(q.shape)}")
    return _FlashMhsaBlocked.apply(q, k, v, bias, float(scale), int(block_q),
                                   int(block_k))


# launches of the forward and of the backward (one count for the two passes
# of the general design), in all and by the design (blocked_plan) that took
# them
flash_mhsa_blocked.launches = 0
flash_mhsa_blocked.launches_bwd = 0
flash_mhsa_blocked.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_mhsa_blocked.launches_bwd_by_design = dict.fromkeys(DESIGNS, 0)
