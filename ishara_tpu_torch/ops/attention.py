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
storing them. On a CUDA tensor it launches ``csrc/attention.cu`` or
raises; on a CPU tensor it runs the plain version beside it
(:func:`mhsa_forward_plain`, :func:`mhsa_backward_plain`): the same
arithmetic, f32 on values widened from ``q``'s dtype, one rounding on the
way out. Both directions take the design that :func:`attention_plan`
names: ``"wgmma"`` (bf16 heads of 32 and 64 whose q, k, v TMA can read:
the persistent forward of ``csrc/attention_fwd_wg.cuh`` on a TMA key /
value ring, which also writes the keep bits, :func:`unpack_keep_bits`, and
one pass of ``csrc/attention_bwd.cuh`` on them) or ``"general"`` (the
forward and the two backward passes of the tensor-core core of
``csrc/attention_tc.cuh``, which regenerate the mask).

The dropout mask is the Philox function of :mod:`.dropout` under the site's
``seed``, with the flat index into ``[B, H, T, T]`` as the counter: every
(batch, head, query, key) has its own word, and the backward regenerates it
(the wgmma design's backward reads the forward's bits instead).
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

# the designs and the rule that picks one for both directions, mirrored
# from csrc/attention_bwd.cuh's k3wg::plan (which, with attention.cu's plan,
# alone owns the wgmma layouts: consumers, key-tile groups, shared memory
# and registers)
DESIGNS = ("general", "wgmma")
_WG_HEADS = (32, 64)           # head widths of the wgmma design


def attention_plan(dtype, T: int, Dh: int, aligned: bool) -> str:
    """Which design ``csrc/attention.cu`` runs, forward and backward, for
    ``[B, H, T, Dh]`` heads of ``dtype``: a rule on these alone, the same as
    the C ``k3wg::plan`` (``ishara_attention_plan``). ``aligned``: q, k, v
    start on 16 bytes and their strides over b, h, t are multiples of 8
    elements (:func:`tma_aligned`).

    * ``"wgmma"``: bf16, ``Dh`` 32 or 64, ``1 <= T <= 384``, aligned -- the
      persistent forward that writes the keep bits, and a backward of one
      block a head on them;
    * ``"general"``: everything else (the mma.sync forward and two
      backward passes)."""
    if dtype == torch.bfloat16 and Dh in _WG_HEADS and 1 <= T <= MAX_T \
            and aligned:
        return "wgmma"
    return "general"


def c_plan(dtype, T: int, Dh: int, aligned: bool) -> dict:
    """``csrc/attention.cu``'s own plan (needs the built library): its
    ``design`` (as :func:`attention_plan` names it, both directions) and,
    for the wgmma design, the backward's ``consumers`` (warpgroups of 64
    keys), ``groups`` (key-tile groups a block walks), ``stages``,
    ``ds_bufs``, ``smem`` (bytes a block) and ``reg_limit`` (setmaxnreg of
    a consumer thread), and the forward's ``fwd_consumers`` (warpgroups of
    64 queries), ``fwd_smem`` and ``fwd_reg_limit`` (0 on the general
    design)."""
    out = (ctypes.c_longlong * 10)()
    fn = _build.function("attention", "ishara_attention_plan",
                         [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.check("attention", fn(_DTYPE_CODE.get(dtype, 2), T, Dh,
                                 int(aligned), ctypes.addressof(out)),
                 "attention plan")
    keys = ("consumers", "groups", "stages", "ds_bufs", "smem", "reg_limit",
            "fwd_consumers", "fwd_smem", "fwd_reg_limit")
    return {"design": DESIGNS[out[0]],
            **{key: int(v) for key, v in zip(keys, out[1:])}}


def tma_aligned(*tensors) -> bool:
    """Whether each ``[B, H, T, Dh]`` tensor starts on 16 bytes with strides
    over b, h, t of 16-byte multiples, so that TMA can read its rows."""
    for t in tensors:
        if t.data_ptr() % 16 or t.stride(3) != 1 or any(
                t.stride(i) * t.element_size() % 16 for i in range(3)):
            return False
    return True


def keep_words(T: int) -> int:
    """32-bit words a query row of the keep bits holds: ``ceil(T / 32)``."""
    return -(-T // 32)


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """Bool ``[..., T, T]`` keep mask -> int32 ``[..., T, ceil(T / 32)]``
    words in the layout the forward kernel writes: word ``c`` of query row
    ``r`` holds keys ``32 c .. 32 c + 31``, key ``k`` at bit ``k % 32``;
    the bits past ``T`` are 0."""
    T = keep.shape[-1]
    W = keep_words(T)
    padded = torch.zeros((*keep.shape[:-1], W * 32), dtype=torch.int64,
                         device=keep.device)
    padded[..., :T] = keep.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=keep.device) \
        << torch.arange(32, device=keep.device)
    words = (padded.reshape(*keep.shape[:-1], W, 32) * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_keep_bits(bits: torch.Tensor, T: int) -> torch.Tensor:
    """The keep mask, bool ``[..., T, T]``, of words in
    :func:`pack_keep_bits`'s layout (the forward kernel's)."""
    words = bits.to(torch.int64) & 0xFFFFFFFF
    keep = (words[..., None] >> torch.arange(32, device=bits.device)) & 1
    return keep.reshape(*bits.shape[:-1], -1)[..., :T].bool()


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


def plan_of(q, k, v) -> str:
    """:func:`attention_plan` of a call on these q, k, v (as the launches
    take them: unit stride over the head dimension)."""
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    return attention_plan(q.dtype, q.shape[2], q.shape[3],
                          tma_aligned(q, k, v))


def _launch_fwd(q, k, v, bias, seed, scale, rate, offset=0, runs=None):
    """(o, lse, bits): bits are the keep decisions, int32 ``[B, H, T,
    ceil(T / 32)]``, where the plan is the wgmma design and ``rate > 0``,
    else None."""
    _check_cuda(q, k, v, bias, seed)
    heads = _mask_heads(q.shape, runs)
    B, H, T, Dh = q.shape
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    bias = bias.contiguous()
    o = torch.empty((B, H, T, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    bits = None
    if rate > 0.0 and plan_of(q, k, v) == "wgmma":
        bits = torch.empty((B, H, T, keep_words(T)), dtype=torch.int32,
                           device=q.device)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    S3 = ctypes.POINTER(ctypes.c_longlong)
    fn = _build.function("attention", "ishara_attention_fwd", [
        I, P, P, P, S3, S3, S3, P, P, P, P, P, I, I, I, I, F, U, F,
        ctypes.c_ulonglong, I, I, P])
    rc = fn(_build.device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _strides3(q), _strides3(k), _strides3(v), bias.data_ptr(),
            seed.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if bits is None else bits.data_ptr(), B, H, T, Dh,
            scale, threshold_of(rate), 1.0 / (1.0 - rate), int(offset),
            heads, _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check("attention", rc, "attention forward kernel")
    return o, lse, bits


def _launch_bwd(q, k, v, bias, seed, o, lse, d_o, scale, rate, offset=0,
                runs=None, bits=None):
    """(dq, dk, dv) by the plan's design; the wgmma design reads ``bits``,
    the forward's (None when ``rate`` is 0)."""
    B, H, T, Dh = q.shape
    heads = _mask_heads(q.shape, runs)
    q, k, v, d_o = (_unit_last(t) for t in (q, k, v, d_o))
    d_o = d_o.to(q.dtype)
    wgmma = plan_of(q, k, v) == "wgmma"
    if wgmma and not tma_aligned(d_o):
        d_o = d_o.contiguous()
    dq, dk, dv = (torch.empty((B, H, T, Dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = None if wgmma else torch.empty((B, H, T), dtype=torch.float32,
                                           device=q.device)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    S3 = ctypes.POINTER(ctypes.c_longlong)
    fn = _build.function("attention", "ishara_attention_bwd", [
        I, P, P, P, P, S3, S3, S3, S3, P, P, P, P, P, P, P, P, P, I, I, I, I,
        F, U, F, ctypes.c_ulonglong, I, I, P])
    rc = fn(_build.device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            d_o.data_ptr(), _strides3(q), _strides3(k), _strides3(v),
            _strides3(d_o), bias.data_ptr(), seed.data_ptr(), o.data_ptr(),
            lse.data_ptr(), None if bits is None else bits.data_ptr(),
            None if delta is None else delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, T, Dh, scale,
            threshold_of(rate), 1.0 / (1.0 - rate), int(offset), heads,
            _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check("attention", rc, "attention backward kernel")
    return dq, dk, dv


class _FlashMhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, rate, offset, runs):
        bits = None
        if q.device.type == "cpu":
            o, lse = mhsa_forward_plain(q, k, v, bias, seed, scale, rate,
                                        offset=offset, runs=runs)
        else:
            o, lse, bits = _launch_fwd(q, k, v, bias, seed, scale, rate,
                                       offset=offset, runs=runs)
            flash_mhsa.launches += 1
            flash_mhsa.launches_by_design[plan_of(q, k, v)] += 1
        ctx.save_for_backward(q, k, v, bias, seed, o, lse, bits)
        ctx.scale, ctx.rate = scale, rate
        ctx.offset, ctx.runs = offset, runs
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, bias, seed, o, lse, bits = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = mhsa_backward_plain(q, k, v, bias, seed, o, lse, d_o,
                                        ctx.scale, ctx.rate,
                                        offset=ctx.offset, runs=ctx.runs)
        else:
            grads = _launch_bwd(q, k, v, bias.contiguous(), seed, o, lse,
                                d_o, ctx.scale, ctx.rate, offset=ctx.offset,
                                runs=ctx.runs, bits=bits)
            flash_mhsa.launches_bwd += 1
            flash_mhsa.launches_bwd_by_design[
                plan_of(q, k, v)] += 1
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


# launches of the forward and of the backward kernels (one count for the
# two passes of the general design), in all and by the design
# (attention_plan) that took them
flash_mhsa.launches = 0
flash_mhsa.launches_bwd = 0
flash_mhsa.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_mhsa.launches_bwd_by_design = dict.fromkeys(DESIGNS, 0)
