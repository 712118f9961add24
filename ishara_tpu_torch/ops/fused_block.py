"""Fused eval-mode encoder blocks for batch-1 serving (port of
``ishara_tpu/ops/fused_block.py``).

:func:`fused_squeezeformer_stack` and :func:`fused_conformer_stack` replace
the Pallas kernels of the same names (``_stack_call``): N blocks of one type
on one ``[T, dim]`` sequence. On a CUDA tensor each launches the hand-written
kernels of ``csrc/fused_block.cu`` (see the note at its top for the design,
its numerics and its bound on an H100), or raises; on a CPU tensor it runs
the plain PyTorch version beside it, :func:`squeeze_body` /
:func:`conformer_body`, which repeat the reference's ``_squeeze_body`` /
``_conformer_body`` step by step. Each wrapper counts its kernel launches in
``.launches``.

Kernel arguments are the reference's per-block leaf tuples
(:mod:`ishara_tpu_torch.bridge`), each leaf stacked on a leading block axis
(:func:`stack_block_args`): matrices ``[in, out]`` at the storage dtype (bf16
by default, or f32), vectors ``[n]`` and depthwise kernels ``[K, C]`` in f32.

:class:`FusedEncoder` runs the whole forward -- stem, the two stacks, top
and classifier -- with the stem and head as plain ``torch.matmul``, as the
reference leaves them to XLA outside any kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..bridge import conformer_block_args, squeeze_block_args
from ..config import EncoderConfig
from ..device import resolve_device
from ..models.encoder import check_variant
from ..models.layers import BN_EPS, LN_EPS, LN_EPS_DEFAULT, positional_encoding
from ..preprocess.pipeline import frame_mask
from . import _build

NEG = -1e30  # the kernels' key bias for a masked frame

# Leaf names and shapes, in the reference's kernel argument order. "m" leaves
# are matmul weights at the storage dtype, "v" leaves f32.
SQUEEZE_LEAVES = (
    ("n1g", "v", "D"), ("n1b", "v", "D"),
    ("f1w1", "m", "D F"), ("f1b1", "v", "F"),
    ("f1w2", "m", "F D"), ("f1b2", "v", "D"),
    ("n2g", "v", "D"), ("n2b", "v", "D"),
    ("qkvw", "m", "D 3D"), ("projw", "m", "D D"),
    ("cng", "v", "D"), ("cnb", "v", "D"),
    ("pw1w", "m", "D E"), ("pw1b", "v", "E"),
    ("dww", "v", "K E"),
    ("pw2w", "m", "E D"), ("pw2b", "v", "D"),
    ("se1w", "m", "D R"), ("se1b", "v", "R"),
    ("se2w", "m", "R D"), ("se2b", "v", "D"),
    ("n3g", "v", "D"), ("n3b", "v", "D"),
    ("f2w1", "m", "D F"), ("f2b1", "v", "F"),
    ("f2w2", "m", "F D"), ("f2b2", "v", "D"),
)
CONFORMER_LEAVES = (
    ("l1g", "v", "D"), ("l1b", "v", "D"),
    ("f1w1", "m", "D F"), ("f1b1", "v", "F"),
    ("f1w2", "m", "F D"), ("f1b2", "v", "D"),
    ("qkvw", "m", "D 3D"), ("projw", "m", "D D"),
    ("pw1w", "m", "D 2D"), ("pw1b", "v", "2D"),
    ("dww", "v", "K D"), ("dwb", "v", "D"),
    ("bng", "v", "D"), ("bnb", "v", "D"), ("bnm", "v", "D"), ("bnv", "v", "D"),
    ("pw2w", "m", "D D"), ("pw2b", "v", "D"),
    ("clng", "v", "D"), ("clnb", "v", "D"),
    ("l2g", "v", "D"), ("l2b", "v", "D"),
    ("f2w1", "m", "D F"), ("f2b1", "v", "F"),
    ("f2w2", "m", "F D"), ("f2b2", "v", "D"),
)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the reference's block bodies, one block, [T, dim])
# ---------------------------------------------------------------------------

def _ln(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _swish(x):
    return x * torch.sigmoid(x)


def _mm(a, w):
    """[T, I] @ [I, O] with f32 operands and accumulation; the weight is
    widened from its storage dtype."""
    return a.to(torch.float32) @ w.to(torch.float32)


def _mhsa(x, mask, qkv_w, proj_w, num_heads, dim):
    """Fused-QKV attention with the full-dim scale; ``mask`` [T] of 1/0.
    At bf16 storage q, k, v and p are rounded to bf16 before their products
    (exact in f32), which accumulate in f32."""
    dh = dim // num_heads
    qkv = _mm(x, qkv_w)  # [T, 3*dim], per head [q|k|v] blocks of dh
    bias = (1.0 - mask) * NEG
    scale = dim ** -0.5

    def rnd(t):
        return t.to(qkv_w.dtype).to(torch.float32)

    outs = []
    for h in range(num_heads):
        base = h * 3 * dh
        q = rnd(qkv[:, base: base + dh])
        k = rnd(qkv[:, base + dh: base + 2 * dh])
        v = rnd(qkv[:, base + 2 * dh: base + 3 * dh])
        s = (q @ k.T) * scale + bias
        s = s - s.max(dim=-1, keepdim=True).values
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        outs.append(rnd(p) @ v)
    return _mm(torch.cat(outs, dim=1), proj_w)


def _masked_gap(x, mask):
    return (x * mask[:, None]).sum(dim=0) / torch.clamp(mask.sum(), min=1.0)


def _dwconv(h, w, causal: bool):
    """Depthwise conv over time, w [K, C]; causal pads K-1 on the left,
    otherwise 'same' pads ((K-1)//2, K//2)."""
    k, T = w.shape[0], h.shape[0]
    pad = (k - 1, 0) if causal else ((k - 1) // 2, k // 2)
    hp = torch.nn.functional.pad(h, (0, 0) + pad)
    out = torch.zeros_like(h)
    for i in range(k):
        out = out + hp[i: i + T] * w[i]
    return out


def _ffn(x, w1, b1, w2, b2):
    return _mm(_swish(_mm(x, w1) + b1), w2) + b2


def squeeze_body(num_heads, dim, x, mask,
                 n1g, n1b, f1w1, f1b1, f1w2, f1b2,
                 n2g, n2b, qkvw, projw,
                 cng, cnb, pw1w, pw1b, dww, pw2w, pw2b,
                 se1w, se1b, se2w, se2b,
                 n3g, n3b, f2w1, f2b1, f2w2, f2b2):
    """One eval-mode Squeezeformer block on x [T, dim] (reference
    ``_squeeze_body``)."""
    x = x + _ffn(_ln(x, n1g, n1b, LN_EPS), f1w1, f1b1, f1w2, f1b2)
    x = x + _mhsa(_ln(x, n2g, n2b, LN_EPS), mask, qkvw, projw, num_heads, dim)
    h = _ln(x, cng, cnb, LN_EPS)
    h = _swish(_mm(h, pw1w) + pw1b)
    h = _swish(_dwconv(h, dww, causal=True))
    h = _mm(h, pw2w) + pw2b
    g = _masked_gap(h, mask)[None, :]
    g = _swish(_mm(g, se1w) + se1b)
    g = torch.sigmoid(_mm(g, se2w) + se2b)
    x = x + h * g
    return x + _ffn(_ln(x, n3g, n3b, LN_EPS), f2w1, f2b1, f2w2, f2b2)


def conformer_body(num_heads, dim, x, mask,
                   l1g, l1b, f1w1, f1b1, f1w2, f1b2,
                   qkvw, projw,
                   pw1w, pw1b, dww, dwb, bng, bnb, bnm, bnv,
                   pw2w, pw2b, clng, clnb,
                   l2g, l2b, f2w1, f2b1, f2w2, f2b2):
    """One eval-mode Conformer block on x [T, dim] (reference
    ``_conformer_body``): FFN1 and MHSA share ln1; the conv module ends in
    LN(h + x) with eps 1e-3."""
    x = x + _ffn(_ln(x, l1g, l1b, LN_EPS), f1w1, f1b1, f1w2, f1b2)
    x = x + _mhsa(_ln(x, l1g, l1b, LN_EPS), mask, qkvw, projw, num_heads, dim)
    res = x
    h = _mm(x, pw1w) + pw1b
    h = h[:, :dim] * torch.sigmoid(h[:, dim:])
    h = _dwconv(h, dww, causal=False) + dwb
    h = (h - bnm) * torch.rsqrt(bnv + BN_EPS) * bng + bnb
    h = _mm(h, pw2w) + pw2b
    x = _ln(h + res, clng, clnb, LN_EPS_DEFAULT)
    return x + _ffn(_ln(x, l2g, l2b, LN_EPS), f2w1, f2b1, f2w2, f2b2)


def squeeze_stack_plain(x, mask, leaves, num_heads):
    """Plain version of :func:`fused_squeezeformer_stack`."""
    x = x.to(torch.float32)
    mask = mask.to(torch.float32)
    for b in range(leaves[0].shape[0]):
        x = squeeze_body(num_heads, x.shape[1], x, mask,
                         *(w[b] for w in leaves))
    return x


def conformer_stack_plain(x, mask, leaves, num_heads):
    """Plain version of :func:`fused_conformer_stack`."""
    x = x.to(torch.float32)
    mask = mask.to(torch.float32)
    for b in range(leaves[0].shape[0]):
        x = conformer_body(num_heads, x.shape[1], x, mask,
                           *(w[b] for w in leaves))
    return x


# ---------------------------------------------------------------------------
# Wrappers of the CUDA kernels
# ---------------------------------------------------------------------------

def stack_block_args(per_block):
    """Per-block leaf tuples -> one tuple of leaves stacked on a leading
    block axis (what the stack wrappers take)."""
    return tuple(torch.stack(ws).contiguous() for ws in zip(*per_block))


def _check(spec, x, mask, leaves, num_heads):
    """Validate the wrapper's inputs; return (dims, storage dtype)."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous f32 [T, dim], got "
                         f"{tuple(x.shape)} {x.dtype}")
    T, D = x.shape
    if mask.shape != (T,):
        raise ValueError(f"mask must be [T]={T}, got {tuple(mask.shape)}")
    if D % num_heads:
        raise ValueError(f"dim {D} is not a multiple of num_heads {num_heads}")
    if len(leaves) != len(spec):
        raise ValueError(f"expected {len(spec)} leaves, got {len(leaves)}")
    by_name = dict(zip((n for n, _, _ in spec), leaves))
    nb = leaves[0].shape[0]
    dims = {"D": D, "2D": 2 * D, "3D": 3 * D, "H": num_heads,
            "F": by_name["f1w1"].shape[-1], "K": by_name["dww"].shape[1]}
    if "se1w" in by_name:
        dims["E"] = by_name["pw1w"].shape[-1]
        dims["R"] = by_name["se1w"].shape[-1]
    mdt = by_name["qkvw"].dtype
    if mdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matmul weights must be bf16 or f32, got {mdt}")
    for (name, kind, shape), w in zip(spec, leaves):
        want = (nb,) + tuple(dims[s] for s in shape.split())
        dt = mdt if kind == "m" else torch.float32
        if tuple(w.shape) != want or w.dtype != dt:
            raise ValueError(f"leaf {name}: want {want} {dt}, got "
                             f"{tuple(w.shape)} {w.dtype}")
        if w.device != x.device or not w.is_contiguous():
            raise ValueError(f"leaf {name} must be contiguous on {x.device}")
    return dims, mdt


def _launch_args(x, mask, leaves):
    ptrs = (ctypes.c_void_p * len(leaves))(*(w.data_ptr() for w in leaves))
    strides = (ctypes.c_longlong * len(leaves))(
        *(w.stride(0) * w.element_size() for w in leaves))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    return ptrs, strides, stream


def _lib():
    lib = _build.load("fused_block")
    if not getattr(lib, "_ishara_declared", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        LL = ctypes.POINTER(ctypes.c_longlong)
        lib.ishara_squeeze_stack.argtypes = (
            [I, P, P, P, P, LL] + [I] * 8 + [F, I] + [P] * 6 + [P])
        lib.ishara_squeeze_stack.restype = I
        lib.ishara_conformer_stack.argtypes = (
            [I, P, P, P, P, LL] + [I] * 6 + [F, I] + [P] * 4 + [P])
        lib.ishara_conformer_stack.restype = I
        lib.ishara_error_string.argtypes = [I]
        lib.ishara_error_string.restype = ctypes.c_char_p
        lib._ishara_declared = True
    return lib


def _raise_on(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.ishara_error_string(rc).decode()})")


def _device_of(x, leaves, dims):
    """The CUDA device index, after the checks that only the kernels need:
    widths in whole GEMM tiles and 16-byte aligned rows and blocks."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels run on CUDA or CPU tensors, "
                         f"not {x.device}")
    for s in ("D", "F", "E"):
        if dims.get(s, 32) % 32:
            raise ValueError(f"the CUDA kernels need {s} = {dims[s]} to be a "
                             f"multiple of 32")
    if (dims["D"] // dims["H"]) % 4:
        raise ValueError(f"the CUDA kernels need dim / num_heads = "
                         f"{dims['D'] // dims['H']} to be a multiple of 4")
    for w in (x, *leaves):
        if w.data_ptr() % 16 or (w.stride(0) * w.element_size()) % 16:
            raise ValueError("the CUDA kernels need 16-byte aligned inputs")
    return x.device.index if x.device.index is not None else \
        torch.cuda.current_device()


def fused_squeezeformer_stack(x, mask, leaves, *, num_heads: int):
    """N eval-mode Squeezeformer blocks on x [T, dim] f32 with mask [T]
    (bool or 1/0); ``leaves`` from :func:`stack_block_args` over
    :func:`ishara_tpu_torch.bridge.squeeze_block_args`. Replaces
    ``ishara_tpu.ops.fused_block.fused_squeezeformer_stack``."""
    mask = mask.to(torch.float32).contiguous()
    dims, mdt = _check(SQUEEZE_LEAVES, x, mask, leaves, num_heads)
    if x.device.type == "cpu":
        return squeeze_stack_plain(x, mask, leaves, num_heads)
    dev = _device_of(x, leaves, dims)
    T, D = x.shape
    F, E = dims["F"], dims["E"]
    out = torch.empty_like(x)
    qkv = x.new_empty((T, 3 * D))
    hid = x.new_empty((T, max(F, E)))
    hid2 = x.new_empty((T, E))
    att = x.new_empty((T, D))
    hb = x.new_empty((T, D))
    gate = x.new_empty((D,))
    ptrs, strides, stream = _launch_args(x, mask, leaves)
    lib = _lib()
    rc = lib.ishara_squeeze_stack(
        dev, x.data_ptr(), mask.data_ptr(), out.data_ptr(), ptrs, strides,
        leaves[0].shape[0], T, D, num_heads, F, E, dims["K"], dims["R"],
        float(D) ** -0.5, int(mdt == torch.bfloat16), qkv.data_ptr(),
        hid.data_ptr(), hid2.data_ptr(), att.data_ptr(), hb.data_ptr(),
        gate.data_ptr(), stream)
    _raise_on(lib, rc, "fused_squeezeformer_stack")
    fused_squeezeformer_stack.launches += 1
    return out


def fused_conformer_stack(x, mask, leaves, *, num_heads: int):
    """N eval-mode Conformer blocks (BN running stats) on x [T, dim] f32;
    ``leaves`` from :func:`stack_block_args` over
    :func:`ishara_tpu_torch.bridge.conformer_block_args`. Replaces
    ``ishara_tpu.ops.fused_block.fused_conformer_stack``."""
    mask = mask.to(torch.float32).contiguous()
    dims, mdt = _check(CONFORMER_LEAVES, x, mask, leaves, num_heads)
    if x.device.type == "cpu":
        return conformer_stack_plain(x, mask, leaves, num_heads)
    dev = _device_of(x, leaves, dims)
    T, D = x.shape
    F = dims["F"]
    out = torch.empty_like(x)
    qkv = x.new_empty((T, 3 * D))
    hid = x.new_empty((T, max(F, 2 * D)))
    hid2 = x.new_empty((T, D))
    att = x.new_empty((T, D))
    ptrs, strides, stream = _launch_args(x, mask, leaves)
    lib = _lib()
    rc = lib.ishara_conformer_stack(
        dev, x.data_ptr(), mask.data_ptr(), out.data_ptr(), ptrs, strides,
        leaves[0].shape[0], T, D, num_heads, F, dims["K"], float(D) ** -0.5,
        int(mdt == torch.bfloat16), qkv.data_ptr(), hid.data_ptr(),
        hid2.data_ptr(), att.data_ptr(), stream)
    _raise_on(lib, rc, "fused_conformer_stack")
    fused_conformer_stack.launches += 1
    return out


fused_squeezeformer_stack.launches = 0
fused_conformer_stack.launches = 0

PLAIN = {fused_squeezeformer_stack: squeeze_stack_plain,
         fused_conformer_stack: conformer_stack_plain}


def fused_squeezeformer_block(x, mask, leaves, *, num_heads: int):
    """One block (K5c): the stack kernel with N=1; ``leaves`` is one
    block's tuple from :func:`ishara_tpu_torch.bridge.squeeze_block_args`."""
    return fused_squeezeformer_stack(x, mask, stack_block_args([leaves]),
                                     num_heads=num_heads)


def fused_conformer_block(x, mask, leaves, *, num_heads: int):
    """One Conformer block (K5c), the stack kernel with N=1."""
    return fused_conformer_stack(x, mask, stack_block_args([leaves]),
                                 num_heads=num_heads)


# ---------------------------------------------------------------------------
# Whole fused forward
# ---------------------------------------------------------------------------

def _storage_dtype(compute_dtype):
    if compute_dtype in (torch.bfloat16, torch.float32):
        return compute_dtype
    if compute_dtype == "int8":
        raise NotImplementedError(
            'compute_dtype="int8" (kernel K5e) is not ported yet (ROADMAP.md '
            "Queue 2, int8/dma fused serving)")
    raise ValueError(f"compute_dtype must be torch.bfloat16 or torch.float32, "
                     f"got {compute_dtype!r}")


class FusedEncoder:
    """Batch-1 eval forward of an ``IsharaEncoder`` through the fused block
    kernels, with the weights packed once for the kernels.

    ``state_dict`` is the port's ``IsharaEncoder`` state (bridged or its
    own); ``compute_dtype`` is the matmul-weight storage dtype inside the
    blocks (bf16 by default, the reference's deploy numerics, or f32)."""

    def __init__(self, cfg: EncoderConfig, state_dict, *,
                 compute_dtype=torch.bfloat16, device=None):
        check_variant(cfg)
        dev = resolve_device(device)
        dt = _storage_dtype(compute_dtype)
        sd = {k: v.detach().to(dev) for k, v in state_dict.items()}
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        f32 = torch.float32
        self.stem_w = sd["stem_conv.weight"].to(f32).T.contiguous()
        self.pos = torch.as_tensor(positional_encoding(cfg.frame_len, cfg.dim),
                                   device=dev)
        self.bn = [sd[f"stem_bn.{n}"].to(f32) for n in
                   ("running_mean", "running_var", "weight", "bias")]
        nsq = cfg.num_squeeze_blocks if cfg.variant != "conformer" else 0
        ncf = cfg.num_conform_blocks if cfg.variant != "squeezeformer" else 0
        self.squeeze = (stack_block_args(
            [squeeze_block_args(sd, f"squeezeformer.{i}.", dt)
             for i in range(nsq)]) if nsq else None)
        self.conform = (stack_block_args(
            [conformer_block_args(sd, f"conformer.{i}.", dt)
             for i in range(ncf)]) if ncf else None)
        self.top_w = sd["top_conv.weight"].to(f32).T.contiguous()
        self.top_b = sd["top_conv.bias"].to(f32)
        self.cls_w = sd["classifier.weight"].to(f32).T.contiguous()
        self.cls_b = sd["classifier.bias"].to(f32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, input_dim] preprocessed frames -> logits [T, num_classes]."""
        mask = frame_mask(x)
        h = _mm(x, self.stem_w) + self.pos[: x.shape[0]]
        m, v, g, b = self.bn
        h = ((h - m) * torch.rsqrt(v + BN_EPS) * g + b).contiguous()
        if self.squeeze is not None:
            h = fused_squeezeformer_stack(h, mask, self.squeeze,
                                          num_heads=self.num_heads)
        if self.conform is not None:
            h = fused_conformer_stack(h, mask, self.conform,
                                      num_heads=self.num_heads)
        h = torch.relu(_mm(h, self.top_w) + self.top_b)
        return _mm(h, self.cls_w) + self.cls_b


def fused_encoder_forward(cfg: EncoderConfig, state_dict, x, *,
                          compute_dtype=torch.bfloat16, device=None):
    """One-shot form of :class:`FusedEncoder`: x [T, input_dim] -> logits.
    Matches ``IsharaEncoder`` eval logits exactly up to f32 rounding at
    ``compute_dtype=torch.float32`` and to about 1% at bf16."""
    enc = FusedEncoder(cfg, state_dict, compute_dtype=compute_dtype,
                       device=device)
    return enc(torch.as_tensor(x).to(resolve_device(device)))
