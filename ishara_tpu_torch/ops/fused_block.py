"""Fused eval-mode encoder blocks for batch-1 serving (port of
``ishara_tpu/ops/fused_block.py``).

:func:`fused_squeezeformer_stack`, :func:`fused_conformer_stack` and
:func:`fused_conv_group_stack` replace the Pallas kernels of the same names
(``_stack_call`` / ``_stack_call_dma``): N blocks of one type -- or N groups
of k ``Conv1DBlock``s followed by one Squeezeformer, Conformer or Transformer
block -- on one ``[T, dim]`` sequence. On a CUDA tensor each launches the
hand-written kernels of ``csrc/fused_block.cu`` (see the note at its top for
the design, its numerics and its bound on an H100), or raises; on a CPU
tensor it runs the plain PyTorch version beside it (:func:`squeeze_body`,
:func:`conformer_body`, :func:`transformer_body`,
:func:`conv1d_block_body`), which repeat the reference's bodies step by
step. Each wrapper counts its kernel launches in ``.launches``.

Kernel arguments are the reference's per-block leaf tuples
(:mod:`ishara_tpu_torch.bridge`), each leaf stacked on a leading block axis
(:func:`stack_block_args`, :func:`stack_group_args`): matrices ``[in, out]``
at the storage dtype (bf16 by default, or f32), vectors ``[n]`` and
depthwise kernels ``[K, C]`` in f32. At int8 storage a matrix is the pair
(q int8 ``[in, out]``, scale f32 ``[out]``) of
:func:`quantize_serving_weights`, and the scale multiplies the product
after the dot.

``dma=True`` is the port of the reference's manually double-buffered weight
DMA: the whole stack runs as one persistent cooperative kernel that
prefetches the next block's weights into L2 while the current block
computes. Its numerics are those of ``dma=False``.

The whole fused forward of an encoder -- stem, the stacks, top and
classifier (the reference's ``fused_encoder_forward``) -- builds on the model
package and lives there: :mod:`ishara_tpu_torch.models.fused`.
"""

from __future__ import annotations

import ctypes

import torch

from ..bridge import (
    conformer_block_args,
    dequantize,
    is_quantized,
    squeeze_block_args,
    transformer_block_args,
)
from ..config import BN_EPS, LN_EPS, LN_EPS_DEFAULT
from . import _build

NEG = -1e30  # the kernels' key bias for a masked frame

# Leaf names and shapes, in the reference's kernel argument order. "m" leaves
# are matmul weights at the storage dtype (or int8 pairs), "v" leaves f32
# vectors the kernels read 16 bytes at a time, "s" leaves small f32 arrays
# read one value at a time.
SQUEEZE_LEAVES = (
    ("n1g", "v", "D"), ("n1b", "v", "D"),
    ("f1w1", "m", "D F"), ("f1b1", "v", "F"),
    ("f1w2", "m", "F D"), ("f1b2", "v", "D"),
    ("n2g", "v", "D"), ("n2b", "v", "D"),
    ("qkvw", "m", "D 3D"), ("projw", "m", "D D"),
    ("cng", "v", "D"), ("cnb", "v", "D"),
    ("pw1w", "m", "D E"), ("pw1b", "v", "E"),
    ("dww", "s", "K E"),
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
    ("dww", "s", "K D"), ("dwb", "v", "D"),
    ("bng", "v", "D"), ("bnb", "v", "D"), ("bnm", "v", "D"), ("bnv", "v", "D"),
    ("pw2w", "m", "D D"), ("pw2b", "v", "D"),
    ("clng", "v", "D"), ("clnb", "v", "D"),
    ("l2g", "v", "D"), ("l2b", "v", "D"),
    ("f2w1", "m", "D F"), ("f2b1", "v", "F"),
    ("f2w2", "m", "F D"), ("f2b2", "v", "D"),
)
TRANSFORMER_LEAVES = (
    ("l1g", "v", "D"), ("l1b", "v", "D"),
    ("qkvw", "m", "D 3D"), ("projw", "m", "D D"),
    ("l2g", "v", "D"), ("l2b", "v", "D"),
    ("f1w", "m", "D F"), ("f2w", "m", "F D"),
)
CONV1D_LEAVES = (
    ("ew", "m", "D C"), ("eb", "v", "C"),
    ("dww", "s", "Kc C"),
    ("bng", "v", "C"), ("bnb", "v", "C"), ("bnm", "v", "C"), ("bnv", "v", "C"),
    ("ecw", "s", "Ke"),
    ("pw", "m", "C D"), ("pb", "v", "D"),
)
# Inner block kinds: the kernels' code for each, its leaves, its bridge.
INNER = {
    "squeezeformer": (0, SQUEEZE_LEAVES, squeeze_block_args),
    "conformer": (1, CONFORMER_LEAVES, conformer_block_args),
    "transformer": (2, TRANSFORMER_LEAVES, transformer_block_args),
}
STORAGE_CODE = {torch.float32: 0, torch.bfloat16: 1, "int8": 2}


# ---------------------------------------------------------------------------
# int8 weights (the export scheme of ishara_tpu/serve/export.py)
# ---------------------------------------------------------------------------

def quantize_serving_weights(state_dict):
    """Symmetric per-output-channel int8 of every float entry with two or
    more dimensions (Linear and Conv1d weights; the output channel is dim 0
    in PyTorch's layouts): ``scale = max(|w|, 1e-8) / 127`` over all other
    dims, ``q = clip(round(w / scale), -127, 127)`` with round-half-to-even
    in f32. Such an entry becomes ``{"q": int8, "scale": f32 [out]}`` on
    the entry's device; biases, norm parameters and BN running statistics
    pass through. The arithmetic runs on the host, as the reference's does,
    and gives its ``quantize_serving_weights`` values bit for bit (a card
    may divide by a constant through its reciprocal, which moves a scale by
    an ulp)."""
    out = {}
    for key, v in state_dict.items():
        if not (torch.is_tensor(v) and v.is_floating_point() and v.dim() >= 2):
            out[key] = v
            continue
        w = v.detach().to("cpu", torch.float32)
        amax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.round(w / scale.reshape((-1,) + (1,) * (w.dim() - 1)))
        out[key] = {"q": torch.clamp(q, -127, 127).to(torch.int8).to(v.device),
                    "scale": scale.to(v.device)}
    return out


def dequantize_serving_weights(state_dict):
    """The f32 ``state_dict`` an int8 one stands for (``q * scale``)."""
    return {k: dequantize(v) if is_quantized(v) else v
            for k, v in state_dict.items()}


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
    widened from its storage dtype. An int8 pair (q, scale [O]) multiplies
    the product by the scale after the dot."""
    if isinstance(w, tuple):
        q, s = w
        return (a.to(torch.float32) @ q.to(torch.float32)) * s
    return a.to(torch.float32) @ w.to(torch.float32)


def _mhsa(x, mask, qkv_w, proj_w, num_heads, dim):
    """Fused-QKV attention with the full-dim scale; ``mask`` [T] of 1/0.
    At bf16 and int8 storage q, k, v and p are rounded to bf16 before their
    products (exact in f32), which accumulate in f32."""
    dh = dim // num_heads
    qkv = _mm(x, qkv_w)  # [T, 3*dim], per head [q|k|v] blocks of dh
    bias = (1.0 - mask) * NEG
    scale = dim ** -0.5

    adt = torch.bfloat16 if isinstance(qkv_w, tuple) else qkv_w.dtype

    def rnd(t):
        return t.to(adt).to(torch.float32)

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


def _eca_gate(h, mask, ecw):
    """Efficient-channel-attention gate: masked GAP -> ``ecw`` [k] slid over
    the CHANNEL axis (cross-correlation, zeros ((k-1)//2, k//2) at the
    ends) -> sigmoid. h [T, C] -> [C]."""
    g = _masked_gap(h, mask)
    k, C = ecw.shape[0], g.shape[0]
    gp = torch.nn.functional.pad(g, ((k - 1) // 2, k // 2))
    out = torch.zeros_like(g)
    for i in range(k):
        out = out + gp[i: i + C] * ecw[i]
    return torch.sigmoid(out)


def conv1d_block_body(x, mask, ew, eb, dww, bng, bnb, bnm, bnv, ecw, pw, pb):
    """One eval-mode Conv1DBlock on x [T, dim] (reference
    ``_conv1d_block_body``): expand (swish) -> causal depthwise conv ->
    BN with running stats -> ECA -> project -> + x."""
    h = _swish(_mm(x, ew) + eb)
    h = _dwconv(h, dww, causal=True)
    h = (h - bnm) * torch.rsqrt(bnv + BN_EPS) * bng + bnb
    h = h * _eca_gate(h, mask, ecw)
    return x + _mm(h, pw) + pb


def transformer_body(num_heads, dim, x, mask,
                     l1g, l1b, qkvw, projw, l2g, l2b, f1w, f2w):
    """One eval-mode TransformerBlock on x [T, dim] (reference
    ``_transformer_body``): pre-LN MHSA, then pre-LN swish FFN without
    biases."""
    x = x + _mhsa(_ln(x, l1g, l1b, LN_EPS), mask, qkvw, projw, num_heads, dim)
    h = _ln(x, l2g, l2b, LN_EPS)
    return x + _mm(_swish(_mm(h, f1w)), f2w)


BODIES = {"squeezeformer": squeeze_body, "conformer": conformer_body,
          "transformer": transformer_body}


def _leaf(w, b):
    """Block b's slice of a stacked leaf (a tensor or an int8 pair)."""
    return tuple(t[b] for t in w) if isinstance(w, tuple) else w[b]


def _nblocks(leaves) -> int:
    w = leaves[0]
    return (w[0] if isinstance(w, tuple) else w).shape[0]


def group_stack_plain(x, mask, groups, inner: str, num_heads):
    """Plain version of :func:`fused_conv_group_stack`: for each group its
    Conv1DBlocks in turn, then the ``inner`` block."""
    conv, leaves = groups
    x = x.to(torch.float32)
    mask = mask.to(torch.float32)
    for b in range(_nblocks(leaves)):
        for cl in conv:
            x = conv1d_block_body(x, mask, *(_leaf(w, b) for w in cl))
        x = BODIES[inner](num_heads, x.shape[1], x, mask,
                          *(_leaf(w, b) for w in leaves))
    return x


def squeeze_stack_plain(x, mask, leaves, num_heads):
    """Plain version of :func:`fused_squeezeformer_stack`."""
    return group_stack_plain(x, mask, ((), leaves), "squeezeformer",
                             num_heads)


def conformer_stack_plain(x, mask, leaves, num_heads):
    """Plain version of :func:`fused_conformer_stack`."""
    return group_stack_plain(x, mask, ((), leaves), "conformer", num_heads)


# ---------------------------------------------------------------------------
# Wrappers of the CUDA kernels
# ---------------------------------------------------------------------------

def _stack(ws):
    if isinstance(ws[0], tuple):
        return tuple(torch.stack(p).contiguous() for p in zip(*ws))
    return torch.stack(ws).contiguous()


def stack_block_args(per_block):
    """Per-block leaf tuples -> one tuple of leaves stacked on a leading
    block axis (what the stack wrappers take); an int8 pair stacks into a
    pair."""
    return tuple(_stack(ws) for ws in zip(*per_block))


def stack_group_args(per_group):
    """[(conv_args_tuple, inner_args), ...] as the reference builds them,
    one entry a group -> ``(conv, inner)`` for
    :func:`fused_conv_group_stack`: ``conv[j]`` holds the j-th
    Conv1DBlock's leaves stacked over the groups (the blocks of one group
    differ in kernel size, so they do not stack with each other), ``inner``
    the attention block's."""
    conv = tuple(stack_block_args(list(position))
                 for position in zip(*(g[0] for g in per_group)))
    return conv, stack_block_args([g[1] for g in per_group])


def _storage(w):
    """The storage that matmul leaf ``w`` (the block's QKV weight) sets for
    all: torch.float32, torch.bfloat16 or "int8"."""
    if isinstance(w, tuple):
        return "int8"
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matmul weights must be bf16, f32 or int8 pairs, "
                         f"got {w.dtype}")
    return w.dtype


def _check_leaves(spec, leaves, dims, nb, storage, device):
    """Every leaf against its spec entry: shape, dtype, device, layout."""
    if len(leaves) != len(spec):
        raise ValueError(f"expected {len(spec)} leaves, got {len(leaves)}")
    for (name, kind, shape), w in zip(spec, leaves):
        want = (nb,) + tuple(dims[s] for s in shape.split())
        parts = [(w, want, storage if kind == "m" else torch.float32)]
        if kind == "m" and storage == "int8":
            if not (isinstance(w, tuple) and len(w) == 2):
                raise ValueError(
                    f"leaf {name}: int8 storage takes (q, scale) pairs from "
                    f"quantize_serving_weights")
            parts = [(w[0], want, torch.int8),
                     (w[1], (nb, want[-1]), torch.float32)]
        for t, shp, dt in parts:
            if not torch.is_tensor(t) or tuple(t.shape) != shp \
                    or t.dtype != dt:
                got = (tuple(t.shape), t.dtype) if torch.is_tensor(t) \
                    else type(t).__name__
                raise ValueError(f"leaf {name}: want {shp} {dt}, got {got}")
            if t.device != device or not t.is_contiguous():
                raise ValueError(f"leaf {name} must be contiguous on {device}")


def _check(kind, x, mask, conv, leaves, num_heads):
    """Validate a stack wrapper's inputs; return (dims, storage, the
    Conv1DBlocks' (depthwise, ECA) kernel sizes)."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous f32 [T, dim], got "
                         f"{tuple(x.shape)} {x.dtype}")
    T, D = x.shape
    if mask.shape != (T,):
        raise ValueError(f"mask must be [T]={T}, got {tuple(mask.shape)}")
    if D % num_heads:
        raise ValueError(f"dim {D} is not a multiple of num_heads {num_heads}")
    spec = INNER[kind][1]
    if len(leaves) != len(spec):
        raise ValueError(f"expected {len(spec)} leaves, got {len(leaves)}")
    by_name = dict(zip((n for n, _, _ in spec), leaves))
    storage = _storage(by_name["qkvw"])

    def width(w, axis=-1):
        return (w[0] if isinstance(w, tuple) else w).shape[axis]

    nb = _nblocks(leaves)
    dims = {"D": D, "2D": 2 * D, "3D": 3 * D, "H": num_heads,
            "F": width(by_name.get("f1w1", by_name.get("f1w")))}
    if "dww" in by_name:
        dims["K"] = by_name["dww"].shape[1]
    if "se1w" in by_name:
        dims["E"] = width(by_name["pw1w"])
        dims["R"] = width(by_name["se1w"])
    _check_leaves(spec, leaves, dims, nb, storage, x.device)
    conv_k = []
    for cl in conv:
        if len(cl) != len(CONV1D_LEAVES):
            raise ValueError(f"expected {len(CONV1D_LEAVES)} Conv1DBlock "
                             f"leaves, got {len(cl)}")
        cd = dict(dims, C=width(cl[0]), Kc=cl[2].shape[1], Ke=cl[7].shape[1])
        if dims.setdefault("C", cd["C"]) != cd["C"]:
            raise ValueError("the Conv1DBlocks of a group must expand to "
                             "one width")
        _check_leaves(CONV1D_LEAVES, cl, cd, nb, storage, x.device)
        conv_k.append((cd["Kc"], cd["Ke"]))
    return dims, storage, conv_k


def _lib():
    lib = _build.load("fused_block")
    if not getattr(lib, "_ishara_declared", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        IP = ctypes.POINTER(ctypes.c_int)
        LL = ctypes.POINTER(ctypes.c_longlong)
        lib.ishara_block_stack.argtypes = (
            [I, I, I, IP, IP, P, P, P, P, LL, P, LL, I, I]
            + [I] * 8 + [F, I, I] + [P] * 6 + [P, IP])
        lib.ishara_block_stack.restype = I
        lib.ishara_error_string.argtypes = [I]
        lib.ishara_error_string.restype = ctypes.c_char_p
        lib._ishara_declared = True
    return lib


def _raise_on(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.ishara_error_string(rc).decode()})")


def _device_of(x, dims, tensors):
    """The CUDA device index, after the checks that only the kernels need:
    widths in whole GEMM tiles and 16-byte aligned rows and blocks."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels run on CUDA or CPU tensors, "
                         f"not {x.device}")
    for s in ("D", "F", "E", "C"):
        if dims.get(s, 32) % 32:
            raise ValueError(f"the CUDA kernels need {s} = {dims[s]} to be a "
                             f"multiple of 32")
    if (dims["D"] // dims["H"]) % 4:
        raise ValueError(f"the CUDA kernels need dim / num_heads = "
                         f"{dims['D'] // dims['H']} to be a multiple of 4")
    for w in tensors:
        if w.data_ptr() % 16 or (w.stride(0) * w.element_size()) % 16:
            raise ValueError("the CUDA kernels need 16-byte aligned inputs")
    return x.device.index if x.device.index is not None else \
        torch.cuda.current_device()


# What the last persistent (dma=True) launch used: (grid blocks, blocks an
# SM holds, dynamic shared memory bytes), for reports.
last_persistent_launch = None


def _run_stack(what, kind, x, mask, conv, leaves, num_heads, dma):
    """Launch the kernels for N groups of (len(conv) Conv1DBlocks, one
    ``kind`` block); ``conv`` is () for a plain block stack."""
    global last_persistent_launch
    dims, storage, conv_k = _check(kind, x, mask, conv, leaves, num_heads)
    code, spec, _ = INNER[kind]
    flat, aligned = [], [x]
    for sp, lv in [(CONV1D_LEAVES, cl) for cl in conv] + [(spec, leaves)]:
        for (_, lkind, _), w in zip(sp, lv):
            q, sc = w if isinstance(w, tuple) else (w, None)
            flat.append((q, sc))
            if lkind != "s":
                aligned += [q] if sc is None else [q, sc]
    dev = _device_of(x, dims, aligned)
    T, D = x.shape
    F, E, C = dims["F"], dims.get("E", 0), dims.get("C", 0)
    wide = max(F, E, 2 * D, C)
    out = torch.empty_like(x)
    qkv = x.new_empty((T, 3 * D))
    hid = x.new_empty((T, wide))
    hid2 = x.new_empty((T, wide))
    att = x.new_empty((T, D))
    hb = x.new_empty((T, D))
    gate = x.new_empty((max(D, C),))
    n = len(flat)
    VP, LL = ctypes.c_void_p * n, ctypes.c_longlong * n
    ptrs = VP(*(q.data_ptr() for q, _ in flat))
    strides = LL(*(q.stride(0) * q.element_size() for q, _ in flat))
    sptrs = VP(*(sc.data_ptr() if sc is not None else None
                 for _, sc in flat))
    sstrides = LL(*(sc.stride(0) * 4 if sc is not None else 0
                    for _, sc in flat))
    IC = ctypes.c_int * max(len(conv_k), 1)
    ck = IC(*(k for k, _ in conv_k))
    cke = IC(*(k for _, k in conv_k))
    info = (ctypes.c_int * 3)()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    lib = _lib()
    rc = lib.ishara_block_stack(
        dev, code, len(conv), ck, cke, x.data_ptr(), mask.data_ptr(),
        out.data_ptr(), ptrs, strides, sptrs, sstrides, n, _nblocks(leaves),
        T, D, num_heads, F, E, dims.get("K", 0), dims.get("R", 0), C,
        float(D) ** -0.5, STORAGE_CODE[storage], int(bool(dma)),
        qkv.data_ptr(), hid.data_ptr(), hid2.data_ptr(), att.data_ptr(),
        hb.data_ptr(), gate.data_ptr(), stream, info)
    _raise_on(lib, rc, what)
    if dma:
        last_persistent_launch = tuple(info)
    return out


def fused_squeezeformer_stack(x, mask, leaves, *, num_heads: int,
                              dma: bool = False):
    """N eval-mode Squeezeformer blocks on x [T, dim] f32 with mask [T]
    (bool or 1/0); ``leaves`` from :func:`stack_block_args` over
    :func:`ishara_tpu_torch.bridge.squeeze_block_args`. ``dma=True`` runs
    the stack as one persistent kernel that prefetches the next block's
    weights (same numerics). Replaces
    ``ishara_tpu.ops.fused_block.fused_squeezeformer_stack``."""
    mask = mask.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        _check("squeezeformer", x, mask, (), leaves, num_heads)
        return squeeze_stack_plain(x, mask, leaves, num_heads)
    out = _run_stack("fused_squeezeformer_stack", "squeezeformer", x, mask,
                     (), leaves, num_heads, dma)
    fused_squeezeformer_stack.launches += 1
    return out


def fused_conformer_stack(x, mask, leaves, *, num_heads: int,
                          dma: bool = False):
    """N eval-mode Conformer blocks (BN running stats) on x [T, dim] f32;
    ``leaves`` from :func:`stack_block_args` over
    :func:`ishara_tpu_torch.bridge.conformer_block_args`. Replaces
    ``ishara_tpu.ops.fused_block.fused_conformer_stack``."""
    mask = mask.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        _check("conformer", x, mask, (), leaves, num_heads)
        return conformer_stack_plain(x, mask, leaves, num_heads)
    out = _run_stack("fused_conformer_stack", "conformer", x, mask, (),
                     leaves, num_heads, dma)
    fused_conformer_stack.launches += 1
    return out


def fused_conv_group_stack(x, mask, groups, inner: str, *, num_heads: int,
                           dma: bool = False):
    """N groups of (k Conv1DBlocks -> one ``inner`` block), ``inner`` being
    "squeezeformer", "conformer" or "transformer", on x [T, dim] f32;
    ``groups`` from :func:`stack_group_args`. How the ``conv_hybrid`` and
    ``conv_transformer`` families are served. Replaces
    ``ishara_tpu.ops.fused_block.fused_conv_group_stack``."""
    if inner not in INNER:
        raise ValueError(f"inner must be one of {sorted(INNER)}, "
                         f"got {inner!r}")
    mask = mask.to(torch.float32).contiguous()
    conv, leaves = groups
    if x.device.type == "cpu":
        _check(inner, x, mask, conv, leaves, num_heads)
        return group_stack_plain(x, mask, groups, inner, num_heads)
    out = _run_stack(f"fused_conv_group_stack[{inner}]", inner, x, mask,
                     conv, leaves, num_heads, dma)
    fused_conv_group_stack.launches += 1
    by_inner = fused_conv_group_stack.launches_by_inner
    by_inner[inner] = by_inner.get(inner, 0) + 1
    return out


fused_squeezeformer_stack.launches = 0
fused_conformer_stack.launches = 0
fused_conv_group_stack.launches = 0
fused_conv_group_stack.launches_by_inner = {}  # the same count, by ``inner``

# Each wrapper's plain version (the int8 and dma forms share it: int8 pairs
# are leaves like any other, and dma changes no arithmetic).
PLAIN = {fused_squeezeformer_stack: squeeze_stack_plain,
         fused_conformer_stack: conformer_stack_plain,
         fused_conv_group_stack: group_stack_plain}


def fused_squeezeformer_block(x, mask, leaves, *, num_heads: int):
    """One block (K5c): the stack kernel with N=1; ``leaves`` is one
    block's tuple from :func:`ishara_tpu_torch.bridge.squeeze_block_args`."""
    return fused_squeezeformer_stack(x, mask, stack_block_args([leaves]),
                                     num_heads=num_heads)


def fused_conformer_block(x, mask, leaves, *, num_heads: int):
    """One Conformer block (K5c), the stack kernel with N=1."""
    return fused_conformer_stack(x, mask, stack_block_args([leaves]),
                                 num_heads=num_heads)
