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
step. Each wrapper counts its kernel calls in ``.launches``. The three call
registered operators (``torch.ops.ishara_tpu_torch.fused_*_stack``), which
hold that device dispatch, so a serving program traced by ``torch.export``
keeps them as calls that launch the same kernels.

The kernel runs a stack as stages -- 12 a Squeezeformer block, 11 a
Conformer, 5 a Transformer, 4 a Conv1DBlock -- each a grid of small
independent tiles (16 x 32 GEMM tiles, their products on the tensor cores
at the presets' widths; 8-query attention tiles). It takes
any widths D, F, E and C2 and any head width D / H, as the reference does:
the ragged edges of the last row and column tiles are masked. It refuses
only a geometry whose stage needs more shared memory than a block has
(:func:`stack_plan`, which mirrors the kernel's plan); :func:`stack_report`
reads back what the last launch ran, its stages as the device counted them.

Kernel arguments are the reference's per-block leaf tuples
(:mod:`ishara_tpu_torch.bridge`), each leaf stacked on a leading block axis
(:func:`stack_block_args`, :func:`stack_group_args`): matrices ``[in, out]``
at the storage dtype (bf16 by default, or f32), vectors ``[n]`` and
depthwise kernels ``[K, C]`` in f32. At int8 storage a matrix is the pair
(q int8 ``[in, out]``, scale f32 ``[out]``) of
:func:`quantize_serving_weights`, and the scale multiplies the product
after the dot.

``dma=True`` is the port of the reference's manually double-buffered weight
DMA: the whole stack runs as one persistent launch that prefetches the next
block's weights into L2 while the current block computes. Its numerics are
those of ``dma=False``, bit for bit.

The whole fused forward of an encoder -- stem, the stacks, top and
classifier (the reference's ``fused_encoder_forward``) -- builds on the model
package and lives there: :mod:`ishara_tpu_torch.models.fused`.
"""

from __future__ import annotations

import ctypes
import functools

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
    """Validate a stack wrapper's inputs (ranks, shapes, dtypes, devices;
    any widths); return (dims, storage, the Conv1DBlocks' (depthwise, ECA)
    kernel sizes)."""
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
            + [I] * 8 + [F, I, I] + [P] * 7 + [P, IP])
        lib.ishara_block_stack.restype = I
        lib.ishara_error_string.argtypes = [I]
        lib.ishara_error_string.restype = ctypes.c_char_p
        lib._ishara_declared = True
    return lib


def _raise_on(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.ishara_error_string(rc).decode()})")


# ---------------------------------------------------------------------------
# The kernel's plan, mirrored from csrc/fused_block.cu: the stages a block
# (group_stages), the tiles of each stage (gemm_tiles, attention_tiles) and
# the dynamic shared memory of each (stage_smem_bytes).
# ---------------------------------------------------------------------------
STAGES_PER_BLOCK = {"squeezeformer": 12, "conformer": 11, "transformer": 5,
                    "conv1d": 4}
GEMM_ROWS, GEMM_COLS, QUERY_ROWS = 16, 32, 8  # a GEMM tile, a query tile
GEMM_DEPTH = 1024  # a GEMM tile's panels hold K in chunks of this depth
GATE_THREADS = 1024
SMEM_LIMIT = 232448  # bytes of shared memory a block may take (H100)
_W_BYTES = {0: 4, 1: 2, 2: 1}


def _cdiv(a, b):
    return -(-a // b)


def _r4(n):
    return _cdiv(n, 4) * 4


def _gemm_smem(K, code):
    kc = min(K, GEMM_DEPTH)
    ldb = GEMM_COLS + 8 if code == 1 else GEMM_COLS  # bf16 rows padded
    return ((GEMM_ROWS * (_r4(kc) + 4) + 2 * _r4(kc)
             + 3 * GEMM_ROWS * GEMM_COLS + 2 * GEMM_ROWS) * 4
            + kc * ldb * _W_BYTES[code])


def _gate_smem(C, extra):
    items = C // 4 if C % 4 == 0 else C
    parts = GATE_THREADS // items if items < GATE_THREADS else 1
    return (parts * C + C + extra + 4) * 4


def _attention_smem(T, dh):
    dp = _r4(dh)
    return (T * (dp + 4) + T * dp + _r4(T) + 8 * _r4(T) + 8 * dp) * 4


def _tiles(n, size):
    return [(a, min(n, a + size)) for a in range(0, n, size)]


@functools.lru_cache(maxsize=64)
def _plan(kind, T, dim, heads, ffn, expand, se, conv_width, nconv, nblocks,
          code):
    if kind not in INNER:
        raise ValueError(f"kind must be one of {sorted(INNER)}, got {kind!r}")
    if dim % heads:
        raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
    C = conv_width if nconv else 0
    expand = expand if kind == "squeezeformer" else 0
    smem = max(_gemm_smem(max(dim, ffn, expand, C), code),
               _attention_smem(T, dim // heads),
               _gate_smem(dim, se) if kind == "squeezeformer" else 0,
               _gate_smem(C, 0) if C else 0)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the stack kernel cannot take T={T}, dim={dim}, heads={heads}, "
            f"ffn={ffn}, expand={expand}, conv_width={C}: a stage needs "
            f"{smem} bytes of shared memory a block, an H100 block has "
            f"{SMEM_LIMIT}")
    per = STAGES_PER_BLOCK[kind] + nconv * STAGES_PER_BLOCK["conv1d"]
    widths = {"ffn": ffn, "qkv": 3 * dim, "channels": dim,
              "expand": expand, "glu": 2 * dim if kind == "conformer" else 0,
              "conv": C}
    return {
        "stages": nblocks * per,
        "stages_per_block": STAGES_PER_BLOCK[kind],
        "stages_per_conv_block": STAGES_PER_BLOCK["conv1d"],
        "launches": nblocks * per,
        "launches_dma": 1,
        "cluster": 1,
        "smem_bytes": smem,
        "rows_per_tile": GEMM_ROWS,
        "row_tiles": _cdiv(T, GEMM_ROWS),
        "rows": _tiles(T, GEMM_ROWS),
        "columns": {k: _tiles(n, GEMM_COLS) for k, n in widths.items() if n},
        "query_tiles": _tiles(T, QUERY_ROWS),
    }


def stack_plan(kind: str, *, T: int, dim: int, heads: int, ffn: int,
               expand: int = 0, se: int = 0, conv_width: int = 0,
               nconv: int = 0, nblocks: int = 1, storage=torch.bfloat16):
    """The plan of a stack on ``csrc/fused_block.cu``, as its C side makes
    it: the stages (one launch each at ``dma=False``, one launch in all at
    ``dma=True``) a stack, a block and a Conv1DBlock; the cluster (1: every
    tile is one thread block); the GEMM tiles' rows and each product's
    columns (``"columns"``: the FFN, QKV, D-wide, Squeezeformer expand,
    Conformer GLU and Conv1DBlock products), the attention's query tiles;
    the largest dynamic shared memory of a stage. ``expand`` is the
    Squeezeformer conv module's width E, ``se`` its SE width R,
    ``conv_width`` the Conv1DBlocks' C. Raises ValueError for a geometry
    the kernel cannot take: a stage that needs more shared memory than a
    block has."""
    code = STORAGE_CODE[{"f32": torch.float32, "bf16": torch.bfloat16}.get(
        storage, storage)]
    return dict(_plan(kind, T, dim, heads, ffn, expand, se, conv_width, nconv,
                      nblocks, code))


# The last stack launch, for stack_report; the device's stage counters.
last_stack_run = None
_COUNTERS = {}


def stack_report():
    """What the last stack launch ran (synchronises with the device): the
    stages as the kernel counted them on the device, the launches and the
    largest dynamic shared memory of a stage as its C side issued them, the
    cluster (1), at ``dma=True`` the grid of the persistent launch (blocks,
    blocks an SM), and under ``"plan"`` the :func:`stack_plan` of the
    launch's geometry."""
    if last_stack_run is None:
        raise RuntimeError("no stack kernel has been launched")
    run = last_stack_run
    issued, launches, smem, blocks, per_sm = run["info"]
    return {"stages": int(run["count"].item()), "stages_issued": issued,
            "launches": launches, "smem_bytes": smem, "cluster": 1,
            "dma": run["dma"], "grid": (blocks, per_sm) if run["dma"]
            else None, "plan": dict(run["plan"])}


def _flat_leaves(kind, conv, leaves):
    spec = INNER[kind][1]
    flat, aligned = [], []
    for sp, lv in [(CONV1D_LEAVES, cl) for cl in conv] + [(spec, leaves)]:
        for (_, lkind, _), w in zip(sp, lv):
            q, sc = w if isinstance(w, tuple) else (w, None)
            flat.append((q, sc))
            if lkind != "s":
                aligned += [q] if sc is None else [q, sc]
    return flat, aligned


def _leaf_arrays(flat):
    n = len(flat)
    VP, LL = ctypes.c_void_p * n, ctypes.c_longlong * n
    return (VP(*(q.data_ptr() for q, _ in flat)),
            LL(*(q.stride(0) * q.element_size() for q, _ in flat)),
            VP(*(sc.data_ptr() if sc is not None else None
                 for _, sc in flat)),
            LL(*(sc.stride(0) * 4 if sc is not None else 0
                 for _, sc in flat)))


def _run_stack(what, kind, x, mask, conv, leaves, num_heads, dma):
    """Launch the kernel for N groups of (len(conv) Conv1DBlocks, one
    ``kind`` block); ``conv`` is () for a plain block stack."""
    global last_stack_run
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels run on CUDA or CPU tensors, "
                         f"not {x.device}")
    dims, storage, conv_k = _check(kind, x, mask, conv, leaves, num_heads)
    nb = _nblocks(leaves)
    T, D = x.shape
    F, E, C = dims["F"], dims.get("E", 0), dims.get("C", 0)
    plan = _plan(kind, T, D, num_heads, F, E, dims.get("R", 0), C,
                 len(conv), nb, STORAGE_CODE[storage])
    flat, aligned = _flat_leaves(kind, conv, leaves)
    if any(w.data_ptr() % 16 for w in [x] + aligned):
        raise ValueError("the stack kernel needs 16-byte aligned inputs")
    ptrs, strides, sptrs, sstrides = _leaf_arrays(flat)
    IC = ctypes.c_int * max(len(conv_k), 1)
    dev = _build.device_index(x)
    count = _COUNTERS.get(dev)
    if count is None:
        count = _COUNTERS[dev] = torch.zeros(1, dtype=torch.int32,
                                             device=x.device)
    lib = _lib()
    wide = max(F, E, 2 * D, C)
    scratch = [x.new_empty(s) for s in ((T, 3 * D), (T, wide), (T, wide),
                                        (T, D), (T, D), (max(D, C),))]
    out = torch.empty_like(x)
    info = (ctypes.c_int * 5)()
    rc = lib.ishara_block_stack(
        dev, INNER[kind][0], len(conv), IC(*(k for k, _ in conv_k)),
        IC(*(k for _, k in conv_k)), x.data_ptr(), mask.data_ptr(),
        out.data_ptr(), ptrs, strides, sptrs, sstrides, len(flat), nb,
        T, D, num_heads, F, E, dims.get("K", 0), dims.get("R", 0), C,
        float(D) ** -0.5, STORAGE_CODE[storage], int(bool(dma)),
        *(t.data_ptr() for t in scratch), count.data_ptr(),
        _build.stream_of(x), info)
    _raise_on(lib, rc, what)
    last_stack_run = {"count": count, "info": tuple(info), "dma": bool(dma),
                      "plan": plan}
    return out


def _flatten(leaves) -> tuple[list[torch.Tensor], list[int]]:
    """A tuple of leaves (tensors or int8 (q, scale) pairs) -> the flat
    tensor list a registered op takes and each leaf's count of tensors."""
    flat, counts = [], []
    for w in leaves:
        parts = list(w) if isinstance(w, tuple) else [w]
        flat += parts
        counts.append(len(parts))
    return flat, counts


def _unflatten(flat, counts) -> tuple:
    out, i = [], 0
    for n in counts:
        out.append(tuple(flat[i:i + n]) if n > 1 else flat[i])
        i += n
    return tuple(out)


def _groups(flat, counts, nconv: int):
    """The registered op's flat arguments -> ``(conv, leaves)``: ``nconv``
    Conv1DBlock positions of ``len(CONV1D_LEAVES)`` leaves, then the inner
    block's."""
    n = len(CONV1D_LEAVES)
    per = [sum(counts[j * n:(j + 1) * n]) for j in range(nconv)]
    conv, i = [], 0
    for j in range(nconv):
        conv.append(_unflatten(flat[i:i + per[j]],
                               counts[j * n:(j + 1) * n]))
        i += per[j]
    return tuple(conv), _unflatten(flat[i:], counts[nconv * n:])


# The three serving entry points are registered operators
# (``torch.ops.ishara_tpu_torch.*``), so that ``torch.export`` can trace a
# serving program through them: on a CUDA tensor the operator launches the
# kernel and counts the launch, on a CPU tensor it runs the plain version.
# Weights arrive as a flat tensor list with each leaf's count of tensors (2
# for an int8 pair), ``dma`` as a flag.

@torch.library.custom_op("ishara_tpu_torch::fused_squeezeformer_stack",
                         mutates_args=(), device_types="cpu")
def _squeeze_op(x: torch.Tensor, mask: torch.Tensor,
                flat: list[torch.Tensor], counts: list[int], num_heads: int,
                dma: bool) -> torch.Tensor:
    leaves = _unflatten(flat, counts)
    _check("squeezeformer", x, mask, (), leaves, num_heads)
    return squeeze_stack_plain(x, mask, leaves, num_heads)


@_squeeze_op.register_kernel("cuda")
def _(x, mask, flat, counts, num_heads, dma):
    out = _run_stack("fused_squeezeformer_stack", "squeezeformer", x, mask,
                     (), _unflatten(flat, counts), num_heads, dma)
    fused_squeezeformer_stack.launches += 1
    return out


@torch.library.custom_op("ishara_tpu_torch::fused_conformer_stack",
                         mutates_args=(), device_types="cpu")
def _conformer_op(x: torch.Tensor, mask: torch.Tensor,
                  flat: list[torch.Tensor], counts: list[int],
                  num_heads: int, dma: bool) -> torch.Tensor:
    leaves = _unflatten(flat, counts)
    _check("conformer", x, mask, (), leaves, num_heads)
    return conformer_stack_plain(x, mask, leaves, num_heads)


@_conformer_op.register_kernel("cuda")
def _(x, mask, flat, counts, num_heads, dma):
    out = _run_stack("fused_conformer_stack", "conformer", x, mask, (),
                     _unflatten(flat, counts), num_heads, dma)
    fused_conformer_stack.launches += 1
    return out


@torch.library.custom_op("ishara_tpu_torch::fused_conv_group_stack",
                         mutates_args=(), device_types="cpu")
def _group_op(x: torch.Tensor, mask: torch.Tensor, flat: list[torch.Tensor],
              counts: list[int], nconv: int, inner: str, num_heads: int,
              dma: bool) -> torch.Tensor:
    conv, leaves = groups = _groups(flat, counts, nconv)
    _check(inner, x, mask, conv, leaves, num_heads)
    return group_stack_plain(x, mask, groups, inner, num_heads)


@_group_op.register_kernel("cuda")
def _(x, mask, flat, counts, nconv, inner, num_heads, dma):
    conv, leaves = _groups(flat, counts, nconv)
    out = _run_stack(f"fused_conv_group_stack[{inner}]", inner, x, mask,
                     conv, leaves, num_heads, dma)
    fused_conv_group_stack.launches += 1
    by_inner = fused_conv_group_stack.launches_by_inner
    by_inner[inner] = by_inner.get(inner, 0) + 1
    return out


for _op in (_squeeze_op, _conformer_op, _group_op):
    _op.register_fake(lambda x, *args: torch.empty_like(x))


def fused_squeezeformer_stack(x, mask, leaves, *, num_heads: int,
                              dma: bool = False):
    """N eval-mode Squeezeformer blocks on x [T, dim] f32 with mask [T]
    (bool or 1/0); ``leaves`` from :func:`stack_block_args` over
    :func:`ishara_tpu_torch.bridge.squeeze_block_args`. ``dma=True`` runs
    the stack as one persistent kernel that prefetches the next block's
    weights (same numerics). Replaces
    ``ishara_tpu.ops.fused_block.fused_squeezeformer_stack``."""
    flat, counts = _flatten(leaves)
    return _squeeze_op(x, mask.to(torch.float32).contiguous(), flat, counts,
                       num_heads, bool(dma))


def fused_conformer_stack(x, mask, leaves, *, num_heads: int,
                          dma: bool = False):
    """N eval-mode Conformer blocks (BN running stats) on x [T, dim] f32;
    ``leaves`` from :func:`stack_block_args` over
    :func:`ishara_tpu_torch.bridge.conformer_block_args`. Replaces
    ``ishara_tpu.ops.fused_block.fused_conformer_stack``."""
    flat, counts = _flatten(leaves)
    return _conformer_op(x, mask.to(torch.float32).contiguous(), flat,
                         counts, num_heads, bool(dma))


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
    conv, leaves = groups
    flat, counts = [], []
    for part in (*conv, leaves):
        f, c = _flatten(part)
        flat += f
        counts += c
    return _group_op(x, mask.to(torch.float32).contiguous(), flat, counts,
                     len(conv), inner, num_heads, bool(dma))


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
