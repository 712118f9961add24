"""Whole-loop decode of the translation model in one kernel launch (port of
``ishara_tpu/ops/decoder_kernel.py``, K9).

:func:`fused_greedy_decode` and :func:`fused_beam_decode` replace the
Pallas ``fused_greedy_decode`` / ``fused_beam_decode``: the whole
autoregressive loop over a precomputed memory -- every decoder layer's
KV-cached step, the classifier, the next token, the early exit -- is one
launch of ``csrc/decoder.cu`` (one thread-block cluster; its source says
why). On a CUDA tensor they launch it or raise; on a CPU tensor they run
the plain version beside it, :func:`decode_plain`, which repeats the
kernel's arithmetic step by step: the additive ``NEG`` masks, head-major
``[S, d]`` rows, two-pass LayerNorm, ``exp(s - max) / sum``, the first
maximum, the stable top-W.

The limit of the design is shared memory: every block of the cluster holds
the activations, the attention scratch and the token state of all W beams
(:func:`fused_decode_smem_bytes`), and that must fit one block's 227 KB;
the weights adapt (each block keeps in shared memory what still fits and
reads the rest from L2). :func:`fused_decode_fits` answers from that
formula and the kernel's limits on W (at most 8, and at most C: -1e30
stands for the dead beams' -inf) and on the head width (at most 128). The
wrappers raise :class:`DecoderFitError` beyond them -- they never fall back
to the unfused loop, as the reference's wrappers do; only an engine built
with ``fused="auto"`` chooses, openly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..decode.autoregressive import length_normalised, top_w

NEG = -1e30
THREADS = 512            # threads a block of the kernel
SMEM_PER_BLOCK = 232448   # bytes of shared memory a block may use (H100)
MAX_BEAM = 8
MAX_HEAD_DIM = 128


class DecoderFitError(ValueError):
    """The geometry is beyond what the decode kernel takes."""


def _align4(w: int) -> int:
    return (w + 3) // 4 * 4


def fused_decode_smem_bytes(d: int, H: int, L: int, C: int, T: int, S: int,
                            W: int = 1) -> int:
    """Bytes of shared memory a block of the kernel needs besides its weight
    cache (``csrc/decoder.cu`` ``vector_words``): the weight pointer table;
    x, the LayerNorm output, q and the context [W, d] each; the FFN hidden
    [W, 4d]; the logits [W, C]; the scores of max(T, S) keys for each of
    the block's at most ceil(W H / 8) attention pairs; the context partials,
    one a thread; the beam scores; the tokens, the cache
    history and a copy [W, S] each; parents, tokens, flags; the norms'
    scales and every bias (17 d a layer, decoder_norm, the classifier's)."""
    ptrs = _align4(2 * (8 * L + 1))
    floats = (8 * W * d + W * C + -(-W * H // 8) * max(T, S) + THREADS
              + 2 * W)
    ints = 3 * W * S + 2 * W + 4
    vecs = 17 * d * L + 2 * d + C
    return 4 * _align4(ptrs + floats + ints + vecs)


def _limits(d, H, L, C, T, S, W) -> str | None:
    """Why the kernel cannot take this geometry, or None."""
    if not 1 <= W <= min(MAX_BEAM, C):
        return f"beam width {W} outside 1..min({MAX_BEAM}, num_classes={C})"
    if d % H or d // H > MAX_HEAD_DIM:
        return f"head dim {d}/{H} is not a whole number <= {MAX_HEAD_DIM}"
    pairs = -(-W * H // 8)   # attention pairs a block of the cluster, at most
    if pairs > THREADS // 32 or 32 * (THREADS // 32 // pairs) < d // H:
        return (f"{W} beams x {H} heads: too many attention pairs a block "
                f"for heads of {d // H}")
    if S < 2:
        return f"max_len {S} < 2"
    need = fused_decode_smem_bytes(d, H, L, C, T, S, W)
    if need > SMEM_PER_BLOCK:
        return (f"{need} bytes of shared memory a block, over "
                f"{SMEM_PER_BLOCK}")
    return None


def fused_decode_fits(model, T: int, max_len: int = 64,
                      beam_width: int = 1) -> bool:
    """Whether the decode kernel takes this model at memory length ``T``,
    ``max_len`` and ``beam_width``."""
    return _limits(model.feature_dim, model.num_heads,
                   model.num_decoder_layers, model.num_classes, T, max_len,
                   beam_width) is None


def check_decode_fits(model, T: int, max_len: int = 64,
                      beam_width: int = 1) -> None:
    """Raise :class:`DecoderFitError` unless :func:`fused_decode_fits`."""
    why = _limits(model.feature_dim, model.num_heads,
                  model.num_decoder_layers, model.num_classes, T, max_len,
                  beam_width)
    if why is not None:
        raise DecoderFitError(
            f"the fused decode kernel cannot take dim={model.feature_dim} "
            f"heads={model.num_heads} L={model.num_decoder_layers} T={T} "
            f"S={max_len} W={beam_width}: {why}; use the unfused decode")


def pack_floats(d: int, L: int, C: int) -> int:
    """Length of :func:`pack_decoder`'s tensor."""
    return L * (14 * d * d + 17 * d) + 2 * d + 2 * C * d + C


def pack_decoder(model) -> torch.Tensor:
    """The decoder's f32 weights in one flat tensor, in the kernel's order:
    per layer norm1 (scale, bias), sa_q, sa_k, sa_v, sa_out (weight
    ``[out, in]``, bias), norm2, ca_q, ca_out, norm3, fc1, fc2; then
    decoder_norm, the classifier and the embedding ``[C, d]``. Pack once a
    model and pass it to the decode functions."""
    leaves = []
    for layer in model.decoder_layers:
        for name in ("norm1", "sa_q", "sa_k", "sa_v", "sa_out", "norm2",
                     "ca_q", "ca_out", "norm3", "fc1", "fc2"):
            mod = getattr(layer, name)
            leaves += [mod.weight, mod.bias]
    leaves += [model.decoder_norm.weight, model.decoder_norm.bias,
               model.classifier.weight, model.classifier.bias,
               model.target_embedding.embedding]
    with torch.no_grad():
        return torch.cat([t.detach().to(torch.float32).reshape(-1)
                          for t in leaves])


def _views(pack, d, L, C):
    """Named views of the packed weights (the plain version's reading)."""
    off = 0

    def take(*shape):
        nonlocal off
        n = 1
        for s in shape:
            n *= s
        v = pack[off:off + n].view(*shape)
        off += n
        return v

    layers = []
    for _ in range(L):
        p = {}
        p["n1g"], p["n1b"] = take(d), take(d)
        for k in ("q", "k", "v", "o"):
            p["w" + k], p["b" + k] = take(d, d), take(d)
        p["n2g"], p["n2b"] = take(d), take(d)
        for k in ("cq", "co"):
            p["w" + k], p["b" + k] = take(d, d), take(d)
        p["n3g"], p["n3b"] = take(d), take(d)
        p["w1"], p["b1"] = take(4 * d, d), take(4 * d)
        p["w2"], p["b2"] = take(d, 4 * d), take(d)
        layers.append(p)
    tail = dict(dng=take(d), dnb=take(d), wcls=take(C, d), bcls=take(C),
                embed=take(C, d))
    return layers, tail


def cross_pack(model, memory) -> torch.Tensor:
    """Cross-attention K / V of ``memory`` [1, T, d] for every layer,
    [L, 2, T, d] f32, head-major rows (feature h * Dh + dh)."""
    T, d = memory.shape[1], model.feature_dim
    with torch.no_grad():
        return torch.stack([torch.stack([k.reshape(T, d), v.reshape(T, d)])
                            for k, v in model.cross_kv(memory)]
                           ).to(torch.float32).contiguous()


def memory_add(mask, T: int, device) -> torch.Tensor:
    """The additive memory mask [T]: 0 at a valid frame, NEG elsewhere."""
    if mask is None:
        return torch.zeros((T,), dtype=torch.float32, device=device)
    m = torch.as_tensor(mask, device=device).reshape(-1, T)[0].bool()
    return torch.where(m, 0.0, NEG).to(torch.float32)


def _ln(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _attend(q, k, v, add, H, scale):
    """q [W, d] against k, v [W, n, d] (head-major rows) with the additive
    mask ``add`` [n] -> [W, d]."""
    W, n, d = k.shape
    Dh = d // H
    s = (k * q[:, None, :]).view(W, n, H, Dh).sum(-1) * scale \
        + add[None, :, None]
    s = s - s.max(dim=1, keepdim=True).values
    p = torch.exp(s)
    p = p / p.sum(dim=1, keepdim=True)
    return (p[..., None] * v.view(W, n, H, Dh)).sum(dim=1).reshape(W, d)


@torch.no_grad()
def decode_plain(pack, cross, memadd, *, d: int, H: int, L: int, C: int,
                 max_len: int, beam_width: int = 1, beam: bool = False,
                 sos: int = 1, eos: int = 2, pad: int = 0,
                 eps: float = 1e-6):
    """Plain version of the decode kernel: the same loop in PyTorch.
    Returns (tokens [W, max_len] int32, raw scores [W] f32, steps run)."""
    S, W = max_len, beam_width
    dev = pack.device
    layers, tail = _views(pack, d, L, C)
    T = cross.shape[2]
    scale = float((d // H) ** -0.5)
    x = tail["embed"][sos].expand(W, d).clone()
    toks = torch.full((W, S), pad, dtype=torch.int32, device=dev)
    toks[:, 0] = sos
    scores = torch.full((W,), NEG, device=dev)
    scores[0] = 0.0
    caches = torch.zeros((L, 2, W, S, d), device=dev)
    rows = torch.arange(S, device=dev)
    fin_row = torch.full((C,), NEG, device=dev)
    fin_row[pad] = 0.0
    steps = 0
    for i in range(S - 1):
        visadd = torch.where(rows <= i, 0.0, NEG)
        for li, p in enumerate(layers):
            h = _ln(x, p["n1g"], p["n1b"], eps)
            q = h @ p["wq"].T + p["bq"]
            caches[li, 0, :, i] = h @ p["wk"].T + p["bk"]
            caches[li, 1, :, i] = h @ p["wv"].T + p["bv"]
            ctx = _attend(q, caches[li, 0], caches[li, 1], visadd, H, scale)
            x = x + ctx @ p["wo"].T + p["bo"]
            h = _ln(x, p["n2g"], p["n2b"], eps)
            q = h @ p["wcq"].T + p["bcq"]
            kx = cross[li, 0].expand(W, T, d)
            vx = cross[li, 1].expand(W, T, d)
            ctx = _attend(q, kx, vx, memadd, H, scale)
            x = x + ctx @ p["wco"].T + p["bco"]
            h = _ln(x, p["n3g"], p["n3b"], eps)
            f = torch.relu(h @ p["w1"].T + p["b1"])
            x = x + f @ p["w2"].T + p["b2"]
        logits = _ln(x, tail["dng"], tail["dnb"], eps) @ tail["wcls"].T \
            + tail["bcls"]
        steps += 1
        if not beam:
            nxt = torch.argmax(logits[0]).to(torch.int32)   # first maximum
            toks[0, i + 1] = nxt
            x = tail["embed"][nxt.long()][None]
            if int(nxt) == eos:
                break
            continue
        m = logits.max(dim=1, keepdim=True).values
        shifted = logits - m
        logp = shifted - torch.log(torch.exp(shifted).sum(dim=1,
                                                          keepdim=True))
        finished = (toks == eos).any(dim=1)
        logp = torch.where(finished[:, None], fin_row[None], logp)
        scores, idx = top_w(scores[:, None] + logp, W)
        parent, tok = idx // C, (idx % C).to(torch.int32)
        toks = toks[parent]
        toks[:, i + 1] = tok
        caches = caches[:, :, parent]
        x = tail["embed"][tok.long()]
        if bool((toks == eos).any(dim=1).all()):
            break
    return toks, scores, steps


def _launch(pack, cross, memadd, d, H, L, C, S, W, beam, sos, eos, pad,
            eps):
    T = cross.shape[2]
    dev = pack.device
    # the kernel reads each layer's K transposed ([d, T]: a thread a key,
    # neighbouring keys in neighbouring words) and V as it is ([T, d])
    cross = torch.stack([cross[:, 0].transpose(1, 2).reshape(L, T * d),
                         cross[:, 1].reshape(L, T * d)], dim=1).contiguous()
    tokens = torch.empty((W, S), dtype=torch.int32, device=dev)
    scores = torch.empty((W,), dtype=torch.float32, device=dev)
    steps = torch.empty((1,), dtype=torch.int32, device=dev)
    cache = torch.zeros((L, 2, W, S, d), dtype=torch.float32, device=dev)
    cluster = ctypes.c_int(0)   # the kernel's cluster size: 16, or 8
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function(
        "decoder", "ishara_decoder_decode",
        [I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, F, F,
         ctypes.POINTER(ctypes.c_int), P])
    rc = fn(_build.device_index(pack), pack.data_ptr(), cross.data_ptr(),
            memadd.data_ptr(), cache.data_ptr(), tokens.data_ptr(),
            scores.data_ptr(), steps.data_ptr(), d, H, L, C, T, S, W,
            int(beam), sos, eos, pad, eps, float((d // H) ** -0.5),
            ctypes.byref(cluster), _build.stream_of(pack))
    _build.check("decoder", rc, "decode kernel")
    return tokens, scores, steps, cluster.value


def _decode(model, memory, mask, pack, S, W, beam, sos, eos, pad):
    if memory.dim() != 3 or memory.shape[0] != 1 \
            or memory.shape[2] != model.feature_dim:
        raise ValueError(f"memory [1, T, {model.feature_dim}] expected (the "
                         f"decode serves one sequence), got "
                         f"{tuple(memory.shape)}")
    T = memory.shape[1]
    check_decode_fits(model, T, S, W)
    dev = memory.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the decode kernel runs on CUDA or CPU tensors, "
                         f"not {dev}")
    pack = (pack_decoder(model) if pack is None else pack).to(dev)
    d, H, L, C = dims = (model.feature_dim, model.num_heads,
                         model.num_decoder_layers, model.num_classes)
    if pack.dtype != torch.float32 or pack.numel() != pack_floats(d, L, C):
        raise ValueError(f"pack: {pack_floats(d, L, C)} float32 values "
                         f"expected (pack_decoder's), got {pack.numel()} "
                         f"{pack.dtype}")
    cross = cross_pack(model, memory)
    memadd = memory_add(mask, T, dev)
    if dev.type == "cpu":
        tokens, scores, _ = decode_plain(
            pack, cross, memadd, d=d, H=H, L=L, C=C, max_len=S,
            beam_width=W, beam=beam, sos=sos, eos=eos, pad=pad)
        return tokens, scores, True
    tokens, scores, _, _ = _launch(pack.contiguous(), cross, memadd, *dims, S,
                                   W, beam, sos, eos, pad, 1e-6)
    return tokens, scores, False


def fused_greedy_decode(model, memory, mask=None, *, max_len: int = 64,
                        sos: int = 1, eos: int = 2, pad: int = 0,
                        pack: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy-decode ``memory`` [1, T, d] (the output of ``model.encode``)
    in one kernel launch. ``mask`` [1, T] bool marks the valid memory
    frames; ``pack`` is :func:`pack_decoder`'s (made here when None).
    Returns tokens [1, max_len] int32, equal to ``greedy_translate_cached``'s.
    Replaces ``ishara_tpu.ops.decoder_kernel.fused_greedy_decode``."""
    tokens, _, plain = _decode(model, memory, mask, pack, max_len, 1, False,
                               sos, eos, pad)
    if not plain:
        fused_greedy_decode.launches += 1
    return tokens


def fused_beam_decode(model, memory, mask=None, *, max_len: int = 64,
                      beam_width: int = 4, sos: int = 1, eos: int = 2,
                      pad: int = 0, pack: torch.Tensor | None = None):
    """Beam-search ``memory`` [1, T, d] in one kernel launch. Returns
    (tokens [W, max_len] int32, raw log-probability scores [W, 1]) of all
    beams; :func:`fused_beam_translate` applies the length penalty and picks
    the best. Replaces ``ishara_tpu.ops.decoder_kernel.fused_beam_decode``."""
    tokens, scores, plain = _decode(model, memory, mask, pack, max_len,
                                    beam_width, True, sos, eos, pad)
    if not plain:
        fused_beam_decode.launches += 1
    return tokens, scores[:, None]


# launches of the decode kernel, greedy and beam
fused_greedy_decode.launches = 0
fused_beam_decode.launches = 0


@torch.no_grad()
def fused_greedy_translate(model, x, mask=None, *, max_len: int = 64,
                           sos: int = 1, eos: int = 2, pad: int = 0,
                           pack: torch.Tensor | None = None):
    """``greedy_translate_cached``'s contract (x [1, T, 92, 3] ->
    (tokens [1, max_len], confidence [1])): the encoder, then the whole
    decode loop as one kernel launch."""
    memory, confidence = model.encode(x, mask)
    tokens = fused_greedy_decode(model, memory, mask, max_len=max_len,
                                 sos=sos, eos=eos, pad=pad, pack=pack)
    return tokens, confidence


@torch.no_grad()
def fused_beam_translate(model, x, mask=None, *, max_len: int = 64,
                         beam_width: int = 4, sos: int = 1, eos: int = 2,
                         pad: int = 0, length_penalty: float = 0.0,
                         pack: torch.Tensor | None = None):
    """``beam_translate_cached``'s contract (-> (tokens [1, max_len],
    confidence [1], best score)): the encoder, one kernel launch for the
    whole beam loop, then the length penalty and the best beam."""
    memory, confidence = model.encode(x, mask)
    tokens, scores = fused_beam_decode(
        model, memory, mask, max_len=max_len, beam_width=beam_width,
        sos=sos, eos=eos, pad=pad, pack=pack)
    scores = length_normalised(tokens, scores[:, 0], length_penalty, eos,
                               pad)
    best = torch.argmax(scores)
    return tokens[best][None], confidence, scores[best]
