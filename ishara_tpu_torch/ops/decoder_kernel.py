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

The design (``csrc/decoder.cu``'s header; :func:`decode_plan` mirrors its
plan): 3 L + 1 stages a step, each (layer, head) unit -- or, where the
cluster has at least twice as many blocks as heads, each part of a head's
columns -- and a slice of the FFN and of the classes on a block of the
cluster, the stages joined by an exchange of partial sums in a fixed order
(the same bits on every run).
Shared memory holds a fixed layout (:func:`fused_decode_smem_bytes`), which
must fit one block's 227 KB with the smallest staging ring; the rest adapts
-- the self-attention caches and the cross-attention K / V stay in shared
memory where they fit, else in global memory, and the weights a block
cannot keep stream through the ring. :func:`fused_decode_fits` answers from
that formula and the kernel's other limits: W at most C (-1e30 stands for
the dead beams' -inf), whole heads, ``max_len`` >= 2; any beam width and
head width within them. The wrappers raise :class:`DecoderFitError` beyond
them -- they never fall back to the unfused loop, as the reference's
wrappers do; only an engine built with ``fused="auto"`` chooses, openly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..decode.autoregressive import length_normalised, top_w

NEG = -1e30
THREADS = 512            # threads a block of the kernel
SMEM_PER_BLOCK = 232448   # bytes of shared memory a block may use (H100)
SLOT_FLOATS = {True: 12288, False: 6144}   # a ring slot, greedy / beam
SLOTS = 2                 # the ring's slots
PIECE_INTS = 12           # ints a piece in the kernel's piece table
# the products a block runs, in the order a step consumes them
QKV, O, CQ, CO, F1, F2, CLS = range(7)
KIND_NAMES = ("qkv", "out", "cross_q", "cross_out", "fc1", "fc2",
              "classifier")


class DecoderFitError(ValueError):
    """The geometry is beyond what the decode kernel takes."""


def _align4(w: int) -> int:
    return (w + 3) // 4 * 4


def _ceil32(w: int) -> int:
    return (w + 31) // 32 * 32


def _rows_lo(n: int, r: int, cl: int) -> int:
    return n * r // cl


def _split(d, H, L, cl, pc):
    """How the heads go over a cluster of ``cl`` blocks with each head's
    columns split over ``pc`` blocks (``layout``): (unit slots a layer,
    the most units a block, the most columns a part)."""
    stride = cl if pc > 1 else H
    return stride, -(-L * stride // cl), -(-(d // H) // pc)


def _units(d, H, L, cl, pc, rank):
    """Block ``rank``'s units in slot order (``unit_of``): (slot v, layer,
    head, first column, columns) -- slot v is layer v // stride, head
    (v % stride) // pc, part (v % stride) % pc, on block v % cl."""
    Dh = d // H
    stride = _split(d, H, L, cl, pc)[0]
    out = []
    for v in range(rank, L * stride, cl):
        s, p = v % stride, v % stride % pc
        if s // pc < H:
            c0 = _rows_lo(Dh, p, pc)
            out.append((v, v // stride, s // pc, c0,
                        _rows_lo(Dh, p + 1, pc) - c0))
    return out


def _pieces(d, H, L, C, cl, pc, rank):
    """(kind, idx, N, K) of block ``rank``'s products in consumption order
    (``csrc/decoder.cu`` ``for_pieces``): per layer its units' q / k / v
    rows and out columns, their cross q rows and cross out columns, its FFN
    rows and fc2 columns; then its classifier rows. idx is the unit slot or
    the layer."""
    r0, r1 = _rows_lo(4 * d, rank, cl), _rows_lo(4 * d, rank + 1, cl)
    units = _units(d, H, L, cl, pc, rank)
    out = []
    for l in range(L):
        mine = [u for u in units if u[1] == l]
        for v, _, _, _, nc in mine:
            out += [(QKV, v, 3 * nc, d), (O, v, d, nc)]
        for v, _, _, _, nc in mine:
            out += [(CQ, v, nc, d), (CO, v, d, nc)]
        if r1 > r0:
            out += [(F1, l, r1 - r0, d), (F2, l, d, r1 - r0)]
    c0, c1 = _rows_lo(C, rank, cl), _rows_lo(C, rank + 1, cl)
    if c1 > c0:
        out.append((CLS, 0, c1 - c0, d))
    return out


def _lanes(N, K, slot):
    """Lanes a row of a product and its padded K (``lanes_of``): the
    smallest power of two g <= 32 at which a tile of 32 / g rows fits a
    ring slot and 2 g times the rows of one pass (the piece, or the whole
    tiles a slot holds) exceeds THREADS."""
    g = 1
    while g < 32:
        tile = (32 // g) * (-(-K // g) * g)
        if tile > slot:
            g *= 2
            continue
        rows = min(N, (slot // tile) * (32 // g))
        if 2 * g * rows <= THREADS and g < K:
            g *= 2
        else:
            break
    return g, -(-K // g) * g


def _tile_floats(N, Kg, g):
    R = 32 // g
    return -(-N // R) * R * Kg


def _place(pieces, budget, slot):
    """First fit under ``budget`` floats: the first piece of each stage
    (qkv, cross q, fc1, classifier) in order, then the others; the rest
    streams in segments of whole tiles that fit a ``slot``. Returns
    (per-piece resident offset or -1, padded resident floats, padded
    scratch floats, resident weight floats, streamed weight floats)."""
    at = [-1] * len(pieces)
    used = scratch = res = strm = 0
    for first in (True, False):
        for i, (kind, _, N, K) in enumerate(pieces):
            if (kind in (QKV, CQ, F1, CLS)) != first:
                continue
            g, Kg = _lanes(N, K, slot)
            w = _tile_floats(N, Kg, g)
            if used + w <= budget:
                at[i], used, res = used, used + w, res + N * K
            else:
                R = 32 // g
                rps = min(max(1, slot // (R * Kg)) * R, -(-N // R) * R)
                scratch += (N // rps) * rps * Kg + _tile_floats(N % rps, Kg,
                                                                g)
                strm += N * K
    return at, used, scratch, res, strm


def _layout_words(d, H, L, C, T, S, W, cl, pc):
    """Words of the layout every block shares (``layout``) and the widest
    product's K."""
    _, umax, cw = _split(d, H, L, cl, pc)
    Rmax = -(-4 * d // cl)
    nmax, Ws = max(T, S), min(W, max(1, -(-W * H // 8)))
    npmax = 4 * umax + 2 * L + 1
    sl = -(-d // cl)
    sizes = [2 * W * d, W * d, W * d, 2 * cl * W * sl, W * C, W * cw, W * cw,
             W * Rmax, Ws * nmax, 2 * (pc - 1) * Ws * nmax,
             W, W, W * W, W * W, 2 * W * S,
             W, W, 2 * W, 4,
             9 * d * L + 2 * d + C + 4 * umax * cw + L * Rmax,
             4 * umax + L, PIECE_INTS * npmax]
    return 20 + sum(_align4(s) for s in sizes), max(d, Rmax, cw)


def _fixed_words(d, H, L, C, T, S, W, cl, smem=SMEM_PER_BLOCK):
    """(fixed words, widest K, parts a head) of the largest split whose
    layout and smallest ring fit ``smem`` bytes (``choose_layout``): each
    head's columns over pc = cl // H blocks (at most Dh) where the cluster
    has at least twice as many blocks as heads, down to 1; pc 1's when
    none fits."""
    Dh = d // H
    for pc in range(min(cl // H, Dh) if cl >= 2 * H else 1, 0, -1):
        fixed, maxK = _layout_words(d, H, L, C, T, S, W, cl, pc)
        if smem // 4 - fixed >= 2 * _ceil32(maxK):
            break
    return fixed, maxK, pc


def fused_decode_smem_bytes(d: int, H: int, L: int, C: int, T: int, S: int,
                            W: int = 1) -> int:
    """Bytes of shared memory a block of the kernel must hold whatever
    streams (``csrc/decoder.cu`` ``ishara_decoder_vector_bytes``), at a
    cluster of 16: x twice (a stage's and the next), its LayerNorm, the
    block's partial [W, d]; the slots in which its column slice of the
    partials arrives, two stages' worth; the logits [W, C]; a unit's q and
    context; the block's FFN hidden; the scores of the beams an attention
    pass holds, and, where a head's columns are split, the partial scores
    of its other blocks, two exchanges' worth; the beam state (scores, top-W
    candidates, two tables [W, S] of the tokens and their cache banks,
    parents, flags); the norms' scales and the biases the block adds; the
    unit and piece tables; the mbarriers; and the smallest staging ring,
    two rows of the widest product (padded to 32 floats). Weights, the
    cross-attention K / V and the self-attention caches adapt: what does
    not fit streams (weights) or stays in global memory (K / V)."""
    fixed, maxK, _ = _fixed_words(d, H, L, C, T, S, W, 16)
    return 4 * (fixed + 2 * _ceil32(maxK))


def decode_plan(d: int, H: int, L: int, C: int, T: int, S: int, W: int = 1,
                cluster: int = 16, smem: int = SMEM_PER_BLOCK) -> dict | None:
    """The kernel's division of the decode over a cluster of ``cluster``
    blocks with ``smem`` bytes of shared memory each (``csrc/decoder.cu``
    ``make_plan``), or None when a block's fixed layout and the smallest
    ring do not fit. The attention work comes in units, each a (layer,
    head) pair or, where the cluster has at least twice as many blocks as
    a layer has heads, a part of one: its columns split over ``parts`` =
    cluster // H blocks, so that every block works in every attention
    stage. A unit's block computes its q / k / v columns (or cross q), its
    attention -- where split, the partial scores exchanged among the
    head's blocks and added in part order (``score_exchanges_per_step``)
    -- and its slice of the out projection as a partial [W, d]; the FFN's
    4d hidden rows and the classifier's rows are split in contiguous
    ranges. Each of the 3 L + 1 stages a step ends in one exchange, the
    cluster's synchronisation (``barriers_per_step``): block s adds column
    slice s of the partials in rank order and sends it to every block, or,
    after the classifier, every block sends its logits to all. Tiles and
    the lanes a row follow ``lanes_of``. Shared memory holds the fixed
    layout, then -- when not everything fits -- a staging ring, the
    self-attention caches if they fit, the cross K / V if they fit, and the
    weights that fit (first fit: the first product of each stage, then the
    others); the rest streams through the ring. Bytes are f32 weights."""
    fixed, maxK, pc = _fixed_words(d, H, L, C, T, S, W, cluster, smem)
    avail = smem // 4 - fixed
    if avail < 2 * _ceil32(maxK):
        return None
    _, umax, cw = _split(d, H, L, cluster, pc)
    cwp = cw | 1
    cache_w = umax * 2 * W * S * cwp
    cross_w = umax * 2 * T * cwp
    pieces = [_pieces(d, H, L, C, cluster, pc, r) for r in range(cluster)]
    slot = max(SLOT_FLOATS[W == 1], _ceil32(maxK))
    wmax = max(_place(p, 1 << 60, slot)[1] for p in pieces)
    slots = 0
    if cache_w + cross_w + wmax <= avail:
        cache_smem = cross_smem = True
        rest = avail - cache_w - cross_w
    else:
        slots = SLOTS
        if avail - slots * slot < 2 * _ceil32(maxK):
            slot = _ceil32(maxK)
        rest = avail - slots * slot
        cache_smem = cache_w <= rest
        rest -= cache_w if cache_smem else 0
        cross_smem = cross_w <= rest
        rest -= cross_w if cross_smem else 0
    o_res = (fixed + slots * slot + (cache_w if cache_smem else 0)
             + (cross_w if cross_smem else 0))
    Ws = min(W, max(1, -(-W * H // 8)))
    blocks = []
    for r, p in enumerate(pieces):
        at, used, scratch, res, strm = _place(p, rest, slot)
        blocks.append(dict(
            units=[u[1:] for u in _units(d, H, L, cluster, pc, r)],
            ffn_rows=(_rows_lo(4 * d, r, cluster),
                      _rows_lo(4 * d, r + 1, cluster)),
            classifier_rows=(_rows_lo(C, r, cluster),
                             _rows_lo(C, r + 1, cluster)),
            pieces=[(KIND_NAMES[k], i, N, K, a >= 0)
                    for (k, i, N, K), a in zip(p, at)],
            smem_words=o_res + used, scratch_floats=scratch,
            resident_bytes=4 * res, streamed_bytes=4 * strm))
    scratch = max(b["scratch_floats"] for b in blocks)
    return dict(
        cluster=cluster, blocks=blocks,
        smem_bytes=4 * max(b["smem_words"] for b in blocks),
        fixed_bytes=4 * fixed,
        scratch_floats=_align4(scratch + (0 if cache_smem else cache_w)),
        resident_bytes=max(b["resident_bytes"] for b in blocks),
        streamed_bytes=max(b["streamed_bytes"] for b in blocks),
        cache_smem=cache_smem, cross_smem=cross_smem, slots=slots,
        slot_floats=slot, parts=pc, barriers_per_step=3 * L + 1,
        score_exchanges_per_step=2 * L * -(-W // Ws) if pc > 1 else 0)


def _limits(d, H, L, C, T, S, W) -> str | None:
    """Why the kernel cannot take this geometry, or None."""
    if not 1 <= W <= C:
        return f"beam width {W} outside 1..num_classes={C}"
    if d % H:
        return f"head dim {d}/{H} is not a whole number"
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


_PLANS: dict[tuple, dict] = {}


def kernel_plan(device_index: int, d, H, L, C, T, S, W) -> dict:
    """The plan the kernel takes on CUDA device ``device_index``, read from
    its C side (``ishara_decoder_plan``: the cluster the card places, the
    shared memory and global scratch a block, the largest block's resident
    and streamed weight bytes, where the caches and the cross K / V live,
    the ring, the blocks a head's columns are split over). Kept per device
    and geometry."""
    key = (device_index, d, H, L, C, T, S, W)
    if key not in _PLANS:
        out = (ctypes.c_longlong * 10)()
        I = ctypes.c_int
        fn = _build.function("decoder", "ishara_decoder_plan",
                             [I] * 8 + [ctypes.POINTER(ctypes.c_longlong)])
        _build.check("decoder", fn(device_index, d, H, L, C, T, S, W, out),
                     "decode kernel plan")
        names = ("cluster", "smem_bytes", "scratch_floats", "resident_bytes",
                 "streamed_bytes", "cache_smem", "cross_smem", "slots",
                 "slot_floats", "parts")
        _PLANS[key] = dict(zip(names, (int(v) for v in out)))
    return _PLANS[key]


def _launch(pack, cross, memadd, d, H, L, C, S, W, beam, sos, eos, pad,
            eps):
    """One launch: (tokens [W, S], raw scores [W], counts [3] -- the steps
    run, the stage-ending exchanges and the score exchanges block 0 took
    part in -- and the cluster size)."""
    T = cross.shape[2]
    dev = pack.device
    idx = _build.device_index(pack)
    plan = kernel_plan(idx, d, H, L, C, T, S, W)
    cross = cross.reshape(L, 2, T, d).contiguous()
    tokens = torch.empty((W, S), dtype=torch.int32, device=dev)
    scores = torch.empty((W,), dtype=torch.float32, device=dev)
    # the steps run, and the exchanges block 0 took part in: those that
    # end a stage, and a split head's partial scores
    counts = torch.empty((3,), dtype=torch.int32, device=dev)
    # each block's streamed weights, and its caches where shared memory
    # does not hold them; written by the kernel before it reads them
    n = max(4, plan["cluster"] * plan["scratch_floats"])
    scratch = torch.empty((n,), dtype=torch.float32, device=dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function(
        "decoder", "ishara_decoder_decode",
        [I, P, P, P, P, ctypes.c_longlong, P, P, P, I, I, I, I, I, I, I, I,
         I, I, I, F, F, P])
    rc = fn(idx, pack.data_ptr(), cross.data_ptr(), memadd.data_ptr(),
            scratch.data_ptr(), n, tokens.data_ptr(), scores.data_ptr(),
            counts.data_ptr(), d, H, L, C, T, S, W, int(beam), sos, eos,
            pad, eps, float((d // H) ** -0.5), _build.stream_of(pack))
    _build.check("decoder", rc, "decode kernel")
    return tokens, scores, counts, plan["cluster"]


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
