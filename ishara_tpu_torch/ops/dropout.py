"""Dropout whose mask is a function of (seed, position) (port of
``ishara_tpu/ops/dropout.py``).

:func:`fast_dropout` and :func:`fast_dropout_add` replace ``tpu_dropout`` and
``tpu_dropout_add``: inverted dropout, and ``res + dropout(x)`` in one pass.
The keep mask is never stored; the backward pass regenerates it
(``dx = mask * dy / (1 - rate)``, ``dres = dy``). On a CUDA tensor each
launches the kernel of ``csrc/dropout.cu`` or raises; on a CPU tensor it runs
the plain version beside it, :func:`dropout_plain`.

**The mask function.** The TPU kernels seed a hardware generator per grid
step; that stream cannot be reproduced. Here the mask is Philox4x32-10 keyed
by the site's seed with the element's flat index as the counter: element
``i`` takes word ``i & 3`` of ``philox(counter=(i >> 2, 0, 0, 0),
key=(seed, 0))``; ``keep = bits >= uint32(rate * 2**32)``, kept values are
scaled by ``1 / (1 - rate)``. :func:`philox_bits` and :func:`keep_mask` are
that function in plain PyTorch (int64 arithmetic for the 32 x 32 -> 64 bit
products); ``csrc/philox.cuh`` is the same function for the kernels of this
module, of :mod:`.attention` and of :mod:`.ffn_kernel`, which therefore agree
with their plain versions element for element with dropout active.

**Offsets.** Every mask function takes the index of its first element
(``offset``; ``start`` for :func:`philox_bits` and :func:`keep_mask`): a
process that holds rows ``[r0, r1)`` of a batch passes ``r0`` times the
elements a row and draws, element for element, what the whole batch's call
draws on those rows. It is 0 unless the batch is split across processes.
A tensor-parallel rank's slice of a site (its heads, its hidden columns)
is strided in the global tensor: ``runs = (width, stride)`` says that its
elements come in runs of ``width``, each ``stride`` global elements after
the one before (:func:`ishara_tpu_torch.parallel.shard.split_offset`).

**Seeds.** A step's randomness is a pure function of (base seed, step):
:func:`step_seeds` gives the step's dropout and augmentation seeds,
:func:`site_seed_table` the seeds of that step's dropout sites in one pass,
and :func:`site_seeds` those of one site by its number.
All of it is tensor arithmetic on the device: no host sync, no generator
state.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


# ---------------------------------------------------------------------------
# Philox4x32-10 in plain PyTorch
# ---------------------------------------------------------------------------

def _mulhilo(m: int, c: torch.Tensor):
    """(high, low) 32-bit halves of ``m * c`` for ``c`` in [0, 2**32) held
    in int64: the product is taken in two 16-bit halves of ``c`` so that no
    intermediate reaches 2**63."""
    a = m * (c >> 16)
    b = m * (c & 0xFFFF)
    t = a + (b >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (b & 0xFFFF)


def philox_block(seed: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 blocks ``[..., 4]`` (int64 holding uint32 values) for
    counters ``(group, 0, 0, 0)`` under key ``(seed, 0)``; ``seed`` and
    ``group`` are integer tensors that broadcast."""
    group = group.to(torch.int64)
    seed = seed.to(torch.int64)
    c0 = group & _MASK32
    c1 = (group >> 32) & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = seed & _MASK32
    k1 = 0
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def philox_bits(seed: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """The random words of flat indices ``start .. start + n - 1`` under
    ``seed`` (a one-element integer tensor): int64 ``[n]`` in [0, 2**32)."""
    g0, g1 = start // 4, (start + n + 3) // 4
    groups = torch.arange(g0, g1, dtype=torch.int64, device=seed.device)
    words = philox_block(seed.reshape(()), groups).reshape(-1)
    return words[start - 4 * g0: start - 4 * g0 + n]


def threshold_of(rate: float) -> int:
    """``uint32(rate * 2**32)``: an element is kept when its word is at
    least this."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * (2 ** 32))


def keep_mask(seed: torch.Tensor, shape, rate: float,
              start: int = 0, runs=None) -> torch.Tensor:
    """Boolean keep mask of ``shape`` for ``seed``: element at flat index
    ``i`` is kept when ``philox_bits(seed)[start + i] >=
    threshold_of(rate)``; with ``runs = (width, stride)`` element ``i``
    takes global index ``start + (i // width) * stride + i % width``."""
    n = 1
    for d in shape:
        n *= int(d)
    if runs is None or runs[0] == runs[1]:
        bits = philox_bits(seed, n, int(start))
    else:
        width, stride = (int(v) for v in runs)
        i = torch.arange(n, dtype=torch.int64, device=seed.device)
        idx = int(start) + (i // width) * stride + i % width
        words = philox_block(seed.reshape(()), idx >> 2)
        bits = words.gather(-1, (idx & 3)[:, None])[:, 0]
    return (bits >= threshold_of(rate)).reshape(tuple(shape))


def step_seeds(base_seed: int, step: torch.Tensor) -> torch.Tensor:
    """int32 ``[2]`` on ``step``'s device: the (dropout, augmentation) seeds
    of optimizer step ``step`` (a 0-d integer tensor) under ``base_seed``.
    A pure function of the two, as the reference's ``fold_in(rng, step)``."""
    key = torch.as_tensor(int(base_seed) & _MASK32, dtype=torch.int64,
                          device=step.device)
    words = philox_block(key, step.to(torch.int64).reshape(()))
    return (words[:2] & 0x7FFFFFFF).to(torch.int32)


def site_seed_table(seed: torch.Tensor, sites: int) -> torch.Tensor:
    """int32 ``[sites, 4]``: the (non-negative) kernel seeds of dropout
    sites ``0 .. sites - 1`` under the step's dropout ``seed`` (a
    one-element integer tensor), made in one pass. Row ``i`` is a pure
    function of (seed, i), distinct for distinct sites."""
    # the step seed keys the generator; the site number is the counter,
    # offset so that it never meets an element index of a mask
    counters = (1 << 40) + torch.arange(sites, dtype=torch.int64,
                                        device=seed.device)
    words = philox_block(seed.reshape(()), counters)
    return (words & 0x7FFFFFFF).to(torch.int32)


def site_seeds(table: torch.Tensor, n: int = 1, site: int = 0) -> torch.Tensor:
    """``n`` int32 kernel seeds for dropout site number ``site`` from the
    step's ``table`` (:func:`site_seed_table`)."""
    if not 1 <= n <= 4:
        raise ValueError(f"a site takes 1 to 4 seeds, got {n}")
    if table.dim() != 2:
        raise ValueError("site_seeds takes the [sites, 4] table that "
                         "site_seed_table makes from the step's dropout seed")
    return table[site, :n]


# ---------------------------------------------------------------------------
# K2: plain version and kernel wrappers
# ---------------------------------------------------------------------------

def dropout_plain(x: torch.Tensor, seed: torch.Tensor, rate: float,
                  res: torch.Tensor | None = None,
                  offset: int = 0, runs=None) -> torch.Tensor:
    """``[res +] x * keep / (1 - rate)`` with the Philox mask from flat
    index ``offset`` on (in ``runs``, see :func:`keep_mask`): f32
    arithmetic, one rounding to ``x``'s dtype (the kernel's semantics)."""
    if rate <= 0.0:
        return x if res is None else res + x
    keep = keep_mask(seed, x.shape, rate, offset, runs).to(torch.float32)
    y = x.to(torch.float32) * (keep * (1.0 / (1.0 - rate)))
    if res is not None:
        y = res.to(torch.float32) + y
    return y.to(x.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x, res, seed, rate, offset=0, runs=None):
    """Run ``csrc/dropout.cu`` on contiguous CUDA tensors."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the dropout kernel takes f32 or bf16, got "
                         f"{x.dtype}")
    if seed.dtype != torch.int32 or seed.numel() < 1 \
            or seed.device != x.device:
        raise ValueError("seed must be an int32 tensor on x's device")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype
                            or res.device != x.device):
        raise ValueError("res must match x in shape, dtype and device")
    width, stride = (x.numel(), x.numel()) if runs is None else runs
    if x.numel() and (width <= 0 or stride < width or x.numel() % width):
        raise ValueError(f"runs {runs} do not tile {x.numel()} values")
    x = x.contiguous()
    res = None if res is None else res.contiguous()
    out = torch.empty_like(x)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.function("dropout", "ishara_dropout", [
        I, P, P, P, L, ctypes.c_ulonglong, L, L, P, ctypes.c_uint,
        ctypes.c_float, I, P])
    rc = fn(_build.device_index(x), x.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            x.numel(), int(offset), max(int(width), 1), max(int(stride), 1),
            seed.data_ptr(), threshold_of(rate), 1.0 / (1.0 - rate),
            _DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.check("dropout", rc, "dropout kernel")
    return out


def _apply(x, res, seed, rate, offset, runs, counter, direction):
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate, res, offset, runs)
    out = _launch(x, res, seed, rate, offset, runs)
    setattr(counter, direction, getattr(counter, direction) + 1)
    return out


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, offset, runs):
        ctx.save_for_backward(seed)
        ctx.rate, ctx.offset, ctx.runs = rate, offset, runs
        return _apply(x, None, seed, rate, offset, runs, fast_dropout,
                      "launches")

    @staticmethod
    def backward(ctx, dy):
        (seed,) = ctx.saved_tensors
        return _apply(dy, None, seed, ctx.rate, ctx.offset, ctx.runs,
                      fast_dropout, "launches_bwd"), None, None, None, None


class _DropoutAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, res, x, seed, rate, offset, runs):
        ctx.save_for_backward(seed)
        ctx.rate, ctx.offset, ctx.runs = rate, offset, runs
        return _apply(x, res, seed, rate, offset, runs, fast_dropout_add,
                      "launches")

    @staticmethod
    def backward(ctx, dy):
        (seed,) = ctx.saved_tensors
        return dy, _apply(dy, None, seed, ctx.rate, ctx.offset, ctx.runs,
                          fast_dropout_add, "launches_bwd"), None, None, \
            None, None


def _runs(runs):
    return None if runs is None else (int(runs[0]), int(runs[1]))


def fast_dropout(x: torch.Tensor, seed: torch.Tensor, rate: float,
                 offset: int = 0, runs=None):
    """Inverted dropout of ``x`` (any shape, f32 or bf16) at static ``rate``
    with the mask of ``seed`` (int32 ``[1]`` on ``x``'s device, fresh per
    site and step) from flat index ``offset`` on, in ``runs`` (see
    :func:`keep_mask`). Replaces ``ishara_tpu.ops.dropout.tpu_dropout``."""
    if rate <= 0.0:
        return x
    return _Dropout.apply(x, seed, float(rate), int(offset), _runs(runs))


def fast_dropout_add(res: torch.Tensor, x: torch.Tensor, seed: torch.Tensor,
                     rate: float, offset: int = 0, runs=None):
    """``res + dropout(x)`` in one pass. Replaces
    ``ishara_tpu.ops.dropout.tpu_dropout_add``."""
    if rate <= 0.0:
        return res + x
    return _DropoutAdd.apply(res, x, seed, float(rate), int(offset),
                             _runs(runs))


# kernel launches of the forward pass and of the backward pass
fast_dropout.launches = 0
fast_dropout.launches_bwd = 0
fast_dropout_add.launches = 0
fast_dropout_add.launches_bwd = 0
