"""Training-time augmentations (port of ``ishara_tpu/preprocess/augment.py``),
batched and statically shaped, with no host sync.

Every function works on the raw ``[B, Tmax, 276]`` + ``[B]`` length
representation *before* :func:`ishara_tpu_torch.preprocess.pipeline.
preprocess`, one row independent of the next (the reference maps its
per-sequence functions over the batch):

* time-warp: resize the valid frames to U(0.5, 1.5) * L
* time-shift: a random crop of up to +-10 frames
* spatial random affine: rotate / scale / shift on x, y
* temporal mask: NaN-out a random contiguous span
* left-right flip: mirror x and swap the left / right hand and pose groups
* finger dropout: NaN-out random hand landmarks

**Random draws.** Each function takes its draws as optional tensors (one
value a row, in the units the reference draws them in), so a test can feed
the values another generator drew. Draws that are not given come from
``generator``, an explicit ``torch.Generator`` on the tensor's device.
:func:`augment` takes them as a dict (see :func:`draw`), and
:func:`draws_from_seed` makes that dict as a pure function of a seed tensor
on the device -- what the training step uses, so that a step's augmentation
depends on (base seed, step) alone.
"""

from __future__ import annotations

import math

import torch

from ..data import landmarks as lm
from ..ops.dropout import philox_bits
from .pipeline import _cols

# name -> (trailing shape, low, high) of every uniform draw of augment(); the
# gates (p_*) are compared with ``prob``, ``shift`` is floored to an integer
# in [-10, 10] and ``fingers`` compared with the finger-dropout probability.
_DRAWS = {
    "p_warp": ((), 0.0, 1.0), "factor": ((), 0.5, 1.5),
    "p_shift": ((), 0.0, 1.0), "shift": ((), -10.0, 11.0),
    "p_affine": ((), 0.0, 1.0), "theta_deg": ((), -10.0, 10.0),
    "scale": ((), 0.8, 1.2), "offset": ((2,), -0.1, 0.1),
    "p_mask": ((), 0.0, 1.0), "u_span": ((), 0.0, 1.0),
    "u_start": ((), 0.0, 1.0),
    "p_fingers": ((), 0.0, 1.0), "fingers": ((2 * lm.N_HAND,), 0.0, 1.0),
    "p_flip": ((), 0.0, 1.0),
}


def _from_uniform(name, u):
    shape, lo, hi = _DRAWS[name]
    v = lo + (hi - lo) * u
    if name == "shift":
        return torch.floor(v).to(torch.int64)
    if name == "fingers":
        return v < 0.1
    return v


def draw(batch: int, device, generator: torch.Generator) -> dict:
    """All of :func:`augment`'s draws for ``batch`` rows from ``generator``
    (on ``device``)."""
    out = {}
    for name, (shape, _, _) in _DRAWS.items():
        u = torch.rand((batch,) + shape, generator=generator, device=device)
        out[name] = _from_uniform(name, u)
    return out


def draws_from_seed(seed: torch.Tensor, batch: int) -> dict:
    """All of :func:`augment`'s draws for ``batch`` rows as a pure function
    of ``seed`` (a one-element integer tensor; the draws live on its
    device): 24-bit uniforms cut from the Philox words of
    :func:`ishara_tpu_torch.ops.dropout.philox_bits`."""
    width = sum(math.prod(shape) for shape, _, _ in _DRAWS.values())
    bits = philox_bits(seed, batch * width).reshape(batch, width)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    out, at = {}, 0
    for name, (shape, _, _) in _DRAWS.items():
        n = math.prod(shape)
        out[name] = _from_uniform(name, u[:, at:at + n].reshape((batch,) + shape))
        at += n
    return out


def _given(value, name, x, generator):
    """``value`` on ``x``'s device, or a fresh draw from ``generator``."""
    if value is not None:
        return torch.as_tensor(value, device=x.device)
    if generator is None:
        raise ValueError(f"{name}: pass the draw or a torch.Generator")
    shape, _, _ = _DRAWS[name]
    return _from_uniform(name, torch.rand((x.shape[0],) + shape,
                                          generator=generator,
                                          device=x.device))


def _rows(x, idx):
    """x[b, idx[b, t]] for x [B, T, C] and idx [B, T]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def time_warp(x, length, prob: float = 0.2, u=None, factor=None,
              generator=None):
    """With probability ``prob`` (``u < prob``), resample the valid frames to
    ``factor * L`` frames, ``factor`` in [0.5, 1.5), clamped to Tmax.
    Returns (x, new_length)."""
    u = _given(u, "p_warp", x, generator)
    factor = _given(factor, "factor", x, generator)
    Tmax = x.shape[1]
    Lf = length.to(torch.float32)
    new_len = torch.clamp((Lf * factor).to(torch.int32), 1, Tmax)
    i = torch.arange(Tmax, dtype=torch.float32, device=x.device)[None, :]
    src = (i + 0.5) * (Lf / new_len.to(torch.float32))[:, None] - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0),
                        torch.clamp(Lf - 1.0, min=0.0)[:, None])
    lo = torch.floor(src).to(torch.int64)
    hi = torch.minimum(lo + 1,
                       torch.clamp(length.to(torch.int64) - 1, min=0)[:, None])
    w = (src - torch.floor(src))[..., None]
    warped = _rows(x, lo) * (1.0 - w) + _rows(x, hi) * w
    t = torch.arange(Tmax, device=x.device)[None, :]
    warped = torch.where((t < new_len[:, None])[..., None], warped,
                         float("nan"))
    apply = u < prob
    return (torch.where(apply[:, None, None], warped, x),
            torch.where(apply, new_len.to(length.dtype), length))


def time_shift(x, length, shift=None, generator=None):
    """Shift each sequence by ``shift`` frames (integers in [-10, 10]),
    expressed as a crop so that the valid prefix stays a prefix: a positive
    shift drops leading frames, a negative one trailing frames."""
    shift = _given(shift, "shift", x, generator).to(torch.int64)
    Tmax = x.shape[1]
    start = torch.clamp(shift, min=0)
    idx = (torch.arange(Tmax, device=x.device)[None, :] + start[:, None]) \
        % Tmax
    new_len = torch.clamp(length.to(torch.int64) - shift.abs(), 1, Tmax)
    return _rows(x, idx), new_len.to(length.dtype)


def spatial_affine(x, theta_deg=None, scale=None, offset=None,
                   generator=None):
    """Rotate by ``theta_deg`` about (0.5, 0.5), scale by ``scale`` and
    shift by ``offset`` ``[B, 2]`` on (x, y); z untouched."""
    theta = torch.deg2rad(_given(theta_deg, "theta_deg", x, generator)
                          .to(torch.float32))[:, None, None]
    scale = _given(scale, "scale", x, generator)[:, None, None]
    offset = _given(offset, "offset", x, generator)
    n = lm.N_LANDMARKS
    xs, ys, zs = x[..., :n], x[..., n:2 * n], x[..., 2 * n:]
    c, s = torch.cos(theta), torch.sin(theta)
    xr = (xs - 0.5) * c - (ys - 0.5) * s
    yr = (xs - 0.5) * s + (ys - 0.5) * c
    xs2 = xr * scale + 0.5 + offset[:, 0, None, None]
    ys2 = yr * scale + 0.5 + offset[:, 1, None, None]
    return torch.cat([xs2, ys2, zs], dim=-1)


def temporal_mask(x, length, max_frac: float = 0.15, u_span=None,
                  u_start=None, generator=None):
    """NaN-out a contiguous span of ``u_span * max_frac * L`` frames
    starting at ``u_start * max(L - span, 1)``."""
    u_span = _given(u_span, "u_span", x, generator)
    u_start = _given(u_start, "u_start", x, generator)
    L = length.to(torch.float32)
    span = (u_span * max_frac * L).to(torch.int32)
    start = (u_start * torch.clamp(L - span, min=1.0)).to(torch.int32)
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    hit = (t >= start[:, None]) & (t < (start + span)[:, None])
    return torch.where(hit[..., None], float("nan"), x)


def lr_flip(x, prob: float = 0.5, u=None, generator=None):
    """Where ``u < prob``: mirror x-coordinates about 0.5 and swap the
    left / right hand and pose groups."""
    u = _given(u, "p_flip", x, generator)
    flipped = x[..., _cols("mirror", x.device)]
    n = lm.N_LANDMARKS
    mirrored = torch.cat([1.0 - flipped[..., :n], flipped[..., n:]], dim=-1)
    return torch.where((u < prob)[:, None, None], mirrored, x)


def finger_dropout(x, drop=None, generator=None):
    """NaN-out (all coordinates of) the hand landmarks where ``drop``
    (bool ``[B, 42]``; the hands occupy landmark columns 0..41) is set; a
    fresh draw drops each with probability 0.1."""
    drop = _given(drop, "fingers", x, generator).to(torch.bool)
    n = lm.N_LANDMARKS
    mask = torch.zeros((x.shape[0], n), dtype=torch.bool, device=x.device)
    mask[:, :2 * lm.N_HAND] = drop
    return torch.where(mask.repeat(1, 3)[:, None, :], float("nan"), x)


def augment(x, length, prob: float = 0.2, flip_prob: float = 0.0,
            draws: dict | None = None, generator=None):
    """The composite augmentation: the warp behind its ``prob`` gate, then
    shift, affine, temporal mask and finger dropout each behind an
    independent ``prob`` gate, then the LR flip when ``flip_prob`` > 0 (off
    by default: it fights the dominant-hand canonicalisation). ``draws`` is
    a dict as :func:`draw` returns it; without one it is drawn from
    ``generator``. Returns (x, length)."""
    if draws is None:
        if generator is None:
            raise ValueError("augment: pass draws or a torch.Generator")
        draws = draw(x.shape[0], x.device, generator)
    d = draws

    def gate(name, new, old):
        keep = (d[name] < prob).reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(keep, new, old)

    x, length = time_warp(x, length, prob, d["p_warp"], d["factor"])
    shifted, shifted_len = time_shift(x, length, d["shift"])
    x, length = gate("p_shift", shifted, x), \
        gate("p_shift", shifted_len, length)
    x = gate("p_affine", spatial_affine(x, d["theta_deg"], d["scale"],
                                        d["offset"]), x)
    x = gate("p_mask", temporal_mask(x, length, u_span=d["u_span"],
                                     u_start=d["u_start"]), x)
    x = gate("p_fingers", finger_dropout(x, d["fingers"]), x)
    if flip_prob > 0.0:
        x = lr_flip(x, flip_prob, d["p_flip"])
    return x, length
