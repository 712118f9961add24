"""Quantization-aware training: int8 fake-quant with a straight-through
estimator (port of ``ishara_tpu/train/qat.py``).

The int8 export (:func:`ishara_tpu_torch.serve.export._quantize_tree`)
stores every floating leaf of two or more dimensions as symmetric
per-output-channel int8. Training through :func:`fake_quant` lets the
forward pass see exactly the dequantized weights that bundle will serve,
while the backward pass treats the rounding as the identity, so the
gradient reaches the float32 master weights unchanged. Checkpoints and
export are untouched: ``state.params`` never holds quantized values.

**The channel axis is flax's.** The export quantizes the flax tree, whose
channel is a leaf's last axis. The port's ``weight`` of a Linear, Conv1d or
Conv2d is that flax kernel with the last axis moved to the front
(:mod:`ishara_tpu_torch.bridge`), so its channel is dim 0; the leaves the
bridge keeps in flax's layout (``embedding``, the U-Net's ``u_bias`` /
``v_bias``) keep it on the last dim (:func:`channel_axis`).
"""

from __future__ import annotations

import contextlib

import torch


class _SteQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, scale):
        q = torch.clamp(torch.round(w / scale), -127, 127)
        return (q * scale).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        # exact pass-through: scale = amax / 127 keeps every value in range,
        # so no clip mask is needed
        return g, None


def fake_quant(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Symmetric per-channel int8 fake-quantization of ``w`` along
    ``axis``: ``scale = max(amax, 1e-8) / 127`` with ``amax`` over every
    other dim (no gradient through it), round half to even, clip to
    +-127, rescale. The backward is the identity."""
    axis = axis % w.dim()
    dims = tuple(d for d in range(w.dim()) if d != axis)
    amax = w.detach().abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    return _SteQuant.apply(w, scale)


def channel_axis(name: str) -> int:
    """The output-channel dim of the port's parameter ``name``: 0 for a
    ``weight`` (bridged from a flax kernel), the last for a leaf kept in
    flax's layout."""
    return 0 if name.rsplit(".", 1)[-1] == "weight" else -1


def quantizes(p: torch.Tensor) -> bool:
    """Whether the export (and so QAT) quantizes this leaf: floating, two
    or more dims."""
    return p.is_floating_point() and p.dim() >= 2


def fake_quant_params(params: dict) -> dict:
    """``name -> tensor`` with every leaf the export quantizes
    fake-quantized along :func:`channel_axis`; the other leaves (biases,
    norm scales) pass as they are."""
    return {name: fake_quant(p, channel_axis(name)) if quantizes(p) else p
            for name, p in params.items()}


@contextlib.contextmanager
def qat_weights(model: torch.nn.Module, enabled: bool = True):
    """Within the block ``model`` computes with fake-quantized copies of
    the parameters the export quantizes, on every path that reads them
    through their modules (the kernels' wrappers too); its ``Parameter``s
    -- the master weights -- are left as they are and take the gradient
    through the straight-through estimator. Keep the backward pass inside
    the block when blocks are recomputed (``remat``), so the recomputation
    sees the same weights."""
    if not enabled:
        yield
        return
    swapped = [(mod, leaf, p) for mod in model.modules()
               for leaf, p in mod._parameters.items()
               if p is not None and quantizes(p)]
    try:
        for mod, leaf, p in swapped:
            mod._parameters[leaf] = fake_quant(p, channel_axis(leaf))
        yield
    finally:
        for mod, leaf, p in swapped:
            mod._parameters[leaf] = p
