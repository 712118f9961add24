"""Weights between the JAX package and the port.

:func:`flax_to_state_dict` turns the JAX package's variables -- a nested dict
of numpy arrays with ``params`` and ``batch_stats``, as ``model.init``
returns them or ``params.msgpack`` holds them -- into the port's
``state_dict``:

* a flax Dense kernel ``[in, out]`` becomes ``Linear.weight`` ``[out, in]``;
* a flax Conv kernel ``[K, in/g, out]`` becomes ``Conv1d.weight``
  ``[out, in/g, K]``;
* LayerNorm / BatchNorm ``scale`` becomes ``weight``; BatchNorm
  ``batch_stats`` ``mean`` / ``var`` become ``running_mean`` /
  ``running_var`` (and ``num_batches_tracked`` is added as 0);
* ``squeezeformer_{i}`` / ``conformer_{i}`` become ``squeezeformer.{i}`` /
  ``conformer.{i}`` (``nn.ModuleList`` entries).

It works on any subtree, so a single block's variables bridge to that
block's ``state_dict``.

:func:`squeeze_block_args` and :func:`conformer_block_args` go from the
port's ``state_dict`` to the per-block argument tuples of the fused kernels,
in the order of the reference's ``_squeeze_args`` / ``_conformer_args``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _module_name(key: str) -> str:
    m = re.fullmatch(r"(squeezeformer|conformer)_(\d+)", key)
    return f"{m.group(1)}.{m.group(2)}" if m else key


def _convert_kernel(a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:                      # Dense [in, out] -> [out, in]
        return a.T
    if a.ndim == 3:                      # Conv [K, in/g, out] -> [out, in/g, K]
        return a.transpose(2, 1, 0)
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def _walk(tree, prefix, out, bn_modules):
    for key, val in tree.items():
        if isinstance(val, dict):
            _walk(val, prefix + _module_name(key) + ".", out, bn_modules)
            continue
        a = np.asarray(val, dtype=np.float32)
        if key == "kernel":
            name, a = "weight", _convert_kernel(a)
        elif key in _LEAF:
            name = _LEAF[key]
            if key in ("mean", "var"):
                bn_modules.add(prefix)
        else:
            raise ValueError(f"unexpected leaf {prefix}{key}")
        out[prefix + name] = torch.from_numpy(np.ascontiguousarray(a))


def flax_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """JAX package variables (numpy leaves) -> the port's ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    bn_modules: set[str] = set()
    _walk(variables.get("params", {}), "", out, bn_modules)
    _walk(variables.get("batch_stats", {}), "", out, bn_modules)
    for prefix in bn_modules:
        out[prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def _mat(sd, key, dt):
    """Linear.weight [out, in] or 1x1 Conv1d.weight [out, in, 1] -> the
    kernel layout [in, out] at the storage dtype."""
    w = sd[key]
    if w.dim() == 3:
        w = w[:, :, 0]
    return w.T.to(dt).contiguous()


def _vec(sd, key):
    return sd[key].to(torch.float32).contiguous()


def _dw(sd, key):
    """Depthwise Conv1d.weight [C, 1, K] -> [K, C] f32."""
    return sd[key][:, 0, :].T.to(torch.float32).contiguous()


def squeeze_block_args(sd, prefix: str, dt) -> tuple[torch.Tensor, ...]:
    """A SqueezeformerBlock's kernel arguments (reference ``_squeeze_args``
    order) from ``sd`` entries under ``prefix``; matmul weights at ``dt``."""
    def m(k):
        return _mat(sd, prefix + k, dt)

    def v(k):
        return _vec(sd, prefix + k)

    return (
        v("norm1.weight"), v("norm1.bias"),
        m("ffn1.fc1.weight"), v("ffn1.fc1.bias"),
        m("ffn1.fc2.weight"), v("ffn1.fc2.bias"),
        v("norm2.weight"), v("norm2.bias"),
        m("mha.qkv.weight"), m("mha.proj.weight"),
        v("conv.norm.weight"), v("conv.norm.bias"),
        m("conv.pw1.weight"), v("conv.pw1.bias"),
        _dw(sd, prefix + "conv.dw.dwconv.weight"),
        m("conv.pw2.weight"), v("conv.pw2.bias"),
        m("conv.se.fc1.weight"), v("conv.se.fc1.bias"),
        m("conv.se.fc2.weight"), v("conv.se.fc2.bias"),
        v("norm3.weight"), v("norm3.bias"),
        m("ffn2.fc1.weight"), v("ffn2.fc1.bias"),
        m("ffn2.fc2.weight"), v("ffn2.fc2.bias"),
    )


def conformer_block_args(sd, prefix: str, dt) -> tuple[torch.Tensor, ...]:
    """A ConformerBlock's kernel arguments (reference ``_conformer_args``
    order), BN running stats included."""
    def m(k):
        return _mat(sd, prefix + k, dt)

    def v(k):
        return _vec(sd, prefix + k)

    return (
        v("ln1.weight"), v("ln1.bias"),
        m("ffn1.fc1.weight"), v("ffn1.fc1.bias"),
        m("ffn1.fc2.weight"), v("ffn1.fc2.bias"),
        m("mha.qkv.weight"), m("mha.proj.weight"),
        m("conv.pw1.weight"), v("conv.pw1.bias"),
        _dw(sd, prefix + "conv.dw.weight"), v("conv.dw.bias"),
        v("conv.bn.weight"), v("conv.bn.bias"),
        v("conv.bn.running_mean"), v("conv.bn.running_var"),
        m("conv.pw2.weight"), v("conv.pw2.bias"),
        v("conv.ln.weight"), v("conv.ln.bias"),
        v("ln2.weight"), v("ln2.bias"),
        m("ffn2.fc1.weight"), v("ffn2.fc1.bias"),
        m("ffn2.fc2.weight"), v("ffn2.fc2.bias"),
    )
