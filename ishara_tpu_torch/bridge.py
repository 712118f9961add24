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
* ``squeezeformer_{i}`` / ``conformer_{i}`` / ``transformer_{i}`` become
  ``squeezeformer.{i}`` / ``conformer.{i}`` / ``transformer.{i}``
  (``nn.ModuleList`` entries), and the conv families' ``conv_squeeze{i}_{j}``
  / ``conv_conform{i}_{j}`` / ``conv_t{i}_{j}`` become ``conv_squeeze.{i}.{j}``
  / ``conv_conform.{i}.{j}`` / ``conv_t.{i}.{j}``;
* the translation model's ``squeezeformer_layers_{i}`` / ``decoder_layers_{i}``
  and the U-Net's ``block_{i}`` become ``squeezeformer_layers.{i}`` /
  ``decoder_layers.{i}`` / ``block.{i}``; a flax Conv2D kernel ``[kh, kw,
  in/g, out]`` becomes ``Conv2d.weight`` ``[out, in/g, kh, kw]``, and the
  relative attention's ``u_bias`` / ``v_bias`` ``[H, Dh]`` keep their names
  and layout; a flax
  ``Embed``'s ``embedding`` ``[num, dim]`` keeps its name and layout, and a
  module's own ``scale`` leaf (the RoPE blocks' shared residual scale, which
  sits beside sub-modules, unlike a norm's) keeps its name.

It works on any subtree, so a single block's variables bridge to that
block's ``state_dict``, and on any tree shaped like ``params`` -- gradients,
or an optimizer's moments: ``flax_to_state_dict({"params": mu})`` names
optax's ``mu`` leaves as the port names its parameters.
:func:`state_dict_to_flax` is the reverse map, and :func:`load_train_state`
carries flax ``params``, ``batch_stats`` and optax moments into a port
``TrainState``.

:func:`squeeze_block_args`, :func:`conformer_block_args`,
:func:`transformer_block_args` and :func:`conv1d_block_args` go from the
port's ``state_dict`` to the per-block argument tuples of the fused kernels,
in the order of the reference's ``_squeeze_args`` / ``_conformer_args`` /
``_transformer_args`` / ``_conv1d_args``. With ``dt == "int8"`` the
``state_dict`` must be a quantized one and every matmul leaf becomes a pair
(q int8 ``[in, out]``, scale f32 ``[out]``); depthwise and ECA kernels are
dequantized to f32.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}
# parameters that keep their flax name and layout
_AS_IS = ("embedding", "u_bias", "v_bias")


def _module_name(key: str) -> str:
    m = re.fullmatch(r"(squeezeformer|conformer|transformer|"
                     r"squeezeformer_layers|decoder_layers|block)_(\d+)", key)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"conv_(squeeze|conform|t)(\d+)_(\d+)", key)
    if m:                     # conv stack i, Conv1DBlock j
        return f"conv_{m.group(1)}.{m.group(2)}.{m.group(3)}"
    return key


def _convert_kernel(a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:                      # Dense [in, out] -> [out, in]
        return a.T
    if a.ndim == 3:                      # Conv [K, in/g, out] -> [out, in/g, K]
        return a.transpose(2, 1, 0)
    if a.ndim == 4:    # Conv2D [kh, kw, in/g, out] -> [out, in/g, kh, kw]
        return a.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def _walk(tree, prefix, out, bn_modules):
    for key, val in tree.items():
        if isinstance(val, dict):
            _walk(val, prefix + _module_name(key) + ".", out, bn_modules)
            continue
        a = np.asarray(val, dtype=np.float32)
        if key == "kernel":
            name, a = "weight", _convert_kernel(a)
        elif key in _AS_IS:     # flax Embed [num, dim], u / v biases [H, Dh]
            name = key
        elif key == "scale" and any(isinstance(v, dict)
                                    for v in tree.values()):
            name = "scale"     # a module's own parameter, not a norm's
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


_LEAF_BACK = {v: k for k, v in _LEAF.items()} | {"scale": "scale"} \
    | {k: k for k in _AS_IS}
_KERNEL_BACK = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flax_module_name(parts: list[str]) -> list[str]:
    """Port module path -> flax path: ``squeezeformer.{i}`` ->
    ``squeezeformer_{i}`` (and so ``decoder_layers.{i}``, ``block.{i}``),
    ``conv_squeeze.{i}.{j}`` -> ``conv_squeeze{i}_{j}``."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p in ("squeezeformer", "conformer", "transformer",
                 "squeezeformer_layers", "decoder_layers", "block") \
                and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        elif p in ("conv_squeeze", "conv_conform", "conv_t") \
                and i + 2 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{p}{parts[i + 1]}_{parts[i + 2]}")
            i += 3
        else:
            out.append(p)
            i += 1
    return out


def state_dict_to_flax(sd: dict) -> dict:
    """The port's ``state_dict`` (or any dict with its names, such as
    ``TrainState.param_dict()``) -> the JAX package's variables as nested
    dicts of numpy arrays: ``{"params": ..., "batch_stats": ...}``."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, val in sd.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = val.detach().to(torch.float32).cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            tree, name = out["batch_stats"], _LEAF_BACK[leaf]
        elif leaf == "weight" and a.ndim >= 2:
            tree, name = out["params"], "kernel"
            a = a.transpose(_KERNEL_BACK[a.ndim])
        else:
            tree, name = out["params"], _LEAF_BACK[leaf]
        for part in _flax_module_name(path):
            tree = tree.setdefault(part, {})
        tree[name] = np.ascontiguousarray(a)
    return out


def load_train_state(state, variables: dict, mu: dict | None = None,
                     nu: dict | None = None, count: int = 0) -> None:
    """Carry the JAX package's ``variables`` (``params`` + ``batch_stats``)
    and, when given, optax's Adam moments ``mu`` / ``nu`` (trees shaped like
    ``params``) and their update ``count`` into the port's ``TrainState``
    ``state``, in place. The slow weights are reset to the parameters, as
    ``TrainState.create`` leaves them."""
    state.model.load_state_dict(flax_to_state_dict(variables))
    state.slow_params.copy_(state.params)
    for flat, tree in ((state.opt_state["mu"], mu),
                       (state.opt_state["nu"], nu)):
        if tree is None:
            continue
        named = flax_to_state_dict({"params": tree})
        for name, sl in state.slices.items():
            flat[sl] = named[name].reshape(-1).to(flat.device)
    state.opt_state["count"].fill_(count)
    state.opt_state["schedule_count"].fill_(count)


def is_quantized(v) -> bool:
    """An int8 entry of a quantized ``state_dict``: {"q": int8 in the
    weight's layout, "scale": f32 [out]} (see
    ``ops.fused_block.quantize_serving_weights``)."""
    return isinstance(v, dict) and set(v) == {"q", "scale"}


def dequantize(v) -> torch.Tensor:
    """f32 value of a ``state_dict`` entry, int8 or float."""
    if is_quantized(v):
        q, s = v["q"], v["scale"]
        return q.to(torch.float32) * s.reshape((-1,) + (1,) * (q.dim() - 1))
    return v.to(torch.float32)


def _mat(sd, key, dt):
    """Linear.weight [out, in] or 1x1 Conv1d.weight [out, in, 1] -> the
    kernel layout [in, out] at the storage dtype; at ``dt == "int8"`` the
    pair (q int8 [in, out], scale f32 [out]) of a quantized entry."""
    w = sd[key]
    if dt == "int8":
        if not is_quantized(w):
            raise ValueError(
                f'compute_dtype="int8" requires weights quantized with '
                f"quantize_serving_weights (the export int8 scheme); "
                f"{key} is not")
        q = w["q"][:, :, 0] if w["q"].dim() == 3 else w["q"]
        return (q.T.contiguous(), w["scale"].to(torch.float32).contiguous())
    w = dequantize(w)
    if w.dim() == 3:
        w = w[:, :, 0]
    return w.T.to(dt).contiguous()


def _vec(sd, key):
    return sd[key].to(torch.float32).contiguous()


def _dw(sd, key):
    """Depthwise Conv1d.weight [C, 1, K] -> [K, C] f32 (an int8 entry is
    dequantized here, as the reference does on load)."""
    return dequantize(sd[key])[:, 0, :].T.contiguous()


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


def transformer_block_args(sd, prefix: str, dt) -> tuple:
    """A TransformerBlock's kernel arguments (reference
    ``_transformer_args`` order)."""
    def m(k):
        return _mat(sd, prefix + k, dt)

    def v(k):
        return _vec(sd, prefix + k)

    return (
        v("ln1.weight"), v("ln1.bias"),
        m("mha.qkv.weight"), m("mha.proj.weight"),
        v("ln2.weight"), v("ln2.bias"),
        m("fc1.weight"), m("fc2.weight"),
    )


def conv1d_block_args(sd, prefix: str, dt) -> tuple:
    """A Conv1DBlock's kernel arguments (reference ``_conv1d_args`` order),
    BN running stats included; the ECA window is [k] f32."""
    def m(k):
        return _mat(sd, prefix + k, dt)

    def v(k):
        return _vec(sd, prefix + k)

    return (
        m("expand.weight"), v("expand.bias"),
        _dw(sd, prefix + "dw.dwconv.weight"),
        v("bn.weight"), v("bn.bias"),
        v("bn.running_mean"), v("bn.running_var"),
        dequantize(sd[prefix + "eca.conv.weight"])[0, 0, :].contiguous(),
        m("project.weight"), v("project.bias"),
    )
