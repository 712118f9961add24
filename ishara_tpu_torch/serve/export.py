"""Export bundles and the serialized serving program (port of
``ishara_tpu/serve/export.py``).

An export bundle is a directory in the JAX package's own format, so a bundle
written by either package loads in both:

* ``config.json`` -- the full typed :class:`~ishara_tpu_torch.config.
  IsharaConfig`;
* ``params.msgpack`` -- the variables in flax's layout (``{"params",
  "batch_stats"}``, :func:`~ishara_tpu_torch.bridge.state_dict_to_flax`) as
  flax's ``serialization.to_bytes`` writes them, read and written here by
  the port's own codec (:mod:`ishara_tpu_torch.serve._msgpack`); floats
  rounded to bf16 by default, or every float leaf of two or more dimensions
  as int8 with per-output-channel scales (``quantized.json``);
* ``inference_args.json`` -- ``{"selected_columns": SEL_COLS}``, the column
  contract of the reference's serving scripts;
* ``stats.npz`` -- per-group normalization statistics.

:func:`load_engine` rebuilds the serving engine from a bundle.
:func:`export_serving_program` writes an engine's whole per-sequence program
(preprocess, encoder, decode, fallback) as a ``torch.export`` program with
its weights, the port's analogue of the reference's ``jax.export``
artifact; the fused block stacks stay in it as calls of their registered
operators, so on the card it launches the same kernels.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..bridge import flax_to_state_dict, state_dict_to_flax
from ..config import IsharaConfig
from ..data import landmarks as lm
from ..device import resolve_device
from ..models.encoder import build_model
from ..preprocess.pipeline import GroupStats
from ._msgpack import packb, unpackb


def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flax_variables(model_or_state_dict) -> dict:
    """A model or its ``state_dict`` -> flax variables (numpy f32 leaves),
    without an empty collection."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    return {k: v for k, v in state_dict_to_flax(sd).items() if v}


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cast_floats(tree, dtype: torch.dtype):
    """Every float leaf at ``dtype`` (round to nearest even), as torch
    tensors."""
    def cast(x):
        t = torch.as_tensor(x)
        return t.to(dtype) if t.is_floating_point() else t

    return _map_leaves(cast, tree)


def _quantize_tree(tree):
    """Symmetric per-output-channel int8 of every float leaf with two or
    more dimensions, in the flax layout (the channel is the last axis),
    as the reference's ``_quantize_tree`` computes it; each such leaf
    becomes ``{"q": int8, "scale": f32[out]}``, other leaves pass as they
    are."""
    def q(x):
        arr = np.asarray(x)
        if not (np.issubdtype(arr.dtype, np.floating) and arr.ndim >= 2):
            return x
        arr = arr.astype(np.float32)
        axes = tuple(range(arr.ndim - 1))
        scale = np.maximum(np.abs(arr).max(axis=axes), 1e-8) / 127.0
        qv = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        return {"q": qv, "scale": scale.astype(np.float32)}

    return _map_leaves(q, tree)


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _dequantize_tree(tree):
    """``{"q", "scale"}`` maps -> f32 ``q * scale``."""
    if _is_q(tree):
        return tree["q"].to(torch.float32) * tree["scale"].to(torch.float32)
    if isinstance(tree, dict):
        return {k: _dequantize_tree(v) for k, v in tree.items()}
    return tree


def export_model(directory: str | Path, config: IsharaConfig,
                 model_or_state_dict, stats: GroupStats | None = None,
                 half_precision: bool = True,
                 quantize_int8: bool = False) -> Path:
    """Write the bundle of a port model (or its ``state_dict``) to
    ``directory``. ``half_precision`` stores every float leaf as bf16 (the
    reference exports fp16); ``quantize_int8`` stores every float leaf of
    two or more dimensions as int8 with per-output-channel symmetric scales
    (dequantized to f32 on load). The bundle is the JAX package's: its
    ``load_bundle`` reads it, and :func:`load_bundle` reads the JAX
    package's."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    config.to_json(directory / "config.json")
    (directory / "inference_args.json").write_text(
        json.dumps({"selected_columns": lm.SEL_COLS}))
    variables = _flax_variables(model_or_state_dict)
    if quantize_int8:
        variables = _quantize_tree(variables)
        (directory / "quantized.json").write_text(json.dumps({"mode": "int8"}))
    elif half_precision:
        variables = _cast_floats(variables, torch.bfloat16)
    (directory / "params.msgpack").write_bytes(packb(variables))
    stats = stats or GroupStats.identity()
    np.savez(
        directory / "stats.npz",
        **{f"mean_{g}": _numpy(v) for g, v in stats.mean.items()},
        **{f"std_{g}": _numpy(v) for g, v in stats.std.items()},
    )
    return directory


def build_task_model(config: IsharaConfig, device=None) -> torch.nn.Module:
    """The eval-mode model of ``config.task`` on ``device`` (default
    ``cuda``; raises when no card is visible): "ctc" -> the encoder of
    ``config.model`` (:func:`~ishara_tpu_torch.models.encoder.
    build_model`); "translation" -> ``ASLTranslationModel`` at
    ``config.model``'s width, heads and dropout, with Conformer blocks for
    the ``conformer`` variant and Squeezeformer blocks otherwise."""
    mcfg = config.model
    if config.task == "translation":
        from ..models.seq2seq import build_translation_model

        return build_translation_model(
            device=device, num_classes=mcfg.num_classes,
            feature_dim=mcfg.dim, num_heads=mcfg.num_heads,
            dropout=mcfg.dropout,
            encoder_type=("conformer" if mcfg.variant == "conformer"
                          else "squeezeformer"))
    return build_model(mcfg, device=device)


def _check_structure(config: IsharaConfig, sd: dict) -> None:
    """Raise unless ``sd`` has exactly the names and shapes of the task
    model's ``state_dict`` (as flax's ``from_bytes`` against the model's
    template refuses another structure)."""
    with torch.device("meta"):
        want = build_task_model(config, device="meta").state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    shapes = [k for k in want if k in sd and sd[k].shape != want[k].shape]
    if missing or extra or shapes:
        raise ValueError(
            f"bundle does not match the {config.task} model of its config: "
            f"missing {missing[:5]}, unexpected {extra[:5]}, shapes differ "
            f"for {shapes[:5]}")


def load_bundle(directory: str | Path):
    """-> (config, state_dict, stats): the bundle's weights as the port's
    ``state_dict`` of f32 CPU tensors (bf16 leaves cast back, int8 leaves
    dequantized), its statistics as CPU tensors."""
    directory = Path(directory)
    config = IsharaConfig.from_json(directory / "config.json")
    tree = unpackb((directory / "params.msgpack").read_bytes())
    if (directory / "quantized.json").exists():
        tree = _dequantize_tree(tree)
    tree = _map_leaves(lambda t: t.numpy(),
                       _cast_floats(tree, torch.float32))
    sd = flax_to_state_dict(tree)
    _check_structure(config, sd)
    z = np.load(directory / "stats.npz")
    groups = sorted({k[5:] for k in z.files if k.startswith("mean_")})
    stats = GroupStats(
        mean={g: torch.from_numpy(z[f"mean_{g}"]) for g in groups},
        std={g: torch.from_numpy(z[f"std_{g}"]) for g in groups},
    )
    return config, sd, stats


def load_engine(directory: str | Path, device=None, **engine_kwargs):
    """Rebuild the batch-1 serving engine of a bundle on ``device`` (default
    ``cuda``; raises when no card is visible): an ``InferenceEngine`` for
    the CTC family, a ``TranslationEngine`` (at the config's
    ``frame_len``) for the encoder-decoder family. ``engine_kwargs`` go to
    the engine (``fused``, ``decode``, ...)."""
    config, sd, stats = load_bundle(directory)
    model = build_task_model(config, device="cpu")
    model.load_state_dict(sd, strict=True)
    if config.task == "translation":
        from .translation_engine import TranslationEngine

        return TranslationEngine(model, stats=stats,
                                 frame_len=config.model.frame_len,
                                 device=device, **engine_kwargs)
    from .engine import InferenceEngine

    return InferenceEngine(model, stats=stats, device=device,
                           **engine_kwargs)


class _ServingProgram(torch.nn.Module):
    """An engine's per-sequence program as a module for ``torch.export``."""

    def __init__(self, program):
        super().__init__()
        self.program = program

    def forward(self, raw, length):
        return self.program(raw, length)


def export_serving_program(directory: str | Path, engine) -> Path:
    """Serialize ``engine``'s per-sequence program ``(raw [max_raw_frames,
    276] f32, length int32 0-d) -> (ids, count)``, its weights included, as
    ``serving_program.pt2`` (``torch.export``) beside
    ``serving_program.json`` (the device type it was traced on and
    ``max_raw_frames``). The program runs on that device type only."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    dev = engine.device
    raw = torch.zeros((engine.max_raw_frames, lm.N_COLS),
                      dtype=torch.float32, device=dev)
    length = torch.tensor(engine.max_raw_frames, dtype=torch.int32,
                          device=dev)
    with torch.no_grad():
        exported = torch.export.export(_ServingProgram(engine.program_fn()),
                                       (raw, length), strict=False)
    torch.export.save(exported, directory / "serving_program.pt2")
    (directory / "serving_program.json").write_text(json.dumps({
        "platforms": [dev.type],
        "max_raw_frames": engine.max_raw_frames,
    }))
    return directory


def load_serving_program(directory: str | Path, device=None):
    """-> callable(raw [max_raw_frames, 276], length) -> (ids, count) from
    ``serving_program.pt2``, its inputs on ``device`` (default ``cuda``;
    raises when no card is visible). Raises RuntimeError when the program
    was traced on another device type: the caller then rebuilds the engine
    with :func:`load_engine`."""
    directory = Path(directory)
    meta = json.loads((directory / "serving_program.json").read_text())
    dev = resolve_device(device)
    if dev.type not in meta["platforms"]:
        raise RuntimeError(
            f"serialized for {meta['platforms']}, running on {dev.type}")
    from ..ops import fused_block  # noqa: F401  (registers the operators)

    exported = torch.export.load(directory / "serving_program.pt2")
    return exported.module()
