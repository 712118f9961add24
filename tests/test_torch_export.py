"""Export bundles between the JAX package and the port (PyTorch, CPU):
the port's msgpack codec against flax's, bundles written by JAX loaded by
the port and the port's loaded by JAX -- f32, bf16, int8 and a translation
bundle, weights bit for bit and the engines' ids exactly -- the int8 bundle
against the port's int8 serving weights, and the ``torch.export`` serving
program against its engine.

Small sizes: a hybrid 2 + 2 at dim 64 (``small_config``), the translation
model at dim 32 with 4 heads; weights from numpy seeds.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ishara_tpu import config as jcfg
from ishara_tpu.serve import export as jexport

import ishara_tpu_torch.config as tcfg
from ishara_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from ishara_tpu_torch.ops.fused_block import quantize_serving_weights
from ishara_tpu_torch.serve import _msgpack
from ishara_tpu_torch.serve import export as texport
from ishara_tpu_torch.serve.engine import InferenceEngine

from torch_port_helpers import (
    jax_model,
    port_model,
    raw_sequence,
    small_config,
    translation_models,
)

ROOT = Path(__file__).resolve().parents[1]
MAX_RAW = 64


def _requests():
    rng = np.random.default_rng(4)
    return [raw_sequence(rng, 12), raw_sequence(rng, 50),
            raw_sequence(rng, 90), raw_sequence(rng, 25, nan_hands=True),
            np.full((10, 276), np.nan, np.float32)]


def _port_config(jconfig):
    """The port's IsharaConfig of a JAX one (through its JSON)."""
    return tcfg.IsharaConfig.from_json(jconfig.to_json())


@pytest.fixture(scope="module")
def ctc():
    cfg = small_config("hybrid")
    model, variables = jax_model(cfg)
    v = jax.tree_util.tree_map(np.array, variables)
    v["params"]["classifier"]["kernel"] *= 8.0
    return jcfg.IsharaConfig(model=cfg), model, v


# --------------------------------------------------------------------------
# The codec
# --------------------------------------------------------------------------

def _tree(rng):
    return {
        "params": {
            "dense": {"kernel": rng.standard_normal((5, 7)).astype(np.float32),
                      "bias": np.zeros(7, np.float32)},
            "half": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
            "q": {"q": rng.integers(-127, 128, (9, 3)).astype(np.int8),
                  "scale": rng.random(3).astype(np.float32)},
            "ids": np.arange(300, dtype=np.int32),
            "empty": np.zeros((0, 4), np.float32),
            "wide": {f"k{i}": np.float32(i) for i in range(20)},
        },
        "step": np.int32(70000), "neg": np.int64(-40000), "lr": 2.5e-3,
        "count": 300, "small": -5, "name": "x" * 40, "flag": True,
        "none": None, "half_scalar": jnp.bfloat16(1.5),
    }


def _torch_leaves(tree):
    """The same tree as the port holds it: bf16 leaves as torch tensors,
    JAX arrays as numpy."""
    def leaf(x):
        if getattr(x, "dtype", None) == jnp.bfloat16:
            words = np.asarray(x).view(np.int16).copy()
            return torch.from_numpy(words).view(torch.bfloat16)
        return np.asarray(x) if isinstance(x, jax.Array) else x

    if isinstance(tree, dict):
        return {k: _torch_leaves(v) for k, v in tree.items()}
    return leaf(tree)


def _assert_restored(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_restored(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        w = np.asarray(want)
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=path)
        else:
            assert got.numpy().dtype == w.dtype, path
            np.testing.assert_array_equal(got.numpy(), w, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_codec_matches_flax_both_ways():
    tree = _tree(np.random.default_rng(0))
    blob = serialization.to_bytes(tree)
    assert _msgpack.packb(_torch_leaves(tree)) == blob
    _assert_restored(_msgpack.unpackb(blob),
                     serialization.msgpack_restore(blob))


def test_codec_chunked_arrays_match_flax(monkeypatch):
    """flax's chunked form (an array over its 2**30-byte limit, here a
    lowered limit on both sides) is read; writing it raises."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    a = np.random.default_rng(1).standard_normal((10, 7)).astype(np.float32)
    blob = serialization.to_bytes({"a": a, "b": {"c": a[:2]}})
    got = _msgpack.unpackb(blob)
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["b"]["c"].numpy(), a[:2])
    with pytest.raises(ValueError, match="chunked"):
        _msgpack.packb({"a": torch.from_numpy(a)})


def test_port_modules_import_no_msgpack_flax_or_h5py():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import ishara_tpu_torch\n"
        "for m in pkgutil.walk_packages(ishara_tpu_torch.__path__,\n"
        "                               'ishara_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]\n"
        "    in ('msgpack', 'flax', 'jax', 'h5py', 'tensorflow',\n"
        "        'ishara_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# --------------------------------------------------------------------------
# Bundles, JAX -> port and port -> JAX
# --------------------------------------------------------------------------

FORMS = {"f32": dict(half_precision=False), "bf16": dict(),
         "int8": dict(quantize_int8=True)}


def _flax_f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("form", list(FORMS))
def test_jax_bundle_loads_into_the_port(ctc, tmp_path, form):
    """Weights bit-equal to JAX's ``load_bundle`` after bridging; the
    port's ``load_engine`` (unfused and fused) gives JAX's ``load_engine``
    ids."""
    config, _, v = ctc
    jexport.export_model(tmp_path, config, v, **FORMS[form])
    _, jv, jstats = jexport.load_bundle(tmp_path)
    pconfig, sd, stats = texport.load_bundle(tmp_path)
    assert pconfig.to_json() == config.to_json()
    _assert_state_dicts_equal(sd, flax_to_state_dict(_flax_f32(jv)))
    for g in jstats.mean:
        np.testing.assert_array_equal(stats.mean[g].numpy(), jstats.mean[g])
    want = jexport.load_engine(tmp_path, max_raw_frames=MAX_RAW)
    engines = [texport.load_engine(tmp_path, device="cpu",
                                   max_raw_frames=MAX_RAW)]
    if form == "bf16":
        engines.append(texport.load_engine(tmp_path, device="cpu",
                                           max_raw_frames=MAX_RAW,
                                           fused=True))
    for raw in _requests():
        ids, count = want(raw)
        for eng in engines:
            got_ids, got_count = eng(raw)
            assert got_count == count
            np.testing.assert_array_equal(got_ids, ids)


@pytest.mark.parametrize("form", list(FORMS))
def test_port_bundle_loads_into_jax(ctc, tmp_path, form):
    """JAX's ``load_bundle`` (``from_bytes`` against its model's template
    for f32 / bf16) reads the port's bundle into the source weights: exact
    at f32, bf16-rounded at bf16, and the int8 integers and scales are
    ``_quantize_tree``'s bit for bit."""
    config, _, v = ctc
    model = port_model(config.model, v)
    texport.export_model(tmp_path, _port_config(config), model,
                         **FORMS[form])
    assert (tmp_path / "config.json").read_text() == config.to_json()
    assert json.loads((tmp_path / "inference_args.json").read_text()) == \
        {"selected_columns": jexport.SEL_COLS}
    _, jv, _ = jexport.load_bundle(tmp_path)
    source = _flax_f32(v)
    if form == "int8":
        raw = serialization.msgpack_restore(
            (tmp_path / "params.msgpack").read_bytes())
        want = jexport._quantize_tree(source)
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(raw)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            assert pa == pb
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        source = jax.tree_util.tree_map(
            np.asarray, jexport._dequantize_tree(want))
    elif form == "bf16":
        source = _flax_f32(jexport._cast_floats(source, jnp.bfloat16))
    got = _flax_f32(jv)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(source)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(source)):
        np.testing.assert_array_equal(a, b)


def test_int8_bundle_carries_the_int8_engines_weights(ctc, tmp_path):
    """The int8 bundle (flax layout, per last axis) and the port's
    ``quantize_serving_weights`` (``fused="int8"``; torch layout, per
    dim 0) hold the same integers and scales, leaf for leaf."""
    config, _, v = ctc
    model = port_model(config.model, v)
    texport.export_model(tmp_path, _port_config(config), model,
                         quantize_int8=True)
    raw = _msgpack.unpackb((tmp_path / "params.msgpack").read_bytes())

    def part(tree, name):
        """The bundle's tree with each int8 leaf replaced by its integers
        (as f32) or by its scales shaped to bridge like its kernel."""
        if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
            q = tree["q"].numpy().astype(np.float32)
            if name == "q":
                return q
            return tree["scale"].numpy().reshape((1,) * (q.ndim - 1) + (-1,))
        if isinstance(tree, dict):
            return {k: part(t, name) for k, t in tree.items()}
        return tree.numpy()

    ints = flax_to_state_dict(part(raw, "q"))
    scales = flax_to_state_dict(part(raw, "scale"))
    qsd = quantize_serving_weights(model.state_dict())
    assert set(ints) == set(qsd)
    n = 0
    for key, w in qsd.items():
        if isinstance(w, dict):
            torch.testing.assert_close(ints[key], w["q"].to(torch.float32),
                                       rtol=0, atol=0, msg=key)
            torch.testing.assert_close(scales[key].reshape(-1), w["scale"],
                                       rtol=0, atol=0, msg=key)
            n += 1
        else:
            torch.testing.assert_close(ints[key], w.to(ints[key].dtype),
                                       rtol=0, atol=0, msg=key)
    assert n > 20


@pytest.mark.parametrize("variant", ["squeezeformer", "conformer", "hybrid",
                                     "conv_hybrid", "conv_transformer",
                                     "parallel_branches",
                                     "squeezeformer_unet"])
def test_bridge_gives_the_jax_template_key_set(variant):
    """``state_dict_to_flax`` of a whole port model has exactly the names
    and shapes of the JAX model's ``init`` tree (what ``from_bytes`` needs
    to restore a port bundle)."""
    cfg = small_config(variant)
    _, v = jax_model(cfg)
    back = {k: t for k, t in state_dict_to_flax(
        port_model(cfg, v).state_dict()).items() if t}
    want = jax.tree_util.tree_map(np.shape, _flax_f32(v))
    assert jax.tree_util.tree_map(np.shape, back) == want


@pytest.mark.parametrize("variant,extra", [
    ("parallel_branches", {}), ("squeezeformer_unet", {}),
    ("hybrid", dict(causal=True, attn_context=9)),
])
def test_new_family_bundles_cross_both_ways(tmp_path, variant, extra):
    """A bundle of each new family and of a causal hybrid, both ways: JAX's
    f32 bundle loads into the port bit for bit and its ``load_engine``
    (unfused, as a causal model or a new family requires; ``fused=True``
    raises ValueError) gives JAX's ids; the port's bf16 bundle loads into
    JAX's ``load_bundle`` as the bf16-rounded weights."""
    from ishara_tpu.config import IsharaConfig

    cfg = small_config(variant, frame_len=24, **extra)
    _, v = jax_model(cfg)
    v = jax.tree_util.tree_map(np.array, v)
    head = v["params"]["unet"]["fc"] if "unet" in v["params"] \
        else v["params"]["classifier"]
    head["kernel"] *= 8.0
    config = IsharaConfig(model=cfg)
    jexport.export_model(tmp_path / "jax", config, v, half_precision=False)
    pconfig, sd, _ = texport.load_bundle(tmp_path / "jax")
    assert pconfig.model.causal == cfg.causal
    _assert_state_dicts_equal(sd, flax_to_state_dict(_flax_f32(v)))
    want = jexport.load_engine(tmp_path / "jax", max_raw_frames=MAX_RAW)
    got = texport.load_engine(tmp_path / "jax", device="cpu",
                              max_raw_frames=MAX_RAW)
    assert got.model.cfg.causal == cfg.causal
    for raw in _requests():
        ids, count = want(raw)
        got_ids, got_count = got(raw)
        assert got_count == count
        np.testing.assert_array_equal(got_ids, ids)
    with pytest.raises(ValueError, match="fused"):
        texport.load_engine(tmp_path / "jax", device="cpu", fused=True)
    texport.export_model(tmp_path / "port", _port_config(config),
                         port_model(cfg, v))
    _, jv, _ = jexport.load_bundle(tmp_path / "port")
    source = _flax_f32(jexport._cast_floats(_flax_f32(v), jnp.bfloat16))
    got_tree = _flax_f32(jv)
    assert jax.tree_util.tree_structure(got_tree) == \
        jax.tree_util.tree_structure(source)
    for a, b in zip(jax.tree_util.tree_leaves(got_tree),
                    jax.tree_util.tree_leaves(source)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("encoder_type", ["squeezeformer", "conformer"])
def test_translation_bundles_cross_both_ways(tmp_path, encoder_type):
    """A JAX translation bundle loads into the port bit-equal and (with
    Squeezeformer blocks) into the port's ``TranslationEngine`` with JAX's
    tokens; the port's translation bundle loads into JAX bit-equal (the
    bridge's key set is the JAX template's)."""
    jm, v, pm, *_ = translation_models(encoder_type, dim=32, heads=4,
                                       classes=30, T=16, seed=2)
    variant = "conformer" if encoder_type == "conformer" else "hybrid"
    config = jcfg.IsharaConfig(task="translation", model=jcfg.EncoderConfig(
        dim=32, num_heads=4, frame_len=16, num_classes=30, variant=variant))
    jexport.export_model(tmp_path / "jax", config, v, half_precision=False)
    _, jv, _ = jexport.load_bundle(tmp_path / "jax")
    _, sd, _ = texport.load_bundle(tmp_path / "jax")
    _assert_state_dicts_equal(sd, flax_to_state_dict(_flax_f32(jv)))
    if encoder_type == "squeezeformer":       # one JAX engine compile
        kw = dict(max_raw_frames=MAX_RAW, max_out=10)
        want = jexport.load_engine(tmp_path / "jax", **kw)
        got = texport.load_engine(tmp_path / "jax", device="cpu", **kw)
        for raw in _requests():
            tokens, conf = want(raw)
            got_tokens, got_conf = got(raw)
            np.testing.assert_array_equal(got_tokens, tokens)
            np.testing.assert_allclose(got_conf, conf, rtol=1e-5,
                                       atol=1e-6)

    texport.export_model(tmp_path / "port", _port_config(config), pm,
                         half_precision=False)
    _, jv2, _ = jexport.load_bundle(tmp_path / "port")
    assert jax.tree_util.tree_structure(_flax_f32(jv2)) == \
        jax.tree_util.tree_structure(_flax_f32(v))
    for a, b in zip(jax.tree_util.tree_leaves(_flax_f32(jv2)),
                    jax.tree_util.tree_leaves(_flax_f32(v))):
        np.testing.assert_array_equal(a, b)


def test_bundle_of_another_structure_is_refused(ctc, tmp_path):
    config, _, v = ctc
    model = port_model(config.model, v)
    bigger = dataclasses.replace(_port_config(config).model,
                                 num_conform_blocks=3)
    texport.export_model(tmp_path, tcfg.IsharaConfig(model=bigger), model)
    with pytest.raises(ValueError, match="missing"):
        texport.load_bundle(tmp_path)


# --------------------------------------------------------------------------
# The torch.export serving program
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(fused=True),
                                dict(decode="beam", beam_width=4,
                                     beam_top_k=6),
                                dict(fused=True, decode="beam", beam_width=4,
                                     beam_top_k=6)],
                         ids=["greedy", "fused", "beam", "fused_beam"])
def test_serving_program_round_trip(tmp_path, kw):
    """A hybrid 1 + 1 at dim 32 (tracing time grows with the model's
    ops)."""
    cfg = small_config("hybrid", dim=32, num_squeeze_blocks=1,
                       num_conform_blocks=1, frame_len=16)
    engine = InferenceEngine(port_model(cfg, jax_model(cfg)[1]),
                             max_raw_frames=MAX_RAW, device="cpu", **kw)
    texport.export_serving_program(tmp_path, engine)
    assert json.loads((tmp_path / "serving_program.json").read_text()) == \
        {"platforms": ["cpu"], "max_raw_frames": MAX_RAW}
    program = texport.load_serving_program(tmp_path, device="cpu")
    for raw in _requests():
        ids, count = engine(raw)
        buf = np.zeros((MAX_RAW, 276), np.float32)
        n = min(len(raw), MAX_RAW)
        buf[:n] = raw[:n]
        got_ids, got_count = program(torch.from_numpy(buf),
                                     torch.tensor(max(n, 1),
                                                  dtype=torch.int32))
        assert int(got_count) == count
        np.testing.assert_array_equal(got_ids.numpy(), ids)


def test_serving_program_refuses_another_platform(ctc, tmp_path):
    config, _, v = ctc
    engine = InferenceEngine(port_model(config.model, v),
                             max_raw_frames=MAX_RAW, device="cpu", fused=True)
    texport.export_serving_program(tmp_path, engine)
    meta = tmp_path / "serving_program.json"
    meta.write_text(json.dumps({"platforms": ["cuda"],
                                "max_raw_frames": MAX_RAW}))
    with pytest.raises(RuntimeError, match="serialized for"):
        texport.load_serving_program(tmp_path, device="cpu")
