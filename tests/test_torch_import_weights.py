"""Weight import into the port (``ishara_tpu_torch.serve.import_weights``)
against Keras and against the JAX package's import of the same files: the
Keras stem through ``import_by_structure`` (output parity with Keras), the
reference ``get_model`` families through ``import_reference_h5`` (port
logits within the reference tests' 1e-4 of Keras's, the imported weights
bit-equal to JAX's import), a TFLite smoke test and ``diff_variables``.
"""

import dataclasses

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

from ishara_tpu.config import EncoderConfig  # noqa: E402
from ishara_tpu.models.encoder import build_model as jbuild  # noqa: E402
from ishara_tpu.serve import import_weights as jiw  # noqa: E402

import ishara_tpu_torch.config as tcfg  # noqa: E402
from ishara_tpu_torch.bridge import state_dict_to_flax  # noqa: E402
from ishara_tpu_torch.models.encoder import build_model  # noqa: E402
from ishara_tpu_torch.serve import import_weights as tiw  # noqa: E402


class Stem(nn.Module):
    dim: int = 16

    @nn.compact
    def __call__(self, x, training=False):
        x = nn.Dense(self.dim, use_bias=False, name="stem_conv")(x)
        x = nn.BatchNorm(use_running_average=not training, momentum=0.95,
                         epsilon=1e-3, name="stem_bn")(x)
        return nn.Dense(8, name="classifier")(x)


@pytest.fixture(scope="module")
def keras_stem(tmp_path_factory):
    tf.keras.utils.set_random_seed(0)
    model = tf.keras.Sequential([
        tf.keras.layers.Input((12, 20)),
        tf.keras.layers.Dense(16, use_bias=False, name="stem_conv"),
        tf.keras.layers.BatchNormalization(momentum=0.95, name="stem_bn"),
        tf.keras.layers.Dense(8, name="classifier"),
    ])
    rng = [np.random.default_rng(i) for i in range(4)]
    model.get_layer("stem_bn").set_weights([
        rng[0].standard_normal(16).astype(np.float32),
        rng[1].standard_normal(16).astype(np.float32),
        rng[2].standard_normal(16).astype(np.float32) * 0.1,
        np.abs(rng[3].standard_normal(16)).astype(np.float32) + 0.5,
    ])
    path = tmp_path_factory.mktemp("h5") / "model.weights.h5"
    model.save_weights(path)
    variables = jax.tree_util.tree_map(np.asarray, Stem().init(
        jax.random.key(0), jnp.zeros((1, 12, 20))))
    return model, path, variables


def _stem_forward(v, x):
    """The stem in torch on flax-layout weights: Dense, BatchNorm (eps
    1e-3), Dense."""
    p, s = v["params"], v["batch_stats"]["stem_bn"]
    t = {k: torch.from_numpy(np.asarray(a, np.float32)) for k, a in (
        ("w1", p["stem_conv"]["kernel"]), ("g", p["stem_bn"]["scale"]),
        ("b", p["stem_bn"]["bias"]), ("m", s["mean"]), ("var", s["var"]),
        ("w2", p["classifier"]["kernel"]), ("b2", p["classifier"]["bias"]))}
    h = torch.from_numpy(x) @ t["w1"]
    h = (h - t["m"]) * torch.rsqrt(t["var"] + 1e-3) * t["g"] + t["b"]
    return (h @ t["w2"] + t["b2"]).numpy()


def _assert_trees_equal(got, want):
    fa = jax.tree_util.tree_flatten_with_path(got)[0]
    fb = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, a), (_, b) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32),
                                      err_msg=jax.tree_util.keystr(p))


def test_h5_import_by_structure_matches_keras_and_jax(keras_stem):
    model_tf, path, variables = keras_stem
    sources = tiw.load_h5_weights(path)
    assert [n for n, _ in sources] == [n for n, _ in
                                       jiw.load_h5_weights(path)]
    imported, report = tiw.import_by_structure(sources, variables)
    want, want_report = jiw.import_by_structure(sources, variables)
    assert report == want_report
    assert not report["unfilled_targets"], report
    _assert_trees_equal(imported, want)
    x = np.random.default_rng(5).standard_normal((2, 12, 20)).astype(
        np.float32)
    np.testing.assert_allclose(_stem_forward(imported, x),
                               model_tf(x, training=False).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_diff_variables_matches_jax(keras_stem):
    _, path, variables = keras_stem
    imported, _ = tiw.import_by_structure(tiw.load_h5_weights(path),
                                          variables)
    diffs = tiw.diff_variables(variables, imported)
    assert diffs == jiw.diff_variables(variables, imported)
    assert len(diffs) >= 7 and any(d > 0 for d in diffs.values())


def test_tflite_import_matches_jax(keras_stem, tmp_path):
    model_tf, _, variables = keras_stem
    blob = tf.lite.TFLiteConverter.from_keras_model(model_tf).convert()
    p = tmp_path / "m.tflite"
    p.write_bytes(blob)
    sources = tiw.load_tflite_weights(p)
    assert len(sources) >= 3
    got, report = tiw.import_by_structure(sources, variables,
                                          source_format="tflite")
    want, want_report = jiw.import_by_structure(sources, variables,
                                                source_format="tflite")
    assert report == want_report
    _assert_trees_equal(got, want)


CONFIGS = {
    "hybrid": dict(variant="hybrid", dim=64, num_squeeze_blocks=1,
                   num_conform_blocks=1, num_heads=4, expansion_factor=2,
                   transformer_kernel_size=15, dropout=0.2, top_mult=1,
                   frame_len=64),
    "conv_hybrid": dict(variant="conv_hybrid", dim=64, num_squeeze_blocks=1,
                        num_conform_blocks=1, kernel_sizes=(11, 5, 3),
                        num_conv_per_block=3, num_heads=4,
                        expansion_factor=2, transformer_kernel_size=15,
                        dropout=0.2, top_mult=2, frame_len=64),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_h5_import_matches_keras_and_jax(tmp_path, name):
    """A reference ``get_model`` checkpoint (``tests/keras_reference.py``,
    legacy h5) into a port model's ``state_dict``: no unfilled target, the
    weights bit-equal to JAX's import of the same file, the port's logits
    within 1e-4 of Keras's."""
    import keras_reference as kref

    jcfg = EncoderConfig(**CONFIGS[name])
    tf.keras.utils.set_random_seed(7)
    kmodel = kref.build_reference_model(jcfg)
    kref.perturb_batch_norms(kmodel, seed=3)
    path = tmp_path / "ref.h5"
    kmodel.save(path)

    x = np.random.default_rng(11).standard_normal(
        (2, jcfg.frame_len, jcfg.input_dim)).astype(np.float32)
    x[0, 40:] = 0.0       # padding frames: the Masking(0.0) contract
    x[1, 25:] = 0.0

    cfg = tcfg.EncoderConfig(**dataclasses.asdict(jcfg))
    model = build_model(cfg, device="cpu")
    sd, report = tiw.import_reference_h5(path, model.state_dict(), cfg)
    assert report["unfilled_targets"] == [] and not \
        report["unmatched_sources"]
    model.load_state_dict(sd)

    jmodel = jbuild(jcfg)
    jv = jmodel.init(jax.random.key(0), jnp.asarray(x))
    want, _ = jiw.import_reference_h5(path, jv, jcfg)
    _assert_trees_equal(state_dict_to_flax(sd), want)

    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = kmodel(x, training=False).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-4, np.max(np.abs(got - ref))
