"""``python -m ishara_tpu_torch`` (``ishara_tpu_torch/__main__.py``) in
subprocesses on the CPU (``--device cpu``), mirroring the JAX package's
CLI tests (``tests/test_export_cli.py``): help, the train smoke, train ->
export -> infer for both families on the synthetic corpus, ``infer`` on a
bundle written by the JAX package's ``export_model`` printing what the JAX
package's own ``infer`` prints, ``eval``, and ``bench`` refusing. The
children run with ``jax`` and ``ishara_tpu`` made unimportable, so a run
that reached either would fail.

The models are small (``--config``: hybrid 1 + 1 at dim 32, T 32): the
default configuration's step takes about a minute on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from ishara_tpu.__main__ import main as j_main
from ishara_tpu.config import EncoderConfig as JEncoderConfig
from ishara_tpu.config import IsharaConfig as JIsharaConfig
from ishara_tpu.serve.export import build_task_model as j_build_task_model
from ishara_tpu.serve.export import export_model as j_export_model

from ishara_tpu_torch.__main__ import BENCH_REFUSAL
from ishara_tpu_torch.config import EncoderConfig, IsharaConfig, TrainConfig

from torch_port_helpers import perturb

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dim=32, variant="hybrid", num_squeeze_blocks=1,
             num_conform_blocks=1, num_heads=4, frame_len=32,
             transformer_kernel_size=7, dropout=0.1, top_dropout=0.1)


@pytest.fixture(scope="module")
def blocker(tmp_path_factory):
    """A directory that, first on the path, makes ``import jax`` and
    ``import ishara_tpu`` raise."""
    d = tmp_path_factory.mktemp("blocker")
    for name in ("jax", "ishara_tpu"):
        (d / name).mkdir()
        (d / name / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    return d


def cli(blocker, *args, timeout=300):
    """``python -m ishara_tpu_torch ARGS`` with two torch threads."""
    env = dict(os.environ, PYTHONPATH=f"{blocker}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "ishara_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _ok(r):
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout.strip().splitlines()


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    path = tmp_path_factory.mktemp("config") / "small.json"
    IsharaConfig(model=EncoderConfig(**SMALL),
                 train=TrainConfig(warmup_epochs=0, validate_every_epochs=1)
                 ).to_json(path)
    return path


@pytest.fixture(scope="module")
def x_npy(tmp_path_factory):
    path = tmp_path_factory.mktemp("input") / "x.npy"
    np.save(path, np.random.default_rng(0).standard_normal((40, 276))
            .astype(np.float32))
    return path


def test_help_lists_the_commands_and_device(blocker):
    out = "\n".join(_ok(cli(blocker, "--help")))
    for cmd in ("train", "export", "eval", "infer", "bench"):
        assert cmd in out
    for cmd in ("train", "export", "eval", "infer"):
        assert "--device" in "\n".join(_ok(cli(blocker, cmd, "--help")))
    # the import reached neither blocked package
    assert _ok(cli(blocker, "train", "--help"))


def test_train_smoke(blocker, small_config, tmp_path):
    r = cli(blocker, "train", "--device", "cpu", "--config",
            str(small_config), "--workdir", str(tmp_path / "run"),
            "--epochs", "1", "--max-sequences", "8", "--batch-size", "8")
    lines = _ok(r)
    assert "ishara_tpu_torch train: device cpu" in r.stderr
    out = json.loads(lines[-1])
    assert "train_loss" in out and np.isfinite(out["train_loss"])
    assert (tmp_path / "run" / "config.json").exists()


@pytest.mark.parametrize("task", ["ctc", "translation"])
def test_train_export_infer(blocker, small_config, x_npy, tmp_path, task):
    run, bundle = tmp_path / "run", tmp_path / "bundle"
    _ok(cli(blocker, "train", "--device", "cpu", "--task", task, "--config",
            str(small_config), "--workdir", str(run), "--epochs", "1",
            "--max-sequences", "8", "--batch-size", "8"))
    lines = _ok(cli(blocker, "export", "--device", "cpu", "--workdir",
                    str(run), "--output", str(bundle)))
    assert lines[-1].startswith("exported step=1 -> ")
    cfg = json.loads((bundle / "config.json").read_text())
    assert cfg["task"] == task and cfg["model"]["dim"] == SMALL["dim"]
    lines = _ok(cli(blocker, "infer", "--device", "cpu", "--bundle",
                    str(bundle), "--input", str(x_npy)))
    if task == "translation":
        out = json.loads(lines[-1])
        assert isinstance(out["text"], str) and np.isfinite(out["confidence"])
    else:
        assert len(lines) == 1
    out = json.loads(_ok(cli(blocker, "eval", "--device", "cpu", "--bundle",
                             str(bundle), "--max-sequences", "4",
                             "--num-sequences", "4"))[-1])
    assert out["num_sequences"] == 4 and np.isfinite(out["latency_ms_p50"])


@pytest.mark.parametrize("task", ["ctc", "translation"])
def test_infer_on_a_jax_bundle_prints_what_jax_prints(blocker, x_npy,
                                                      tmp_path, capsys,
                                                      task):
    kw = dict(SMALL, dropout=0.0, top_dropout=0.0)
    if task == "translation":
        kw["num_classes"] = 62
    cfg = JIsharaConfig(model=JEncoderConfig(**kw), task=task)
    _, init = j_build_task_model(cfg)
    variables = perturb(jax.tree_util.tree_map(np.asarray,
                                               init(jax.random.key(3))))
    bundle = j_export_model(tmp_path / "bundle", cfg, variables)
    capsys.readouterr()
    j_main(["infer", "--bundle", str(bundle), "--input", str(x_npy)])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = _ok(cli(blocker, "infer", "--device", "cpu", "--bundle",
                  str(bundle), "--input", str(x_npy)))[-1]
    if task == "translation":
        g, w = json.loads(got), json.loads(want)
        assert g["text"] == w["text"]
        np.testing.assert_allclose(g["confidence"], w["confidence"],
                                   rtol=1e-5)
    else:
        assert got == want


def test_bench_refuses_and_runs_nothing(blocker):
    r = cli(blocker, "bench")
    assert r.returncode != 0
    assert BENCH_REFUSAL in r.stderr
    assert r.stdout == ""


def test_no_card_and_no_device_raises(blocker, small_config, tmp_path):
    """Without ``--device`` the CLI asks for the card; this host has none,
    so it fails rather than moving to the CPU."""
    r = cli(blocker, "train", "--config", str(small_config), "--workdir",
            str(tmp_path / "run"), "--epochs", "1", "--max-sequences", "8",
            "--batch-size", "8")
    assert r.returncode != 0 and "no CUDA device" in r.stderr
