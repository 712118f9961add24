"""The port stands alone: importing it pulls in neither ``jax`` nor any
module of ``ishara_tpu``, and its entry points never fall back to the CPU on
their own."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_reference_package():
    """Every module of the port (``train/``, ``evaluation/``, the ``ops/``,
    ``data/`` and ``preprocess/`` modules, the translation model, its
    decodes, kernel and engines, ... -- found by walking the package) and
    ``chip_smoke.py``."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import ishara_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ishara_tpu_torch.__path__, 'ishara_tpu_torch.')]\n"
        "for want in ('train.state', 'train.optim', 'evaluation.metrics',\n"
        "             'ops.ctc', 'ops.ctc_kernel', 'ops.dropout',\n"
        "             'ops.attention', 'ops.ffn_kernel', 'ops.selection',\n"
        "             'ops.fused_block', 'ops._build', 'models.fused',\n"
        "             'data.synthetic', 'models.seq2seq',\n"
        "             'decode.autoregressive', 'ops.decoder_kernel',\n"
        "             'serve.translation_engine', 'ops.attention_blocked',\n"
        "             'ops.conv_kernel',\n"
        "             'preprocess.augment', 'serve.engine', 'bridge',\n"
        "             'models.squeezeformer_unet', 'serve.streaming',\n"
        "             'train.qat', 'parallel.mesh', 'parallel.distributed',\n"
        "             'parallel.shard', 'data.dataset', 'data.cache'):\n"
        "    assert 'ishara_tpu_torch.' + want in names, want\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax'\n"
        "    or m.startswith(('jax.', 'jaxlib', 'flax', 'ishara_tpu.'))\n"
        "    or m == 'ishara_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_raise_without_a_card(monkeypatch):
    """Called without ``device`` on a host with no CUDA card, every entry
    point raises instead of running on the CPU."""
    import ishara_tpu_torch.config as tcfg
    from ishara_tpu_torch import resolve_device
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.models.fused import fused_encoder_forward
    from ishara_tpu_torch.models.seq2seq import (
        ASLTranslationModel,
        build_translation_model,
    )
    from ishara_tpu_torch.serve.engine import BatchedEngine, InferenceEngine
    from ishara_tpu_torch.serve.translation_engine import (
        BatchedTranslationEngine,
        TranslationEngine,
    )
    from ishara_tpu_torch.train import TrainState, make_optimizer
    import ishara_tpu_torch
    from ishara_tpu_torch.serve.streaming import StreamingEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.EncoderConfig(variant="squeezeformer", dim=32,
                             num_squeeze_blocks=1, num_heads=4, frame_len=16)
    model = build_model(cfg, device="cpu")
    translation = ASLTranslationModel(feature_dim=32, num_heads=4)
    calls = [
        lambda: resolve_device(),
        lambda: build_model(cfg),
        lambda: InferenceEngine(model),
        lambda: BatchedEngine(model),
        lambda: fused_encoder_forward(cfg, model.state_dict(),
                                      torch.zeros(16, cfg.input_dim)),
        lambda: TrainState.create(
            model, make_optimizer(tcfg.TrainConfig())[0]),
        lambda: build_translation_model(feature_dim=32, num_heads=4),
        lambda: TranslationEngine(translation),
        lambda: TranslationEngine(translation, fused=True),
        lambda: BatchedTranslationEngine(translation),
        lambda: ishara_tpu_torch.get_model(dim=32, num_heads=4),
        lambda: build_model(tcfg.EncoderConfig(
            variant="squeezeformer_unet", dim=32, num_heads=4)),
        lambda: StreamingEncoder(tcfg.EncoderConfig(
            variant="squeezeformer", dim=32, num_squeeze_blocks=1,
            num_heads=4, frame_len=16, causal=True, attn_context=8), model),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert next(model.parameters()).device.type == "cpu"
    assert next(translation.parameters()).device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result on this host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
