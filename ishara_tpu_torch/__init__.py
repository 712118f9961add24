"""Ishara-TPU ported to PyTorch and CUDA (NVIDIA Hopper, ``sm_90a``).

The JAX package ``ishara_tpu`` is the reference; this package keeps its
module layout and names so each counterpart is easy to find. It imports
``torch`` and never ``jax`` or ``ishara_tpu``: what it needs from the
reference's numpy-only modules (landmark layout, vocabulary, config) lives
here as its own copy.

Ported so far: all seven encoder families (squeezeformer, conformer,
hybrid, conv_hybrid, conv_transformer, parallel_branches and the Temporal
U-Net squeezeformer_unet) in eval and training mode, the attention-block
ones also causal, with ``get_model`` and ``build_model``, and the
encoder-decoder translation model; preprocessing and augmentation; CTC and
translation training (train steps, the ``Trainer`` loop, checkpoints, the
evaluation harness); batch-1 and batched CTC serving (greedy collapse or the
on-device CTC prefix beam search, :mod:`ishara_tpu_torch.decode.beam_device`,
then the constant-phrase fallback) with the fused encoder blocks -- at bf16,
f32 or int8 weight storage, launch by launch or as one persistent kernel per
stack -- as hand-written CUDA kernels
(:mod:`ishara_tpu_torch.ops.fused_block`); translation serving (greedy or
beam, the whole decode loop as one kernel launch,
:mod:`ishara_tpu_torch.ops.decoder_kernel`); export bundles in the JAX
package's format, both ways, ``load_engine`` and the ``torch.export``
serving program (:mod:`ishara_tpu_torch.serve.export`); Keras / TFLite
weight import and the real-time clients; chunked streaming of a causal
model (:mod:`ishara_tpu_torch.serve.streaming`); quantization-aware
training (:mod:`ishara_tpu_torch.train.qat`), ``remat``, and data-parallel
training over a device mesh (:mod:`ishara_tpu_torch.parallel`); the parquet
corpus reader and the shard cache (:mod:`ishara_tpu_torch.data.dataset`,
:mod:`ishara_tpu_torch.data.cache`). Every training kernel has its CUDA
counterpart too. See ``ROADMAP.md`` for the rest (tensor parallelism, the
native Levenshtein, the CLI).

Entry points take a ``device``; without one they run on ``cuda`` and raise
when no card is visible (:func:`resolve_device`) -- they never fall back to
the CPU on their own.
"""

from .config import EncoderConfig, IsharaConfig, TrainConfig, baseline_config
from .data.landmarks import FRAME_LEN, MAX_PHRASE_LENGTH, N_COLS, SEL_COLS
from .data.tokenizer import CTCTokenizer, Seq2SeqTokenizer
from .data.vocab import NUM_CLASSES, PAD_TOKEN, PAD_TOKEN_IDX
from .device import resolve_device

__version__ = "0.1.0"


def get_model(*args, **kwargs):
    """Lazy re-export of :func:`ishara_tpu_torch.models.get_model` (the
    reference README API)."""
    from .models import get_model as _gm

    return _gm(*args, **kwargs)


__all__ = [
    "CTCTokenizer",
    "EncoderConfig",
    "FRAME_LEN",
    "IsharaConfig",
    "MAX_PHRASE_LENGTH",
    "N_COLS",
    "NUM_CLASSES",
    "PAD_TOKEN",
    "PAD_TOKEN_IDX",
    "SEL_COLS",
    "Seq2SeqTokenizer",
    "TrainConfig",
    "baseline_config",
    "get_model",
    "resolve_device",
]
