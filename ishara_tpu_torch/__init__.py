"""Ishara-TPU ported to PyTorch and CUDA (NVIDIA Hopper, ``sm_90a``).

The JAX package ``ishara_tpu`` is the reference; this package keeps its
module layout and names so each counterpart is easy to find. It imports
``torch`` and never ``jax`` or ``ishara_tpu``: what it needs from the
reference's numpy-only modules (landmark layout, vocabulary, config) lives
here as its own copy.

Ported so far: the batch-1 CTC serving path of ``baseline_config(5)``
(preprocess -> encoder -> greedy collapse -> constant-phrase fallback), with
the fused encoder blocks as hand-written CUDA kernels
(:mod:`ishara_tpu_torch.ops.fused_block`). See ``ROADMAP.md`` for the rest.

Entry points take a ``device``; without one they run on ``cuda`` and raise
when no card is visible (:func:`resolve_device`) -- they never fall back to
the CPU on their own.
"""

from .config import EncoderConfig, IsharaConfig, baseline_config
from .data.landmarks import FRAME_LEN, MAX_PHRASE_LENGTH, N_COLS
from .data.tokenizer import CTCTokenizer
from .data.vocab import NUM_CLASSES, PAD_TOKEN, PAD_TOKEN_IDX
from .device import resolve_device

__version__ = "0.1.0"

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
    "baseline_config",
    "resolve_device",
]
