"""Typed configuration: a copy of ``ishara_tpu/config.py`` (the port
imports nothing of the JAX package). A config JSON written by either package
loads in both.

The five BASELINE.json configs are provided as named presets.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


# Keras parity epsilons of the encoder's norms, shared by the model layers
# and the fused block kernels.
LN_EPS = 1e-6
BN_EPS = 1e-3
# The reference Conformer conv module builds its norms with Keras defaults.
LN_EPS_DEFAULT = 1e-3


@dataclass
class EncoderConfig:
    """Architecture config. ``variant`` selects the reference model family:

    * ``squeezeformer`` — N SqueezeformerBlocks (conv-squeezeformer nbs)
    * ``conformer`` — N ConformerBlocks (conv-conformer-test-2-d67a5e)
    * ``hybrid`` — N Squeezeformer then M Conformer blocks (canonical
      conv-squeezeformer-conformer-test, the 0.728 family)
    * ``conv_hybrid`` — (Conv1DBlock*k -> Squeezeformer)*N then
      (Conv1DBlock*k -> Conformer)*M (conv-hybrid-model, the README API)
    * ``conv_transformer`` — (Conv1DBlock*k -> TransformerBlock)*N
      (conv-conformer.ipynb 1st-place style)
    * ``parallel_branches`` — M Conformer || N Squeezeformer branches,
      concat + Dense merge (conv-conformer-test-2.ipynb; the reference
      recorded it as a NaN failure, rebuilt for inventory completeness)
    """

    dim: int = 256
    variant: str = "hybrid"
    num_squeeze_blocks: int = 4
    num_conform_blocks: int = 4
    num_heads: int = 8
    expansion_factor: int = 2
    transformer_kernel_size: int = 15
    kernel_sizes: tuple[int, ...] = (11, 5, 3)
    num_conv_per_block: int = 3
    dropout: float = 0.4
    top_dropout: float = 0.4
    top_mult: int = 1          # top Dense width = dim * top_mult
    frame_len: int = 176
    input_dim: int = 276
    num_classes: int = 60
    blank_id: int = 59
    dtype: str = "float32"     # computation dtype; params stay float32
    remat: bool = False        # jax.checkpoint each block: trade FLOPs for HBM
    # canonicalize handedness in preprocess (nb4 process_landmarks dominant-
    # hand selection + inference_v3 flip_lr); part of the data contract the
    # weights are trained under, hence model config
    dominant_hand: bool = False
    # route MHSA through the Pallas flash kernel (ops/attention.py) instead
    # of XLA einsum; measured per-size — see RESULTS.md kernel measurements
    use_flash: bool = False
    # causal/streaming mode (beyond the reference, ROADMAP #5): every frame's
    # output depends only on frames <= t (causal attention bounded by
    # attn_context keys, causal convs, cumulative SE gate), enabling the
    # stateful chunked StreamingEncoder (serve/streaming.py) for live
    # captioning. Only the attention-block families support it.
    causal: bool = False
    attn_context: int = 256    # max left-context keys a query may attend to


@dataclass
class TrainConfig:
    """Optimizer/schedule config (reference nb cells 10-11 + integration.py)."""

    batch_size: int = 64
    num_epochs: int = 50
    warmup_epochs: int = 5
    lr_max: float = 4e-3
    wd_ratio: float = 0.05           # weight decay = lr * wd_ratio per epoch
    optimizer: str = "radam_lookahead"  # or "adamw"
    lookahead_sync_period: int = 5
    radam_sma_threshold: float = 4.0
    grad_clip_norm: float = 1.0
    aug_prob: float = 0.2
    # LR-flip augmentation prob (reference data_loader.py p=0.5); default off —
    # it fights EncoderConfig.dominant_hand canonicalization, enable only one
    lr_flip_prob: float = 0.0
    # quantization-aware training: forward through the int8 fake-quantizer
    # (train/qat.py) so the int8 export bundle is accuracy-faithful
    qat: bool = False
    # length-bucketed batching (data/sampler.py): allowed static raw-frame
    # caps, ascending; () = one global cap (the reference's behavior). Each
    # cap compiles its own step program (a handful, cached by jit).
    bucket_boundaries: tuple[int, ...] = ()
    seed: int = 42
    steps_per_epoch: int = 1000      # set from dataset at runtime
    checkpoint_every_epochs: int = 40
    validate_every_epochs: int = 5
    # EarlyStopping parity (nb4 train_model: EarlyStopping(patience=20,
    # restore_best_weights=True)): stop after this many epochs without a
    # val_score improvement (0 = never stop early). Improvements are only
    # observable at validation epochs, so an effective patience below
    # validate_every_epochs never triggers.
    early_stop_patience: int = 0
    # restore the best-val checkpoint into the final state when train()
    # returns (the Keras restore_best_weights=True behavior)
    restore_best_at_end: bool = False
    # every N optimizer steps, run the histogram-instrumented train step and
    # log per-layer gradient/parameter histograms (reference wandb.watch(
    # model, log_freq=100), integration.py:672). 0 = off.
    histogram_every_steps: int = 0


@dataclass
class MeshConfig:
    """Device-mesh layout for pjit. v0 is 1-D data parallel over ICI."""

    data_axis: str = "data"
    num_devices: int = -1  # -1 = all visible devices


@dataclass
class IsharaConfig:
    model: EncoderConfig = field(default_factory=EncoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # which reference pipeline family: "ctc" (TF/Keras notebook path) or
    # "translation" (torch integration.py encoder-decoder path); recorded in
    # export bundles so deployment rebuilds the right model
    task: str = "ctc"

    def to_json(self, path: str | Path | None = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_json(cls, source: str | Path) -> "IsharaConfig":
        # JSON text, or the path of a file that holds it (a long JSON
        # string is no valid path to test for existence)
        text = (str(source) if isinstance(source, str)
                and source.lstrip().startswith("{")
                else Path(source).read_text())
        raw = json.loads(text)
        model = EncoderConfig(**{**raw.get("model", {}),
                                 "kernel_sizes": tuple(raw.get("model", {}).get("kernel_sizes", (11, 5, 3)))})
        return cls(
            model=model,
            train=TrainConfig(**raw.get("train", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
            task=raw.get("task", "ctc"),
        )


# ---------------------------------------------------------------------------
# The five BASELINE.json configs (PROGRESS.jsonl / SURVEY.md §6).
# ---------------------------------------------------------------------------

def baseline_config(index: int) -> IsharaConfig:
    """1: tiny squeezeformer CTC smoke; 2: squeezeformer mini-shard training;
    3: hybrid 2+2 full training; 4: beam decode + eval; 5: batch-1 serving."""
    # Training presets (1-4) default to bf16 compute: measured ~1.5x faster
    # on v5e and convergence-validated (RESULTS.md); params/optimizer state
    # stay f32. Preset 5 (serving) stays f32 for exact-parity decoding —
    # measured a wash for batch-1 latency anyway.
    cfgs = {
        1: IsharaConfig(
            model=EncoderConfig(variant="squeezeformer", dim=256,
                                num_squeeze_blocks=2, num_conform_blocks=0,
                                num_heads=4, transformer_kernel_size=15,
                                dropout=0.1, top_mult=2, dtype="bfloat16"),
        ),
        2: IsharaConfig(
            model=EncoderConfig(variant="squeezeformer", dim=256,
                                num_squeeze_blocks=8, num_conform_blocks=0,
                                num_heads=4, transformer_kernel_size=15,
                                dropout=0.1, top_mult=2, dtype="bfloat16"),
        ),
        3: IsharaConfig(
            model=EncoderConfig(variant="conv_hybrid", dim=256,
                                num_squeeze_blocks=2, num_conform_blocks=2,
                                kernel_sizes=(11, 5, 3), num_conv_per_block=3,
                                dropout=0.2, top_mult=2, dtype="bfloat16"),
        ),
        4: IsharaConfig(
            model=EncoderConfig(variant="hybrid", dim=256,
                                num_squeeze_blocks=4, num_conform_blocks=4,
                                dropout=0.4, top_mult=1, dtype="bfloat16"),
        ),
        5: IsharaConfig(
            model=EncoderConfig(variant="hybrid", dim=256,
                                num_squeeze_blocks=4, num_conform_blocks=4,
                                dropout=0.4, top_mult=1, dtype="float32"),
        ),
    }
    return cfgs[index]
