#!/usr/bin/env python
"""The translation family's hard-corpus accuracy gate on the PyTorch port:
the counterpart of ``examples/train_translation_hard.py``, importing only
``ishara_tpu_torch``.

Trains ``ASLTranslationModel`` (grouped feature extraction, 2 RoPE
Squeezeformer blocks, 2 causal decoder layers, confidence head; dim 208, 8
heads, dropout 0.1, f32) with the reference recipe -- AdamW with a
one-cycle schedule peaking at 1e-3, gradient clip 1.0, batch 256, 40 epochs
of 32 steps -- on ``HardSyntheticASLFR`` phrases (8192 training sequences,
seed 0; 512 validation sequences, seed 1; confusability 0.6, hand NaNs
0.15, prototype seed 7) through ``Seq2SeqTokenizer`` and the port's
``Trainer(task="translation")``, then exports the trained weights as an f32
bundle (``export_model``, under ``--workdir``) and scores them through
``run_harness`` in the ``TranslationEngine`` that ``load_engine`` builds
from it (KV-cached greedy decode).

    python tools/train_translation_hard_torch.py              # on the card
    python tools/train_translation_hard_torch.py --resume     # continue

The gate: the final ``val_score`` at least 0.78, and the harness score
within 0.005 of it. The last line is a JSON summary: the validation curve,
the harness score and the verdict.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TARGET, MARGIN = 0.78, 0.005


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--sequences", type=int, default=8192)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--workdir", default="runs/hard_translation_torch")
    ap.add_argument("--confusability", type=float, default=0.6)
    ap.add_argument("--hand-nan", type=float, default=0.15)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-raw-frames", type=int, default=384)
    ap.add_argument("--val-sequences", type=int, default=512)
    ap.add_argument("--dim", type=int, default=208)
    ap.add_argument("--frame-len", type=int, default=176)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --workdir and "
                         "continue (exact mid-epoch resume)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    from ishara_tpu_torch.config import (
        EncoderConfig,
        IsharaConfig,
        TrainConfig,
    )
    from ishara_tpu_torch.data.synthetic import HardSyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer
    from ishara_tpu_torch.evaluation.harness import run_harness
    from ishara_tpu_torch.serve.export import export_model, load_engine
    from ishara_tpu_torch.train import Trainer

    # the reference geometry: 4 x FeatureExtractor(52) = 208 features, 2
    # RoPE Squeezeformer layers, 2 decoder layers, 8 heads; the recipe:
    # AdamW + one-cycle peaking at 1e-3, gradient clip 1.0
    cfg = IsharaConfig(
        task="translation",
        model=EncoderConfig(dim=args.dim, num_heads=8,
                            frame_len=args.frame_len, dropout=args.dropout,
                            num_classes=62),
        train=TrainConfig(batch_size=args.batch_size,
                          num_epochs=args.epochs,
                          warmup_epochs=max(1, args.epochs // 10),
                          lr_max=args.lr, optimizer="adamw",
                          validate_every_epochs=max(2, args.epochs // 10),
                          aug_prob=0.2))

    common = dict(confusability=args.confusability, hand_nan=args.hand_nan,
                  proto_seed=7)        # train/val share the handshape table
    train_ds = HardSyntheticASLFR(num_sequences=args.sequences, seed=0,
                                  **common)
    val_ds = HardSyntheticASLFR(num_sequences=args.val_sequences, seed=1,
                                **common)

    t0 = time.time()
    tok = Seq2SeqTokenizer()
    trainer = Trainer(cfg, train_ds, val_ds, tok, workdir=args.workdir,
                      max_raw_frames=args.max_raw_frames,
                      task="translation", device=args.device)
    if args.resume and trainer.resume():
        print(f"resumed from step {int(trainer.state.step)}", flush=True)
    history = trainer.train()
    train_wall = time.time() - t0
    print("final:", json.dumps(history[-1]), flush=True)
    print(f"train wall: {train_wall:.0f}s", flush=True)
    curve = [(r["epoch"], r["val_score"]) for r in history
             if "val_score" in r]
    final = history[-1].get("val_score")

    # the serving path on the trained weights through an f32 export
    # bundle, as examples/train_translation_hard.py serves the JAX one
    bundle = Path(args.workdir) / "bundle"
    export_model(bundle, cfg, trainer.model, stats=trainer.stats,
                 half_precision=False)
    engine = load_engine(bundle, device=args.device,
                         max_raw_frames=args.max_raw_frames)
    result = run_harness(engine, val_ds, tok,
                         num_sequences=args.val_sequences, translation=True)
    print("harness:", json.dumps(result.as_dict()), flush=True)
    for p, t in result.examples[:8]:
        print(f"  pred={p!r} target={t!r}")
    ok = (final is not None and final >= TARGET
          and abs(result.score - final) <= MARGIN)
    print(json.dumps({"gate": {
        "val_curve": curve, "final_val_score": final,
        "harness": result.score, "harness_gap": result.score - final
        if final is not None else None,
        "train_wall_s": round(train_wall, 1),
        "steps": int(trainer.state.step), "gate_passed": bool(ok)}}),
        flush=True)


if __name__ == "__main__":
    main()
