#!/usr/bin/env python
"""The hard-corpus accuracy gate on the PyTorch port: the counterpart of
``examples/train_hard.py``, importing only ``ishara_tpu_torch``.

Trains the preset-4 flagship (hybrid 4 + 4, dim 256, bf16, dropout 0.4) with
the reference recipe -- batch 256, 30 epochs of exponential warm-up and
half-cosine lrfn, RAdam + Lookahead -- on ``HardSyntheticASLFR`` (8192
training sequences, seed 0; 512 validation sequences, seed 1; confusability
0.6, hand NaNs 0.15, prototype seed 7) through the port's ``Trainer``, then
scores the trained weights through ``run_harness`` at the three precisions an
export bundle gives (f32; rounded to bf16 and cast back; int8 per output
channel, dequantized), each in an ``InferenceEngine`` with the engine's
defaults, as ``load_engine`` would build it.

    python tools/train_hard_torch.py                 # on the card
    python tools/train_hard_torch.py --resume        # continue a run

The gate: the final ``val_score`` at least 0.945, the f32 harness score
within 0.005 of it, and the three precisions within 0.005 of one another.
The last line is a JSON summary: the validation curve, the harness scores,
the int8 gap and the verdict.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TARGET, MARGIN = 0.945, 0.005


def precision_engines(trainer, max_raw_frames, device):
    """(name, InferenceEngine) for the f32, bf16 and int8 weights of the
    trainer's model, each on a fresh model of the training config."""
    import torch

    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.ops.fused_block import (
        dequantize_serving_weights,
        quantize_serving_weights,
    )
    from ishara_tpu_torch.serve.engine import InferenceEngine

    sd = {k: v.detach().to("cpu", torch.float32)
          if v.is_floating_point() else v.detach().cpu()
          for k, v in trainer.state.model.state_dict().items()}
    forms = {
        "f32": sd,
        "bf16": {k: v.to(torch.bfloat16).to(torch.float32)
                 if v.is_floating_point() else v for k, v in sd.items()},
        "int8": dequantize_serving_weights(quantize_serving_weights(sd)),
    }
    for name, weights in forms.items():
        model = build_model(trainer.cfg.model, device=device)
        model.load_state_dict(weights)
        yield name, InferenceEngine(model, stats=trainer.stats,
                                    max_raw_frames=max_raw_frames,
                                    device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--sequences", type=int, default=8192)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--workdir", default="runs/hard_flagship_torch")
    ap.add_argument("--confusability", type=float, default=0.6)
    ap.add_argument("--hand-nan", type=float, default=0.15)
    ap.add_argument("--dropout", type=float, default=0.4)
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--max-raw-frames", type=int, default=384)
    ap.add_argument("--val-sequences", type=int, default=512)
    ap.add_argument("--causal", action="store_true",
                    help="the causal flagship (not ported yet: raises)")
    ap.add_argument("--attn-context", type=int, default=176)
    ap.add_argument("--skip-export", action="store_true",
                    help="stop after training (no harness scores)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --workdir and "
                         "continue (exact mid-epoch resume)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    from ishara_tpu_torch.config import baseline_config
    from ishara_tpu_torch.data.synthetic import HardSyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.evaluation.harness import run_harness
    from ishara_tpu_torch.train import Trainer

    cfg = baseline_config(4)           # hybrid 4+4 dim=256 bf16
    cfg.model.dropout = args.dropout
    if args.causal:
        cfg.model.causal = True
        cfg.model.attn_context = args.attn_context
    cfg.train.num_epochs = args.epochs
    cfg.train.batch_size = args.batch_size
    cfg.train.warmup_epochs = max(1, args.epochs // 10)
    cfg.train.lr_max = args.lr
    cfg.train.validate_every_epochs = max(2, args.epochs // 10)

    common = dict(confusability=args.confusability, hand_nan=args.hand_nan,
                  proto_seed=7)        # train/val share the handshape table
    train_ds = HardSyntheticASLFR(num_sequences=args.sequences, seed=0,
                                  **common)
    val_ds = HardSyntheticASLFR(num_sequences=args.val_sequences, seed=1,
                                **common)

    t0 = time.time()
    tok = CTCTokenizer()
    trainer = Trainer(cfg, train_ds, val_ds, tok, workdir=args.workdir,
                      max_raw_frames=args.max_raw_frames, device=args.device)
    if args.resume and trainer.resume():
        print(f"resumed from step {int(trainer.state.step)}", flush=True)
    history = trainer.train()
    train_wall = time.time() - t0
    print("final:", json.dumps(history[-1]), flush=True)
    print(f"train wall: {train_wall:.0f}s", flush=True)
    curve = [(r["epoch"], r["val_score"]) for r in history
             if "val_score" in r]
    summary = {"val_curve": curve, "train_wall_s": round(train_wall, 1),
               "steps": int(trainer.state.step)}
    final = history[-1].get("val_score")
    if args.skip_export:
        print(json.dumps({"gate": summary}), flush=True)
        return

    scores = {}
    for name, engine in precision_engines(trainer, args.max_raw_frames,
                                          args.device):
        result = run_harness(engine, val_ds, tok,
                             num_sequences=args.val_sequences)
        scores[name] = result.score
        print(f"harness[{name}]:", json.dumps(result.as_dict()), flush=True)
        if name == "f32":
            for p, t in result.examples[:8]:
                print(f"  pred={p!r} target={t!r}")
    gap = scores["f32"] - scores["int8"]
    print(f"int8 gap vs f32: {gap:+.4f}"
          + (" (>=0.005 — run the QAT variant)" if gap >= 0.005 else ""),
          flush=True)
    spread = max(scores.values()) - min(scores.values())
    ok = (final is not None and final >= TARGET
          and abs(scores["f32"] - final) <= MARGIN and spread <= MARGIN)
    summary.update(final_val_score=final, harness=scores, int8_gap=gap,
                   precision_spread=spread, gate_passed=bool(ok))
    print(json.dumps({"gate": summary}), flush=True)


if __name__ == "__main__":
    main()
