#!/usr/bin/env python
"""The hard-corpus accuracy gate on the PyTorch port: the counterpart of
``examples/train_hard.py``, importing only ``ishara_tpu_torch``.

Trains the preset-4 flagship (hybrid 4 + 4, dim 256, bf16, dropout 0.4) with
the reference recipe -- batch 256, 30 epochs of exponential warm-up and
half-cosine lrfn, RAdam + Lookahead -- on ``HardSyntheticASLFR`` (8192
training sequences, seed 0; 512 validation sequences, seed 1; confusability
0.6, hand NaNs 0.15, prototype seed 7) through the port's ``Trainer``, then
exports the trained weights as f32, bf16 and int8 bundles (``export_model``,
the JAX package's bundle format, under ``--workdir``) and scores each
through ``run_harness`` in the ``InferenceEngine`` that ``load_engine``
builds from it, with the engine's defaults (unfused).

    python tools/train_hard_torch.py                 # on the card
    python tools/train_hard_torch.py --causal        # the causal flagship
    python tools/train_hard_torch.py --resume        # continue a run

The gate: the final ``val_score`` at least 0.945 (0.91 with ``--causal``),
and each bundle's harness score within 0.005 of it and of the others.
``--causal`` trains the streaming flagship (``causal=True``,
``attn_context`` 176) and also scores the f32 weights served chunk by
chunk through ``StreamingEncoder`` (no resampling, no fallback; recorded,
not gated). The last line is a JSON summary: the validation curve, the
harness scores, the int8 gap and the verdict.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TARGET, CAUSAL_TARGET, MARGIN = 0.945, 0.91, 0.005


def bundle_engines(trainer, workdir, max_raw_frames, device):
    """(name, InferenceEngine) for the f32, bf16 and int8 export bundles of
    the trainer's model: each written by ``export_model`` under
    ``workdir`` and served by ``load_engine`` with the engine's defaults,
    as ``examples/train_hard.py`` scores the JAX package's bundles."""
    from ishara_tpu_torch.serve.export import export_model, load_engine

    for name, kw in (("f32", dict(half_precision=False)),
                     ("bf16", dict(half_precision=True)),
                     ("int8", dict(quantize_int8=True))):
        bundle = Path(workdir) / ("bundle" if name == "f32"
                                  else f"bundle_{name}")
        export_model(bundle, trainer.cfg, trainer.state.model,
                     stats=trainer.stats, **kw)
        yield name, load_engine(bundle, device=device,
                                max_raw_frames=max_raw_frames)


class StreamedEngine:
    """The engine interface of ``run_harness`` over ``StreamingEncoder``:
    a raw ``[T, 276]`` sequence, padded with NaN frames (invalid after
    normalisation) to whole chunks, streamed from a fresh state; the ids
    its frames emitted."""

    def __init__(self, streamer):
        self.streamer = streamer

    def __call__(self, raw):
        import numpy as np

        c = self.streamer.chunk_size
        n = -(-max(len(raw), 1) // c) * c
        buf = np.full((n, raw.shape[1]), np.nan, np.float32)
        buf[:len(raw)] = raw
        state, emitted = self.streamer.init_state(), []
        for i in range(0, n, c):
            state, ids, _, _ = self.streamer.step(state, buf[i:i + c])
            emitted.append(ids)
        ids = np.asarray(self.streamer.collect(emitted), np.int32)
        return ids, len(ids)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--sequences", type=int, default=8192)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--workdir", default=None,
                    help="default: runs/hard_flagship_torch, or "
                         "runs/hard_causal_torch with --causal")
    ap.add_argument("--confusability", type=float, default=0.6)
    ap.add_argument("--hand-nan", type=float, default=0.15)
    ap.add_argument("--dropout", type=float, default=0.4)
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--max-raw-frames", type=int, default=384)
    ap.add_argument("--val-sequences", type=int, default=512)
    ap.add_argument("--causal", action="store_true",
                    help="the causal flagship (gate 0.91), also scored "
                         "through StreamingEncoder")
    ap.add_argument("--attn-context", type=int, default=176)
    ap.add_argument("--skip-export", action="store_true",
                    help="stop after training (no harness scores)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --workdir and "
                         "continue (exact mid-epoch resume)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    if args.workdir is None:
        args.workdir = ("runs/hard_causal_torch" if args.causal
                        else "runs/hard_flagship_torch")

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
    for name, engine in bundle_engines(trainer, args.workdir,
                                       args.max_raw_frames, args.device):
        result = run_harness(engine, val_ds, tok,
                             num_sequences=args.val_sequences)
        scores[name] = result.score
        print(f"harness[{name}]:", json.dumps(result.as_dict()), flush=True)
        if name == "f32":
            for p, t in result.examples[:8]:
                print(f"  pred={p!r} target={t!r}")
    if args.causal:
        from ishara_tpu_torch.serve.streaming import StreamingEncoder

        streamer = StreamingEncoder(cfg.model, trainer.state.model,
                                    stats=trainer.stats, chunk_size=8,
                                    device=args.device)
        result = run_harness(StreamedEngine(streamer), val_ds, tok,
                             num_sequences=args.val_sequences)
        summary["streaming"] = result.as_dict()
        print("harness[streaming]:", json.dumps(result.as_dict()),
              flush=True)
    gap = scores["f32"] - scores["int8"]
    print(f"int8 gap vs f32: {gap:+.4f}"
          + (" (>=0.005 — run the QAT variant)" if gap >= 0.005 else ""),
          flush=True)
    spread = max(scores.values()) - min(scores.values())
    target = CAUSAL_TARGET if args.causal else TARGET
    ok = (final is not None and final >= target
          and all(abs(v - final) <= MARGIN for v in scores.values())
          and spread <= MARGIN)
    summary.update(final_val_score=final, harness=scores, int8_gap=gap,
                   precision_spread=spread, gate_passed=bool(ok))
    print(json.dumps({"gate": summary}), flush=True)


if __name__ == "__main__":
    main()
