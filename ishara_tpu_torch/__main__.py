"""Command-line interface: ``python -m ishara_tpu_torch <command>`` (port of
``ishara_tpu/__main__.py``).

  train    train a model (parquet corpus or the built-in synthetic one)
  eval     run the harness on an export bundle
  export   package a trained run into a deployment bundle
  infer    decode one .npy landmark sequence with a bundle
  bench    refuses: the port has no benchmark yet

Every command but ``bench`` takes ``--device`` (default: the CUDA card,
which raises when none is visible; ``cpu`` runs the plain PyTorch path).
Nothing runs at import, and ``torch`` is imported by the commands.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_REFUSAL = ("bench: the PyTorch port has no benchmark yet. The JAX "
                 "package's bench.py measures the TPU program, not this "
                 "one; nothing was run.")


def _load_dataset(args, split="train"):
    if args.data_dir:
        from .data.dataset import ParquetASLFR
        from .parallel.distributed import process_shard

        # this process's shard of the corpus; (0, 1) in a single process
        pidx, pcount = process_shard()
        return ParquetASLFR(
            args.data_dir, fold=args.fold, split=split,
            max_sequences=args.max_sequences,
            process_index=pidx, process_count=pcount)
    from .data.synthetic import SyntheticASLFR

    n = args.max_sequences or (512 if split == "train" else 128)
    # the splits share proto_seed (the same character -> pose language) and
    # differ only in the phrase seed
    return SyntheticASLFR(num_sequences=n, seed=0 if split == "train" else 1,
                          proto_seed=7)


def _config(args):
    from .config import IsharaConfig, baseline_config

    if args.config:
        if not Path(args.config).exists():
            raise SystemExit(f"--config not found: {args.config}")
        return IsharaConfig.from_json(args.config)
    if args.preset:
        return baseline_config(args.preset)
    return IsharaConfig()


def _tokenizer(task: str):
    from .data.tokenizer import CTCTokenizer, Seq2SeqTokenizer

    return Seq2SeqTokenizer() if task == "translation" else CTCTokenizer()


def _device(args):
    """The command's device (``--device``, default the card); named on
    stderr, so that a caller can tell where the command ran."""
    from .device import resolve_device

    device = resolve_device(args.device)
    print(f"ishara_tpu_torch {args.cmd}: device {device}", file=sys.stderr)
    return device


def cmd_train(args):
    import torch.distributed as dist

    from .parallel.distributed import initialize_distributed
    from .parallel.mesh import make_mesh
    from .train.trainer import Trainer

    if args.multihost or args.data_parallel:
        # one process a card, as torchrun starts them; a no-op alone
        initialize_distributed()
    cfg = _config(args)
    if args.epochs:
        cfg.train.num_epochs = args.epochs
    if args.batch_size:
        cfg.train.batch_size = args.batch_size
    if args.task:
        cfg.task = args.task
    tok = _tokenizer(cfg.task)
    if cfg.task == "translation":
        cfg.model.num_classes = tok.vocab_size
    device = _device(args)
    train_ds = _load_dataset(args, "train")
    val_ds = _load_dataset(args, "val")
    mesh = make_mesh() if args.data_parallel and dist.is_initialized() \
        and dist.get_world_size() > 1 else None
    stats = None
    if args.compute_stats:
        from .data.dataset import compute_group_stats

        stats = compute_group_stats(train_ds, num_sequences=500)
    trainer = Trainer(cfg, train_ds, val_ds, tok, stats=stats,
                      workdir=args.workdir, mesh=mesh, task=cfg.task,
                      device=device)
    if args.resume:
        trainer.resume()
    history = trainer.train()
    print(json.dumps(history[-1] if history else {}))


def cmd_export(args):
    from .config import IsharaConfig
    from .serve.export import build_task_model, export_model
    from .train.checkpoint import CheckpointManager
    from .train.optim import make_optimizer
    from .train.state import TrainState

    saved = Path(args.workdir) / "config.json"
    cfg = IsharaConfig.from_json(saved) if saved.exists() else _config(args)
    device = _device(args)
    model = build_task_model(cfg, device="cpu")
    tx, _ = make_optimizer(cfg.train)
    state = TrainState.create(model, tx, device=device)
    ckpt = CheckpointManager(Path(args.workdir) / "ckpt")
    step = ckpt.best_step()
    if step is not None:
        ckpt.restore(state, best=True)
    else:
        step = ckpt.latest_step()
        ckpt.restore(state, step=step)
    # like the reference, the bundle carries no normalisation statistics
    out = export_model(args.output, cfg, state.model,
                       half_precision=not args.full_precision)
    print(f"exported step={step} -> {out}")


def cmd_eval(args):
    from .config import IsharaConfig
    from .evaluation.harness import run_harness
    from .serve.export import load_engine

    cfg = IsharaConfig.from_json(Path(args.bundle) / "config.json")
    engine = load_engine(args.bundle, device=_device(args))
    ds = _load_dataset(args, "val")
    result = run_harness(engine, ds, _tokenizer(cfg.task),
                         num_sequences=args.num_sequences,
                         apply_filter=args.dominant_hand_filter,
                         translation=cfg.task == "translation")
    print(json.dumps(result.as_dict()))


def cmd_infer(args):
    import numpy as np

    from .config import IsharaConfig
    from .serve.export import load_engine

    cfg = IsharaConfig.from_json(Path(args.bundle) / "config.json")
    engine = load_engine(args.bundle, device=_device(args))
    x = np.load(args.input).astype(np.float32)
    out = engine.predict_text(x, _tokenizer(cfg.task))
    if cfg.task == "translation":
        text, conf = out
        print(json.dumps({"text": text, "confidence": conf}))
    else:
        print(out)


def cmd_bench(args):
    raise SystemExit(BENCH_REFUSAL)


def main(argv=None):
    p = argparse.ArgumentParser(prog="ishara_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--data-dir", default=None,
                        help="ASLFR parquet root (default: synthetic corpus)")
        sp.add_argument("--fold", type=int, default=None)
        sp.add_argument("--max-sequences", type=int, default=None)
        sp.add_argument("--config", default=None, help="IsharaConfig JSON")
        sp.add_argument("--preset", type=int, default=None,
                        help="baseline config preset 1-5")

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the plain PyTorch path)")

    sp = sub.add_parser("train")
    common(sp)
    device(sp)
    sp.add_argument("--task", choices=["ctc", "translation"], default=None,
                    help="pipeline family (default: config's task, ctc)")
    sp.add_argument("--workdir", default="runs/default")
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--data-parallel", action="store_true",
                    help="shard each batch's rows over the processes of "
                         "the group (one process a card, under torchrun)")
    sp.add_argument("--multihost", action="store_true",
                    help="join the process group (coordinator via "
                         "ISHARA_COORDINATOR/NUM_PROCESSES/PROCESS_ID or "
                         "torchrun's MASTER_ADDR/WORLD_SIZE/RANK)")
    sp.add_argument("--compute-stats", action="store_true")
    sp.add_argument("--resume", action="store_true")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("export")
    common(sp)
    device(sp)
    sp.add_argument("--workdir", default="runs/default")
    sp.add_argument("--output", default="export/bundle")
    sp.add_argument("--full-precision", action="store_true")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("eval")
    common(sp)
    device(sp)
    sp.add_argument("--bundle", required=True)
    sp.add_argument("--num-sequences", type=int, default=1000)
    sp.add_argument("--dominant-hand-filter", action="store_true")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("infer")
    device(sp)
    sp.add_argument("--bundle", required=True)
    sp.add_argument("--input", required=True, help=".npy [T, 276] landmarks")
    sp.set_defaults(fn=cmd_infer)

    sp = sub.add_parser("bench", help="refuses until the port has a "
                                      "benchmark")
    sp.add_argument("--profile", action="store_true")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
