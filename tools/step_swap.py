#!/usr/bin/env python3
"""Which kernel moves a training step off the CPU's: one fused step of the
long-sequence card test's model (hybrid 1 + 1, dim 64, T 400, f32, the
weights and seeds of ``tests/test_torch_cuda.py::
test_long_sequence_step_on_the_card_matches_the_cpu``) on the CPU, then on
the card with no kernel, each kernel alone, and every kernel swapped for
its plain PyTorch version; prints the loss and gradient norm of each
against the CPU's.

    python3 tools/step_swap.py
"""

import copy
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def swaps():
    """{kernel: [(module, launcher name, plain stand-in)]}."""
    from ishara_tpu_torch.ops import attention_blocked as ab
    from ishara_tpu_torch.ops import conv_kernel as cm
    from ishara_tpu_torch.ops import ctc_kernel as ck
    from ishara_tpu_torch.ops import dropout as dr

    return {
        "ctc": [(ck, "_launch_alpha",
                 lambda logits, labels, blank_id, want_alpha:
                 ck.ctc_forward_plain(logits, labels, blank_id)),
                (ck, "_launch_beta",
                 lambda logits, labels, alpha, nll, dy, blank_id:
                 ck.ctc_backward_plain(logits, labels, alpha, nll, dy,
                                       blank_id))],
        "conv_module": [(cm, "_launch_fwd", lambda x, args:
                         cm.conv_module_forward_plain(x, *args,
                                                      with_p=True)),
                        (cm, "_launch_bwd", lambda x, dy, args, p:
                         cm.conv_module_backward_plain(x, args[0], dy,
                                                       *args[1:], p=p))],
        "attention_blocked": [
            (ab, "_launch_fwd", lambda q, k, v, bias, scale, Tp:
             ab.blocked_attention_forward_plain(q, k, v, bias, scale)),
            (ab, "_launch_bwd", lambda q, k, v, bias, o, lse, d_o, scale:
             ab.blocked_attention_backward_plain(q, k, v, bias, o, lse, d_o,
                                                 scale))],
        "dropout": [(dr, "_launch",
                     lambda x, res, seed, rate, offset=0, runs=None:
                     dr.dropout_plain(x, seed, rate, res, offset,
                                      runs))],
    }


def main():
    import torch

    from ishara_tpu_torch.config import EncoderConfig, TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.models.layers import SqueezeformerConvModule
    from ishara_tpu_torch.preprocess import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    if not torch.cuda.is_available():
        print("step_swap: no CUDA device is visible", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EncoderConfig(variant="hybrid", dim=64, num_heads=4,
                        num_squeeze_blocks=1, num_conform_blocks=1,
                        frame_len=400, dropout=0.0, top_dropout=0.2)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    for m in model.modules():   # f32: the table would take the composition
        if isinstance(m, SqueezeformerConvModule):
            m.fused = True
    batch = SyntheticASLFR(num_sequences=4, frames_per_char=16,
                           seed=3).batch(range(4), CTCTokenizer(),
                                         max_frames=600)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), 400,
                                     aug_prob=0.2)
    _, mc = step(TrainState.create(copy.deepcopy(model), tx, device="cpu"),
                 batch, seed=1)
    loss, norm = float(mc["loss"]), float(mc["grad_norm"])
    print(f"cpu: loss {loss:.6f} grad norm {norm:.6f}", flush=True)
    table = swaps()
    for label in ["none", *table, "all"]:
        chosen = ([] if label == "none" else
                  sum(table.values(), []) if label == "all" else table[label])
        saved = [(m, n, getattr(m, n)) for m, n, _ in chosen]
        try:
            for m, n, f in chosen:
                setattr(m, n, f)
            card = TrainState.create(copy.deepcopy(model), tx, device="cuda")
            _, mg = step(card, batch, seed=1)
            lg, ng = float(mg["loss"]), float(mg["grad_norm"])
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
        print(f"card, plain {label}: loss {lg:.6f} (rel "
              f"{abs(lg - loss) / abs(loss):.3e}) grad norm {ng:.6f} (rel "
              f"{abs(ng - norm) / norm:.3e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
