#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):

1. Build the CUDA kernels from ``ishara_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and print the card's name and power limit.
2. Kernels, at the main paths' shapes (T=176, dim 256, 8 heads), each held
   against its plain PyTorch version on the card and timed (CUDA events,
   median after warm-up) beside its plain version and its bound:
   the Squeezeformer and Conformer stacks of ``baseline_config(5)`` (4
   blocks each) at bf16, f32 and int8 weight storage, and as the persistent
   ``dma=True`` kernel (also held equal to ``dma=False``, and timed with a
   cold L2); the conv-group stacks of ``baseline_config(3)`` (2 groups of
   three Conv1DBlocks + a Squeezeformer or Conformer block) and of a
   ``conv_transformer`` configuration of the same widths (inner Transformer
   blocks); one block alone (N = 1).
3. Engines, each with seeded random weights on nine requests of every
   length class, a left-hand-dominant one, NaN hands and an all-NaN one:
   preset 5 through ``InferenceEngine(fused=True)``, ``fused="int8"``,
   ``fused=True, dma=True`` and ``fused="int8", dma=True``; preset 3 through
   ``fused=False``, ``True``, ``"int8"`` and ``True, dma=True``; the
   ``conv_transformer`` configuration through ``fused=False`` and ``True``.
   Fused logits against the unfused path's (int8 against the unfused model
   on the dequantized weights), dma ids against non-dma ids, the kernels'
   launch counts over each nine-request run, p50/p99 request latency, device
   time by kernel under ``torch.profiler``, ``BatchedEngine``, and the
   constant-phrase fallback probe. Then the CTC prefix beam search (W 8,
   K 8) in the serving program: preset 5 through
   ``InferenceEngine(decode="beam")`` with ``fused`` True, "int8" and True
   + dma, preset 3 fused, ``BatchedEngine(decode="beam")`` at batch 8;
   every request's ids and counts against the port's search on the CPU on
   the log-probs copied off the card, at K 60 against the host search's
   best prefix; the stacks' launches, p50 / p99 beside the greedy engines,
   the search's own time and device kernels. Then export bundles: preset 5
   as f32, bf16 and int8 bundles read back by the port's own msgpack codec,
   each ``load_engine(fused=True)`` against an engine on the same (rounded
   or dequantized) weights; a translation bundle through K9; the fused
   beam program through ``export_serving_program`` /
   ``load_serving_program`` against its engine, the stacks launched.
4. Training kernels at the flagship training step's shapes (batch 256,
   T = 176, dim 256, 8 heads of 32, hidden 512, 64 labels, 60 classes): the
   CTC alpha / beta kernels, dropout and dropout-add, attention and the
   feed-forward branch, each forward and every gradient against its plain
   PyTorch version on the card, with dropout at 0.4 and at 0, at bf16 and
   f32 (the feed-forward branch's f32 form is its general kernels), and
   attention also with 4 heads of 64, 4 of 48 and 2 of 128, a second
   backward bit for bit (the attention kernel's two directions by
   design: bf16 heads of 32 and 64 on the persistent wgmma forward, whose
   keep bits are held to ``keep_mask``'s bit for bit, and on the one-pass
   wgmma backward, which must beat ``F.scaled_dot_product_attention``'s
   backward at the flagship shape and reads those bits; f32 and bf16 heads
   of 48 and 128 on the general kernels); the weight product of the
   feed-forward and conv-module backwards against an f32 matmul; the CTC kernels
   on chip_smoke's labels and on the training
   step's own (times a frame beside the chain floor, a second launch bit
   for bit), and at T 1024 and 2048; the feed-forward
   kernel's masks against
   the plain PyTorch Philox bit for bit; CUDA-event times of forward and
   backward beside the plain version's, the bound and one PyTorch library
   call (``F.ctc_loss``, ``F.dropout``, ``F.scaled_dot_product_attention``;
   for the feed-forward branch, which no one call computes, the
   ``F.linear`` / ``silu`` / ``dropout`` composition).
5. Training: ``baseline_config(4)`` (hybrid 4 + 4, bf16, dropout 0.4) at
   batch 256 on a synthetic corpus through ``make_optimizer`` ->
   ``TrainState.create`` -> ``make_fused_ctc_train_step``: one step on the
   kernels against the same step with every kernel replaced by its plain
   version, from the same state and seeds (loss, gradient norm, parameters
   and both moments); 20 steps of the recipe's ``TrainConfig()`` with the
   launch counts read around them, the loss finite throughout and lower at
   the end, and 20 more at an epoch a step, which walk the whole warm-up; the
   non-finite guard; ``ctc_train_step`` and both eval steps; ms a step, and
   the device's busy share under ``torch.profiler``.
6. The long-sequence training step: K8 (the tiled attention,
   ``flash_mhsa_blocked``) at its q, k, v ``[256, 8, 512, 32]`` in bf16 and
   f32, with 4 heads of 64, 2 of 128, 1 of 256 and 8 of 12 at T 512, and
   at T 200 (blocks of 128, 64 and 16) with a sequence whose keys are all
   masked, a second backward bit for bit, each launch's design
   (``blocked_plan``: bf16 heads of 32 and 64 on the wgmma forward and, up
   to T 640 / 384, the one-pass wgmma backward) asserted and equal to the
   C plan; K7 (the conv-module
   branch, ``conv_module_residual``) at x ``[256, 512, 256]`` in bf16 (its
   wgmma design) and f32 (the tile kernels) and at the flagship's ``[256,
   176, 256]``, there also with 33 and 63 depthwise taps (tile and general
   paths; ``conv_kernel.tile_smem`` and ``conv_plan`` held to the C side's
   for every configuration; each launch's design asserted, the backward's
   kernels free of a forward tile kernel); each forward and every
   gradient against its plain version, timed beside it, the bound and
   ``F.scaled_dot_product_attention`` with the einsum composition (K8) or
   the port's composition (K7). Then ``baseline_config(4)`` at
   ``frame_len=512`` and ``dropout=0.0`` (batch 256, bf16,
   ``TrainConfig()``) on raw sequences mostly longer than 384 frames: one
   step on the kernels against the plain versions, the same (seed, step)
   bit for bit, 10 steps with the launch counts (K7 4 + 4, K8 8 + 8, all
   on the wgmma designs, K1 1 + 1, the top dropout 1 + 1, none of K3, K4
   and the dropout-add), a
   finite falling loss, ms a step, sequences/s, the peak of allocated
   memory and the device's busy share and time by kernel. Then one step of
   a narrow hybrid at T 400 (``tests/test_torch_cuda.py::test_long_sequence
   _step_on_the_card_matches_the_cpu``) on the card against the same step
   on the CPU: loss, gradient norm and every gradient within the test's
   tolerances.
7. Wide depthwise kernels and the ``Trainer``: ``baseline_config(4)`` with
   ``transformer_kernel_size`` 33 and 63, one step against the plain
   versions and 3 steps with K7's launches (4 + 4 a step). Then the CTC
   ``Trainer`` (no ``device``: the card) on ``HardSyntheticASLFR(1024)``
   with 256 validation sequences, batch 256, 3 epochs validated every
   epoch: finite losses, the three scores, the best, periodic and final
   checkpoints on disk, every training kernel launched; its ms a step
   beside the bare step's, the time the loop waited for the host, one
   batch's collation; a second run preempted on its 6th batch load and
   resumed by a third ``Trainer``, which ends bit for bit where the
   uninterrupted run did.
8. Translation serving: the encoder-decoder model at the reference width
   (dim 208, 8 heads of 26, 2 + 2 layers, 62 classes, T 176, max_out 64,
   beam 4) with seeded weights. K9 -- the whole decode loop in one launch,
   greedy at max_out 64 and 18 and beam at width 4 -- against its plain
   version on the card (tokens exactly, beam scores), timed beside the
   plain version, the port's unfused KV-cached loop and the bound; nine
   requests through ``TranslationEngine`` with ``fused`` False / True /
   "auto", ``kv_cache`` False, ``early_exit`` False, ``decode="beam"``
   unfused and fused (the same tokens everywhere, one K9 launch a fused
   request), the eos probe, ``BatchedTranslationEngine`` at batch 32
   (sequences/s), p50/p99 latencies and ``torch.profiler`` breakdowns.
9. Translation training at the reference width (dim 208, 2 + 2 layers, 8
   heads, dropout 0.1, T 176, labels of 64 tokens, batch 256, f32, AdamW at
   a peak of 1e-3): the dropout kernel on the attention probabilities of
   the encoder ``[256, 8, 176, 176]`` and the decoder ``[256, 8, 63, 63]``
   (timed rows) and ``[256, 8, 63, 176]``, forward and backward against
   its plain version beside F.dropout; one ``make_fused_translation_train_
   step`` on the kernel against the same step with the plain version, the
   same (seed, step) twice; 20 steps with K2's launches (23 + 23 a step,
   no other training kernel), a finite falling loss; ms a step,
   sequences/s and the device's busy share; the eval step. Then
   ``Trainer(task="translation")`` for 2 epochs of 4 steps on 1024
   hard-corpus sequences with one validation, and a run preempted
   mid-epoch and resumed by a third ``Trainer``, bit for bit.
10. Causal mode and the two further families: the dropout kernel on the
   causal attention probabilities ``[256, 8, 176, 176]`` bf16 at rate 0.4
   against its plain version beside F.dropout; ``baseline_config(4)`` with
   ``causal=True``, ``attn_context`` 176 (bf16, batch 256): one step on the
   kernels against the plain versions, 10 steps with the launch counts (the
   feed-forward, dropout and CTC kernels; never the attention, tiled
   attention or conv-module kernels), ms a step beside the bidirectional
   flagship's, the busy share; one step of a small causal hybrid on the
   card against the CPU; ``StreamingEncoder`` over the causal flagship
   (f32, seeded weights) in chunks of 8 against the batch causal forward
   on the card (logits to 1e-4, the emitted ids), then per-chunk p50 / p99
   over 200 chunks and the device kernels a chunk; ``parallel_branches``
   at preset 4's widths and the Temporal U-Net at dim 144 (8 blocks, 4
   heads): one step against the plain versions, 3 steps with the launch
   counts, nine unfused requests and ``BatchedEngine``, the fused modes
   refused.
11. QAT, ``remat``, data parallelism and the shard cache: the dropout,
   attention and feed-forward kernels on rows [128, 256) of the flagship
   batch with those rows' element offset, against their plain versions
   and the whole batch's launch (bit for bit); ``baseline_config(4)`` with
   ``qat=True`` (one step against the plain versions, 10 steps with the
   launch counts, ms a step beside the plain step, the QAT eval step's
   ids against ``InferenceEngine(fused="int8")`` on the nine requests)
   and with ``remat=True`` (one step bit for bit against ``remat=False``,
   ms a step and peak memory of both); the data-parallel step (f32) on a
   1-rank NCCL mesh against the plain step, and on two gloo ranks of 128
   rows sharing the card (``chip_smoke.py --dp-rank``) against the
   single-process batch-256 step, the replicas bit for bit; a ``Trainer``
   epoch on ``ShardedASLFR`` shards of the hard corpus.
12. Tensor parallelism, the native library and the CLI: the dropout kernel
   on a tensor-parallel rank's strided slices (4 of 8 heads of the
   attention probabilities, half the FFN hidden; f32) against its plain
   version and against the whole tensor's launch, bit for bit; the
   attention kernel on a rank's heads and the FFN kernel's partial sums on
   its hidden columns at the TP step's shapes, against their plain
   versions and the whole launches, timed; preset 4
   (f32, batch 256, dropout 0.4) on two gloo ranks sharing the card as a
   ``(data 1, model 2)`` mesh (``chip_smoke.py --tp-rank``), the state
   sharded by ``shard_state_tp``: one step held to the single-process
   step, the replicated elements bit for bit on both ranks, the launches
   of every kernel the step takes, ms a step beside the unsharded step's;
   the native Levenshtein library built and equal to the Python DP on
   1000 pairs, both timed; ``python -m ishara_tpu_torch`` ``train``,
   ``export``, ``infer`` and ``eval`` on the card with no ``--device``.
13. One JSON line listing every ported kernel (``offset``: whether it
   takes a data-parallel rank's element offset; the ``tp`` rows carry the
   tensor-parallel step's launches), then the card's name and power
   limit, then ``{"ok": true, "device": {...}}`` as the last line.

Exits with a non-zero code, printing no result, when no CUDA device is
visible or the port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit). int8
# weights multiply f32 activations: no tensor-core type takes that pair, so
# the bf16 rate (dequantize, then bf16 mma) is the card's best for them.
HBM_BYTES_PER_S = 3.35e12
# exponentials a second: 16 a clock an SM (the multi-function unit), 132
# SMs at 1.98 GHz, the floor under an attention kernel's softmax
MUFU_PER_S = 16 * 132 * 1.98e9
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 989e12}
L2_BYTES = 50 * 2 ** 20
# Tolerances of kernel against plain version, per element:
# |kernel - plain| <= ATOL + RTOL * |plain|. At f32 storage both do f32
# arithmetic and differ only in summation order; at bf16 and int8 both hold
# the same weights (and int8 scales) and round q, k, v and p to bf16 at the
# same points, but a last-bit difference before a rounding can move one
# value by a bf16 ulp (2^-8 relative).
KERNEL_TOL = {"f32": (1e-3, 1e-3), "bf16": (1e-2, 1e-2), "int8": (1e-2, 1e-2)}
# the QAT eval step against the int8 engine (qat_phase): the largest
# |difference| of their log-probs, and the top-2 gap below which a frame's
# argmax counts as a tie that either side may break
QAT_LOGPROB_TOL = 3e-3
QAT_TIE_GAP = 2e-3
# Fused (bf16 or int8 weights) against unfused (f32) logits: the tolerance
# the JAX package's own tests hold its bf16 and int8 deploy numerics to
# (tests/test_fused_block.py, test_fused_encoder_forward_parity and
# test_fused_encoder_int8_parity).
LOGIT_TOL = (5e-2, 5e-2)
FALLBACK_TEXT = "2 a-e -aroe"
DEVICE = "cuda"
SOURCE = "ishara_tpu_torch/ops/csrc/fused_block.cu"
REF = "ishara_tpu/ops/fused_block.py"
CSRC = "ishara_tpu_torch/ops/csrc/"
# Training kernels against their plain versions, |kernel - plain| <= tol *
# (max|plain| + |plain|). f32: the same arithmetic in another summation
# order, with expf / logf of another library. bf16: kernel and plain version
# round at the same points, but a last-bit difference before a rounding moves
# a value by one bf16 ulp (2^-8 relative), and a gradient sums many such
# values. Dropout itself is exact (one multiply, one rounding).
# The CTC gradient of a row beyond a few hundred frames: the occupancy
# exp(alpha + beta - logP) with |logP| in the thousands, where one f32 ulp
# (~2.4e-4) of gamma moves an occupancy by as much ("ctc_long").
TRAIN_TOL = {"f32": 2e-4, "bf16": 2e-2, "ctc": 2e-5, "ctc_long": 2e-3,
             "dropout": 0.0}
# One training step on the kernels against the same step on the plain
# versions (bf16 model, dropout 0.4, identical masks): relative tolerance of
# the loss and of the gradient norm; the largest difference of a parameter
# after the update as a share of the largest movement the step gave a
# parameter, and likewise the optimizer's first and second moments as a share
# of their largest entries. RAdam's first step is lr times the clipped
# gradient, so the parameter and first-moment shares are the largest error of
# a gradient entry over the largest entry, and the second moment's is about
# twice that.
STEP_TOL = {"loss": 5e-3, "grad_norm": 1e-3, "param": 1e-2, "mu": 1e-2,
            "nu": 2e-2}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def randomize(model, seed: int) -> None:
    """Seeded random weights and realistic BN statistics: matrices
    N(0, 1/fan_in), norm scales 1 + 0.1 N, biases and means 0.1 N, running
    variances 0.5 + U(0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            n = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                v = 0.5 + torch.rand(t.shape, generator=g)
            elif name.endswith("weight") and t.dim() >= 2:
                v = n / math.sqrt(t[0].numel())
            elif name.endswith("weight"):
                v = 1.0 + 0.1 * n
            else:
                v = 0.1 * n
            t.copy_(v)


def requests(seed: int):
    """(label, raw [T, 276]) requests made with numpy from ``seed``."""
    from ishara_tpu_torch.data import landmarks as lm

    rng = np.random.default_rng(seed)
    r = lm.GROUP_IDX["rhand"].ravel()
    l_ = lm.GROUP_IDX["lhand"].ravel()

    def seq(T, p_r=0.2, p_l=0.7):
        x = rng.random((T, lm.N_COLS)).astype(np.float32)
        x[np.ix_(rng.random(T) < p_r, r)] = np.nan
        x[np.ix_(rng.random(T) < p_l, l_)] = np.nan
        return x

    out = [("len60", seq(60)), ("len150", seq(150)), ("len250", seq(250)),
           ("len384", seq(384)), ("len500", seq(500)), ("len700", seq(700)),
           ("left_dominant", seq(200, p_r=0.8, p_l=0.1))]
    nan_hands = seq(120)
    nan_hands[:, np.concatenate([r, l_])] = np.nan
    out.append(("nan_hands", nan_hands))
    out.append(("all_nan", np.full((90, lm.N_COLS), np.nan, np.float32)))
    return out


def time_ms(fn, runs: int = 100, warmup: int = 5, before=None,
            head_start: bool = True) -> float:
    """Median device time of ``fn`` in ms (one CUDA event pair per run).
    ``before`` runs ahead of each timed run, outside its event pair. With
    ``head_start`` the device first spins for about a millisecond (touching
    no memory), so that the host has enqueued all of ``fn``'s launches
    before the first one starts and the time is the device's alone; without
    it the runs follow each other directly and a slow host shows in the
    time, as it does for a caller."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        if before is not None:
            before()
        if head_start:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_ms(fn, runs: int = 50) -> float:
    """Median host time of one call of ``fn`` in ms: what the caller's
    thread spends before the call returns, the device idle at its start."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_kernels(fn) -> dict:
    """{kernel: launches} of the port's libraries (their names carry the
    anonymous namespace of csrc/*.cu) in one call of ``fn``, by
    torch.profiler: the first profiled call after the first that records
    any (a cold profiler can miss a call's launches, at times all of them),
    of at most four."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = {re.search(r"\w+_kernel", e.key).group(0): e.count
                for e in prof.key_averages()
                if "anonymous namespace" in e.key
                and re.search(r"\w+_kernel", e.key)}
        if i and seen:
            break
    return seen


def _tensors(w):
    return w if isinstance(w, tuple) else (w,)


def stack_work(fb, kind, x, mask, conv, leaves):
    """(bytes, operations) a stack must move and do: each input read and
    the output written once -- int8 matrices at one byte a value, their
    scale leaves included; matmul, attention, depthwise-conv and ECA-window
    multiply-adds counted as 2 operations each (the other elementwise work,
    under 1% of the total, is left out)."""
    T, D = x.shape
    nb = _tensors(leaves[0])[0].shape[0]
    nbytes = 2 * x.numel() * 4 + mask.numel() * 4
    ops = 4 * T * T * D * nb  # q.k and p.v over all heads
    specs = [(fb.CONV1D_LEAVES, cl) for cl in conv] + \
        [(fb.INNER[kind][1], leaves)]
    for spec, lv in specs:
        for (name, lkind, _), w in zip(spec, lv):
            nbytes += sum(t.numel() * t.element_size() for t in _tensors(w))
            q = _tensors(w)[0]
            if lkind == "m":
                rows = 1 if name.startswith("se") else T
                ops += 2 * rows * q.shape[1] * q.shape[2] * nb
            elif name == "dww":
                ops += 2 * T * q.shape[1] * q.shape[2] * nb
            elif name == "ecw":  # the window over channels, on the GAP row
                ops += 2 * q.shape[1] * _tensors(lv[0])[0].shape[-1] * nb
    return nbytes, ops


def stem_output(model, raw_np, n):
    """The main path's stem output [T, dim] and mask for one request."""
    import torch

    from ishara_tpu_torch.preprocess.pipeline import (
        GroupStats,
        frame_mask,
        preprocess,
    )

    raw = torch.zeros((384, 276), device=DEVICE)
    raw[:n] = torch.from_numpy(raw_np[:n]).to(DEVICE)
    x = preprocess(raw, torch.tensor(n, device=DEVICE),
                   GroupStats.identity(), model.cfg.frame_len, thin=True)
    with torch.no_grad():
        h = model.stem_bn(model.stem_conv(x) + model.pos_enc).contiguous()
    return h, frame_mask(x)


def stack_run_line(report):
    """What fused_block.stack_report() says a stack launch ran."""
    plan = report["plan"]
    line = (f"{report['stages']} stages counted on the device (plan "
            f"{plan['stages']}) in {report['launches']} launch(es), at most "
            f"{report['smem_bytes']} B shared memory a stage (plan "
            f"{plan['smem_bytes']})")
    if report["grid"]:
        grid, per_sm = report["grid"]
        line += (f", one cooperative launch of {grid} blocks ({per_sm} an "
                 f"SM)")
    return line


def stack_run_ok(report):
    """The kernel ran the stages of its plan, counted on the device, in the
    launches of its form, with the plan's shared memory."""
    plan = report["plan"]
    return (report["stages"], report["launches"], report["smem_bytes"]) == (
        plan["stages"], 1 if report["dma"] else plan["launches"],
        plan["smem_bytes"])


def kernel_phase(models, reqs):
    """Every kernel form against its plain version, timed beside its bound.
    Returns {(config, kind, storage tag, dma): row}."""
    import torch

    from ishara_tpu_torch.models import fused as fenc
    from ishara_tpu_torch.ops import fused_block as fb

    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device=DEVICE)
    wrappers = {"squeezeformer": (fb.fused_squeezeformer_stack, f"{REF}:615"),
                "conformer": (fb.fused_conformer_stack, f"{REF}:629")}
    # (config, segment kinds in the encoder's order,
    #  forms (storage tag, dma) in the order they run)
    plan = [
        ("preset5", ("squeezeformer", "conformer"),
         [("bf16", False), ("f32", False), ("int8", False), ("bf16", True),
          ("f32", True), ("int8", True)]),
        ("preset3", ("squeezeformer", "conformer"),
         [("bf16", False), ("f32", False), ("int8", False), ("bf16", True)]),
        ("conv_transformer", ("transformer",),
         [("bf16", False), ("f32", False), ("int8", False)]),
    ]
    storages = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": "int8"}
    rows = {}
    for config, kinds, forms in plan:
        model = models[config]
        cfg = model.cfg
        sd = model.state_dict()
        x_in, mask = stem_output(model, reqs[1][1], 150)
        qsd = fb.quantize_serving_weights(sd)
        for kind in kinds:
            grouped = cfg.variant in ("conv_hybrid", "conv_transformer")
            if grouped:
                fn, replaces = fb.fused_conv_group_stack, f"{REF}:430"
                name = f"fused_conv_group_stack[{kind}]"
            else:
                fn, replaces = wrappers[kind]
                name = fn.__name__
            outs = {}
            for tag, dma in forms:
                conv, leaves = fenc.encoder_segment_args(
                    cfg, qsd if tag == "int8" else sd, kind, storages[tag])

                def run(dma=dma, conv=conv, leaves=leaves):
                    if grouped:
                        return fn(x_in, mask, (conv, leaves), kind,
                                  num_heads=cfg.num_heads, dma=dma)
                    return fn(x_in, mask, leaves, num_heads=cfg.num_heads,
                              dma=dma)

                def plain(conv=conv, leaves=leaves):
                    return fb.group_stack_plain(x_in, mask, (conv, leaves),
                                                kind, cfg.num_heads)

                got = run()
                torch.cuda.synchronize()
                report = fb.stack_report()
                again = run()
                ref = plain()
                err = (got - ref).abs()
                atol, rtol = KERNEL_TOL[tag]
                max_abs = float(err.max())
                max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= atol + rtol * ref.abs()).all())
                form = f"{tag} weights" + (", dma" if dma else "")
                same2 = torch.equal(got, again)
                extra = (f"; {stack_run_line(report)}; a second launch "
                         f"equals the first bit for bit: {same2}")
                ok = ok and same2 and stack_run_ok(report)
                if dma:
                    same = torch.equal(got, outs[tag])
                    extra += f"; equals dma=False bit for bit: {same}"
                    ok = ok and same
                else:
                    outs[tag] = got
                ms = time_ms(run)
                loop_ms = time_ms(run, head_start=False)
                cold_ms = time_ms(run, runs=30, before=flush.zero_)
                call_ms = host_ms(run)
                plain_ms = time_ms(plain, runs=20, warmup=2,
                                   head_start=False)
                nbytes, ops = stack_work(fb, kind, x_in, mask, conv, leaves)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[tag] * 1e3
                row = dict(
                    name=name + ("" if (tag, dma) == ("bf16", False)
                                 else f"[{tag}{',dma' if dma else ''}]"),
                    route="cuda", source=SOURCE,
                    replaces=(f"{REF}:599" if dma else
                              f"{REF}:65" if tag == "int8" else replaces),
                    launches=None, max_abs_err=max_abs, ms=ms,
                    plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=None, back_to_back_ms=loop_ms,
                    cold_l2_ms=cold_ms, host_call_ms=call_ms)
                nblocks = _tensors(leaves[0])[0].shape[0]
                log(f"kernel {name} [{form}] {config} T={x_in.shape[0]} "
                    f"dim={x_in.shape[1]} blocks={nblocks}: max_abs_err "
                    f"{max_abs:.3e} max_rel_err {max_rel:.3e} "
                    f"(tol |err| <= {atol} + {rtol}*|plain|) "
                    f"{'PASS' if ok else 'FAIL'}{extra}; kernel {ms:.4f} ms "
                    f"({cold_ms:.4f} ms after an L2 flush, {loop_ms:.4f} ms "
                    f"back to back without a head start; the call takes "
                    f"{call_ms:.4f} ms of host time), plain "
                    f"{plain_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
                    f"({nbytes} bytes, {ops} operations, by "
                    f"{row['bound_by']})")
                if not ok:
                    raise AssertionError(f"{name} [{form}] disagrees with "
                                         f"its plain version, a second "
                                         f"launch, its dma=False form or "
                                         f"its plan")
                rows[(config, kind, tag, dma)] = row
                if (tag, dma) == ("f32", False):
                    next_in = ref  # the next segment's input on the path
            # the unfused nn.Module blocks of the same segment, the nearest
            # thing PyTorch's own calls offer (no single call computes it)
            stacks = {"squeezeformer": (model.conv_squeeze,
                                        model.squeezeformer),
                      "conformer": (model.conv_conform, model.conformer),
                      "transformer": (model.conv_t, model.transformer)}[kind]

            def modules(stacks=stacks):
                with torch.no_grad():
                    h, m = x_in[None], mask[None]
                    for i, blk in enumerate(stacks[1]):
                        for conv in (stacks[0][i] if len(stacks[0]) else ()):
                            h = conv(h, m)
                        h = blk(h, m)
                return h

            mods_ms = time_ms(modules, runs=20, warmup=2, head_start=False)
            log(f"  the same segment as unfused nn.Module blocks (cuBLAS, "
                f"cuDNN, f32): {mods_ms:.4f} ms")
            for key, row in rows.items():
                if key[:2] == (config, kind):
                    row["unfused_modules_ms"] = mods_ms
            x_in = next_in.contiguous()

    # the published Squeezeformer widths that are not multiples of 32 (XS
    # 144 with 4 heads of 36, S 196 with 4 heads of 49, M 324 with 4 heads
    # of 81, whose FFN of 1296 is deeper than a GEMM tile's panel), where
    # the kernel masks the ragged edges of its tiles: preset 5's stacks at
    # those widths, every form against its plain version
    from ishara_tpu_torch.config import baseline_config
    from ishara_tpu_torch.models.encoder import build_model

    for dim in (144, 196, 324):
        cfg = dataclasses.replace(baseline_config(5).model, dim=dim,
                                  num_heads=4)
        model = build_model(cfg, device=DEVICE)
        randomize(model, seed=dim)
        sd = model.state_dict()
        qsd = fb.quantize_serving_weights(sd)
        g = torch.Generator().manual_seed(dim)
        x_in = torch.randn((cfg.frame_len, dim), generator=g).to(DEVICE)
        mask = (torch.arange(cfg.frame_len) < 150).float().to(DEVICE)
        for kind in ("squeezeformer", "conformer"):
            fn = wrappers[kind][0]
            outs = {}
            for tag, dma in [(t, d) for t in storages for d in (False, True)]:
                _, leaves = fenc.encoder_segment_args(
                    cfg, qsd if tag == "int8" else sd, kind, storages[tag])
                got = fn(x_in, mask, leaves, num_heads=4, dma=dma)
                torch.cuda.synchronize()
                report = fb.stack_report()
                same = torch.equal(got, fn(x_in, mask, leaves, num_heads=4,
                                           dma=dma))
                if dma:
                    same = same and torch.equal(got, outs[tag])
                outs[tag] = got
                ref = fb.group_stack_plain(x_in, mask, ((), leaves), kind, 4)
                err = (got - ref).abs()
                atol, rtol = KERNEL_TOL[tag]
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= atol + rtol * ref.abs()).all()) and \
                    stack_run_ok(report) and same
                ms = time_ms(lambda: fn(x_in, mask, leaves, num_heads=4,
                                        dma=dma), runs=20)
                plain_ms = time_ms(lambda: fb.group_stack_plain(
                    x_in, mask, ((), leaves), kind, 4), runs=3, warmup=1,
                    head_start=False)
                nbytes, ops = stack_work(fb, kind, x_in, mask, (), leaves)
                bound = max(nbytes / HBM_BYTES_PER_S,
                            ops / PEAK_OPS_PER_S[tag]) * 1e3
                log(f"kernel {fn.__name__} [{tag} weights"
                    f"{', dma' if dma else ''}] dim={dim} heads=4 T="
                    f"{cfg.frame_len}: max_abs_err {float(err.max()):.3e} "
                    f"(tol |err| <= {atol} + {rtol}*|plain|) "
                    f"{'PASS' if ok else 'FAIL'}; {stack_run_line(report)}; "
                    f"a second launch (and at dma, dma=False) bit-equal: "
                    f"{same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound:.5f} ms")
                if not ok:
                    raise AssertionError(f"{fn.__name__} [{tag}] at dim "
                                         f"{dim} disagrees with its plain "
                                         f"version, a second launch, its "
                                         f"dma=False form or its plan")

    # K5c: one block alone is the stack kernel with N = 1
    model = models["preset5"]
    sd = model.state_dict()
    x_in, mask = stem_output(model, reqs[1][1], 150)
    for kind, block_fn, args_of in (
            ("squeezeformer", fb.fused_squeezeformer_block,
             fb.INNER["squeezeformer"][2]),
            ("conformer", fb.fused_conformer_block,
             fb.INNER["conformer"][2])):
        args = args_of(sd, f"{kind}.0.", torch.bfloat16)
        leaves = fb.stack_block_args([args])
        stack_fn = wrappers[kind][0]
        got = block_fn(x_in, mask, args, num_heads=model.cfg.num_heads)
        ref = fb.group_stack_plain(x_in, mask, ((), leaves), kind,
                                   model.cfg.num_heads)
        err = (got - ref).abs()
        atol, rtol = KERNEL_TOL["bf16"]
        if not bool((err <= atol + rtol * ref.abs()).all()):
            raise AssertionError(f"{block_fn.__name__} disagrees with its "
                                 f"plain version")
        ms = time_ms(lambda: stack_fn(x_in, mask, leaves,
                                      num_heads=model.cfg.num_heads))
        p_ms = time_ms(lambda: fb.group_stack_plain(
            x_in, mask, ((), leaves), kind, model.cfg.num_heads), runs=5,
            warmup=1, head_start=False)
        nbytes, ops = stack_work(fb, kind, x_in, mask, (), leaves)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["bf16"])
        log(f"kernel {block_fn.__name__} [bf16 weights, N=1] max_abs_err "
            f"{float(err.max()):.3e} PASS; kernel {ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound * 1e3:.5f} ms ({nbytes} bytes, "
            f"{ops} operations)")
    return rows


# The kernels of csrc/fused_block.cu, as the profiler's names spell them
# ("(anonymous namespace)::gemm_kernel<...>(...)").
PORT_KERNEL = re.compile(
    r"::(gemm_kernel|attention_kernel|dwconv_kernel|se_gate_kernel|"
    r"eca_gate_kernel|se_apply_kernel|layernorm_kernel|"
    r"stack_persistent_kernel)\b")


def profile_phase(label, engine, reqs, n: int = 20, kernels=PORT_KERNEL):
    """Device time by kernel over ``n`` requests (torch.profiler with
    CUPTI), the port's kernel launches per request (the kernels whose names
    ``kernels`` matches), and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            engine(reqs[i % len(reqs)][1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, _, t in rows)
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    port = [(c, t) for k, c, t in rows if kernels.search(k)]
    log(f"profile: {label}, {n} requests: wall {wall_us / n:.1f} us/request "
        f"with the profiler on, device busy {busy / n:.1f} us/request "
        f"({100 * busy / wall_us:.1f}% of wall); the port's kernels: "
        f"{sum(c for c, _ in port) / n:.1f} launches/request, "
        f"{sum(t for _, t in port) / n:.1f} us/request; all device kernels "
        f"and copies: {sum(c for _, c, _ in rows) / n:.1f} /request")
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:14]:
        m = kernels.search(key)
        name = m.group(1) if m else key[:60]
        if m and "bfloat16" in key:
            name += "<bf16>"
        if m and "signed char" in key:
            name += "<int8>"
        log(f"  {t / n:9.1f} us/request {100 * t / busy:5.1f}% "
            f"{count / n:6.1f} calls/request  {name}")
    return sum(c for c, _ in port) / n


def latencies(engines, reqs, smi, rounds: int = 200, unfused: int = 50):
    """p50/p99 host-clock request latency of every engine. The engines take
    turns, request by request, so that a spell of host noise falls on all of
    them alike; an unfused engine serves only the first ``unfused`` rounds.
    ``engines`` maps a label to (engine, is_fused)."""
    times = {label: [] for label in engines}
    for i in range(rounds):
        raw = reqs[i % len(reqs)][1]
        for label, (engine, fused) in engines.items():
            if not fused and i >= unfused:
                continue
            t0 = time.perf_counter()
            engine(raw)
            times[label].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for label, ts in times.items():
        ts.sort()
        out[label] = (ts[len(ts) // 2], ts[int(len(ts) * 0.99) - 1])
        log(f"latency {label}, {len(ts)} requests: p50 {out[label][0]:.4f} "
            f"ms p99 {out[label][1]:.4f} ms on {smi}")
    return out


def engine_phase(models, reqs, smi):
    """Serve every engine path. Returns {(config, fused, dma):
    {wrapper name: launches over the nine-request run}}."""
    import torch

    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models import fused as fenc
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.ops import fused_block as fb
    from ishara_tpu_torch.preprocess.pipeline import preprocess
    from ishara_tpu_torch.serve import BatchedEngine, InferenceEngine

    tok = CTCTokenizer()
    wrappers = (fb.fused_squeezeformer_stack, fb.fused_conformer_stack,
                fb.fused_conv_group_stack)
    expected = {"preset5": {"fused_squeezeformer_stack",
                            "fused_conformer_stack"},
                "preset3": {"fused_conv_group_stack"},
                "conv_transformer": {"fused_conv_group_stack"}}
    plan = [("preset5", True, False), ("preset5", "int8", False),
            ("preset5", True, True), ("preset5", "int8", True),
            ("preset3", False, False), ("preset3", True, False),
            ("preset3", "int8", False), ("preset3", True, True),
            ("conv_transformer", False, False),
            ("conv_transformer", True, False)]
    engines, results, launches = {}, {}, {}

    def frames(engine, raw):
        n = min(raw.shape[0], engine.max_raw_frames)
        buf = torch.zeros((engine.max_raw_frames, raw.shape[1]),
                          device=DEVICE)
        buf[:n] = torch.from_numpy(raw[:n]).to(DEVICE)
        return preprocess(buf, torch.tensor(max(n, 1), device=DEVICE),
                          engine.stats, engine.frame_len, thin=True)

    for config, fused, dma in plan:
        model = models[config]
        cfg = model.cfg
        label = (f"InferenceEngine(fused={fused!r}, dma={dma}) {config} "
                 f"({cfg.variant})")
        eng = InferenceEngine(model, fused=fused, dma=dma, device=DEVICE)
        engines[(config, fused, dma)] = eng
        eng(reqs[0][1])  # warm-up outside the counted run
        torch.cuda.synchronize()

        # the main path, with the launch counts read around it
        for w in wrappers:
            w.launches = 0
        fb.fused_conv_group_stack.launches_by_inner.clear()
        res = [(label_, *eng(raw)) for label_, raw in reqs]
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        counts.update(
            (f"fused_conv_group_stack[{k}]", n) for k, n in
            fb.fused_conv_group_stack.launches_by_inner.items())
        results[(config, fused, dma)] = res
        launches[(config, fused, dma)] = counts
        log(f"engine {label}: {len(reqs)} requests, kernel launches {counts}")
        for name in expected[config] if fused else ():
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched by {label}")
        if not fused and any(counts.values()):
            raise AssertionError(f"{label} launched a fused kernel")
        for (label_, ids, count) in res:
            if ids.shape != (eng.max_out,) or not 0 <= count <= eng.max_out:
                raise AssertionError(f"{label_}: bad output {ids.shape} "
                                     f"{count}")

        if dma:  # the same ids and counts as the launch-by-launch engine
            for (label_, ids, count), (_, ids0, count0) in zip(
                    res, results[(config, fused, False)]):
                if count != count0 or not np.array_equal(ids, ids0):
                    raise AssertionError(f"{label}: {label_} differs from "
                                         f"the dma=False engine")
            log("  ids and counts equal the dma=False engine's on all "
                "requests PASS")
        elif fused:
            # logits against the unfused model: on the same weights, or at
            # int8 on the dequantized ones
            sd = model.state_dict()
            ref_model = model
            if fused == "int8":
                sd = fb.quantize_serving_weights(sd)
                ref_model = build_model(cfg, device=DEVICE)
                ref_model.load_state_dict(fb.dequantize_serving_weights(sd))
            enc = fenc.FusedEncoder(
                cfg, sd, device=DEVICE,
                compute_dtype="int8" if fused == "int8" else torch.bfloat16)
            worst = 0.0
            for (label_, ids, count), (_, raw) in zip(res, reqs):
                x = frames(eng, raw)
                with torch.no_grad():
                    lf = enc(x)
                    lp = ref_model(x[None])[0]
                if not bool(torch.isfinite(lf).all()):
                    raise AssertionError(f"{label_}: non-finite fused logits")
                err = (lf - lp).abs()
                worst = max(worst, float(err.max()))
                if not bool((err <= LOGIT_TOL[0]
                             + LOGIT_TOL[1] * lp.abs()).all()):
                    raise AssertionError(
                        f"{label}: {label_}: fused logits off the unfused "
                        f"path by {float(err.max()):.3e}")
                agree = int((lf.argmax(-1) == lp.argmax(-1)).sum())
                log(f"  {label_:14s} T={raw.shape[0]:4d} count={count:2d} "
                    f"text={tok.decode(ids[:count])!r} | logits max_abs_err "
                    f"{float(err.max()):.3e}, frame argmax agree {agree}/"
                    f"{lf.shape[0]}")
            against = ("the unfused model on the dequantized weights"
                       if fused == "int8" else "the unfused model")
            log(f"  fused logits vs {against}: max_abs_err {worst:.3e} "
                f"(tol |err| <= {LOGIT_TOL[0]} + {LOGIT_TOL[1]}*|unfused|) "
                f"PASS")
        else:
            with torch.no_grad():
                lp = model(frames(eng, reqs[1][1])[None])[0]
            if lp.shape != (cfg.frame_len, cfg.num_classes) \
                    or not bool(torch.isfinite(lp).all()):
                raise AssertionError(f"{label}: bad logits {lp.shape}")
            log(f"  logits {tuple(lp.shape)} finite PASS")

    timed = {f"InferenceEngine(fused={fused!r}, dma={dma}) {config}":
             (eng, bool(fused))
             for (config, fused, dma), eng in engines.items()}
    # preset 5 unfused, the yardstick of its fused engines
    timed["InferenceEngine(fused=False, dma=False) preset5"] = (
        InferenceEngine(models["preset5"], fused=False, device=DEVICE), False)
    latencies(timed, reqs, smi)

    per_req = {}
    for key in (("preset5", True, False), ("preset5", True, True),
                ("preset3", True, False)):
        per_req[key] = profile_phase(
            f"InferenceEngine(fused=True, dma={key[2]}) {key[0]}",
            engines[key], reqs)
    nstacks = 2
    if abs(per_req[("preset5", True, True)] - nstacks) > 1e-9:
        raise AssertionError(
            f"dma=True launched {per_req[('preset5', True, True)]} port "
            f"kernels a request, not one a stack ({nstacks})")
    log(f"dma=True: one kernel launch a stack ({nstacks} a request) PASS")

    for config, fused in (("preset5", True), ("preset5", "int8"),
                          ("preset3", True)):
        batched = BatchedEngine(models[config], batch_size=4, fused=fused,
                                device=DEVICE)
        bids, bcounts = batched([raw for _, raw in reqs[:4]])
        for i, (label_, ids, count) in enumerate(
                results[(config, fused, False)][:4]):
            if not (np.array_equal(bids[i], ids) and bcounts[i] == count):
                raise AssertionError(
                    f"BatchedEngine(fused={fused!r}) {config} row {i} "
                    f"({label_}) differs from InferenceEngine")
        log(f"BatchedEngine(fused={fused!r}) {config} batch 4: counts "
            f"{bcounts.tolist()} match InferenceEngine")

    for config, fused in (("preset5", True), ("preset5", "int8"),
                          ("preset3", True)):
        model = models[config]
        with torch.no_grad():
            bias = model.classifier.bias
            saved = float(bias[59])
            bias[59] = 1000.0
            probe = InferenceEngine(model, fused=fused, device=DEVICE)
            text = probe.predict_text(reqs[2][1], tok)
            bias[59] = saved
        if text != FALLBACK_TEXT:
            raise AssertionError(f"fallback probe ({config}, fused="
                                 f"{fused!r}) gave {text!r}")
        log(f"fallback probe {config} fused={fused!r}: {text!r} PASS")
    return launches


# ---------------------------------------------------------------------------
# CTC beam serving, export bundles and the exported serving program
# ---------------------------------------------------------------------------

BEAM_W, BEAM_K = 8, 8   # the engines' defaults (the reference's)


def stack_wrappers():
    from ishara_tpu_torch.ops import fused_block as fb

    return (fb.fused_squeezeformer_stack, fb.fused_conformer_stack,
            fb.fused_conv_group_stack)


def zero_stack_counts():
    """Every stack wrapper's launch count and the device's stage counters
    to 0."""
    from ishara_tpu_torch.ops import fused_block as fb

    for w in stack_wrappers():
        w.launches = 0
    fb.fused_conv_group_stack.launches_by_inner.clear()
    for c in fb._COUNTERS.values():
        c.zero_()


def stack_counts() -> dict:
    return {w.__name__: w.launches for w in stack_wrappers()}


STACKS_OF = {"preset5": ("fused_squeezeformer_stack",
                         "fused_conformer_stack"),
             "preset3": ("fused_conv_group_stack",)}


def check_launched(label, counts, config):
    for name in STACKS_OF[config]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by {label}")


def request_log_probs(engine, encoder, raw):
    """The log-probs that ``engine``'s program searches for ``raw``: its
    preprocess, ``encoder`` (the engine's encoder rebuilt from the same
    weights), the f32 log-softmax, on the card."""
    import torch

    from ishara_tpu_torch.preprocess.pipeline import preprocess

    n = min(raw.shape[0], engine.max_raw_frames)
    buf = torch.zeros((engine.max_raw_frames, raw.shape[1]), device=DEVICE)
    buf[:n] = torch.from_numpy(raw[:n]).to(DEVICE)
    cfg = engine.model.cfg
    x = preprocess(buf, torch.tensor(max(n, 1), device=DEVICE), engine.stats,
                   cfg.frame_len, thin=True, dominant_hand=cfg.dominant_hand)
    with torch.no_grad():
        return torch.log_softmax(encoder(x).float(), dim=-1)


def with_fallback(ids, count, max_out):
    """The serving program's fallback: fewer than 3 ids -> the constant
    phrase (cropped to max_out)."""
    from ishara_tpu_torch.serve.engine import FALLBACK_IDS

    if count >= 3:
        return np.asarray(ids), count
    nfb = min(len(FALLBACK_IDS), max_out)
    out = np.full(max_out, 59, np.int64)
    out[:nfb] = FALLBACK_IDS[:nfb]
    return out, nfb


def device_profile(fn):
    """(device kernels and copies, device us, wall us) of one call of
    ``fn`` under torch.profiler, the second of two profiled calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows), wall)


def beam_phase(models, reqs, smi):
    """The CTC prefix beam search in the serving program at W 8, K 8:
    preset 5 through ``InferenceEngine(decode="beam")`` with ``fused``
    True, "int8" and True + dma, preset 3 with ``fused=True`` and
    ``BatchedEngine(decode="beam", fused=True)`` at batch 8; every
    request's ids and counts against the port's search on the CPU on the
    log-probs copied off the card (the same fallback), at K 60 (every
    class) against the host search's best prefix; the stack launches of
    each nine-request run, p50 / p99 beside the greedy engines, and the
    search's own time and device kernels."""
    import torch

    from ishara_tpu_torch.decode.beam import ctc_beam_search
    from ishara_tpu_torch.decode.beam_device import beam_search_device
    from ishara_tpu_torch.models.fused import FusedEncoder
    from ishara_tpu_torch.ops import fused_block as fb
    from ishara_tpu_torch.serve import BatchedEngine, InferenceEngine

    plan = [("preset5", True, False), ("preset5", "int8", False),
            ("preset5", True, True), ("preset3", True, False)]
    beam = dict(decode="beam", beam_width=BEAM_W, beam_top_k=BEAM_K)
    engines, results, launches = {}, {}, {}
    for config, fused, dma in plan:
        model = models[config]
        label = f"InferenceEngine(decode=beam, fused={fused!r}, dma={dma}) " \
            f"{config}"
        eng = InferenceEngine(model, fused=fused, dma=dma, device=DEVICE,
                              **beam)
        engines[(config, fused, dma)] = eng
        eng(reqs[0][1])
        torch.cuda.synchronize()
        zero_stack_counts()
        res = [eng(raw) for _, raw in reqs]
        torch.cuda.synchronize()
        counts = launches[(config, fused, dma)] = stack_counts()
        log(f"beam {label}: {len(reqs)} requests, kernel launches {counts}")
        check_launched(label, counts, config)
        results[(config, fused, dma)] = res

        sd = model.state_dict()
        if fused == "int8":
            sd = fb.quantize_serving_weights(sd)
        enc = FusedEncoder(model.cfg, sd, dma=dma, device=DEVICE,
                           compute_dtype="int8" if fused == "int8"
                           else torch.bfloat16)
        t0 = time.perf_counter()
        for (rl, raw), (ids, count) in zip(reqs, res):
            lp = request_log_probs(eng, enc, raw).cpu()
            want = beam_search_device(lp, beam_width=BEAM_W, top_k=BEAM_K,
                                      max_len=eng.max_out)
            want_ids, want_count = with_fallback(want[0].numpy(),
                                                 int(want[1]), eng.max_out)
            if count != want_count or not np.array_equal(ids, want_ids):
                raise AssertionError(
                    f"{label} {rl}: ids {ids[:count].tolist()} differ from "
                    f"the CPU search's {want_ids[:want_count].tolist()}")
            log(f"  {rl:14s} T={raw.shape[0]:4d} count={count:2d} "
                f"best log-prob {float(want[2]):.4f}")
        log(f"  ids and counts equal the port's beam search on the CPU on "
            f"the card's log-probs, all {len(reqs)} requests "
            f"({time.perf_counter() - t0:.1f} s of CPU search) PASS")

    batched = BatchedEngine(models["preset5"], batch_size=8, fused=True,
                            device=DEVICE, **beam)
    zero_stack_counts()
    bids, bcounts = batched([raw for _, raw in reqs[:8]])
    counts = stack_counts()
    check_launched("BatchedEngine(decode=beam)", counts, "preset5")
    for i, (ids, count) in enumerate(results[("preset5", True, False)][:8]):
        if not (np.array_equal(bids[i], ids) and bcounts[i] == count):
            raise AssertionError(f"BatchedEngine(decode=beam) row {i} "
                                 f"differs from InferenceEngine")
    log(f"BatchedEngine(decode=beam, fused=True) preset5 batch 8: kernel "
        f"launches {counts}, ids equal InferenceEngine's PASS")

    # every class a frame: exact prefix search, the host search's best
    # prefix (max_out at the window's length, so no prefix is cut)
    T = models["preset5"].cfg.frame_len
    exact = InferenceEngine(models["preset5"], fused=True, device=DEVICE,
                            decode="beam", beam_width=BEAM_W, beam_top_k=60,
                            max_out=T)
    enc = FusedEncoder(models["preset5"].cfg, models["preset5"].state_dict(),
                       device=DEVICE)
    zero_stack_counts()
    for rl, raw in reqs:
        ids, count = exact(raw)
        lp = request_log_probs(exact, enc, raw).cpu().numpy()
        best = ctc_beam_search(lp, BEAM_W, 59, top_k_emissions=60)[0][0]
        want_ids, want_count = with_fallback(
            list(best) + [59] * (T - len(best)), len(best), T)
        if count != want_count or not np.array_equal(ids, want_ids):
            raise AssertionError(f"K=60 {rl}: ids differ from the host "
                                 f"search's best prefix")
    check_launched("InferenceEngine(decode=beam, K=60)", stack_counts(),
                   "preset5")
    log(f"InferenceEngine(decode=beam, beam_top_k=60, max_out={T}) preset5: "
        f"ids equal the host ctc_beam_search's best prefix on all "
        f"{len(reqs)} requests PASS")

    timed = {
        "InferenceEngine(greedy, fused=True) preset5": (InferenceEngine(
            models["preset5"], fused=True, device=DEVICE), True),
        "InferenceEngine(greedy, fused=True) preset3": (InferenceEngine(
            models["preset3"], fused=True, device=DEVICE), True)}
    for (config, fused, dma), eng in engines.items():
        timed[f"InferenceEngine(decode=beam, fused={fused!r}, dma={dma}) "
              f"{config}"] = (eng, True)
    latencies(timed, reqs, smi, rounds=20)
    profile_phase("InferenceEngine(decode=beam, fused=True) preset5",
                  engines[("preset5", True, False)], reqs, n=3)

    eng = engines[("preset5", True, False)]
    lp = request_log_probs(eng, FusedEncoder(
        models["preset5"].cfg, models["preset5"].state_dict(),
        device=DEVICE), reqs[1][1])

    def search():
        return beam_search_device(lp, beam_width=BEAM_W, top_k=BEAM_K,
                                  max_len=eng.max_out)

    ms = host_ms(search, runs=10)
    kernels, dev_us, wall_us = device_profile(search)
    log(f"beam_search_device (T {lp.shape[0]}, W {BEAM_W}, K {BEAM_K}, "
        f"max_len {eng.max_out}) alone: {ms:.4f} ms a request (host clock, "
        f"median of 10); {kernels} device kernels and copies a request, "
        f"device busy {dev_us / 1e3:.4f} of {wall_us / 1e3:.4f} ms "
        f"profiled ({100 * dev_us / wall_us:.1f}%) on {smi}")
    return launches


def bundle_phase(models, reqs, smi, workdir: Path):
    """Export bundles and the serving program on the card: preset 5 as
    f32, bf16 and int8 bundles read back by the port's own codec, each
    ``load_engine(fused=True)`` against an engine built directly on the
    same (rounded or dequantized) weights; a translation bundle of the
    reference model served through K9; the fused preset-5 beam program
    through ``export_serving_program`` / ``load_serving_program`` against
    its engine, the stacks launched (the device's stage counter)."""
    import importlib.util

    import torch

    from ishara_tpu_torch.config import EncoderConfig, IsharaConfig
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.models.seq2seq import build_translation_model
    from ishara_tpu_torch.ops import decoder_kernel as dk
    from ishara_tpu_torch.ops import fused_block as fb
    from ishara_tpu_torch.serve import (
        InferenceEngine,
        TranslationEngine,
        export_model,
        export_serving_program,
        load_engine,
        load_serving_program,
    )

    log(f"bundles: msgpack importable here: "
        f"{importlib.util.find_spec('msgpack') is not None}; the port's "
        f"codec reads and writes params.msgpack")
    model = models["preset5"]
    config = IsharaConfig(model=model.cfg)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    forms = {
        "f32": (dict(half_precision=False), sd),
        "bf16": (dict(half_precision=True),
                 {k: v.to(torch.bfloat16).float() if v.is_floating_point()
                  else v for k, v in sd.items()}),
        "int8": (dict(quantize_int8=True), fb.dequantize_serving_weights(
            fb.quantize_serving_weights(sd))),
    }
    for form, (kw, weights) in forms.items():
        d = workdir / f"preset5_{form}"
        export_model(d, config, model, **kw)
        size = (d / "params.msgpack").stat().st_size
        t0 = time.perf_counter()
        got = load_engine(d, fused=True, device=DEVICE)
        load_s = time.perf_counter() - t0
        direct = build_model(model.cfg, device=DEVICE)
        direct.load_state_dict(weights)
        want = InferenceEngine(direct, fused=True, device=DEVICE)
        zero_stack_counts()
        res = [got(raw) for _, raw in reqs]
        counts = stack_counts()
        check_launched(f"load_engine({form} bundle)", counts, "preset5")
        for (rl, raw), (ids, count) in zip(reqs, res):
            want_ids, want_count = want(raw)
            if count != want_count or not np.array_equal(ids, want_ids):
                raise AssertionError(f"{form} bundle {rl}: ids differ from "
                                     f"the engine on the same weights")
        log(f"bundle preset5 {form}: params.msgpack {size} bytes, "
            f"load_engine(fused=True) {load_s:.2f} s, kernel launches "
            f"{counts}, ids equal the engine on the same weights on all "
            f"{len(reqs)} requests PASS")
    if "msgpack" in sys.modules:
        raise AssertionError("the port imported msgpack")

    translation = build_translation_model(device=DEVICE)
    randomize(translation, seed=7)
    tconfig = IsharaConfig(task="translation", model=EncoderConfig(
        dim=translation.feature_dim, num_heads=translation.num_heads,
        num_classes=translation.num_classes, frame_len=TR["T"]))
    d = workdir / "translation_f32"
    export_model(d, tconfig, translation, half_precision=False)
    got = load_engine(d, fused=True, max_out=TR["S"], device=DEVICE)
    want = TranslationEngine(translation, frame_len=TR["T"], max_out=TR["S"],
                             fused=True, device=DEVICE)
    dk.fused_greedy_decode.launches = 0
    res = [got(raw) for _, raw in reqs]
    k9 = dk.fused_greedy_decode.launches
    if k9 != len(reqs):
        raise AssertionError(f"the translation bundle's engine launched K9 "
                             f"{k9} times, not once a request")
    for (rl, raw), (toks, conf) in zip(reqs, res):
        want_toks, want_conf = want(raw)
        if not np.array_equal(toks, want_toks) \
                or abs(conf - want_conf) > 1e-6:
            raise AssertionError(f"translation bundle {rl}: tokens differ")
    log(f"bundle translation (dim {translation.feature_dim}, "
        f"{translation.num_layers} + {translation.num_decoder_layers} "
        f"layers) f32: load_engine(fused=True) K9 launches {k9}, tokens and "
        f"confidence equal the engine on the same weights PASS")

    eng = InferenceEngine(model, fused=True, device=DEVICE, decode="beam",
                          beam_width=BEAM_W, beam_top_k=BEAM_K)
    d = workdir / "program"
    t0 = time.perf_counter()
    export_serving_program(d, eng)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = load_serving_program(d, device=DEVICE)
    load_s = time.perf_counter() - t0

    def run_program(raw):
        n = min(raw.shape[0], eng.max_raw_frames)
        buf = np.zeros((eng.max_raw_frames, raw.shape[1]), np.float32)
        buf[:n] = raw[:n]
        ids, count = program(torch.from_numpy(buf).to(DEVICE),
                             torch.tensor(max(n, 1), dtype=torch.int32)
                             .to(DEVICE))
        return ids.cpu().numpy(), int(count)

    zero_stack_counts()
    stages, res = [], []
    for rl, raw in reqs:
        res.append(run_program(raw))
        stages.append(sum(int(c.item()) for c in fb._COUNTERS.values()))
    counts = stack_counts()
    for (rl, raw), (ids, count) in zip(reqs, res):
        want_ids, want_count = eng(raw)
        if count != want_count or not np.array_equal(ids, want_ids):
            raise AssertionError(f"exported program {rl}: ids differ from "
                                 f"its engine's")
    check_launched("the exported program", counts, "preset5")
    if min(stages) <= 0:
        raise AssertionError("the exported program ran no stack stage on "
                             "the device")
    log(f"export_serving_program (fused, beam) preset5: exported in "
        f"{export_s:.2f} s, loaded in {load_s:.2f} s, "
        f"{(d / 'serving_program.pt2').stat().st_size} bytes; ids equal the "
        f"engine's on all {len(reqs)} requests, stack launches {counts}, "
        f"device stage counter {stages[0]} after a request PASS")
    latencies({"exported program (fused, beam) preset5": (run_program, True),
               "InferenceEngine(decode=beam, fused=True) preset5":
               (eng, True)}, reqs, smi, rounds=10)


# ---------------------------------------------------------------------------
# Training kernels and the training step
# ---------------------------------------------------------------------------

# The flagship training step's shapes (baseline_config(4) at batch 256).
TB, TT, TD, TH, TM, TU, TC = 256, 176, 256, 8, 512, 64, 60


def close(what, got, ref, tol):
    """max |got - ref|; raises unless every element is finite and within
    tol * (max|ref| + |ref|)."""
    got, ref = got.detach().float(), ref.detach().float()
    err = (got - ref).abs()
    bound = tol * (ref.abs().max() + ref.abs())
    if not bool(got.isfinite().all()) or not bool((err <= bound).all()):
        raise AssertionError(
            f"{what}: max_abs_err {float(err.max()):.3e} against max|plain| "
            f"{float(ref.abs().max()):.3e} is outside tol {tol}")
    return float(err.max())


def bound_of(nbytes, ops, dtype_tag):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_tag] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def train_row(name, wrapper, direction, source, replaces, err, ms, plain_ms,
              nbytes, ops, tag, library_ms, smi):
    bound_ms, bound_by = bound_of(nbytes, ops, tag)
    log(f"kernel {name}: max_abs_err {err:.3e} PASS; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
        f"{bound_ms:.5f} ms ({nbytes} bytes, {ops} operations, by "
        f"{bound_by}) on {smi}")
    return dict(name=name, route="cuda", source=CSRC + source,
                replaces=replaces, launches=None, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, counter=(wrapper, direction))


def ctc_chain_floor_ms(T, runs):
    """Device time of one warp stepping T frames of K1's chain arithmetic
    alone (csrc/ctc.cu's ctc_chain_floor_kernel: two shuffles and two
    log-add-exps a step, no loads, launch included): the least a kernel that
    steps the recursion frame by frame can take."""
    import ctypes

    import torch

    from ishara_tpu_torch.ops import _build

    out = torch.empty(32, device=DEVICE)
    fn = _build.function("ctc", "ishara_ctc_chain_floor",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
    launch = lambda: _build.check(  # noqa: E731
        "ctc", fn(_build.device_index(out), T, out.data_ptr(),
                  _build.stream_of(out)), "CTC chain floor")
    return time_ms(launch, runs=runs)


def ctc_kernel_rows(smi, runs):
    """K1: alpha (forward) and beta (backward) against the plain recursions
    and beside F.ctc_loss, at B 256, T 176, U 64, C 60 on two label sets:
    today's (1-30 labels, an all-blank row, a row of repeats, a row of all
    64 labels: 129 states) and the training step's own
    (``SyntheticASLFR(256, seed=3)``, phrases of 3-10 characters: at most
    21 states); a second launch bit for bit; ms a frame beside the chain
    floor; and at T 1024 and 2048 (8 rows) against the plain recursions."""
    import torch
    import torch.nn.functional as F

    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.ops import ctc_kernel as ck

    g = torch.Generator(device=DEVICE).manual_seed(11)
    logits = (2.0 * torch.randn((TB, TT, TC), generator=g, device=DEVICE)
              ).requires_grad_()
    rng = np.random.default_rng(11)
    labels = np.full((TB, TU), 59, np.int32)
    for b in range(TB):
        n = int(rng.integers(1, 31))
        labels[b, :n] = rng.integers(0, 59, n)
    labels[0] = 59                          # a row of all-blank labels
    labels[1, :6] = [7, 7, 7, 3, 3, 7]      # repeats
    labels[2] = rng.integers(0, 59, TU)     # all 64 labels used
    step_labels = SyntheticASLFR(num_sequences=TB, seed=3).batch(
        range(TB), CTCTokenizer(), max_frames=96)["labels"]
    dy = torch.rand((TB,), generator=g, device=DEVICE) + 0.5
    x = logits.detach()
    floor = ctc_chain_floor_ms(TT, runs)
    S = 2 * TU + 1
    b_f = logits.numel() * 4 + labels.size * 4 + TB * 4
    b_b = 2 * logits.numel() * 4 + labels.size * 4 + 2 * TB * 4
    measured = {}
    for tag, lab_np in (("chip_smoke's labels", labels),
                        ("the step's labels", np.asarray(step_labels))):
        lab = torch.from_numpy(lab_np.astype(np.int32)).to(DEVICE)
        fwd = lambda lab=lab: ck.ctc_loss_kernel(  # noqa: E731
            logits, lab, reduction="none")
        nll = fwd()
        bwd = lambda nll=nll: torch.autograd.grad(  # noqa: E731
            nll, logits, dy, retain_graph=True)[0]
        grad = bwd()
        nll2 = fwd()
        grad2 = torch.autograd.grad(nll2, logits, dy)[0]
        torch.cuda.synchronize()
        if not (torch.equal(nll, nll2) and torch.equal(grad, grad2)):
            raise AssertionError(f"ctc kernels on {tag}: a second launch "
                                 f"gave other bits")
        with torch.no_grad():
            ref_nll, alpha = ck.ctc_forward_plain(x, lab)
            ref_grad = ck.ctc_backward_plain(x, lab, alpha, ref_nll, dy)
        e_f = close(f"ctc alpha kernel nll ({tag})", nll, ref_nll,
                    TRAIN_TOL["ctc"])
        e_b = close(f"ctc beta kernel gradient ({tag})", grad, ref_grad,
                    TRAIN_TOL["f32"])
        ms_f, ms_b = time_ms(fwd, runs=runs), time_ms(bwd, runs=runs)
        states = int(2 * (lab_np != 59).sum(1).max() + 1)
        log(f"kernel ctc_loss_kernel {tag} (widest row {states} of {S} "
            f"states): forward {ms_f:.4f} ms ({1e3 * ms_f / TT:.3f} us a "
            f"frame), backward {ms_b:.4f} ms ({1e3 * ms_b / TT:.3f} us a "
            f"frame); nll, gradient max_abs_err {e_f:.3e}, {e_b:.3e}; a "
            f"second launch bit-equal PASS; chain floor {floor:.4f} ms "
            f"({1e3 * floor / TT:.3f} us a frame), bytes bound "
            f"{b_f / HBM_BYTES_PER_S * 1e3:.5f} / "
            f"{b_b / HBM_BYTES_PER_S * 1e3:.5f} ms, on {smi}")
        measured[tag] = (lab, nll, e_f, e_b, ms_f, ms_b, fwd, bwd, alpha,
                         ref_nll)
    lab, nll, e_f, e_b, ms_f, ms_b, fwd, bwd, alpha, ref_nll = \
        measured["chip_smoke's labels"]
    step_f, step_b = measured["the step's labels"][4:6]

    # the library's CTC on the same inputs (log-softmax included, as the
    # kernel includes it); also a third opinion on the value
    lens = torch.full((TB,), TT, dtype=torch.long)
    tlens = torch.from_numpy((labels != 59).sum(1)).to(torch.long)
    lx = x.clone().requires_grad_()

    def lib_fwd():
        return F.ctc_loss(F.log_softmax(lx, -1).transpose(0, 1), lab,
                          lens, tlens, blank=59, reduction="none")

    lib = lib_fwd()
    close("ctc kernel nll against F.ctc_loss", nll, lib.detach(), 1e-4)

    def lib_bwd():
        return torch.autograd.grad(lib, lx, dy, retain_graph=True)[0]

    with torch.no_grad():
        p_f = time_ms(lambda: ck.ctc_forward_plain(x, lab), runs=3,
                      warmup=1, head_start=False)
        p_b = time_ms(lambda: ck.ctc_backward_plain(x, lab, alpha,
                                                    ref_nll, dy),
                      runs=3, warmup=1, head_start=False)
    # long rows, beyond what a [T, C] slab in shared memory allowed (T ~ 950)
    for T in (1024, 2048):
        xl = 2.0 * torch.randn((8, T, TC), generator=g, device=DEVICE)
        labl = lab[:8]
        xr = xl.clone().requires_grad_()
        nll_l = ck.ctc_loss_kernel(xr, labl, reduction="none")
        (grad_l,) = torch.autograd.grad(nll_l, xr, dy[:8])
        torch.cuda.synchronize()
        with torch.no_grad():
            rn, ra = ck.ctc_forward_plain(xl, labl)
            rgl = ck.ctc_backward_plain(xl, labl, ra, rn, dy[:8])
        el = (close(f"ctc alpha kernel nll T {T}", nll_l, rn,
                    TRAIN_TOL["ctc"]),
              close(f"ctc beta kernel gradient T {T}", grad_l, rgl,
                    TRAIN_TOL["ctc_long"]))
        log(f"kernel ctc_loss_kernel [8, {T}, {TC}] U {TU}: nll, gradient "
            f"max_abs_err {el[0]:.3e}, {el[1]:.3e} PASS")
        del xl, xr, nll_l, grad_l, rn, ra, rgl
    ops = TB * TT * (S * 12 + TC * 4)   # two log-add-exps a state, softmax
    src, ref = "ctc.cu", "ishara_tpu/ops/ctc_kernel.py"
    rows = [
        train_row("ctc_loss_kernel[alpha]", ck.ctc_loss_kernel, "launches",
                  src, f"{ref}:163", e_f, ms_f, p_f, b_f, ops, "f32",
                  time_ms(lib_fwd, runs=runs), smi),
        train_row("ctc_loss_kernel[beta]", ck.ctc_loss_kernel,
                  "launches_bwd", src, f"{ref}:218", e_b, ms_b, p_b, b_b,
                  ops, "f32", time_ms(lib_bwd, runs=runs), smi),
    ]
    for row, step_ms in zip(rows, (step_f, step_b)):
        row.update(frames=TT, us_per_frame=1e3 * row["ms"] / TT,
                   chain_floor_ms=floor, step_labels_ms=step_ms)
    return rows


def dropout_kernel_rows(smi, runs, shape=(TB, TT, TD), tags=("bf16", "f32"),
                        forms=("fast_dropout", "fast_dropout_add"),
                        row_tag="bf16", rate=0.4, suffix=""):
    """K2: dropout and dropout-add, forward and backward, at ``shape`` in
    each of ``tags``, against the plain Philox version (exact) and beside
    F.dropout, at ``rate`` and at 0; the timed rows are those of
    ``row_tag``, named with ``suffix``."""
    import torch
    import torch.nn.functional as F

    from ishara_tpu_torch.ops import dropout as dr

    g = torch.Generator(device=DEVICE).manual_seed(12)
    seed = torch.tensor([20240], dtype=torch.int32, device=DEVICE)
    drop = rate
    rows = []
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for tag in tags:
        dt = dtypes[tag]
        x = torch.randn(shape, generator=g, device=DEVICE).to(dt)
        res = torch.randn(shape, generator=g, device=DEVICE).to(dt)
        dy = torch.randn(shape, generator=g, device=DEVICE).to(dt)
        size = x.numel() * x.element_size()
        for form in forms:
            add = form == "fast_dropout_add"
            wrapper = getattr(dr, form)
            errs = []
            for rate in (drop, 0.0):
                xr = x.clone().requires_grad_()
                out = wrapper(res, xr, seed, rate) if add \
                    else wrapper(xr, seed, rate)
                dx = torch.autograd.grad(out, xr, dy)[0]
                ref = dr.dropout_plain(x, seed, rate, res if add else None)
                ref_dx = dr.dropout_plain(dy, seed, rate)
                errs.append(close(f"{form} {tag} rate {rate}", out, ref,
                                  TRAIN_TOL["dropout"]))
                errs.append(close(f"{form} {tag} rate {rate} dx", dx, ref_dx,
                                  TRAIN_TOL["dropout"]))
            kept = float((dr.fast_dropout(x, seed, drop) != 0).float().mean())
            if abs(kept - (1.0 - drop)) > 2e-3:
                raise AssertionError(f"{form} {tag}: keep share {kept}")
            xr = x.clone().requires_grad_()
            out = wrapper(res, xr, seed, drop) if add \
                else wrapper(xr, seed, drop)

            def fwd(add=add, wrapper=wrapper, x=x, res=res):
                return wrapper(res, x, seed, drop) if add \
                    else wrapper(x, seed, drop)

            def bwd(out=out, xr=xr, dy=dy):
                return torch.autograd.grad(out, xr, dy, retain_graph=True)

            lx = x.clone().requires_grad_()

            def lib(add=add, x=lx, res=res):
                y = F.dropout(x, drop, training=True)
                return res + y if add else y

            lout = lib()

            def lib_bwd(lout=lout, lx=lx, dy=dy):
                return torch.autograd.grad(lout, lx, dy, retain_graph=True)

            def plain(add=add, x=x, res=res):
                return dr.dropout_plain(x, seed, drop, res if add else None)

            p_ms = time_ms(plain, runs=3, warmup=1, head_start=False)
            f_ms, b_ms = time_ms(fwd, runs=runs), time_ms(bwd, runs=runs)
            l_ms = time_ms(lib, runs=runs)
            lb_ms = time_ms(lib_bwd, runs=runs)
            log(f"kernel {form} [{tag}] {list(shape)} rate {drop} and 0, "
                f"forward and dx: equal to the plain Philox version "
                f"(max_abs_err {max(errs):.1e}), keep share {kept:.4f} PASS; "
                f"forward {f_ms:.4f} ms backward {b_ms:.4f} ms plain "
                f"{p_ms:.4f} ms F.dropout{' + add' if add else ''} "
                f"{l_ms:.4f} ms, its backward {lb_ms:.4f} ms on {smi}")
            if tag != row_tag:
                continue        # the timed path's tensors are row_tag's
            ref_line = 154 if add else 93
            for name, direction, ms, nb, lib_ms in (
                    (form + suffix, "launches", f_ms,
                     (3 if add else 2) * size, l_ms),
                    (form + "[bwd]" + suffix, "launches_bwd", b_ms,
                     2 * size, lb_ms)):
                rows.append(train_row(
                    name, wrapper, direction, "dropout.cu",
                    f"ishara_tpu/ops/dropout.py:{ref_line}", max(errs), ms,
                    p_ms, nb, x.numel(), tag, lib_ms, smi))
    return rows


def attention_kernel_rows(smi, runs):
    """K3: forward and dq / dk / dv against the plain version with the same
    Philox mask, dropout 0.4 and 0, bf16 and f32, a fully masked row, heads
    of 32, 64, 48 and 128, the same bits on a second backward; beside
    F.scaled_dot_product_attention. Both directions' design by
    ``attention_plan``: bf16 heads of 32 and 64 on the wgmma design (the
    forward of csrc/attention_fwd_wg.cuh, whose keep bits equal
    ``keep_mask``'s bit for bit; the backward of csrc/attention_bwd.cuh on
    them), f32 and bf16 48 / 128 on the general kernels; each check asserts
    the design each launch took."""
    import torch
    import torch.nn.functional as F

    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops.dropout import keep_mask

    def took(design, launch, direction="backward"):
        """Runs ``launch``; raises unless it made one launch of K3 in
        ``direction`` and that one on ``design``."""
        counts = (at.flash_mhsa.launches_bwd_by_design
                  if direction == "backward"
                  else at.flash_mhsa.launches_by_design)
        before = dict(counts)
        result = launch()
        torch.cuda.synchronize()
        got = {d: n - before[d] for d, n in counts.items() if n != before[d]}
        if got != {design: 1}:
            raise AssertionError(f"K3's {direction} took {got}, expected one "
                                 f"launch on the {design} design")
        return result

    Dh = TD // TH
    scale = TD ** -0.5
    g = torch.Generator(device=DEVICE).manual_seed(13)
    seed = torch.tensor([977], dtype=torch.int32, device=DEVICE)
    lengths = torch.randint(40, TT + 1, (TB,), generator=g, device=DEVICE)
    lengths[0] = 0                                   # every key masked
    lengths[1] = TT
    bias = at.mask_to_bias(torch.arange(TT, device=DEVICE)[None, :]
                           < lengths[:, None])
    rows = []
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        # q, k, v as the layer makes them: views of one [B, T, H, 3 Dh] tensor
        qkv = torch.randn((TB, TT, TH, 3 * Dh), generator=g,
                          device=DEVICE).to(dt).requires_grad_()
        d_o = torch.randn((TB, TH, TT, Dh), generator=g,
                          device=DEVICE).to(dt)

        def split(t):
            return t.transpose(1, 2).split(Dh, dim=-1)

        design = "wgmma" if tag == "bf16" else "general"
        errs = {}
        for rate in (0.4, 0.0):
            q, k, v = split(qkv)
            o = took(design, lambda: at.flash_mhsa(q, k, v, bias, seed, scale,
                                                   rate), "forward")
            dq, dk, dv = took(design, lambda: torch.autograd.grad(
                o, (q, k, v), d_o))
            with torch.no_grad():
                qd, kd, vd = split(qkv.detach())
                ro, lse = at.mhsa_forward_plain(qd, kd, vd, bias, seed, scale,
                                                rate)
                rq, rk, rv = at.mhsa_backward_plain(
                    qd, kd, vd, bias, seed, ro, lse, d_o, scale, rate)
            tol = TRAIN_TOL[tag]
            errs[rate] = (
                close(f"attention {tag} rate {rate} o", o, ro, tol),
                max(close(f"attention {tag} rate {rate} d{n}", a, b, tol)
                    for n, a, b in (("q", dq, rq), ("k", dk, rk),
                                    ("v", dv, rv))))
            if rate == 0.0:     # and against the plain einsum oracle
                close(f"attention {tag} against reference_mhsa", o,
                      at.reference_mhsa(qd, kd, vd, bias, scale), tol)
            del ro, lse, rq, rk, rv
        q, k, v = split(qkv)
        o = at.flash_mhsa(q, k, v, bias, seed, scale, 0.4)

        def fwd(q=q, k=k, v=v):
            return at.flash_mhsa(q, k, v, bias, seed, scale, 0.4)

        def bwd(o=o, q=q, k=k, v=v, d_o=d_o):
            return torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)

        lq = qkv.detach().clone().requires_grad_()
        mask = bias[:, None, None, :].to(dt)

        def lib_fwd(lq=lq, mask=mask):
            a, b, c = split(lq)
            return F.scaled_dot_product_attention(
                a, b, c, attn_mask=mask, dropout_p=0.4, scale=scale)

        lo = lib_fwd()

        def lib_bwd(lo=lo, lq=lq, d_o=d_o):
            return torch.autograd.grad(lo, lq, d_o, retain_graph=True)

        with torch.no_grad():
            qd, kd, vd = split(qkv.detach())
            ro, lse = at.mhsa_forward_plain(qd, kd, vd, bias, seed, scale, 0.4)
            p_f = time_ms(lambda: at.mhsa_forward_plain(
                qd, kd, vd, bias, seed, scale, 0.4), runs=3, warmup=1,
                head_start=False)
            p_b = time_ms(lambda: at.mhsa_backward_plain(
                qd, kd, vd, bias, seed, ro, lse, d_o, scale, 0.4), runs=3,
                warmup=1, head_start=False)
        f_ms, b_ms = time_ms(fwd, runs=runs), time_ms(bwd, runs=runs)
        f0_ms = time_ms(lambda: at.flash_mhsa(q, k, v, bias, seed, scale,
                                              0.0), runs=runs)
        lf_ms, lb_ms = time_ms(lib_fwd, runs=runs), time_ms(lib_bwd, runs=runs)
        size = TB * TH * TT * Dh * qkv.element_size()
        small = bias.numel() * 4 + TB * TH * TT * 4       # bias and lse
        log(f"kernel flash_mhsa [{tag}] q, k, v [{TB}, {TH}, {TT}, {Dh}] "
            f"(o, d(q|k|v)) max_abs_err: rate 0.4 {errs[0.4]}, rate 0 "
            f"{errs[0.0]}, row 0 fully masked and finite PASS; forward "
            f"({design}) {f_ms:.4f} ms (at rate 0 {f0_ms:.4f} ms) backward "
            f"({design}) {b_ms:.4f} ms; plain "
            f"{p_f:.4f} / {p_b:.4f} ms; F.scaled_dot_product_attention "
            f"{lf_ms:.4f} / {lb_ms:.4f} ms: the kernel's forward "
            f"{f_ms / lf_ms:.3f}x, backward {b_ms / lb_ms:.3f}x the "
            f"library's; {TB * TH * TT * TT} exponentials a direction, "
            f"{TB * TH * TT * TT / MUFU_PER_S * 1e3:.4f} ms at 16 a clock an "
            f"SM on {smi}")
        if tag != "bf16":
            continue
        if not b_ms < lb_ms:
            raise AssertionError(f"K3's wgmma backward {b_ms:.4f} ms is not "
                                 f"below F.scaled_dot_product_attention's "
                                 f"{lb_ms:.4f} ms")
        again = took(design, lambda: torch.autograd.grad(
            o, (q, k, v), d_o, retain_graph=True))
        first = torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"attention {tag}: a second backward gave "
                                 f"other bits")
        log(f"  attention {tag}: the same bits on a second backward PASS")
        with torch.no_grad():
            _, _, kb = at._launch_fwd(*split(qkv.detach()), bias, seed,
                                      scale, 0.4)
            same = torch.equal(kb, at.pack_keep_bits(
                keep_mask(seed, (TB, TH, TT, TT), 0.4)))
        # the bits are the wgmma design's own traffic (the mask can be drawn
        # again from the seed): the K3 rows' bound_ms leaves them out
        log(f"  attention {tag}: the forward's keep bits ({kb.numel() * 4} "
            f"bytes, {kb.numel() * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
            f"memory rate, written by the forward and read by the backward "
            f"besides the bound's bytes) equal keep_mask's bit for bit "
            f"{'PASS' if same else 'FAIL'}")
        if not same:
            raise AssertionError("K3's forward wrote other keep bits than "
                                 "keep_mask's")
        del kb
        # heads of 64 (4 heads at dim 256, presets 1 and 2: the wgmma
        # backward), of 48 (the general passes, padded to 64) and of 128
        # (2 heads at dim 256: the general passes)
        for Hx, Dx, dx in ((TH // 2, 2 * Dh, "wgmma"), (4, 48, "general"),
                           (2, 128, "general")):
            q4 = torch.randn((TB, TT, Hx, 3 * Dx), generator=g,
                             device=DEVICE).to(dt).requires_grad_()
            d4 = torch.randn((TB, Hx, TT, Dx), generator=g,
                             device=DEVICE).to(dt)
            qa, ka, va = q4.transpose(1, 2).split(Dx, dim=-1)
            o4 = took(dx, lambda: at.flash_mhsa(qa, ka, va, bias, seed,
                                                scale, 0.4), "forward")
            g4 = took(dx, lambda: torch.autograd.grad(
                o4, (qa, ka, va), d4, retain_graph=True))
            with torch.no_grad():
                qd, kd, vd = q4.detach().transpose(1, 2).split(Dx, dim=-1)
                ro, lse = at.mhsa_forward_plain(qd, kd, vd, bias, seed, scale,
                                                0.4)
                rg = at.mhsa_backward_plain(qd, kd, vd, bias, seed, ro, lse,
                                            d4, scale, 0.4)
            e4 = (close(f"attention Dh {Dx} o", o4, ro, tol),
                  max(close(f"attention Dh {Dx} d{n}", a, b, tol)
                      for n, a, b in zip("qkv", g4, rg)))
            f4 = time_ms(lambda: at.flash_mhsa(qa, ka, va, bias, seed, scale,
                                               0.4), runs=5)
            b4 = time_ms(lambda: torch.autograd.grad(
                o4, (qa, ka, va), d4, retain_graph=True), runs=5)
            log(f"kernel flash_mhsa [{tag}] q, k, v [{TB}, {Hx}, {TT}, {Dx}] "
                f"rate 0.4 (o, d(q|k|v)) max_abs_err {e4} PASS; forward "
                f"({dx}) {f4:.4f} ms backward ({dx}) {b4:.4f} ms on {smi}")
            del q4, d4, o4, g4, ro, lse, rg
        ref = "ishara_tpu/ops/attention.py"
        ops_f = 4 * TB * TH * TT * TT * Dh          # q.k and p.v
        wg = design == "wgmma"
        rows.append(train_row(
            "flash_mhsa", at.flash_mhsa, "launches",
            "attention_fwd_wg.cuh" if wg else "attention_tc.cuh",
            f"{ref}:131", errs[0.4][0], f_ms, p_f, 4 * size + small, ops_f,
            tag, lf_ms, smi))
        rows.append(train_row(
            "flash_mhsa[bwd]", at.flash_mhsa, "launches_bwd",
            "attention_bwd.cuh" if wg else "attention_tc.cuh", f"{ref}:168",
            errs[0.4][1], b_ms, p_b, 8 * size + small, 5 * ops_f // 2, tag,
            lb_ms, smi))
    return rows


# K4 shapes whose plans are held to the C rule: the flagship and the card
# tests' shapes, 384 / 768, off-grid widths and a rank's half of a hidden
K4_PLAN_SHAPES = ((256, 512), (128, 256), (128, 128), (64, 128), (192, 512),
                  (256, 256), (256, 1024), (384, 384), (256, 768),
                  (768, 256), (384, 768), (20, 36), (70, 100), (36, 20),
                  (256, 1536), (320, 512))


def k4_plan_and_instructions():
    """K4's plan: ``ffn_plan`` against csrc/ffn.cu's own rule at every
    shape of ``K4_PLAN_SHAPES``; ptxas's report of the wgmma design's
    kernels (at most 255 registers a thread, no stack frame, no spills);
    and Hopper's own instructions in the built library: HGMMA in the wgmma
    design's forward and row kernels, TMA (cp.async.bulk.tensor) for their
    tiles."""
    import torch

    from ishara_tpu_torch.ops import _build
    from ishara_tpu_torch.ops import ffn_kernel as fk

    for dtype in (torch.bfloat16, torch.float32):
        for k, m in K4_PLAN_SHAPES:
            py, c = fk.ffn_plan(dtype, k, m), fk.c_plan(dtype, k, m)
            if py != c:
                raise AssertionError(f"ffn_plan({dtype}, {k}, {m}) = {py}, "
                                     f"the C plan {c}")
    flagship = fk.ffn_plan(torch.bfloat16, TD, TM)
    log(f"K4 plan: ffn_plan equals the C plan at {len(K4_PLAN_SHAPES)} "
        f"shapes x 2 dtypes; the flagship ({TD}, {TM}) takes "
        f"{flagship.design}: {flagship.tile_rows}-row tiles, "
        f"{flagship.fwd_slots} / {flagship.bwd_slots} weight slots, "
        f"{flagship.fwd_smem} / {flagship.bwd_smem} bytes of shared memory, "
        f"{flagship.acc_regs} accumulator registers a thread of "
        f"{flagship.reg_limit} PASS")
    build_log = _build.build_log("ffn")
    serialised = [line for line in build_log.splitlines()
                  if "C7512" in line and "_wg_kernel" in line]
    regs = {}
    for entry in build_log.split("Function properties for ")[1:]:
        name = entry.split(maxsplit=1)[0]
        if "_wg_kernel" in name:
            used = re.search(r"Used (\d+) registers", entry)
            spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                               r"stores, (\d+) bytes spill loads", entry)
            regs[name] = (int(used.group(1)) if used else None,
                          tuple(int(v) for v in spills.groups())
                          if spills else None)
    # K4's two kernels at K 64 to 256, and the weight product of wgrad.cuh
    fit = len(regs) == 9 and not serialised and all(
        r is not None and r <= 255 and sp == (0, 0, 0)
        for r, sp in regs.values())
    log(f"K4 registers (ptxas -v, the {len(regs)} wgmma kernel instances, "
        f"the weight product's included): "
        f"used {sorted({r for r, _ in regs.values()}, key=str)} a thread at "
        f"launch, stack / spill stores / spill loads "
        f"{sorted({sp for _, sp in regs.values()}, key=str)} bytes, "
        f"{len(serialised)} serialised (C7512) {'PASS' if fit else 'FAIL'}")
    if not fit:
        raise AssertionError(f"the wgmma kernels spill, serialise wgmma or "
                             f"exceed 255 registers: {regs} {serialised}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(_build.build()["ffn"])], capture_output=True,
                          text=True, check=True).stdout
    hgmma = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(maxsplit=1)[0]
        for kernel in ("ffn_fwd_wg_kernel", "ffn_bwd_wg_kernel"):
            if f"{len(kernel)}{kernel}" in name:  # as the name is mangled
                hgmma[kernel] = hgmma.get(kernel, 0) + section.count("HGMMA")
    src = _build.SRC_DIR
    tma = "cp.async.bulk.tensor" in (src / "hopper.cuh").read_text() \
        and "tma_load(" in (src / "ffn.cu").read_text()
    ok = hgmma.get("ffn_fwd_wg_kernel", 0) > 0 \
        and hgmma.get("ffn_bwd_wg_kernel", 0) > 0 and tma
    log(f"K4 instructions (cuobjdump --dump-sass of the ffn library): HGMMA "
        f"in each kernel {hgmma}; weight tiles by TMA "
        f"(cp.async.bulk.tensor) {tma} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the wgmma design's kernels lack HGMMA or TMA")


def ffn_kernel_rows(smi, runs):
    """K4: forward and all seven gradients against the plain version with
    the same Philox masks, at the Squeezeformer sites' rates (0.4, 0.4), the
    Conformer sites' (0.4, 0) and without dropout; the masks bit for bit;
    beside the F.linear / silu / dropout composition."""
    import torch
    import torch.nn.functional as F

    from ishara_tpu_torch.ops import ffn_kernel as fk
    from ishara_tpu_torch.ops.dropout import keep_mask

    g = torch.Generator(device=DEVICE).manual_seed(14)
    seeds = torch.tensor([31337, 4242], dtype=torch.int32, device=DEVICE)
    N = TB * TT

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * scale

    x = rand(TB, TT, TD).to(torch.bfloat16).requires_grad_()
    res = rand(TB, TT, TD).to(torch.bfloat16).requires_grad_()
    dy = rand(TB, TT, TD).to(torch.bfloat16)
    params = [rand(TD, TM, scale=TD ** -0.5), rand(TM, scale=0.1),
              rand(TM, TD, scale=TM ** -0.5), rand(TD, scale=0.1)]
    for p in params:
        p.requires_grad_()
    w1, b1, w2, b2 = params

    k4_plan_and_instructions()
    k1, k2 = fk.debug_masks(N, TM, TD, seeds, 0.4, 0.4)
    same = bool(torch.equal(k1.bool(), keep_mask(seeds[0:1], (N, TM), 0.4))) \
        and bool(torch.equal(k2.bool(), keep_mask(seeds[1:2], (N, TD), 0.4)))
    # ... and the plain Philox gives the same words on the CPU
    cpu = keep_mask(seeds[0:1].cpu(), (64, TM), 0.4)
    same = same and bool(torch.equal(k1[:64].bool().cpu(), cpu))
    log(f"debug_masks [{N}, {TM}] and [{N}, {TD}] at rate 0.4: equal to the "
        f"plain PyTorch Philox bit for bit: {same}; keep share "
        f"{float(k1.mean()):.4f} {'PASS' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the kernels' masks differ from the plain "
                             "PyTorch Philox")
    del k1, k2

    names = ("dx", "dres", "dw1", "db1", "dw2", "db2")
    errs = {}
    for r1, r2 in ((0.4, 0.4), (0.4, 0.0), (0.0, 0.0)):
        out = fk.ffn_residual(x, res, w1, b1, w2, b2, seeds, r1, r2)
        grads = torch.autograd.grad(out, [x, res] + params, dy)
        torch.cuda.synchronize()
        with torch.no_grad():
            x2, dy2 = x.reshape(N, TD), dy.reshape(N, TD)
            w1c, w2c = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
            ref = fk.ffn_forward_plain(x2, res.reshape(N, TD), w1c, b1, w2c,
                                       b2, seeds, r1, r2)
            rdx, rdw1, rdb1, rdw2, rdb2 = fk.ffn_backward_plain(
                x2, dy2, w1c, b1, w2c, seeds, r1, r2)
        tol = TRAIN_TOL["bf16"]
        e_out = close(f"ffn rates {r1}/{r2} out", out.reshape(N, TD), ref, tol)
        refs = (rdx, dy2, rdw1, rdb1, rdw2, rdb2)
        e_g = {n: close(f"ffn rates {r1}/{r2} {n}",
                        a.reshape(b.shape), b, tol)
               for n, a, b in zip(names, grads, refs)}
        errs[(r1, r2)] = (e_out, max(e_g.values()))
        log(f"kernel ffn_residual [bf16] x [{N}, {TD}] hidden {TM} rates "
            f"{r1}/{r2}: out max_abs_err {e_out:.3e}; gradients "
            + ", ".join(f"{n} {e:.3e}" for n, e in e_g.items())
            + f" (tol {tol} * (max|plain| + |plain|)) PASS")
    # the weight gradients are sums in a fixed order: the same bits again
    again = torch.autograd.grad(
        fk.ffn_residual(x, res, w1, b1, w2, b2, seeds, 0.0, 0.0),
        params, dy)
    if not all(torch.equal(a, b) for a, b in zip(again, grads[2:])):
        raise AssertionError("ffn weight gradients differ from run to run")
    log("  weight gradients equal bit for bit from run to run PASS")

    # the general kernels (f32 operands, which no tensor-core tile takes) at
    # the same width: what an f32 model's training step runs
    xf, rf = (t.detach().float().requires_grad_() for t in (x, res))
    dyf = dy.float()
    tol = TRAIN_TOL["f32"]
    for r1, r2 in ((0.4, 0.4), (0.4, 0.0), (0.0, 0.0)):
        out = fk.ffn_residual(xf, rf, w1, b1, w2, b2, seeds, r1, r2)
        grads = torch.autograd.grad(out, [xf, rf] + params, dyf,
                                    retain_graph=True)
        torch.cuda.synchronize()
        with torch.no_grad():
            x2, dy2 = xf.reshape(N, TD), dyf.reshape(N, TD)
            ref = fk.ffn_forward_plain(x2, rf.reshape(N, TD), w1, b1, w2, b2,
                                       seeds, r1, r2)
            refs = fk.ffn_backward_plain(x2, dy2, w1, b1, w2, seeds, r1, r2)
        e_out = close(f"ffn f32 rates {r1}/{r2} out", out.reshape(N, TD),
                      ref, tol)
        refs = (refs[0], dy2) + tuple(refs[1:])
        e_g = max(close(f"ffn f32 rates {r1}/{r2} {n}", a.reshape(b.shape),
                        b, tol)
                  for n, a, b in zip(names, grads, refs))
        times = ""
        if (r1, r2) == (0.4, 0.4):
            f_ms = time_ms(lambda: fk.ffn_residual(
                xf, rf, w1, b1, w2, b2, seeds, 0.4, 0.4), runs=5)
            b_ms = time_ms(lambda: torch.autograd.grad(
                out, [xf, rf] + params, dyf, retain_graph=True), runs=5)
            times = f"; forward {f_ms:.4f} ms backward {b_ms:.4f} ms on {smi}"
        log(f"kernel ffn_residual [f32] x [{N}, {TD}] hidden {TM} rates "
            f"{r1}/{r2}: out max_abs_err {e_out:.3e}, gradients {e_g:.3e} "
            f"(tol {tol} * (max|plain| + |plain|)) PASS{times}")
    del xf, rf, dyf, out, grads, ref, refs

    out = fk.ffn_residual(x, res, w1, b1, w2, b2, seeds, 0.4, 0.4)

    def fwd():
        return fk.ffn_residual(x, res, w1, b1, w2, b2, seeds, 0.4, 0.4)

    def bwd():
        return torch.autograd.grad(out, [x, res] + params, dy,
                                   retain_graph=True)

    lx = x.detach().clone().requires_grad_()
    lw = [p.detach().to(torch.bfloat16).requires_grad_() for p in params]

    def lib_fwd():
        h = F.dropout(F.silu(F.linear(lx, lw[0].t(), lw[1])), 0.4, True)
        return res + F.dropout(F.linear(h, lw[2].t(), lw[3]), 0.4, True)

    lo = lib_fwd()

    def lib_bwd():
        return torch.autograd.grad(lo, [lx] + lw, dy, retain_graph=True)

    with torch.no_grad():
        x2, dy2 = x.reshape(N, TD), dy.reshape(N, TD)
        w1c, w2c = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
        p_f = time_ms(lambda: fk.ffn_forward_plain(
            x2, res.reshape(N, TD), w1c, b1, w2c, b2, seeds, 0.4, 0.4),
            runs=3, warmup=1, head_start=False)
        p_b = time_ms(lambda: fk.ffn_backward_plain(
            x2, dy2, w1c, b1, w2c, seeds, 0.4, 0.4), runs=3, warmup=1,
            head_start=False)
    size = N * TD * 2
    weights = 2 * TD * TM * 2 + (TD + TM) * 4
    ref = "ishara_tpu/ops/ffn_kernel.py"
    return [
        train_row("ffn_residual", fk.ffn_residual, "launches", "ffn.cu",
                  f"{ref}:153", errs[(0.4, 0.4)][0], time_ms(fwd, runs=runs),
                  p_f, 3 * size + weights, 4 * N * TD * TM, "bf16",
                  time_ms(lib_fwd, runs=runs), smi),
        # x and dy read, dx written, the weights read and their f32
        # gradients written; five products (the hidden is recomputed)
        train_row("ffn_residual[bwd]", fk.ffn_residual, "launches_bwd",
                  "ffn.cu", f"{ref}:177", errs[(0.4, 0.4)][1],
                  time_ms(bwd, runs=runs), p_b, 3 * size + 3 * weights,
                  10 * N * TD * TM, "bf16", time_ms(lib_bwd, runs=runs), smi),
    ]


def weight_product_rows(smi, runs):
    """The weight product of K4's and K7's backwards (csrc/wgrad.cuh, the
    wgmma kernel and the fixed-order sum of its row splits, through
    ``ffn_kernel.weight_product``) against its plain version, an f32 matmul
    of the widened operands, at the flagship's shapes (x^T dh and g^T d of
    K4, xn^T du and s^T dp of K7: N 45056 rows, 256 x 512 and 512 x 256), at
    a row count off the 64-row step, and on the general kernel (f32 and
    widths off the 8-grid); the same bits on a second launch; timed beside
    the plain version and ``torch.mm`` with an f32 output (a yardstick
    only)."""
    import torch

    from ishara_tpu_torch.ops import ffn_kernel as fk

    g = torch.Generator(device=DEVICE).manual_seed(21)
    N = TB * TT
    rows, errs, times = [], {}, {}
    for n, p, q, dt in ((N, TD, TM, torch.bfloat16),
                        (N, TM, TD, torch.bfloat16),
                        (N - 37, TD, TM, torch.bfloat16),
                        (515, TD, TM, torch.float32),
                        (515, 36, 20, torch.bfloat16)):
        a = torch.randn((n, p), generator=g, device=DEVICE).to(dt)
        b = torch.randn((n, q), generator=g, device=DEVICE).to(dt)
        design = fk.product_design(dt, p, q)
        before = dict(fk.weight_product.launches_by_design)
        got = fk.weight_product(a, b)
        torch.cuda.synchronize()
        if fk.weight_product.launches_by_design != dict(
                before, **{design: before[design] + 1}):
            raise AssertionError(f"the weight product [{n}, {p}] x [{n}, "
                                 f"{q}] did not launch on {design}")
        want = a.float().T @ b.float()
        what = f"weight product {str(dt)[6:]} [{n}, {p}]^T [{n}, {q}]"
        err = close(what, got, want, 1e-4)
        if not torch.equal(got, fk.weight_product(a, b)):
            raise AssertionError(f"{what}: a second launch gave other bits")
        log(f"  {what} ({design}): max_abs_err {err:.3e} against the f32 "
            f"matmul, the same bits on a second launch PASS")
        if n == N and dt == torch.bfloat16:
            errs[(p, q)] = err
            ms = time_ms(lambda: fk.weight_product(a, b), runs=runs)
            plain = time_ms(lambda: a.float().T @ b.float(), runs=5)
            try:
                lib = time_ms(lambda: torch.mm(a.T, b,
                                               out_dtype=torch.float32),
                              runs=runs)
            except (RuntimeError, TypeError):
                lib = None
            times[(p, q)] = (ms, plain, lib)
            log(f"kernel weight_product [{n}, {p}]^T [{n}, {q}] bf16: "
                f"{ms:.4f} ms (the product over {fk.wgrad_splits(n, p, q)} "
                f"row splits and their sum); plain {plain:.4f} ms; torch.mm "
                f"with an f32 output "
                f"{'none' if lib is None else f'{lib:.4f} ms'} on {smi}")
        del a, b, got, want
    # K4's dw1 x^T dh ([N, 256]^T [N, 512]); dw2 and K7's are the same
    # sizes. Bytes: each operand read once, the f32 result written once.
    ms, plain, lib = times[(TD, TM)]
    rows.append(train_row(
        "weight_product", fk.weight_product, "launches", "wgrad.cuh",
        "ishara_tpu/ops/ffn_kernel.py:104", errs[(TD, TM)], ms, plain,
        N * (TD + TM) * 2 + TD * TM * 4, 2 * N * TD * TM, "bf16", lib, smi))
    return rows


def train_kernel_phase(smi, runs: int = 20):
    """Every training kernel against its plain version at full width, timed
    beside its plain version, its bound and a library call."""
    import torch

    rows = []
    for make in (ctc_kernel_rows, dropout_kernel_rows, attention_kernel_rows,
                 ffn_kernel_rows, weight_product_rows):
        rows += make(smi, runs)
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def plain_versions():
    """Within the block every training wrapper computes with its plain
    PyTorch version instead of launching its kernel, on the same tensors:
    the yardstick for one whole training step. (The package itself has no
    such switch: on a CUDA tensor a wrapper launches or raises.)"""
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab
    from ishara_tpu_torch.ops import conv_kernel as cm
    from ishara_tpu_torch.ops import ctc_kernel as ck
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.ops import ffn_kernel as fk

    swaps = [
        (dr, "_launch", lambda x, res, seed, rate, offset=0, runs=None:
            dr.dropout_plain(x, seed, rate, res, offset, runs)),
        (at, "_launch_fwd", lambda *a, **kw:
            (*at.mhsa_forward_plain(*a, **kw), None)),
        (at, "_launch_bwd", lambda *a, bits=None, **kw:
            at.mhsa_backward_plain(*a, **kw)),
        (fk, "_launch_fwd", lambda *a, **kw:
            fk.ffn_forward_plain(*a, **kw)),
        (fk, "_launch_bwd", lambda *a, **kw:
            fk.ffn_backward_plain(*a, **kw)),
        (ck, "_launch_alpha", lambda logits, labels, blank_id, want_alpha:
            ck.ctc_forward_plain(logits, labels, blank_id)),
        (ck, "_launch_beta", lambda logits, labels, alpha, nll, dy, blank_id:
            ck.ctc_backward_plain(logits, labels, alpha, nll, dy, blank_id)),
        (ab, "_launch_fwd", lambda q, k, v, bias, scale, Tp:
            ab.blocked_attention_forward_plain(q, k, v, bias, scale)),
        (ab, "_launch_bwd", lambda q, k, v, bias, o, lse, d_o, scale:
            ab.blocked_attention_backward_plain(q, k, v, bias, o, lse, d_o,
                                                scale)),
        (cm, "_launch_fwd", lambda x, args:
            cm.conv_module_forward_plain(x, *args, with_p=True)),
        (cm, "_launch_bwd", lambda x, dy, args, p:
            cm.conv_module_backward_plain(x, args[0], dy, *args[1:], p=p)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def zero_k4_designs():
    from ishara_tpu_torch.ops import ffn_kernel as fk

    for counts in (fk.ffn_residual.launches_by_design,
                   fk.ffn_residual.launches_bwd_by_design):
        for design in counts:
            counts[design] = 0


def log_k4_designs(label, steps, require=None):
    """Logs K4's launches by design (``ffn_plan``) since
    :func:`zero_k4_designs`; ``require``: the counts they must equal."""
    from ishara_tpu_torch.ops import ffn_kernel as fk

    got = {"forward": {d: n for d, n in
                       fk.ffn_residual.launches_by_design.items() if n},
           "backward": {d: n for d, n in
                        fk.ffn_residual.launches_bwd_by_design.items() if n}}
    ok = require is None or got == require
    log(f"{label}: K4 launches by design over {steps} step(s): forward "
        f"{got['forward'] or 'none'}, backward {got['backward'] or 'none'}"
        + ("" if require is None else " PASS" if ok else
           f" FAIL (expected {require})"))
    if not ok:
        raise AssertionError(f"{label}: K4's launches took other designs "
                             f"than {require}: {got}")


def zero_k8_designs():
    from ishara_tpu_torch.ops import attention_blocked as ab

    for counts in (ab.flash_mhsa_blocked.launches_by_design,
                   ab.flash_mhsa_blocked.launches_bwd_by_design):
        for design in counts:
            counts[design] = 0


def log_k8_designs(label, steps, require):
    """Logs K8's launches by design (``blocked_plan``) since
    :func:`zero_k8_designs`; raises unless they equal ``require``."""
    from ishara_tpu_torch.ops import attention_blocked as ab

    got = {"forward": {d: n for d, n in
                       ab.flash_mhsa_blocked.launches_by_design.items() if n},
           "backward": {d: n for d, n in
                        ab.flash_mhsa_blocked.launches_bwd_by_design.items()
                        if n}}
    ok = got == require
    log(f"{label}: K8 launches by design over {steps} step(s): forward "
        f"{got['forward'] or 'none'}, backward {got['backward'] or 'none'}"
        + (" PASS" if ok else f" FAIL (expected {require})"))
    if not ok:
        raise AssertionError(f"{label}: K8's launches took other designs "
                             f"than {require}: {got}")


def zero_k3_designs():
    from ishara_tpu_torch.ops import attention as at

    for counts in (at.flash_mhsa.launches_by_design,
                   at.flash_mhsa.launches_bwd_by_design):
        for design in counts:
            counts[design] = 0


def log_k3_designs(label, steps, require=None):
    """Logs K3's forward and backward launches by design
    (``attention_plan``) since :func:`zero_k3_designs`; ``require``: the
    counts each direction's must equal."""
    from ishara_tpu_torch.ops import attention as at

    for direction, counts in (("forward", at.flash_mhsa.launches_by_design),
                              ("backward",
                               at.flash_mhsa.launches_bwd_by_design)):
        got = {d: n for d, n in counts.items() if n}
        ok = require is None or got == require
        log(f"{label}: K3 {direction} launches by design over {steps} "
            f"step(s): {got or 'none'}"
            + ("" if require is None else " PASS" if ok else
               f" FAIL (expected {require})"))
        if not ok:
            raise AssertionError(f"{label}: K3's {direction} launches took "
                                 f"other designs than {require}: {got}")


def zero_product_counts():
    from ishara_tpu_torch.ops import ffn_kernel as fk

    fk.weight_product.launches = 0
    for design in fk.weight_product.launches_by_design:
        fk.weight_product.launches_by_design[design] = 0


def log_product_counts(label, steps, require):
    """Logs the weight product's launches by design (csrc/wgrad.cuh, inside
    K4's and K7's backwards) since :func:`zero_product_counts`; raises
    unless they equal ``require``. Returns the count on wgmma."""
    from ishara_tpu_torch.ops import ffn_kernel as fk

    got = {d: n for d, n in fk.weight_product.launches_by_design.items() if n}
    ok = got == require
    log(f"{label}: weight product launches by design over {steps} step(s): "
        f"{got or 'none'} " + ("PASS" if ok else f"FAIL (expected "
                                                f"{require})"))
    if not ok:
        raise AssertionError(f"{label}: the weight product took other "
                             f"designs than {require}: {got}")
    return got.get("wgmma", 0)


def zero_k7_designs():
    from ishara_tpu_torch.ops import conv_kernel as ck

    for counts in (ck.conv_module_residual.launches_by_design,
                   ck.conv_module_residual.launches_bwd_by_design):
        for design in counts:
            counts[design] = 0


def log_k7_designs(label, steps, require):
    """Logs K7's launches by design (``conv_plan``) since
    :func:`zero_k7_designs`; raises unless they equal ``require``."""
    from ishara_tpu_torch.ops import conv_kernel as ck

    got = {"forward": {d: n for d, n in
                       ck.conv_module_residual.launches_by_design.items()
                       if n},
           "backward": {d: n for d, n in
                        ck.conv_module_residual.launches_bwd_by_design.items()
                        if n}}
    ok = got == require
    log(f"{label}: K7 launches by design over {steps} step(s): forward "
        f"{got['forward'] or 'none'}, backward {got['backward'] or 'none'}"
        + (" PASS" if ok else f" FAIL (expected {require})"))
    if not ok:
        raise AssertionError(f"{label}: K7's launches took other designs "
                             f"than {require}: {got}")


def wgmma_k7(steps):
    """Every one of a flagship-width step's 4 + 4 K7 launches on the wgmma
    design."""
    return {"forward": {"wgmma": 4 * steps},
            "backward": {"wgmma": 4 * steps}}


def wgmma_k4(steps):
    """Every one of a flagship-width step's 16 + 16 K4 launches on the
    wgmma design."""
    return {"forward": {"wgmma": 16 * steps},
            "backward": {"wgmma": 16 * steps}}


def train_counters():
    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab
    from ishara_tpu_torch.ops import conv_kernel as cm
    from ishara_tpu_torch.ops import ctc_kernel as ck
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.ops import ffn_kernel as fk

    return {"ctc_loss_kernel": ck.ctc_loss_kernel,
            "fast_dropout": dr.fast_dropout,
            "fast_dropout_add": dr.fast_dropout_add,
            "flash_mhsa": at.flash_mhsa, "ffn_residual": fk.ffn_residual,
            "flash_mhsa_blocked": ab.flash_mhsa_blocked,
            "conv_module_residual": cm.conv_module_residual}


# Launches a training step of baseline_config(4), forward and backward
# alike, as the model implies them: 4 Squeezeformer + 4 Conformer blocks
# with two feed-forward sites and one attention each; a dropout-add on each
# Squeezeformer block's attention branch (the Conformer's is a plain add);
# the conv-module kernel at each Squeezeformer block's conv module (the
# flagship row selects it since it beat the composition there); the top
# dropout; one CTC loss.
STEP_LAUNCHES = {"ffn_residual": 16, "flash_mhsa": 8, "fast_dropout_add": 4,
                 "conv_module_residual": 4, "fast_dropout": 1,
                 "ctc_loss_kernel": 1}
# The weight products a step (csrc/wgrad.cuh): two in each backward of K4
# and of K7.
STEP_PRODUCTS = 2 * (STEP_LAUNCHES["ffn_residual"]
                     + STEP_LAUNCHES["conv_module_residual"])
# The same step at f32 (the data-parallel phase): the selection table sends
# the conv module to its composition there, where the kernel lost to it.
DP_STEP_LAUNCHES = dict(STEP_LAUNCHES, conv_module_residual=0)


def step_against_plain(label, step, state0, batch):
    """One step on the kernels against the same step with every kernel
    replaced by its plain version, from the same state and seeds (loss,
    gradient norm, parameters, both moments, batch statistics), and the
    same (seed, step) twice, bit for bit."""
    import torch

    sk, sp = state0.clone(), state0.clone()
    sk, mk = step(sk, batch, seed=0)
    with plain_versions():
        sp, mp = step(sp, batch, seed=0)
    torch.cuda.synchronize()
    d_loss = abs(float(mk["loss"]) - float(mp["loss"])) \
        / abs(float(mp["loss"]))
    d_norm = abs(float(mk["grad_norm"]) - float(mp["grad_norm"])) \
        / float(mp["grad_norm"])
    moved = float((sk.params - state0.params).abs().max())
    d_par = float((sk.params - sp.params).abs().max()) / moved
    d_mom = {n: float((sk.opt_state[n] - sp.opt_state[n]).abs().max()
                      / sp.opt_state[n].abs().max()) for n in ("mu", "nu")}
    d_bn = max(float((a - b).abs().max()) for a, b in
               zip(sk.batch_stats.values(), sp.batch_stats.values()))
    ok = (d_loss <= STEP_TOL["loss"] and d_norm <= STEP_TOL["grad_norm"]
          and moved > 0.0 and d_par <= STEP_TOL["param"]
          and all(d_mom[n] <= STEP_TOL[n] for n in d_mom))
    log(f"{label}: one step, kernels vs plain versions from the same state "
        f"and seeds: loss {float(mk['loss']):.5f} vs {float(mp['loss']):.5f} "
        f"(rel {d_loss:.2e}, tol {STEP_TOL['loss']}), grad norm "
        f"{float(mk['grad_norm']):.5f} vs {float(mp['grad_norm']):.5f} (rel "
        f"{d_norm:.2e}, tol {STEP_TOL['grad_norm']}), largest parameter "
        f"difference {d_par:.3e} of the largest movement {moved:.3e} (tol "
        f"{STEP_TOL['param']}), first moment {d_mom['mu']:.3e} and second "
        f"moment {d_mom['nu']:.3e} of their largest entries (tol "
        f"{STEP_TOL['mu']}, {STEP_TOL['nu']}), batch statistics {d_bn:.3e} "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: a step on the kernels disagrees with "
                             f"the same step on the plain versions")
    sk2, mk2 = step(state0.clone(), batch, seed=0)
    if float(mk2["loss"]) != float(mk["loss"]) \
            or not torch.equal(sk2.params, sk.params):
        raise AssertionError(f"{label}: the same (seed, step) gave another "
                             f"step")
    log(f"{label}: the same (seed, step) gives the same loss and parameters "
        f"bit for bit PASS")
    del sk, sp, sk2
    torch.cuda.empty_cache()


STEP_MS: dict[str, float] = {}     # ms a step by label, this run


def time_steps(label, step, state, batch, smi, top=16):
    """ms a step (host clock around a step that ends in a synchronize,
    median of 10), sequences/s, and the device's busy share and time by
    kernel under torch.profiler over 3 steps. Returns the state."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, seed=0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    STEP_MS[label] = step_ms
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, m = step(state, batch, seed=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, _, t in rows)
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"{label}: {step_ms:.2f} ms a step (median of 10, host clock, each "
        f"ending in a synchronize; min {min(times):.2f} max "
        f"{max(times):.2f}), {TB / step_ms * 1e3:.0f} sequences/s; under the "
        f"profiler over 3 steps: wall {wall_us / 3e3:.2f} ms a step, device "
        f"busy {busy / 3e3:.2f} ms a step ({100 * busy / wall_us:.1f}% of "
        f"wall), {sum(c for _, c, _ in rows) / 3:.0f} device kernels and "
        f"copies a step, on {smi}")
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"  {t / 3e3:9.3f} ms/step {100 * t / busy:5.1f}% "
            f"{count / 3:7.1f} calls/step  {key[:90]}")
    prod = [(c, t) for key, c, t in rows if any(
        name in key for name in ("product_wg_kernel", "product_tc_kernel",
                                 "product_general_kernel"))]
    log(f"{label}: the weight products (wgrad::product_*_kernel) "
        f"{sum(t for _, t in prod) / 3e3:.3f} ms a step, "
        f"{sum(c for c, _ in prod) / 3:.1f} calls a step")
    return state


def train_batch(n=TB, seed=3):
    import torch

    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer

    host = SyntheticASLFR(num_sequences=n, seed=seed).batch(
        range(n), CTCTokenizer(), max_frames=96)
    return {k: torch.from_numpy(host[k]).to(DEVICE)
            for k in ("raw", "lengths", "labels")}


def run_counted(step, state, batch, steps):
    """``steps`` steps with every training wrapper's count set to 0 just
    before and read just after: (state, losses, {(wrapper, direction):
    launches})."""
    import torch

    counters = train_counters()
    for w in counters.values():
        w.launches = w.launches_bwd = 0
    zero_k4_designs()
    zero_k3_designs()
    zero_k7_designs()
    zero_product_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, seed=0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {(n, d): getattr(w, d) for n, w in counters.items()
                for d in ("launches", "launches_bwd")}
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a non-finite training loss: {losses}")
    return state, losses, launches


def train_phase(smi, steps: int = 20):
    """The training slice on the card. Returns {(wrapper name, direction):
    launches over the ``steps``-step run}."""
    import torch

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.data.landmarks import MAX_PHRASE_LENGTH
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats, preprocess
    from ishara_tpu_torch.train import (
        TrainState,
        ctc_eval_step,
        ctc_train_step,
        make_fused_ctc_eval_step,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = baseline_config(4).model
    tcfg = TrainConfig()            # the recipe, as the main path takes it
    torch.manual_seed(4)            # the weights: PyTorch's default init
    model = build_model(cfg, device=DEVICE)
    batch = train_batch()
    tx, schedule = make_optimizer(tcfg)
    state0 = TrainState.create(model, tx, device=DEVICE)
    stats = GroupStats.identity()
    step = make_fused_ctc_train_step(stats, cfg.frame_len,
                                     aug_prob=tcfg.aug_prob,
                                     blank_id=cfg.blank_id)
    log(f"train: baseline_config(4) ({cfg.variant} "
        f"{cfg.num_squeeze_blocks}+{cfg.num_conform_blocks}, dim {cfg.dim}, "
        f"{cfg.dtype}, dropout {cfg.dropout}), batch {TB}, raw "
        f"{tuple(batch['raw'].shape)}, labels {tuple(batch['labels'].shape)}, "
        f"{state0.params.numel()} parameters, {tcfg.optimizer}, lr "
        f"{float(schedule(0)):.3e}")

    step_against_plain("train", step, state0, batch)

    # the main path, with the launch counts read around it
    state, losses, launches = run_counted(step, state0.clone(), batch, steps)
    log(f"train: {steps} steps of make_fused_ctc_train_step, loss "
        + " ".join(f"{v:.3f}" for v in losses))
    log(f"train: kernel launches over the run {launches}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log_k4_designs("train", steps, wgmma_k4(steps))
    log_k3_designs("train", steps, {"wgmma": 8 * steps})
    log_k7_designs("train", steps, wgmma_k7(steps))
    products = log_product_counts("train", steps,
                                  {"wgmma": STEP_PRODUCTS * steps})
    for (name, direction), n in launches.items():
        if n != steps * STEP_LAUNCHES.get(name, 0):
            raise AssertionError(
                f"{name}.{direction} = {n} over {steps} steps, expected "
                f"{STEP_LAUNCHES.get(name, 0)} a step")
    launches[("weight_product", "launches")] = products
    # each step draws other masks and augmentations, so "lower at the end
    # than at the start" compares the means of the first and the last three
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"training loss did not fall: {losses}")
    if int(state.step) != steps or int(state.nonfinite_count) != 0 \
            or int(state.opt_state["schedule_count"]) != steps:
        raise AssertionError("step counters are off after the run")
    log(f"train: loss finite at every step, mean of the first three "
        f"{first:.3f} -> of the last three {last:.3f}; launches a step: "
        + ", ".join(f"{n} {c} + {c}" for n, c in STEP_LAUNCHES.items())
        + " (forward + backward) PASS")

    # The recipe holds its first learning rate, 1.25e-4, for an epoch of
    # 1000 steps, so the run above never leaves it. With an epoch a step the
    # same 20 steps walk lrfn's five warm-up epochs (1.25e-4 doubling to
    # 4e-3) and go on into its cosine, crossing RAdam's rectification
    # threshold and four Lookahead syncs at rates that move the loss far.
    fast_tx, _ = make_optimizer(TrainConfig(steps_per_epoch=1))
    probe = TrainState.create(copy.deepcopy(state0.model), fast_tx,
                              device=DEVICE)
    falling = []
    for _ in range(steps):
        probe, m = step(probe, batch, seed=0)
        falling.append(m["loss"])
    falling = [float(v) for v in falling]
    first, last = sum(falling[:3]) / 3, sum(falling[-3:]) / 3
    log(f"train: {steps} steps at an epoch a step, loss "
        + " ".join(f"{v:.3f}" for v in falling))
    if not all(math.isfinite(v) for v in falling) or not last < first:
        raise AssertionError(f"training loss did not fall: {falling}")
    log(f"train: mean of the first three {first:.3f} -> of the last three "
        f"{last:.3f} PASS")
    del probe

    state = time_steps("train", step, state, batch, smi)

    # the non-finite guard: an infinite coordinate makes the loss non-finite
    probe = state.clone()
    before = (probe.params.clone(), probe.slow_params.clone(),
              {k: v.clone() for k, v in probe.opt_state.items()},
              [b.clone() for b in probe.batch_stats.values()])
    bad = dict(batch, raw=batch["raw"].clone())
    bad["raw"][:, :, :] = float("inf")
    probe, m = step(probe, bad, seed=0)
    same = (torch.equal(probe.params, before[0])
            and torch.equal(probe.slow_params, before[1])
            and all(torch.equal(v, before[2][k])
                    for k, v in probe.opt_state.items())
            and all(torch.equal(a, b) for a, b in
                    zip(probe.batch_stats.values(), before[3])))
    ok = (same and not math.isfinite(float(m["loss"]))
          and int(probe.nonfinite_count) == 1
          and int(probe.step) == int(state.step) + 1)
    log(f"train: non-finite probe: loss {float(m['loss'])}, every leaf "
        f"unchanged {same}, nonfinite_count {int(probe.nonfinite_count)}, "
        f"step {int(probe.step)}, schedule count "
        f"{int(probe.opt_state['schedule_count'])} "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the non-finite guard failed")
    del probe, before

    # ctc_train_step on a preprocessed batch, and the two eval steps
    with torch.no_grad():
        x = torch.vmap(lambda r, n: preprocess(r, n, stats, cfg.frame_len))(
            batch["raw"], batch["lengths"])
    state, m = ctc_train_step(state, {"x": x, "labels": batch["labels"]},
                              seed=0)
    ev = make_fused_ctc_eval_step(stats, cfg.frame_len,
                                  blank_id=cfg.blank_id)(state, batch)
    ev2 = ctc_eval_step(state, {"x": x, "labels": batch["labels"]})
    torch.cuda.synchronize()
    ok = (math.isfinite(float(m["loss"]))
          and ev["loss_per_seq"].shape == (TB,)
          and bool(ev["loss_per_seq"].isfinite().all())
          and ev["ids"].shape == (TB, MAX_PHRASE_LENGTH)
          and ev["counts"].shape == (TB,)
          and ev2["logits"].shape == (TB, cfg.frame_len, cfg.num_classes)
          and abs(float(ev2["loss"]) - float(ev["loss"]))
          <= 1e-3 * abs(float(ev["loss"])))
    log(f"train: ctc_train_step loss {float(m['loss']):.3f}; fused eval step "
        f"loss {float(ev['loss']):.3f}, loss_per_seq "
        f"{tuple(ev['loss_per_seq'].shape)}, ids {tuple(ev['ids'].shape)}, "
        f"counts {tuple(ev['counts'].shape)}; ctc_eval_step loss "
        f"{float(ev2['loss']):.3f} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("an eval step or ctc_train_step gave a bad "
                             "result")
    return launches


# ---------------------------------------------------------------------------
# The long-sequence training step: K7 and K8
# ---------------------------------------------------------------------------

LT = 512                    # the long step's frames
CONV_REF = "ishara_tpu/ops/conv_kernel.py"
BLOCKED_REF = "ishara_tpu/ops/attention_blocked.py"


def blocked_attention_kernel_rows(smi, runs):
    """K8: forward, lse and dq / dk / dv against the plain version, bf16
    and f32, at the long step's shape (8 heads of 32, T 512), with 4 heads
    of 64, 2 of 128, 1 of 256 and 8 of 12 at T 512, and at T 200 (padded
    to 256 or 208) with masked keys and one sequence with every key masked
    at blocks of 128, 64 and 16; the same bits on a second backward; each
    launch's design (``blocked_plan``, equal to the C plan) asserted and
    logged; timed beside the plain version, F.scaled_dot_product_attention
    (the additive mask and the scale) and the layer's einsum composition."""
    import torch
    import torch.nn.functional as F

    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab

    def took(q, k, v, launch):
        """Runs ``launch`` (one forward, two backwards); raises unless each
        took the design ``plan_of`` names and the C plan names the same."""
        plan = ab.plan_of(q, k, v)
        c = ab.c_plan(q.dtype, q.shape[2], q.shape[3],
                      at.tma_aligned(*(ab._unit_last(t) for t in (q, k, v))))
        if (c["forward"], c["backward"]) != tuple(plan):
            raise AssertionError(f"blocked_plan {plan} is not the C plan {c}")
        before = (dict(ab.flash_mhsa_blocked.launches_by_design),
                  dict(ab.flash_mhsa_blocked.launches_bwd_by_design))
        result = launch()
        got = tuple({d: n - b[d] for d, n in now.items() if n != b[d]}
                    for now, b in zip(
                        (ab.flash_mhsa_blocked.launches_by_design,
                         ab.flash_mhsa_blocked.launches_bwd_by_design),
                        before))
        if got != ({plan.forward: 1}, {plan.backward: 2}):
            raise AssertionError(f"K8 took {got}, expected {plan}")
        return plan, result

    g = torch.Generator(device=DEVICE).manual_seed(15)
    scale = TD ** -0.5
    rows, errs = [], {}

    def bias_of(T, all_masked):
        lengths = torch.randint(T // 3, T + 1, (TB,), generator=g,
                                device=DEVICE)
        lengths[1] = T
        if all_masked:
            lengths[0] = 0
        return at.mask_to_bias(torch.arange(T, device=DEVICE)[None, :]
                               < lengths[:, None])

    def check(tag, dt, H, T, all_masked, Dh=None, blocks=(128, 128)):
        Dh = Dh or TD // H
        bias = bias_of(T, all_masked)
        qkv = torch.randn((TB, T, H, 3 * Dh), generator=g,
                          device=DEVICE).to(dt).requires_grad_()
        d_o = torch.randn((TB, H, T, Dh), generator=g, device=DEVICE).to(dt)
        q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)

        def run():
            o = ab.flash_mhsa_blocked(q, k, v, bias, scale, *blocks)
            grads = torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)
            again = torch.autograd.grad(o, (q, k, v), d_o, retain_graph=True)
            torch.cuda.synchronize()
            return o, grads, again

        plan, (o, grads, again) = took(q, k, v, run)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"blocked attention [{tag}] H {H} Dh {Dh} "
                                 f"T {T}: a second backward gave other bits")
        with torch.no_grad():
            ro, lse = ab.blocked_attention_forward_plain(q, k, v, bias, scale,
                                                         *blocks)
            rgrads = ab.blocked_attention_backward_plain(q, k, v, bias, ro,
                                                         lse, d_o, scale)
            _, klse = ab._launch_fwd(q, k, v, bias, scale,
                                     ab.padded_length(T, *blocks))
        tol = TRAIN_TOL[tag]
        what = f"blocked attention [{tag}] H {H} Dh {Dh} T {T}"
        e_o = close(f"{what} o", o, ro, tol)
        close(f"{what} lse", klse, lse, TRAIN_TOL["f32"])
        e_g = max(close(f"{what} d{n}", a, b, tol)
                  for n, a, b in zip("qkv", grads, rgrads))
        if all_masked:
            # every key masked: V averaged over the padded length, exactly
            # the plain version's rule, and the row's lse at -1e30
            if not bool((klse[0] == lse[0]).all()):
                raise AssertionError(f"{what}: the all-masked lse differs")
        log(f"kernel flash_mhsa_blocked [{tag}] q, k, v [{TB}, {H}, {T}, "
            f"{Dh}] blocks {blocks}"
            f"{' with sequence 0 all masked' if all_masked else ''} "
            f"(forward {plan.forward}, backward {plan.backward}, the C "
            f"plan's): o max_abs_err {e_o:.3e}, d(q|k|v) {e_g:.3e} (tol "
            f"{tol}); the same bits on a second backward PASS")
        del ro, lse, rgrads, klse, grads, again
        return (q, k, v), d_o, bias, o, (e_o, e_g)

    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qkv, d_o, bias, o, errs[tag] = check(tag, dt, TH, LT, False)
        del qkv, d_o, bias, o
        torch.cuda.empty_cache()
    # heads of 64, 128, 256 and 12 (not a multiple of 8: the narrow copy
    # path) at T 512; T 200 with an all-masked sequence at blocks of 128,
    # 64 and 16 (Tp 256, 256, 208: the core's 64-key tile need not divide)
    for H, T, masked, Dh, blocks in (
            (TH // 2, LT, False, None, (128, 128)),
            (TH // 4, LT, False, None, (128, 128)),
            (1, LT, False, None, (128, 128)),
            (TH, LT, False, 12, (128, 128)),
            (TH, 200, True, None, (128, 128)),
            (TH, 200, True, None, (64, 64)),
            (TH, 200, True, None, (16, 16))):
        (q, k, v), d_o, bias, o, _ = check("bf16", torch.bfloat16, H, T,
                                           masked, Dh, blocks)
        f_ms = time_ms(lambda: ab.flash_mhsa_blocked(q, k, v, bias, scale,
                                                     *blocks), runs=5)
        b_ms = time_ms(lambda: torch.autograd.grad(
            o, (q, k, v), d_o, retain_graph=True), runs=5)
        log(f"  forward {f_ms:.4f} ms backward {b_ms:.4f} ms on {smi}")
        del d_o, bias, o, q, k, v
        check("f32", torch.float32, H, T, masked, Dh, blocks)
        torch.cuda.empty_cache()

    # the long step's shape at bf16, timed
    Dh, dt = TD // TH, torch.bfloat16
    bias = bias_of(LT, False)
    qkv = torch.randn((TB, LT, TH, 3 * Dh), generator=g,
                      device=DEVICE).to(dt).requires_grad_()
    d_o = torch.randn((TB, TH, LT, Dh), generator=g, device=DEVICE).to(dt)
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    plan = ab.plan_of(q, k, v)
    if plan != ("wgmma", "wgmma"):
        raise AssertionError(f"the long step's K8 takes {plan}, not wgmma")
    o = ab.flash_mhsa_blocked(q, k, v, bias, scale)
    f_ms = time_ms(lambda: ab.flash_mhsa_blocked(q, k, v, bias, scale),
                   runs=runs)
    b_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), d_o,
                                               retain_graph=True), runs=runs)
    mask = bias[:, None, None, :].to(dt)
    lq = qkv.detach().clone().requires_grad_()

    def lib_fwd():
        a, b, c = lq.transpose(1, 2).split(Dh, dim=-1)
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              scale=scale)

    lo = lib_fwd()
    lf_ms = time_ms(lib_fwd, runs=runs)
    lb_ms = time_ms(lambda: torch.autograd.grad(lo, lq, d_o,
                                                retain_graph=True), runs=runs)
    keep = bias == 0.0

    def einsum_fwd():
        a, b, c = lq.transpose(1, 2).split(Dh, dim=-1)
        s = torch.einsum("bhqd,bhkd->bhqk", a, b) * scale
        s = s.masked_fill(~keep[:, None, None, :], torch.finfo(s.dtype).min)
        return torch.einsum("bhqk,bhkd->bhqd", s.softmax(dim=-1), c)

    eo = einsum_fwd()
    ef_ms = time_ms(einsum_fwd, runs=runs)
    eb_ms = time_ms(lambda: torch.autograd.grad(eo, lq, d_o,
                                                retain_graph=True), runs=runs)
    with torch.no_grad():
        qd, kd, vd = (t.detach() for t in (q, k, v))
        ro, lse = ab.blocked_attention_forward_plain(qd, kd, vd, bias, scale)
        p_f = time_ms(lambda: ab.blocked_attention_forward_plain(
            qd, kd, vd, bias, scale), runs=3, warmup=1, head_start=False)
        p_b = time_ms(lambda: ab.blocked_attention_backward_plain(
            qd, kd, vd, bias, ro, lse, d_o, scale), runs=3, warmup=1,
            head_start=False)
    exps = TB * TH * LT * LT          # one exponential a score, each way
    log(f"kernel flash_mhsa_blocked [bf16] q, k, v [{TB}, {TH}, {LT}, {Dh}] "
        f"(forward {plan.forward}, backward {plan.backward}): forward "
        f"{f_ms:.4f} ms backward {b_ms:.4f} ms; plain {p_f:.4f} / "
        f"{p_b:.4f} ms; F.scaled_dot_product_attention {lf_ms:.4f} / "
        f"{lb_ms:.4f} ms ({f_ms / lf_ms:.2f}x / {b_ms / lb_ms:.2f}x); "
        f"einsum composition {ef_ms:.4f} / {eb_ms:.4f} ms; {exps} "
        f"exponentials a direction, {exps / MUFU_PER_S * 1e3:.4f} ms at 16 a "
        f"clock an SM on {smi}")
    size = TB * TH * LT * Dh * 2
    small = bias.numel() * 4 + TB * TH * LT * 4       # bias and lse
    product = 2 * TB * TH * LT * LT * Dh              # one [T, T] product
    rows.append(train_row(
        "flash_mhsa_blocked", ab.flash_mhsa_blocked, "launches",
        "attention_fwd_wg.cuh", f"{BLOCKED_REF}:145", errs["bf16"][0], f_ms,
        p_f, 4 * size + small, 2 * product, "bf16", lf_ms, smi))
    # q, k, v, o, dO read, dq, dk, dv written, lse and delta read; the
    # function needs 5 products (S recomputed, dP, dV, dQ, dK), as many as
    # the wgmma backward does
    rows.append(train_row(
        "flash_mhsa_blocked[bwd]", ab.flash_mhsa_blocked, "launches_bwd",
        "attention_bwd.cuh", f"{BLOCKED_REF}:208", errs["bf16"][1], b_ms,
        p_b, 8 * size + 2 * small, 5 * product, "bf16", lb_ms, smi))
    return rows


# Depthwise widths beyond the 32 taps the first K7 took: a halo of 48 and
# of 64 rows.
WIDE_KS = (33, 63)


def conv_plan_mirror_check():
    """conv_kernel.tile_smem against the shared memory csrc/conv_module.cu
    computes for each tile configuration, and the path each call takes."""
    import torch

    from ishara_tpu_torch.ops import conv_kernel as ck

    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            for cfg, (mtp, _, ec) in enumerate(
                    ck._TILE_CONFIGS[(dt, backward)]):
                for D in (64, 144, 256, 512):
                    for K in (1, 15, 17, 31) + WIDE_KS:
                        py = ck.tile_smem(dt, backward, mtp, ec, D, K)
                        c = ck.c_tile_smem(dt, backward, cfg, D, K)
                        if py != c:
                            raise AssertionError(
                                f"tile_smem {dt} backward={backward} config "
                                f"{cfg} D {D} K {K}: Python {py}, C {c}")
                        n += 1
    plans = 0
    for dt in (torch.float32, torch.bfloat16):
        for D in (64, 128, 144, 192, 256, 320, 512):
            for E in (64, 128, 256, 512, 1024):
                for K in (1, 3, 15, 16, 17, 33):
                    py = ck.conv_plan(dt, D, E, K)
                    c = ck.c_plan(dt, D, E, K)
                    if py != c["design"] or c["design"] == "wgmma" and max(
                            c["fwd_smem"], c["bwd_smem"]) > ck.SMEM_LIMIT:
                        raise AssertionError(
                            f"conv_plan {dt} D {D} E {E} K {K}: Python {py}, "
                            f"C {c}")
                    plans += 1
    x = torch.zeros((TB, TT, TD), dtype=torch.bfloat16)
    paths = {(K, tag, d): ck.design_of(x.to(dt), 2 * TD, K, d)
             for K in (15,) + WIDE_KS
             for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
             for d in (False, True)}
    log(f"conv_kernel.tile_smem equals csrc/conv_module.cu's at {n} "
        f"(dtype, direction, config, D, K), conv_kernel.conv_plan's design "
        f"the C ishara_conv_plan's at {plans} (dtype, D, E, K), whose wgmma "
        f"layouts fit in {ck.SMEM_LIMIT} bytes PASS; at [{TB}, {TT}, "
        f"{TD}] the designs: " + ", ".join(
            f"K {K} {tag} {'bwd' if d else 'fwd'} {p}"
            for (K, tag, d), p in paths.items()))


def conv_module_kernel_rows(smi, runs):
    """K7: forward and all twelve gradients against the plain version at
    the long step's shape [256, 512, 256] (E 512, K 15, r 32) and at the
    flagship's [256, 176, 256], bf16 (the wgmma design) and f32 (the tile
    kernels), there also with 33 and 63 depthwise taps (on the tile path
    and on the general path); the design each direction took, by the
    counters; timed beside the plain version and the port's composition (no
    one PyTorch call computes the branch)."""
    import torch

    from ishara_tpu_torch.models.layers import SqueezeformerConvModule
    from ishara_tpu_torch.ops import conv_kernel as ck

    conv_plan_mirror_check()
    r = TD // 8
    rows = []
    cases = [(LT, "bf16", 15), (LT, "f32", 15), (TT, "bf16", 15),
             (TT, "f32", 15)] + [(TT, tag, K) for K in WIDE_KS
                                 for tag in ("bf16", "f32")]
    for T, tag, K in cases:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
        torch.manual_seed(T)
        module = SqueezeformerConvModule(TD, K, 2, dtype=dt).to(DEVICE)
        randomize(module, seed=T)
        g = torch.Generator(device=DEVICE).manual_seed(T)
        x = torch.randn((TB, T, TD), generator=g, device=DEVICE).to(
            dt).requires_grad_()
        dy = torch.randn((TB, T, TD), generator=g, device=DEVICE).to(dt)
        lengths = torch.randint(T // 3, T + 1, (TB,), generator=g,
                                device=DEVICE)
        lengths[0] = 0                                 # an empty sequence
        mask = torch.arange(T, device=DEVICE)[None, :] < lengths[:, None]
        args = module.kernel_args(x, mask)
        params = list(module.parameters())
        zero_k7_designs()
        out = ck.conv_module_residual(x, *args)
        grads = torch.autograd.grad(out, [x] + params, dy, retain_graph=True)
        torch.cuda.synchronize()
        design = {d: n for d, n in
                  ck.conv_module_residual.launches_by_design.items() if n}
        design_b = {d: n for d, n in
                    ck.conv_module_residual.launches_bwd_by_design.items()
                    if n}
        want = {ck.design_of(x, 2 * TD, K, False): 1}, \
            {ck.design_of(x, 2 * TD, K, True): 1}
        if (design, design_b) != want or (
                tag == "bf16" and K == 15 and want != ({"wgmma": 1},
                                                       {"wgmma": 1})):
            raise AssertionError(f"K7 [{tag}] T {T} K {K} took the designs "
                                 f"{design} / {design_b}, expected {want}")
        dname, dname_b = next(iter(design)), next(iter(design_b))
        again = torch.autograd.grad(out, [x] + params, dy, retain_graph=True)
        torch.cuda.synchronize()
        with torch.no_grad():
            pa = ck._prep(x, *args)
            ref = ck.conv_module_forward_plain(x, *pa)
            rg = ck.conv_module_backward_plain(x, pa[0], dy, *pa[1:])
        tol = TRAIN_TOL[tag]
        what = f"conv module [{tag}] x [{TB}, {T}, {TD}] K {K}"
        e_o = close(f"{what} out", out, ref, tol)
        # the kernel's gradients in its own order: dx, then the eleven
        names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dwdw", "dw2", "db2",
                 "dwf1", "dbf1", "dwf2", "dbf2")
        kg = torch.autograd.grad(out, [x] + list(args[1:]), dy,
                                 retain_graph=True)
        e_g = {n: close(f"{what} {n}", a, b, tol)
               for n, a, b in zip(names, kg, rg)}
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"{what}: gradients differ from run to run")
        log(f"kernel conv_module_residual [{tag}] x [{TB}, {T}, {TD}] E "
            f"{2 * TD} K {K} r {r}, design {dname} / {dname_b} (forward / "
            f"backward), sequence 0 empty: out max_abs_err "
            f"{e_o:.3e}; gradients " + ", ".join(
                f"{n} {e:.2e}" for n, e in e_g.items())
            + f" (tol {tol}); the same bits on a second backward PASS")
        del kg, again, ref, rg, pa
        f_ms = time_ms(lambda: ck.conv_module_residual(x, *args), runs=runs)
        b_ms = time_ms(lambda: torch.autograd.grad(
            out, [x] + params, dy, retain_graph=True), runs=runs)
        module.fused = False
        co = module(x, mask, training=True)
        c_f = time_ms(lambda: module(x, mask, training=True), runs=runs)
        c_b = time_ms(lambda: torch.autograd.grad(
            co, [x] + params, dy, retain_graph=True), runs=runs)
        with torch.no_grad():
            pa = ck._prep(x, *args)
            p_f = time_ms(lambda: ck.conv_module_forward_plain(x, *pa),
                          runs=3, warmup=1, head_start=False)
            p_b = time_ms(lambda: ck.conv_module_backward_plain(
                x, pa[0], dy, *pa[1:]), runs=3, warmup=1, head_start=False)
        log(f"  forward {f_ms:.4f} ms backward {b_ms:.4f} ms; plain "
            f"{p_f:.4f} / {p_b:.4f} ms; the composition (F.conv1d, "
            f"layer_norm, silu, SE) {c_f:.4f} / {c_b:.4f} ms on {smi}")
        if tag == "bf16" and K == 15:
            log(f"  selection conv_module_fused ({TD}, {T}, {TB}): the kernel "
                f"{f_ms + b_ms:.4f} ms forward + backward against the "
                f"composition's {c_f + c_b:.4f} ms")
        if T == LT or K in WIDE_KS:
            n_f = device_kernels(lambda: ck.conv_module_residual(x, *args))
            n_b = device_kernels(lambda: torch.autograd.grad(
                out, [x] + params, dy, retain_graph=True))
            log(f"  one call on the card (torch.profiler): "
                f"{sum(n_f.values())} kernels forward {n_f}, "
                f"{sum(n_b.values())} backward {n_b}")
            again_fwd = [k for k in n_b if "fwd_tile_kernel" in k
                         or "fwd_wg_kernel" in k]
            if again_fwd or (dname_b == "wgmma"
                             and "bwd_wg_kernel" not in n_b):
                raise AssertionError(f"K7's backward ran a forward tile "
                                     f"kernel again, or the profile missed "
                                     f"its own: {n_b}")
        wide = K in WIDE_KS and tag == "bf16"
        if (T, tag, K) == (LT, "bf16", 15) or wide:
            name = "conv_module_residual" + (f"[K{K}]" if wide else "")
            N, E, es = TB * T, 2 * TD, x.element_size()
            weights = 2 * TD * E * es + (K * E + 2 * TD * r + 5 * TD
                                         + E + r) * 4
            product = 2 * N * TD * E
            dw = 2 * N * E * K
            src = {"wgmma": "conv_wg.cuh"}
            # x and the mask read, out written, the weights read; two
            # products and the conv. The kept p is the design's own traffic
            # (the backward could rebuild it): logged beside, not counted
            rows.append(train_row(
                name, ck.conv_module_residual, "launches",
                src.get(dname, "conv_module.cu"), f"{CONV_REF}:297", e_o,
                f_ms, p_f, 2 * N * TD * es + N * 4 + weights,
                2 * product + dw, tag, None, smi))
            log(f"  {name}: the forward's kept p ({N * TD * 4} bytes, "
                f"{N * TD * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory "
                f"rate, written by the forward besides the bound's bytes, "
                f"read by the backward within its own)")
            # x, dy, the kept p and the mask read, dx written, the weights
            # read and their f32 gradients written; u recomputed, ds, dxn,
            # dw1 and dw2, and the conv, its transpose and dwdw
            rows.append(train_row(
                name.replace("[", "[bwd,") if wide else name + "[bwd]",
                ck.conv_module_residual,
                "launches_bwd", src.get(dname_b, "conv_module.cu"),
                f"{CONV_REF}:331", max(e_g.values()), b_ms, p_b,
                3 * N * TD * es + N * TD * 4 + N * 4 + 2 * weights,
                5 * product + 3 * dw, tag, None, smi))
            rows[-2]["design"], rows[-1]["design"] = dname, dname_b
            if wide:  # launches: the wide-kernel training run's
                rows[-2]["run"] = rows[-1]["run"] = K
        del module, x, dy, out, grads, co, pa, args, params
        torch.cuda.empty_cache()
    return rows


def attention_selection_times(smi, runs):
    """The selection table's attention rows: forward + backward ms of each
    candidate at batch 256, 8 heads of 32, bf16 -- the single-block kernel
    (K3), the tiled kernel (K8, no dropout) and the layer's einsum
    composition (softmax, then the dropout kernel on the weights) -- at T
    176 (the flagship row), 384 (the largest T that the long row decides
    with dropout on) and 512 (the long row), dropout 0.4 and 0."""
    import torch

    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab
    from ishara_tpu_torch.ops.dropout import fast_dropout

    g = torch.Generator(device=DEVICE).manual_seed(16)
    seed = torch.tensor([5], dtype=torch.int32, device=DEVICE)
    scale, Dh = TD ** -0.5, TD // TH
    for T, rates in ((TT, (0.4, 0.0)), (384, (0.4,)), (LT, (0.4, 0.0))):
        lengths = torch.randint(T // 3, T + 1, (TB,), generator=g,
                                device=DEVICE)
        keep = torch.arange(T, device=DEVICE)[None, :] < lengths[:, None]
        bias = at.mask_to_bias(keep)
        qkv = torch.randn((TB, T, TH, 3 * Dh), generator=g, device=DEVICE
                          ).to(torch.bfloat16).requires_grad_()
        d_o = torch.randn((TB, TH, T, Dh), generator=g,
                          device=DEVICE).to(torch.bfloat16)

        def einsum(q, k, v, rate):
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
            s = s.masked_fill(~keep[:, None, None, :],
                              torch.finfo(s.dtype).min)
            return torch.einsum("bhqk,bhkd->bhqd",
                                fast_dropout(s.softmax(dim=-1), seed, rate),
                                v)

        cands = {"einsum": einsum,
                 "flash": lambda q, k, v, rate: at.flash_mhsa(
                     q, k, v, bias, seed, scale, rate),
                 "flash_blocked": lambda q, k, v, rate: ab.flash_mhsa_blocked(
                     q, k, v, bias, scale)}
        for rate in rates:
            times = {}
            for name, fn in cands.items():
                if (name == "flash" and T > at.MAX_T) or \
                        (name == "flash_blocked" and rate > 0.0):
                    continue

                def step(fn=fn, rate=rate):
                    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
                    torch.autograd.grad(fn(q, k, v, rate), qkv, d_o)

                times[name] = time_ms(step, runs=runs)
            log(f"selection: attention T {T} rate {rate}, forward + backward "
                f"ms: " + ", ".join(f"{n} {t:.4f}" for n, t in times.items())
                + f" -> {min(times, key=times.get)} on {smi}")
        del qkv, d_o
        torch.cuda.empty_cache()


def wide_head_attention_checks(smi):
    """K3 (T 176, dropout 0.4) and K8 (T 512) at single heads of 320 and
    512 -- wider than one 256-wide tile, so they run in column chunks --
    against their plain versions at batch 32, bf16 and f32, timed."""
    import torch

    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import attention_blocked as ab

    B = 32
    seed = torch.tensor([99], dtype=torch.int32, device=DEVICE)
    for kernel, T in (("flash_mhsa", TT), ("flash_mhsa_blocked", LT)):
        for Dh in (320, 512):
            for tag in ("bf16", "f32"):
                dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
                g = torch.Generator(device=DEVICE).manual_seed(Dh + T)
                q, k, v, d_o = (torch.randn((B, 1, T, Dh), generator=g,
                                            device=DEVICE).to(dt)
                                for _ in range(4))
                for t in (q, k, v):
                    t.requires_grad_()
                mask = torch.rand((B, T), generator=g, device=DEVICE) > 0.2
                mask[0] = False
                bias = at.mask_to_bias(mask)
                scale = Dh ** -0.5

                def fwd():
                    if kernel == "flash_mhsa":
                        return at.flash_mhsa(q, k, v, bias, seed, scale, 0.4)
                    return ab.flash_mhsa_blocked(q, k, v, bias, scale)

                o = fwd()
                grads = torch.autograd.grad(o, (q, k, v), d_o,
                                            retain_graph=True)
                torch.cuda.synchronize()
                with torch.no_grad():
                    if kernel == "flash_mhsa":
                        ro, lse = at.mhsa_forward_plain(q, k, v, bias, seed,
                                                        scale, 0.4)
                        rg = at.mhsa_backward_plain(q, k, v, bias, seed, ro,
                                                    lse, d_o, scale, 0.4)
                    else:
                        ro, lse = ab.blocked_attention_forward_plain(
                            q, k, v, bias, scale)
                        rg = ab.blocked_attention_backward_plain(
                            q, k, v, bias, ro, lse, d_o, scale)
                tol = TRAIN_TOL[tag]
                what = f"{kernel} [{tag}] head {Dh} T {T}"
                e_o = close(f"{what} o", o, ro, tol)
                e_g = max(close(f"{what} d{n}", a, b, tol)
                          for n, a, b in zip("qkv", grads, rg))
                f_ms = time_ms(fwd, runs=5)
                b_ms = time_ms(lambda: torch.autograd.grad(
                    o, (q, k, v), d_o, retain_graph=True), runs=5)
                log(f"kernel {kernel} [{tag}] q/k/v [{B}, 1, {T}, {Dh}] (two "
                    f"256-wide column chunks): o max_abs_err {e_o:.3e}, "
                    f"dq/dk/dv {e_g:.3e} (tol {tol}) PASS; forward "
                    f"{f_ms:.4f} ms backward {b_ms:.4f} ms on {smi}")
                del q, k, v, d_o, o, grads, ro, rg
    torch.cuda.empty_cache()


def ffn_selection_times(smi, runs):
    """The selection table's ffn_dropout_kernel rows: forward + backward ms
    of the FFN kernel (K4) and of the F.linear / silu / dropout composition
    at batch 256, dim 256, hidden 512, rates 0.4 / 0.4, bf16, at T 176 and
    512."""
    import torch
    import torch.nn.functional as F

    from ishara_tpu_torch.ops import ffn_kernel as fk

    seeds = torch.tensor([7, 8], dtype=torch.int32, device=DEVICE)
    for T in (TT, LT):
        g = torch.Generator(device=DEVICE).manual_seed(T)
        x, res, dy = (torch.randn((TB, T, TD), generator=g, device=DEVICE)
                      .to(torch.bfloat16) for _ in range(3))
        x.requires_grad_()
        res.requires_grad_()
        ws = [torch.randn(s, generator=g, device=DEVICE).mul(0.05)
              .to(torch.bfloat16).requires_grad_()
              for s in ((TD, TM), (TM,), (TM, TD), (TD,))]
        out = fk.ffn_residual(x, res, *ws, seeds, 0.4, 0.4)
        k_f = time_ms(lambda: fk.ffn_residual(x, res, *ws, seeds, 0.4, 0.4),
                      runs=runs)
        k_b = time_ms(lambda: torch.autograd.grad(
            out, [x, res] + ws, dy, retain_graph=True), runs=runs)

        def comp():
            h = F.dropout(F.silu(F.linear(x, ws[0].t(), ws[1])), 0.4, True)
            return res + F.dropout(F.linear(h, ws[2].t(), ws[3]), 0.4, True)

        co = comp()
        c_f = time_ms(comp, runs=runs)
        c_b = time_ms(lambda: torch.autograd.grad(
            co, [x, res] + ws, dy, retain_graph=True), runs=runs)
        log(f"selection ffn_dropout_kernel ({TD}, {T}, {TB}): the kernel "
            f"{k_f:.4f} + {k_b:.4f} = {k_f + k_b:.4f} ms forward + backward "
            f"against the composition's {c_f:.4f} + {c_b:.4f} = "
            f"{c_f + c_b:.4f} ms on {smi}")
        del x, res, dy, ws, out, co
        torch.cuda.empty_cache()


def long_kernel_phase(smi, runs: int = 20):
    import torch

    rows = blocked_attention_kernel_rows(smi, runs)
    torch.cuda.empty_cache()
    attention_selection_times(smi, runs)
    torch.cuda.empty_cache()
    wide_head_attention_checks(smi)
    ffn_selection_times(smi, runs)
    rows += conv_module_kernel_rows(smi, runs)
    torch.cuda.empty_cache()
    return rows


# Launches a step of the long-sequence step, forward and backward alike:
# the tiled attention at each of the 8 blocks' attention, the conv-module
# kernel at each Squeezeformer block's conv module, the top dropout, one CTC
# loss; with the attention dropout off, no single-block attention, no
# feed-forward kernel (its sites drop nothing) and no dropout-add.
LONG_STEP_LAUNCHES = {"conv_module_residual": 4, "flash_mhsa_blocked": 8,
                      "ctc_loss_kernel": 1, "fast_dropout": 1,
                      "flash_mhsa": 0, "ffn_residual": 0,
                      "fast_dropout_add": 0}


def long_train_phase(smi, steps: int = 10):
    """The long-sequence training step on the card: ``baseline_config(4)``
    at ``frame_len=512`` and ``dropout=0.0`` (``top_dropout`` 0.4), batch
    256, bf16, ``TrainConfig()``. Returns {(wrapper name, direction):
    launches over the ``steps``-step run}."""
    import torch

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = dataclasses.replace(baseline_config(4).model, frame_len=LT,
                              dropout=0.0)
    tcfg = TrainConfig()
    torch.manual_seed(5)
    model = build_model(cfg, device=DEVICE)
    # phrases of 3-10 characters at ~80 frames each: 240-800 raw frames,
    # three in four above the single-block kernel's 384
    ds = SyntheticASLFR(num_sequences=TB, frames_per_char=80, seed=3)
    host = ds.batch(range(TB), CTCTokenizer(), max_frames=768)
    batch = {k: torch.from_numpy(host[k]).to(DEVICE)
             for k in ("raw", "lengths", "labels")}
    above = float((batch["lengths"] > 384).float().mean())
    tx, schedule = make_optimizer(tcfg)
    state0 = TrainState.create(model, tx, device=DEVICE)
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=tcfg.aug_prob,
                                     blank_id=cfg.blank_id)
    counters = train_counters()
    log(f"long train: baseline_config(4) at frame_len {cfg.frame_len}, "
        f"dropout {cfg.dropout} (top {cfg.top_dropout}), {cfg.dtype}, batch "
        f"{TB}, raw {tuple(batch['raw'].shape)} ({100 * above:.0f}% of the "
        f"sequences above 384 frames), labels "
        f"{tuple(batch['labels'].shape)}, {state0.params.numel()} "
        f"parameters, lr {float(schedule(0)):.3e}")

    step_against_plain("long train", step, state0, batch)

    state = state0.clone()
    torch.cuda.reset_peak_memory_stats()
    for w in counters.values():
        w.launches = w.launches_bwd = 0
    zero_k4_designs()
    zero_k8_designs()
    zero_k7_designs()
    zero_product_counts()
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, seed=0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {(n, d): getattr(w, d) for n, w in counters.items()
                for d in ("launches", "launches_bwd")}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    log(f"long train: {steps} steps, loss "
        + " ".join(f"{v:.3f}" for v in losses))
    log(f"long train: kernel launches over the run {launches}")
    log_k4_designs("long train", steps, {"forward": {}, "backward": {}})
    log_k8_designs("long train", steps, {"forward": {"wgmma": 8 * steps},
                                         "backward": {"wgmma": 8 * steps}})
    log_k7_designs("long train", steps, wgmma_k7(steps))
    log_product_counts("long train", steps, {
        "wgmma": 2 * LONG_STEP_LAUNCHES["conv_module_residual"] * steps})
    for (name, direction), n in launches.items():
        if n != steps * LONG_STEP_LAUNCHES[name]:
            raise AssertionError(
                f"{name}.{direction} = {n} over {steps} steps, expected "
                f"{LONG_STEP_LAUNCHES[name]} a step")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"long training loss did not fall: {losses}")
    log(f"long train: loss finite at every step, mean of the first three "
        f"{first:.3f} -> of the last three {last:.3f}; launches a step: "
        + ", ".join(f"{n} {c} + {c}" for n, c in LONG_STEP_LAUNCHES.items())
        + f" PASS; max_memory_allocated {peak / 2 ** 30:.2f} GiB")

    time_steps("long train", step, state, batch, smi, top=20)
    return launches


def wide_kernel_train_phase(smi, steps: int = 3):
    """``baseline_config(4)`` with ``transformer_kernel_size`` 33 and 63 at
    the flagship's batch 256 in bf16: one step on the kernels against the
    plain versions, then ``steps`` steps with the launch counts read around
    them (K7 4 + 4 a step). Returns {K: {(wrapper name, direction):
    launches}}."""
    import torch

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    ds = SyntheticASLFR(num_sequences=TB, seed=3)
    host = ds.batch(range(TB), CTCTokenizer(), max_frames=96)
    batch = {k: torch.from_numpy(host[k]).to(DEVICE)
             for k in ("raw", "lengths", "labels")}
    out = {}
    for K in WIDE_KS:
        cfg = dataclasses.replace(baseline_config(4).model,
                                  transformer_kernel_size=K)
        torch.manual_seed(K)
        tx, _ = make_optimizer(TrainConfig())
        state0 = TrainState.create(build_model(cfg, device=DEVICE), tx,
                                   device=DEVICE)
        step = make_fused_ctc_train_step(GroupStats.identity(),
                                         cfg.frame_len, aug_prob=0.2,
                                         blank_id=cfg.blank_id)
        label = f"wide train K {K}"
        step_against_plain(label, step, state0, batch)
        counters = train_counters()
        state = state0.clone()
        for w in counters.values():
            w.launches = w.launches_bwd = 0
        for _ in range(steps):
            state, m = step(state, batch, seed=0)
        torch.cuda.synchronize()
        launches = {(n, d): getattr(w, d) for n, w in counters.items()
                    for d in ("launches", "launches_bwd")}
        for (name, direction), n in launches.items():
            if n != steps * STEP_LAUNCHES.get(name, 0):
                raise AssertionError(
                    f"{label}: {name}.{direction} = {n} over {steps} steps, "
                    f"expected {STEP_LAUNCHES.get(name, 0)} a step")
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"{label}: the loss is not finite")
        log(f"{label}: {steps} steps, loss {float(m['loss']):.3f}, "
            f"conv_module_residual "
            f"{launches[('conv_module_residual', 'launches')]} + "
            f"{launches[('conv_module_residual', 'launches_bwd')]} launches "
            f"PASS")
        out[K] = launches
        del state0, state
        torch.cuda.empty_cache()
    return out


# The Trainer phase: baseline_config(4) on the hard corpus the gate trains
# on (tools/train_hard_torch.py), cut to 1024 training sequences (4 steps an
# epoch) and 256 validation sequences, 3 epochs, validated every epoch.
TRAINER_EPOCHS = 3
HARD = dict(confusability=0.6, hand_nan=0.15, proto_seed=7)


class _PreemptedData:
    """A dataset whose ``batch`` raises on its ``fail_after + 1``-th call:
    a preemption in the middle of an epoch."""

    def __init__(self, inner, fail_after):
        self._inner, self._fail, self._n = inner, fail_after, 0

    def __len__(self):
        return len(self._inner)

    def batch(self, idx, tok, max_frames=None):
        if self._n >= self._fail:
            raise RuntimeError("simulated preemption")
        self._n += 1
        return self._inner.batch(idx, tok, max_frames=max_frames)


def trainer_config():
    from ishara_tpu_torch.config import baseline_config

    cfg = baseline_config(4)
    cfg.train.num_epochs = TRAINER_EPOCHS
    cfg.train.batch_size = TB
    cfg.train.warmup_epochs = 1
    cfg.train.validate_every_epochs = 1
    cfg.train.checkpoint_every_epochs = 2
    return cfg


def trainer_phase(smi, workdir: Path):
    """The CTC ``Trainer`` on the card (no ``device`` argument: ``cuda``):
    3 epochs with validation, checkpoints on disk, the kernels' launches
    over the run, the Trainer's ms a step beside the bare step's and the
    host's share of an epoch; then a run preempted on its 6th batch load
    and resumed by a third ``Trainer``, which must end bit for bit where
    the uninterrupted run did."""
    import shutil

    import torch

    from ishara_tpu_torch.data.synthetic import HardSyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.train import Trainer

    shutil.rmtree(workdir, ignore_errors=True)
    tok = CTCTokenizer()
    train_ds = HardSyntheticASLFR(num_sequences=4 * TB, seed=0, **HARD)
    val_ds = HardSyntheticASLFR(num_sequences=TB, seed=1, **HARD)
    idx = np.arange(TB)
    t0 = time.perf_counter()
    host = train_ds.batch(idx, tok, max_frames=384)
    collate_ms = (time.perf_counter() - t0) * 1e3

    counters = train_counters()
    for w in counters.values():
        w.launches = w.launches_bwd = 0
    full = Trainer(trainer_config(), train_ds, val_ds, tok,
                   workdir=workdir / "full")
    t0 = time.perf_counter()
    hist = full.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {(n, d): getattr(w, d) for n, w in counters.items()
                for d in ("launches", "launches_bwd")}
    steps = int(full.state.step)
    spe = full.cfg.train.steps_per_epoch
    for name, per_step in STEP_LAUNCHES.items():
        n_f = launches[(name, "launches")]
        n_b = launches[(name, "launches_bwd")]
        if n_b != steps * per_step or n_f < n_b:
            raise AssertionError(f"trainer: {name} launched {n_f} + {n_b} "
                                 f"times over {steps} steps, expected "
                                 f"{per_step} + {per_step} a step")
    for r in hist:
        log(f"trainer: epoch {r['epoch']} " + json.dumps(r))
    keys = ("val_loss", "val_score", "val_score_maxlen", "val_score_pooled")
    ok = (len(hist) == TRAINER_EPOCHS and steps == TRAINER_EPOCHS * spe
          and all(math.isfinite(r["train_loss"]) for r in hist)
          and all(all(k in r for k in keys) for r in hist)
          and all(math.isfinite(r[k]) for r in hist for k in keys)
          # the competition and pooled scores are 1 - edits / target
          # length, so a prediction longer than its target scores below 0
          # (an untrained model's often does); max_len's lies in [0, 1]
          and all(r[k] <= 1.0 for r in hist for k in keys[1:])
          and all(r["val_score_maxlen"] >= 0.0 for r in hist))
    ckpt = workdir / "full" / "ckpt"
    main = sorted(p.name for p in ckpt.glob("step_*.pt"))
    best = sorted(p.name for p in (ckpt / "best").glob("step_*.pt"))
    meta = full.ckpt.read_meta()
    on_disk = (f"step_{steps}.pt" in main            # final
               and f"step_{2 * spe}.pt" in main      # periodic, epoch 2
               and len(best) == 1
               and best[0] == f"step_{full.ckpt.best_step()}.pt"
               and meta[str(steps)]["completed_epochs"] == TRAINER_EPOCHS)
    log(f"trainer: {TRAINER_EPOCHS} epochs of {spe} steps, {steps} steps; "
        f"losses finite, val_loss and the three val scores present and "
        f"finite, the scores at most 1 and val_score_maxlen in [0, 1]: "
        f"{ok}; checkpoints main {main}, best "
        f"{best}, meta steps {sorted(meta, key=int)}: {on_disk}; launches "
        f"over the run (training and validation) {launches} "
        f"{'PASS' if ok and on_disk else 'FAIL'}")
    if not (ok and on_disk):
        raise AssertionError("the Trainer run failed its checks")

    # where an epoch's time goes: the Trainer's epoch wall over its steps
    # against the bare step on a collated batch, and the host's share
    epoch_s = [r["epoch_time_s"] for r in hist]
    wait_s = [r["data_wait_s"] for r in hist]
    val_s = [r["val_time_s"] for r in hist]
    step = full._train_step
    batch = {k: torch.from_numpy(host[k]).to(DEVICE)
             for k in ("raw", "lengths", "labels")}
    probe = full.state.clone()
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe, _m = step(probe, batch, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    bare = statistics.median(times[1:])
    del probe
    loop_ms = [1e3 * e / spe for e in epoch_s]
    share = [round(100 * w / e, 1) for w, e in zip(wait_s, epoch_s)]
    log(f"trainer timing: epoch wall {epoch_s} s, {spe} steps an epoch: "
        f"{loop_ms} ms a step in the loop (epoch 0 includes the first "
        f"batch's collation with nothing to overlap); bare "
        f"make_fused_ctc_train_step {bare:.3f} ms a step (median of 5, host "
        f"clock, synchronized); the loop waited for the host's next batch "
        f"{wait_s} s an epoch ({share}% "
        f"of the epoch); collating one batch of {TB} at 384 frames "
        f"{collate_ms:.1f} ms on the host; validation ({len(val_ds)} "
        f"sequences) {val_s} s; sequences/s over an epoch "
        f"{[round(spe * TB / e, 1) for e in epoch_s]}; train() wall "
        f"{wall:.2f} s on {smi}")

    # a preemption mid-epoch, then a resume in a third Trainer
    cut = Trainer(trainer_config(), _PreemptedData(train_ds, spe + 1),
                  val_ds, tok, workdir=workdir / "mid")
    try:
        cut.train()
    except RuntimeError as e:
        if "simulated preemption" not in str(e):
            raise
    else:
        raise AssertionError("the preempted run was not preempted")
    consumed = cut._epoch_batches_done
    if not (cut.completed_epochs == 1 and 0 < consumed < spe):
        raise AssertionError(f"the preemption did not land mid-epoch: "
                             f"{cut.completed_epochs} epochs, {consumed} "
                             f"batches")
    del cut
    torch.cuda.empty_cache()
    resumed = Trainer(trainer_config(), train_ds, val_ds, tok,
                      workdir=workdir / "mid")
    if not resumed.resume() or resumed._resume_skip != consumed:
        raise AssertionError("resume() did not find the mid-epoch checkpoint")
    resumed.train()
    a, b = resumed.state, full.state
    pairs = ([("params", a.params, b.params),
              ("slow_params", a.slow_params, b.slow_params)]
             + [(f"opt_state.{k}", a.opt_state[k], b.opt_state[k])
                for k in a.opt_state]
             + [(f"batch_stats.{k}", v, b.batch_stats[k])
                for k, v in a.batch_stats.items()])
    differ = [n for n, x, y in pairs if not torch.equal(x, y)]
    same_step = int(a.step) == int(b.step)
    log(f"trainer: preempted on batch load {spe + 2} (epoch 1, {consumed} "
        f"of {spe} batches done), resumed by a third Trainer: step "
        f"{int(a.step)} vs {int(b.step)}, params, slow_params, "
        f"{len(a.opt_state)} optimizer tensors (both moments) and "
        f"{len(a.batch_stats)} BatchNorm statistics equal the uninterrupted "
        f"run's bit for bit: {not differ} "
        f"{'PASS' if same_step and not differ else 'FAIL'}")
    if differ or not same_step:
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one in {differ}")
    del full, resumed, a, b
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Translation serving: the encoder-decoder model and K9
# ---------------------------------------------------------------------------

DEC_REF = "ishara_tpu/ops/decoder_kernel.py"
# K9 against its plain version: tokens exactly; the beams' raw scores (sums
# of up to 63 log-probabilities) within |err| <= 1e-5 + 1e-6 |score|, the
# same f32 arithmetic in another summation order.
SCORE_TOL = (1e-5, 1e-6)
# The translation reference geometry (bench.py's ASLTranslationModel): dim
# 208, 8 heads of 26, 2 + 2 layers, 62 classes, T 176, max_out 64, beam 4.
TR = dict(T=176, S=64, W=4, C=62, EOS=2)
DECODE_KERNEL = re.compile(r"(decode_kernel)\b")


def decode_work(d, L, C, T, W, steps):
    """(bytes, operations) of one decode: the packed decoder weights, the
    cross-attention K / V and the mask read once, the tokens written once;
    multiply-adds (2 operations each) of the products, the self-attention
    over the steps so far and the cross-attention, for ``W`` rows and the
    ``steps`` steps this run took."""
    weights = L * (14 * d * d + 17 * d) + 2 * d + 2 * C * d + C
    nbytes = 4 * (weights + 2 * L * T * d + T + W * (steps + 1) + W)
    macs = 0
    for i in range(steps):
        macs += W * (L * (14 * d * d + 2 * (i + 1) * d + 2 * T * d) + C * d)
    return nbytes, 2 * macs


def decode_plan_row(dk, d, H, L, C, T, S, W):
    """K9's plan at this geometry as the card takes it (the C side's, which
    must equal ``decode_plan``'s): cluster, the blocks a head's columns are
    split over, the largest block's resident and streamed weight bytes,
    where the caches and the cross K / V live, and the exchanges a step
    the plan expects (those that end a stage, the cluster's
    synchronisations, and a split head's score exchanges)."""
    import torch

    got = dk.kernel_plan(torch.cuda.current_device(), d, H, L, C, T, S, W)
    want = dk.decode_plan(d, H, L, C, T, S, W, cluster=got["cluster"])
    for key in ("smem_bytes", "scratch_floats", "resident_bytes",
                "streamed_bytes", "cache_smem", "cross_smem", "slots",
                "slot_floats", "parts"):
        if int(want[key]) != got[key]:
            raise AssertionError(f"decode plan {key}: the kernel's "
                                 f"{got[key]}, decode_plan's {want[key]}")
    return dict(cluster=got["cluster"], parts=got["parts"],
                resident_bytes_per_block=got["resident_bytes"],
                streamed_bytes_per_block=got["streamed_bytes"],
                caches_in_smem=bool(got["cache_smem"]),
                cross_kv_in_smem=bool(got["cross_smem"]),
                planned_exchanges_per_step=want["barriers_per_step"],
                planned_score_exchanges_per_step=want[
                    "score_exchanges_per_step"])


def decode_check(dk, args, plan):
    """One K9 decode (``dk._launch(*args)``) held against its plain version:
    tokens and steps exactly, raw scores within SCORE_TOL, a second launch
    bit-equal (tokens, scores, counts), and the kernel's own counts of its
    exchanges equal to the plan's a step. Returns what was found."""
    import torch

    pack, cross, madd, d, H, L, C, S, W, beam = args[:10]
    got, gscore, counts, cluster = dk._launch(*args)
    again, ascore, acounts, _ = dk._launch(*args)
    want, wscore, steps = dk.decode_plain(
        pack, cross, madd, d=d, H=H, L=L, C=C, max_len=S, beam_width=W,
        beam=beam)
    err = float((gscore - wscore).abs().max())
    steps_run, xch, sxch = counts.tolist()
    tokens = torch.equal(got, want) and steps_run == steps
    within = bool(((gscore - wscore).abs() <= SCORE_TOL[0]
                   + SCORE_TOL[1] * wscore.abs()).all())
    same = (torch.equal(again, got) and torch.equal(acounts, counts)
            and torch.equal(ascore.view(torch.int32),
                            gscore.view(torch.int32)))
    counted = (xch == steps * plan["planned_exchanges_per_step"]
               and sxch == steps * plan["planned_score_exchanges_per_step"])
    return dict(ok=tokens and within and same and counted, tokens=tokens,
                err=err, same=same, steps=steps, cluster=cluster,
                exchanges_per_step=xch / max(1, steps_run),
                score_exchanges_per_step=sxch / max(1, steps_run),
                counted=counted, first_row=got[0, :12].tolist())


def wide_decode_checks(smi):
    """K9 at the geometries the first design refused: beam 8 and 12 at the
    reference geometry (S 64; their caches in global memory), and heads
    of 160 (dim 320, 2 heads, T 176; each head's columns over 8 blocks),
    greedy and beam 4 -- through ``decode_check``; timed."""
    import torch

    from ishara_tpu_torch.models.seq2seq import ASLTranslationModel
    from ishara_tpu_torch.ops import decoder_kernel as dk

    T, S, C, EOS = TR["T"], TR["S"], TR["C"], TR["EOS"]
    for dim, heads, W, beam in ((208, 8, 8, True), (208, 8, 12, True),
                                (320, 2, 1, False), (320, 2, 4, True)):
        m = ASLTranslationModel(num_classes=C, feature_dim=dim, num_layers=2,
                                num_decoder_layers=2, num_heads=heads)
        m = m.to(DEVICE)
        randomize(m, seed=11)
        g = torch.Generator().manual_seed(5)
        memory = torch.randn((1, T, dim), generator=g).to(DEVICE)
        mask = (torch.arange(T) < 150)[None].to(DEVICE)
        pack = dk.pack_decoder(m)
        pack[pack.numel() - C * dim - C + EOS] -= 1e4   # every step runs
        args = (pack, dk.cross_pack(m, memory), dk.memory_add(mask, T, DEVICE),
                dim, heads, 2, C, S, W, beam, 1, EOS, 0, 1e-6)
        plan = decode_plan_row(dk, dim, heads, 2, C, T, S, W)
        r = decode_check(dk, args, plan)
        ms = time_ms(lambda: dk._launch(*args), runs=10)
        log(f"kernel fused_{'beam' if beam else 'greedy'}_decode at dim "
            f"{dim}, {heads} heads of {dim // heads}, beam width {W}: "
            f"{r['steps']} steps, tokens equal the plain version's "
            f"{r['tokens']}, score max_abs_err {r['err']:.3e}, two launches "
            f"bit-equal {r['same']}, exchanges a step (counted) "
            f"{r['exchanges_per_step']:g} + {r['score_exchanges_per_step']:g}"
            f" as planned {r['counted']} {'PASS' if r['ok'] else 'FAIL'}; "
            f"{ms:.4f} ms ({1e3 * ms / (S - 1):.2f} us a step); plan {plan}; "
            f"on {smi}")
        if not r["ok"]:
            raise AssertionError(f"K9 at dim {dim}, {heads} heads, beam "
                                 f"width {W} disagrees with its plain "
                                 f"version or with itself")


def translation_phase(smi):
    """K9 against its plain version and the translation engines, at the
    reference width. Returns (kernel rows, {wrapper: launches over the
    nine-request run of its fused engine})."""
    import torch

    from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer
    from ishara_tpu_torch.decode import autoregressive as ar
    from ishara_tpu_torch.models.seq2seq import build_translation_model
    from ishara_tpu_torch.ops import decoder_kernel as dk
    from ishara_tpu_torch.ops import selection
    from ishara_tpu_torch.preprocess.pipeline import (
        GroupStats,
        frame_mask,
        preprocess,
    )
    from ishara_tpu_torch.serve import (
        BatchedTranslationEngine,
        TranslationEngine,
    )

    T, S, W, C, EOS = TR["T"], TR["S"], TR["W"], TR["C"], TR["EOS"]
    model = build_translation_model(device=DEVICE)
    randomize(model, seed=7)
    d, H, L = model.feature_dim, model.num_heads, model.num_decoder_layers
    reqs = requests(seed=1)
    tok = Seq2SeqTokenizer()
    log(f"translation: ASLTranslationModel(num_classes={C}, feature_dim={d}, "
        f"num_layers={model.num_layers}, num_decoder_layers={L}, "
        f"num_heads={H}), {sum(p.numel() for p in model.parameters())} "
        f"parameters, T={T}, max_out={S}, beam {W}; decoder pack "
        f"{4 * dk.pack_decoder(model).numel()} bytes")

    # the main path's memory for one request (len150), through the
    # engine's own preprocess and the encoder
    raw = torch.zeros((384, 276), device=DEVICE)
    raw[:150] = torch.from_numpy(reqs[1][1][:150]).to(DEVICE)
    flat = preprocess(raw, torch.tensor(150, device=DEVICE),
                      GroupStats.identity(), T)
    mask = frame_mask(flat)[None]
    x = flat.reshape(1, T, 92, 3)
    with torch.no_grad():
        memory, _ = model.encode(x, mask)
    pack = dk.pack_decoder(model)
    # the timed decodes run every step: the eos logit is held down
    no_eos = pack.clone()
    no_eos[pack.numel() - C * d - C + EOS] -= 1e4
    cross = dk.cross_pack(model, memory)
    madd = dk.memory_add(mask, T, DEVICE)
    rows = []
    for name, W_, S_, beam, wrapper, line in (
            ("fused_greedy_decode", 1, S, False, dk.fused_greedy_decode, 298),
            ("fused_greedy_decode[max_out=18]", 1, 18, False,
             dk.fused_greedy_decode, 298),
            ("fused_beam_decode", W, S, True, dk.fused_beam_decode, 580)):
        errs = []
        plan = decode_plan_row(dk, d, H, L, C, T, S_, W_)
        for p_, what in ((pack, "the model's weights"),
                         (no_eos, "the eos logit held down")):
            args = (p_, cross, madd, d, H, L, C, S_, W_, beam, 1, EOS, 0,
                    1e-6)
            r = decode_check(dk, args, plan)
            errs.append(r["err"])
            log(f"kernel {name} ({what}): {r['steps']} steps, cluster of "
                f"{r['cluster']} blocks; tokens equal the plain version's: "
                f"{r['tokens']}; beam score max_abs_err {r['err']:.3e}; a "
                f"second launch bit-equal: {r['same']}; exchanges a step "
                f"(counted) {r['exchanges_per_step']:g} + "
                f"{r['score_exchanges_per_step']:g} as planned "
                f"{r['counted']} {'PASS' if r['ok'] else 'FAIL'}; first row "
                f"{r['first_row']}")
            if not r["ok"]:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version or with itself ({what})")
        # times with every step run (the eos logit held down)
        ms = time_ms(lambda: dk._launch(*args), runs=30)
        plain_ms = time_ms(lambda: dk.decode_plain(
            no_eos, cross, madd, d=d, H=H, L=L, C=C, max_len=S_,
            beam_width=W_, beam=beam), runs=3, warmup=1, head_start=False)
        # the yardstick: the port's unfused KV-cached loop on the same
        # model, memory and settings (every step run), minus nothing: it
        # takes x, so its encoder is timed apart and taken off
        slow = copy.deepcopy(model)
        with torch.no_grad():
            slow.classifier.bias[EOS] -= 1e4
            if beam:
                loop = lambda: ar.beam_translate_cached(  # noqa: E731
                    slow, x, mask, max_len=S_, beam_width=W_)
            else:
                loop = lambda: ar.greedy_translate_cached(  # noqa: E731
                    slow, x, mask, max_len=S_)
            enc_ms = time_ms(lambda: slow.encode(x, mask), runs=20,
                             head_start=False)
            loop_ms = time_ms(loop, runs=5, warmup=1, head_start=False)
        del slow
        nbytes, ops = decode_work(d, L, C, T, W_, S_ - 1)
        bound_ms, bound_by = bound_of(nbytes, ops, "f32")
        step_bytes = nbytes - 4 * (W_ * (S_ + 1))
        reread_ms = (S_ - 1) * step_bytes / HBM_BYTES_PER_S * 1e3
        log(f"kernel {name}: kernel {ms:.4f} ms ({1e3 * ms / (S_ - 1):.2f} "
            f"us a step over {S_ - 1} steps), plain {plain_ms:.4f} ms, the "
            f"unfused KV-cached loop {loop_ms - enc_ms:.4f} ms ({loop_ms:.4f}"
            f" ms with its encoder, {enc_ms:.4f} ms); bound {bound_ms:.5f} "
            f"ms ({nbytes} bytes, {ops} operations, by {bound_by}); the "
            f"same bytes re-read every step {reread_ms:.4f} ms; plan {plan}; "
            f"on {smi}")
        rows.append(dict(
            name=name, route="cuda", source=CSRC + "decoder.cu",
            replaces=f"{DEC_REF}:{line}", launches=None,
            max_abs_err=max(errs),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, unfused_loop_ms=loop_ms - enc_ms,
            steps=S_ - 1, us_per_step=1e3 * ms / (S_ - 1),
            exchanges_per_step=r["exchanges_per_step"],
            score_exchanges_per_step=r["score_exchanges_per_step"],
            counter=wrapper))
    wide_decode_checks(smi)

    # the engines: nine requests each; K9's launches counted around the
    # fused engines' runs
    plan = [("fused=False kv_cache=False", dict(kv_cache=False)),
            ("fused=False", dict()),
            ("fused=False early_exit=False", dict(early_exit=False)),
            ("fused=True", dict(fused=True)),
            ('fused="auto"', dict(fused="auto")),
            ('decode="beam" fused=False', dict(decode="beam", beam_width=W)),
            ('decode="beam" fused=True', dict(decode="beam", beam_width=W,
                                              fused=True))]
    engines, results, launches = {}, {}, {}
    for label, kw in plan:
        eng = TranslationEngine(model, frame_len=T, max_out=S, device=DEVICE,
                                **kw)
        eng(reqs[0][1])
        torch.cuda.synchronize()
        dk.fused_greedy_decode.launches = 0
        dk.fused_beam_decode.launches = 0
        res = [eng(r) for _, r in reqs]
        torch.cuda.synchronize()
        counts = {"fused_greedy_decode": dk.fused_greedy_decode.launches,
                  "fused_beam_decode": dk.fused_beam_decode.launches}
        engines[label], results[label] = eng, res
        fused = kw.get("fused", False)
        if fused == "auto":
            fused = (selection.translation_decode_fused(d, T)
                     and dk.fused_decode_fits(model, T, S, 1))
        want = {"fused_greedy_decode": 0, "fused_beam_decode": 0}
        if fused:
            want["fused_beam_decode" if kw.get("decode") == "beam"
                 else "fused_greedy_decode"] = len(reqs)
            launches = {**launches, **{k: v for k, v in counts.items() if v}}
        log(f"engine TranslationEngine({label}): {len(reqs)} requests, K9 "
            f"launches {counts}")
        if counts != want:
            raise AssertionError(f"TranslationEngine({label}) launched K9 "
                                 f"{counts}, not {want} (one a fused "
                                 f"request)")
        for (rl, _), (toks, conf) in zip(reqs, res):
            if toks.shape != (S,) or toks[0] != 1 or not math.isfinite(conf):
                raise AssertionError(f"{label} {rl}: bad output")
    log(f"selection.translation_decode_fused({d}, {T}) = "
        f"{selection.translation_decode_fused(d, T)}")
    greedy = results["fused=False"]
    for label, res in results.items():
        ref = results['decode="beam" fused=False'] if "beam" in label \
            else greedy
        for (rl, _), (toks, conf), (rt, rc) in zip(reqs, res, ref):
            if not np.array_equal(toks, rt) or abs(conf - rc) > 1e-4:
                raise AssertionError(f"TranslationEngine({label}) {rl}: "
                                     f"tokens differ from the unfused "
                                     f"engine's")
    for (rl, raw), (toks, conf), (bt, _) in zip(
            reqs, greedy, results['decode="beam" fused=True']):
        log(f"  {rl:14s} T={raw.shape[0]:4d} confidence {conf:+.4f} greedy "
            f"{toks[:14].tolist()} beam {bt[:14].tolist()}")
    log("tokens equal across every greedy mode, and fused beam equals "
        "unfused beam, on all nine requests PASS")

    # eos probe: the classifier biased to eos gives [sos, eos, pad ...]
    with torch.no_grad():
        saved = float(model.classifier.bias[EOS])
        model.classifier.bias[EOS] = 1000.0
        for kw in (dict(fused=True), dict(fused=False),
                   dict(decode="beam", beam_width=W, fused=True)):
            probe = TranslationEngine(model, frame_len=T, max_out=S,
                                      device=DEVICE, **kw)
            toks, _ = probe(reqs[2][1])
            if toks.tolist() != [1, EOS] + [0] * (S - 2) \
                    or probe.predict_text(reqs[2][1], tok)[0] != "":
                raise AssertionError(f"eos probe {kw} gave {toks[:6]}")
        model.classifier.bias[EOS] = saved
    log("eos probe (classifier bias at eos): [sos, eos, pad ...] from the "
        "fused greedy, unfused greedy and fused beam engines PASS")

    batched = BatchedTranslationEngine(model, batch_size=32, frame_len=T,
                                       max_out=S, device=DEVICE)
    batch = [reqs[i % len(reqs)][1] for i in range(32)]
    btoks, _ = batched(batch)
    for i in range(32):
        if not np.array_equal(btoks[i], greedy[i % len(reqs)][0]):
            raise AssertionError(f"BatchedTranslationEngine row {i} differs "
                                 f"from TranslationEngine")
    b_ms = [host_ms(lambda: batched(batch), runs=1) for _ in range(5)]
    b_ms = statistics.median(b_ms)
    log(f"BatchedTranslationEngine(batch_size=32): tokens equal "
        f"TranslationEngine's PASS; {b_ms:.3f} ms a batch, "
        f"{32e3 / b_ms:.1f} sequences/s (median of 5) on {smi}")

    timed = {f"TranslationEngine({label})": (eng, "fused=True" in label)
             for label, eng in engines.items()}
    latencies(timed, reqs, smi, rounds=100, unfused=20)
    for label in ("fused=True", 'decode="beam" fused=True', "fused=False"):
        profile_phase(f"TranslationEngine({label})", engines[label], reqs,
                      n=9, kernels=DECODE_KERNEL)
    return rows, launches


# ---------------------------------------------------------------------------
# Translation training: K2 at every dropout site of the encoder-decoder model
# ---------------------------------------------------------------------------

# bench.py's ASLTranslationModel at the gate's recipe
# (tools/train_translation_hard_torch.py): dim 208, 8 heads of 26, 2 RoPE
# Squeezeformer blocks, 2 decoder layers, 62 classes, dropout 0.1, T 176,
# labels of 64 tokens, batch 256, f32, AdamW at a peak of 1e-3. Its 23
# dropout sites (7 an encoder block, 4 a decoder layer, the target
# embedding's) each launch K2 once forward and once backward a step; no
# other training kernel runs.
TR_TRAIN = dict(dim=208, heads=8, layers=2, dropout=0.1, lr=1e-3)
TR_SITES = 23
# The attention probabilities K2 drops there: encoder self-attention,
# decoder self-attention and cross-attention.
TR_PROB_SHAPES = ((TB, 8, 176, 176), (TB, 8, 63, 63), (TB, 8, 63, 176))


def translation_dropout_rows(smi, runs: int = 20):
    """K2 on the translation step's attention probabilities, f32 at rate
    0.1: the encoder's [256, 8, 176, 176] and the decoder's [256, 8, 63,
    63] timed as rows, the cross-attention's [256, 8, 63, 176] held to the
    plain version; forward and backward exact, beside F.dropout."""
    import torch

    rows = []
    for shape in TR_PROB_SHAPES:
        timed = shape[-1] == shape[-2]
        rows += dropout_kernel_rows(
            smi, runs if timed else 3, shape=shape, tags=("f32",),
            forms=("fast_dropout",), row_tag="f32" if timed else None,
            rate=TR_TRAIN["dropout"],
            suffix=f"[f32 {'x'.join(map(str, shape))}]")
        torch.cuda.empty_cache()
    return rows


def translation_train_phase(smi, steps: int = 20):
    """The translation training slice on the card. Returns {(wrapper name,
    direction): launches over the ``steps``-step run}."""
    import torch

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.data.synthetic import HardSyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer
    from ishara_tpu_torch.models.seq2seq import ASLTranslationModel
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_translation_eval_step,
        make_fused_translation_train_step,
        make_optimizer,
    )

    tok = Seq2SeqTokenizer()
    T = TR["T"]
    torch.manual_seed(6)            # the weights: PyTorch's default init
    model = ASLTranslationModel(
        num_classes=tok.vocab_size, feature_dim=TR_TRAIN["dim"],
        num_layers=TR_TRAIN["layers"], num_decoder_layers=TR_TRAIN["layers"],
        num_heads=TR_TRAIN["heads"], dropout=TR_TRAIN["dropout"])
    host = HardSyntheticASLFR(num_sequences=TB, seed=0, **HARD).batch(
        range(TB), tok, max_frames=384)
    batch = {k: torch.from_numpy(host[k]).to(DEVICE)
             for k in ("raw", "lengths", "labels")}
    # the gate's AdamW and one-cycle, compressed to this run: from 4e-5 up
    # to the peak of 1e-3 at step 6 and down again by step 20
    tcfg = TrainConfig(optimizer="adamw", lr_max=TR_TRAIN["lr"],
                       num_epochs=1, steps_per_epoch=steps, batch_size=TB)
    tx, schedule = make_optimizer(tcfg)
    state0 = TrainState.create(model, tx, device=DEVICE,
                               lookahead_sync_period=1)
    step = make_fused_translation_train_step(
        GroupStats.identity(), T, aug_prob=tcfg.aug_prob,
        pad_idx=tok.pad_token, eos_idx=tok.eos_token)
    counters = train_counters()
    log(f"translation train: ASLTranslationModel(dim {TR_TRAIN['dim']}, "
        f"{TR_TRAIN['heads']} heads, {TR_TRAIN['layers']} + "
        f"{TR_TRAIN['layers']} layers, {tok.vocab_size} classes, dropout "
        f"{TR_TRAIN['dropout']}, {model.num_sites} dropout sites), f32, "
        f"batch {TB}, T {T}, raw {tuple(batch['raw'].shape)}, labels "
        f"{tuple(batch['labels'].shape)}, {state0.params.numel()} "
        f"parameters, adamw, lr {float(schedule(0)):.3e} rising to "
        f"{TR_TRAIN['lr']:g}")
    if model.num_sites != TR_SITES:
        raise AssertionError(f"{model.num_sites} dropout sites, not "
                             f"{TR_SITES}")

    step_against_plain("translation train", step, state0, batch)

    state = state0.clone()
    for w in counters.values():
        w.launches = w.launches_bwd = 0
    zero_k3_designs()
    zero_product_counts()
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, seed=0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {(n, d): getattr(w, d) for n, w in counters.items()
                for d in ("launches", "launches_bwd")}
    losses = [float(v) for v in losses]
    log(f"translation train: {steps} steps of "
        f"make_fused_translation_train_step, loss "
        + " ".join(f"{v:.3f}" for v in losses))
    log(f"translation train: kernel launches over the run {launches}")
    log_k3_designs("translation train", steps, {})
    log_product_counts("translation train", steps, {})
    for (name, direction), n in launches.items():
        want = steps * TR_SITES if name == "fast_dropout" else 0
        if n != want:
            raise AssertionError(f"{name}.{direction} = {n} over {steps} "
                                 f"steps, expected {want}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"translation loss did not fall: {losses}")
    if int(state.step) != steps or int(state.nonfinite_count) != 0:
        raise AssertionError("step counters are off after the run")
    log(f"translation train: loss finite at every step, mean of the first "
        f"three {first:.3f} -> of the last three {last:.3f}; fast_dropout "
        f"{TR_SITES} + {TR_SITES} launches a step, no other training kernel "
        f"PASS")

    state = time_steps("translation train", step, state, batch, smi)

    ev = make_fused_translation_eval_step(
        GroupStats.identity(), T, pad_idx=tok.pad_token,
        eos_idx=tok.eos_token)(state, batch)
    torch.cuda.synchronize()
    ok = (math.isfinite(float(ev["loss"]))
          and ev["ids"].shape == (TB, TR["S"])
          and bool((ev["ids"][:, 0] == tok.sos_token).all())
          and bool(ev["loss_per_seq"].isfinite().all())
          and bool(ev["confidence"].isfinite().all()))
    log(f"translation train: fused eval step loss {float(ev['loss']):.3f}, "
        f"ids {tuple(ev['ids'].shape)}, confidence mean "
        f"{float(ev['confidence'].mean()):.3f} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the translation eval step gave a bad result")
    del state, state0
    torch.cuda.empty_cache()
    return launches


def translation_trainer_config():
    """The gate's recipe at the reference width, cut to 2 epochs of 4 steps
    with one validation at the end."""
    from ishara_tpu_torch.config import (
        EncoderConfig,
        IsharaConfig,
        TrainConfig,
    )

    return IsharaConfig(
        task="translation",
        model=EncoderConfig(dim=TR_TRAIN["dim"], num_heads=TR_TRAIN["heads"],
                            frame_len=TR["T"], dropout=TR_TRAIN["dropout"],
                            num_classes=TR["C"]),
        train=TrainConfig(batch_size=TB, num_epochs=2, warmup_epochs=1,
                          lr_max=TR_TRAIN["lr"], optimizer="adamw",
                          validate_every_epochs=2,
                          checkpoint_every_epochs=1))


def translation_trainer_phase(smi, workdir: Path):
    """``Trainer(task="translation")`` on the card: 2 epochs of 4 steps on
    1024 hard-corpus sequences and one validation; then a run preempted
    mid-epoch and resumed by a third Trainer, which must end bit for bit
    where the uninterrupted run did."""
    import shutil

    import torch

    from ishara_tpu_torch.data.synthetic import HardSyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.train import Trainer

    shutil.rmtree(workdir, ignore_errors=True)
    tok = Seq2SeqTokenizer()
    train_ds = HardSyntheticASLFR(num_sequences=4 * TB, seed=0, **HARD)
    val_ds = HardSyntheticASLFR(num_sequences=TB, seed=1, **HARD)
    dr.fast_dropout.launches = dr.fast_dropout.launches_bwd = 0
    full = Trainer(translation_trainer_config(), train_ds, val_ds, tok,
                   workdir=workdir / "full", task="translation")
    t0 = time.perf_counter()
    hist = full.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = int(full.state.step)
    spe = full.cfg.train.steps_per_epoch
    bwd = dr.fast_dropout.launches_bwd
    for r in hist:
        log(f"translation trainer: epoch {r['epoch']} " + json.dumps(r))
    keys = ("val_loss", "val_score", "val_score_maxlen", "val_score_pooled")
    ok = (len(hist) == 2 and steps == 2 * spe == 8
          and bwd == steps * TR_SITES
          and all(math.isfinite(r["train_loss"]) for r in hist)
          and all(k in hist[-1] and math.isfinite(hist[-1][k])
                  for k in keys)
          and all(k not in hist[0] for k in keys))
    log(f"translation trainer: 2 epochs of {spe} steps, {steps} steps, "
        f"fast_dropout {bwd} backward launches ({TR_SITES} a step), losses "
        f"finite, one validation at the end; train() wall {wall:.2f} s on "
        f"{smi} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the translation Trainer run failed its checks")

    cut = Trainer(translation_trainer_config(),
                  _PreemptedData(train_ds, spe + 1), val_ds, tok,
                  workdir=workdir / "mid", task="translation")
    try:
        cut.train()
    except RuntimeError as e:
        if "simulated preemption" not in str(e):
            raise
    else:
        raise AssertionError("the preempted run was not preempted")
    consumed = cut._epoch_batches_done
    if not (cut.completed_epochs == 1 and 0 < consumed < spe):
        raise AssertionError(f"the preemption did not land mid-epoch: "
                             f"{cut.completed_epochs} epochs, {consumed} "
                             f"batches")
    del cut
    torch.cuda.empty_cache()
    resumed = Trainer(translation_trainer_config(), train_ds, val_ds, tok,
                      workdir=workdir / "mid", task="translation")
    if not resumed.resume() or resumed._resume_skip != consumed:
        raise AssertionError("resume() did not find the mid-epoch checkpoint")
    rh = resumed.train()
    a, b = resumed.state, full.state
    pairs = ([("params", a.params, b.params),
              ("slow_params", a.slow_params, b.slow_params)]
             + [(f"opt_state.{k}", a.opt_state[k], b.opt_state[k])
                for k in a.opt_state]
             + [(f"batch_stats.{k}", v, b.batch_stats[k])
                for k, v in a.batch_stats.items()])
    differ = [n for n, x, y in pairs if not torch.equal(x, y)]
    same = (int(a.step) == int(b.step)
            and rh[-1]["val_score"] == hist[-1]["val_score"])
    log(f"translation trainer: preempted on batch load {spe + 2} (epoch 1, "
        f"{consumed} of {spe} batches done), resumed by a third Trainer: "
        f"step {int(a.step)} vs {int(b.step)}, val_score "
        f"{rh[-1]['val_score']} vs {hist[-1]['val_score']}; params, "
        f"slow_params, {len(a.opt_state)} optimizer tensors and "
        f"{len(a.batch_stats)} BatchNorm statistics equal the "
        f"uninterrupted run's bit for bit: {not differ} "
        f"{'PASS' if same and not differ else 'FAIL'}")
    if differ or not same:
        raise AssertionError(f"the resumed translation run differs from "
                             f"the uninterrupted one in {differ}")
    del full, resumed, a, b
    torch.cuda.empty_cache()


# The long-sequence step on the card against the same step on the CPU:
# tests/test_torch_cuda.py::test_long_sequence_step_on_the_card_matches_the_
# cpu, with its tolerances (loss 1e-6, gradient norm 1e-4 relative, every
# gradient 1e-3 of its leaf's largest entry).
LONG_CPU_TOL = {"loss": 1e-6, "grad_norm": 1e-4, "grad": 1e-3}


def long_step_against_cpu_phase(smi):
    """One fused step of a narrow long-sequence hybrid (dim 64, T 400,
    attention dropout 0: the tiled attention, the conv-module kernel -- its
    f32 tile kernels, forced with ``fused=True`` since the table sends f32
    to the composition -- and K1 on the card) on the card and on this
    machine's CPU, from the same weights and seeds, at f32."""
    import torch

    from ishara_tpu_torch.config import EncoderConfig, TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.models.layers import SqueezeformerConvModule
    from ishara_tpu_torch.ops import conv_kernel as cm
    from ishara_tpu_torch.ops import ctc_kernel as ck
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = EncoderConfig(variant="hybrid", dim=64, num_heads=4,
                        num_squeeze_blocks=1, num_conform_blocks=1,
                        frame_len=400, dropout=0.0, top_dropout=0.2)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    for m in model.modules():
        if isinstance(m, SqueezeformerConvModule):
            m.fused = True
    batch = SyntheticASLFR(num_sequences=4, frames_per_char=16,
                           seed=3).batch(range(4), CTCTokenizer(),
                                         max_frames=600)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), 400,
                                     aug_prob=0.2, with_grads=True)
    cpu = TrainState.create(copy.deepcopy(model), tx, device="cpu")
    card = TrainState.create(copy.deepcopy(model), tx, device=DEVICE)
    before = (ck.ctc_loss_kernel.launches_bwd,
              cm.conv_module_residual.launches_bwd)
    _, mc = step(cpu, batch, seed=1)
    _, mg = step(card, batch, seed=1)
    torch.cuda.synchronize()
    d_loss = abs(float(mg["loss"]) - float(mc["loss"])) \
        / abs(float(mc["loss"]))
    d_norm = abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        / float(mc["grad_norm"])
    largest = max(float(g.abs().max()) for g in mc["grads"].values())
    d_grad = max(float((mg["grads"][n].cpu() - g).abs().max())
                 / max(float(g.abs().max()), 1e-3 * largest)
                 for n, g in mc["grads"].items())
    ok = (ck.ctc_loss_kernel.launches_bwd == before[0] + 1
          and cm.conv_module_residual.launches_bwd == before[1] + 1
          and d_loss <= LONG_CPU_TOL["loss"]
          and d_norm <= LONG_CPU_TOL["grad_norm"]
          and d_grad <= LONG_CPU_TOL["grad"])
    log(f"long step on the card against the CPU (hybrid 1 + 1, dim 64, T "
        f"400, f32): loss {float(mg['loss']):.6f} vs {float(mc['loss']):.6f}"
        f" (rel {d_loss:.2e}, tol {LONG_CPU_TOL['loss']}), gradient norm "
        f"{float(mg['grad_norm']):.4f} vs {float(mc['grad_norm']):.4f} (rel "
        f"{d_norm:.2e}, tol {LONG_CPU_TOL['grad_norm']}), largest gradient "
        f"difference {d_grad:.2e} of its leaf's largest entry (of 1e-3 of "
        f"the largest over all leaves where that is more; tol "
        f"{LONG_CPU_TOL['grad']}) on {smi} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the long-sequence step on the card disagrees "
                             "with the CPU's")


# ---------------------------------------------------------------------------
# Causal mode, streaming, and the parallel-branches and U-Net families
# ---------------------------------------------------------------------------

CAUSAL_CONTEXT = 176
# Launches a causal step of baseline_config(4) makes, forward and backward
# alike: the feed-forward kernel at both sites of all 8 blocks; the dropout
# kernel on each block's attention probabilities (causal attention is the
# masked einsum composition, never the attention kernels) and on the top;
# the dropout-add on each Squeezeformer block's attention branch; one CTC
# loss. No attention kernel (flash or tiled) and no conv-module kernel: they
# implement full attention and the whole-sequence SE gate.
CAUSAL_STEP_LAUNCHES = {"ffn_residual": 16, "fast_dropout": 9,
                        "fast_dropout_add": 4, "ctc_loss_kernel": 1,
                        "flash_mhsa": 0, "flash_mhsa_blocked": 0,
                        "conv_module_residual": 0}
CAUSAL_PROBS = (TB, TH, TT, TT)
STREAM_CHUNK, STREAM_TOL = 8, 1e-4


def causal_config(**kw):
    from ishara_tpu_torch.config import baseline_config

    return dataclasses.replace(baseline_config(4).model, causal=True,
                               attn_context=CAUSAL_CONTEXT, **kw)


def causal_train_phase(smi, steps: int = 10):
    """The causal flagship's training step: baseline_config(4) with
    ``causal=True``, ``attn_context`` 176 (bf16, dropout 0.4, batch 256,
    the recipe's ``TrainConfig()``): one step against the plain versions,
    ``steps`` steps with the launch counts (K1, K2 and K4 on, K3, K7 and K8
    never), ms a step beside the bidirectional flagship's of this run, the
    busy share. Returns the run's launches."""
    import torch

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = causal_config()
    tcfg = TrainConfig()
    torch.manual_seed(4)
    model = build_model(cfg, device=DEVICE)
    batch = train_batch()
    tx, _ = make_optimizer(tcfg)
    state0 = TrainState.create(model, tx, device=DEVICE)
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=tcfg.aug_prob,
                                     blank_id=cfg.blank_id)
    log(f"causal train: baseline_config(4) causal, attn_context "
        f"{cfg.attn_context} ({cfg.variant} {cfg.num_squeeze_blocks}+"
        f"{cfg.num_conform_blocks}, dim {cfg.dim}, {cfg.dtype}, dropout "
        f"{cfg.dropout}), batch {TB}, {state0.params.numel()} parameters")
    step_against_plain("causal train", step, state0, batch)
    state, losses, launches = run_counted(step, state0.clone(), batch, steps)
    log(f"causal train: {steps} steps, loss "
        + " ".join(f"{v:.3f}" for v in losses))
    log(f"causal train: kernel launches over the run {launches}")
    log_k4_designs("causal train", steps, wgmma_k4(steps))
    log_k3_designs("causal train", steps, {})
    log_product_counts("causal train", steps, {
        "wgmma": 2 * CAUSAL_STEP_LAUNCHES["ffn_residual"] * steps})
    for (name, direction), n in launches.items():
        if n != steps * CAUSAL_STEP_LAUNCHES[name]:
            raise AssertionError(
                f"causal train: {name}.{direction} = {n} over {steps} "
                f"steps, expected {CAUSAL_STEP_LAUNCHES[name]} a step")
    log("causal train: launches a step: "
        + ", ".join(f"{n} {c} + {c}" for n, c in CAUSAL_STEP_LAUNCHES.items())
        + " (forward + backward; K1, K2 and K4 launched, K3, K7 and K8 "
          "never) PASS")
    time_steps("causal train", step, state, batch, smi)
    if "train" in STEP_MS:
        log(f"causal train: {STEP_MS['causal train']:.2f} ms a step against "
            f"the bidirectional flagship's {STEP_MS['train']:.2f} ms in this "
            f"run ({STEP_MS['causal train'] / STEP_MS['train']:.2f}x) on "
            f"{smi}")
    del state, state0
    torch.cuda.empty_cache()
    return launches


def causal_step_against_cpu_phase(smi):
    """One fused step of a small causal hybrid (dim 64, 1 + 1 blocks, T
    176, attn_context 64, dropout 0.1, f32) on the card and on this
    machine's CPU from the same weights and seeds."""
    import torch

    from ishara_tpu_torch.config import EncoderConfig, TrainConfig
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = EncoderConfig(variant="hybrid", dim=64, num_heads=4,
                        num_squeeze_blocks=1, num_conform_blocks=1,
                        frame_len=176, dropout=0.1, top_dropout=0.1,
                        causal=True, attn_context=64)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    batch = SyntheticASLFR(num_sequences=8, seed=3).batch(
        range(8), CTCTokenizer(), max_frames=200)
    tx, _ = make_optimizer(TrainConfig())
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=0.2, with_grads=True)
    cpu = TrainState.create(copy.deepcopy(model), tx, device="cpu")
    card = TrainState.create(copy.deepcopy(model), tx, device=DEVICE)
    counters = train_counters()
    before = {n: w.launches_bwd for n, w in counters.items()}
    _, mc = step(cpu, batch, seed=1)
    _, mg = step(card, batch, seed=1)
    torch.cuda.synchronize()
    launched = {n: w.launches_bwd - before[n] for n, w in counters.items()}
    d_loss = abs(float(mg["loss"]) - float(mc["loss"])) \
        / abs(float(mc["loss"]))
    d_norm = abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        / float(mc["grad_norm"])
    largest = max(float(g.abs().max()) for g in mc["grads"].values())
    d_grad = max(float((mg["grads"][n].cpu() - g).abs().max())
                 / max(float(g.abs().max()), 1e-3 * largest)
                 for n, g in mc["grads"].items())
    ok = (launched["ffn_residual"] == 4 and launched["ctc_loss_kernel"] == 1
          and launched["fast_dropout"] == 3
          and launched["flash_mhsa"] == launched["flash_mhsa_blocked"]
          == launched["conv_module_residual"] == 0
          and d_loss <= LONG_CPU_TOL["loss"]
          and d_norm <= LONG_CPU_TOL["grad_norm"]
          and d_grad <= LONG_CPU_TOL["grad"])
    log(f"causal step on the card against the CPU (hybrid 1 + 1, dim 64, T "
        f"176, attn_context 64, f32): loss {float(mg['loss']):.6f} vs "
        f"{float(mc['loss']):.6f} (rel {d_loss:.2e}, tol "
        f"{LONG_CPU_TOL['loss']}), gradient norm "
        f"{float(mg['grad_norm']):.6f} vs {float(mc['grad_norm']):.6f} (rel "
        f"{d_norm:.2e}, tol {LONG_CPU_TOL['grad_norm']}), largest gradient "
        f"difference {d_grad:.2e} (tol {LONG_CPU_TOL['grad']}); card "
        f"launches {launched} on {smi} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the causal step on the card disagrees with "
                             "the CPU's")


def stream_frames(rng, T):
    """Raw [T, 276] landmarks in [0, 1], the right hand missing in frames
    20-39 and every landmark in frames 100-103 (all-NaN frames: invalid)."""
    from ishara_tpu_torch.data import landmarks as lm

    raw = rng.random((T, lm.N_COLS)).astype(np.float32)
    raw[20:40, lm.GROUP_IDX["rhand"].ravel()] = np.nan
    if T > 104:
        raw[100:104] = np.nan
    return raw


def streaming_phase(smi, chunks: int = 200):
    """``StreamingEncoder`` over the causal flagship (baseline_config(4)
    causal, attn_context 176, seeded weights, f32) in chunks of 8: the
    streamed logits against the batch causal forward on the card on the
    same unresampled frames, the emitted ids against a greedy collapse of
    the batch logits; then per-chunk latency (host clock, each chunk ending
    in a synchronize) over ``chunks`` chunks and the device kernels a
    chunk."""
    import torch

    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import _TABLES
    from ishara_tpu_torch.serve.streaming import StreamingEncoder

    cfg = causal_config(dtype="float32")
    model = build_model(cfg, device=DEVICE)
    randomize(model, seed=11)
    rng = np.random.default_rng(5)
    T = cfg.frame_len
    raw = stream_frames(rng, T)
    x = torch.from_numpy(np.nan_to_num(raw[:, _TABLES["out"]])).to(DEVICE)
    with torch.no_grad():
        want = model(x[None])[0]
    streamer = StreamingEncoder(cfg, model, chunk_size=STREAM_CHUNK)
    state, got, emitted = streamer.init_state(), [], []
    for i in range(0, T, STREAM_CHUNK):
        state, ids, _, logits = streamer.step(state, raw[i:i + STREAM_CHUNK])
        got.append(logits)
        emitted.append(ids)
    got = torch.cat(got)
    err = float((got - want).abs().max())
    within = bool(((got - want).abs()
                   <= STREAM_TOL + STREAM_TOL * want.abs()).all())
    top2 = want.topk(2, dim=-1).values
    clear = bool(((top2[:, 0] - top2[:, 1]) > 1e-3).all())
    collapsed, prev = [], cfg.blank_id
    for t in want.argmax(-1).tolist():
        if t != prev and t != cfg.blank_id:
            collapsed.append(t)
        prev = t
    same_ids = StreamingEncoder.collect(emitted) == collapsed
    ok = within and (same_ids or not clear)
    log(f"streaming: baseline_config(4) causal (attn_context "
        f"{cfg.attn_context}, f32), {T} unresampled frames with NaN hands "
        f"and 4 all-NaN frames in chunks of {STREAM_CHUNK}: streamed logits "
        f"against the batch causal forward on the card max_abs_err "
        f"{err:.3e} (tol {STREAM_TOL} + {STREAM_TOL} |logit|), emitted ids "
        f"{'equal to' if same_ids else 'NOT equal to'} the batch logits' "
        f"greedy collapse ({len(collapsed)} ids; every frame's top two "
        f"{'more' if clear else 'not all more'} than 1e-3 apart) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("streaming disagrees with the batch causal "
                             "forward")

    long_raw = stream_frames(rng, chunks * STREAM_CHUNK)
    state, times = streamer.init_state(), []
    for i in range(chunks):
        chunk = long_raw[i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ids, n, logits = streamer.step(state, chunk)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not bool(logits.isfinite().all()) or state.pos != chunks * STREAM_CHUNK:
        raise AssertionError("the long stream went wrong")
    warm = times[5:]
    p50, p99 = np.percentile(warm, 50), np.percentile(warm, 99)
    chunk = long_raw[:STREAM_CHUNK]
    kernels, dev_us, wall_us = device_profile(
        lambda: streamer.step(state, chunk))
    log(f"streaming: {chunks} chunks of {STREAM_CHUNK} frames "
        f"({chunks * STREAM_CHUNK} frames, past frame_len), per chunk p50 "
        f"{p50:.4f} ms p99 {p99:.4f} ms (host clock, each ending in a "
        f"synchronize; the first 5 left out), "
        f"{STREAM_CHUNK / p50 * 1e3:.0f} frames/s at p50; one chunk: "
        f"{kernels} device kernels and copies, device busy {dev_us:.1f} of "
        f"{wall_us:.1f} us ({100 * dev_us / wall_us:.1f}%) on {smi}")
    del streamer, model
    torch.cuda.empty_cache()


FAMILY_KERNELS = {
    # launches a step (forward + backward alike) at each family's config
    "parallel_branches": {"ffn_residual": 16, "flash_mhsa": 8,
                          "conv_module_residual": 4, "fast_dropout_add": 4,
                          "fast_dropout": 1, "ctc_loss_kernel": 1,
                          "flash_mhsa_blocked": 0},
    # three dropout sites a block (attention probabilities, each FFN's
    # hidden), eight blocks; no other kernel on the U-Net's path
    "squeezeformer_unet": {"fast_dropout": 24, "ctc_loss_kernel": 1,
                           "ffn_residual": 0, "flash_mhsa": 0,
                           "flash_mhsa_blocked": 0,
                           "conv_module_residual": 0,
                           "fast_dropout_add": 0},
}


def family_configs():
    from ishara_tpu_torch.config import EncoderConfig, baseline_config

    return {
        # preset 4's widths (bf16, dropout 0.4), 4 Conformer || 4
        # Squeezeformer blocks
        "parallel_branches": dataclasses.replace(
            baseline_config(4).model, variant="parallel_branches"),
        # the speech Squeezeformer-XS widths the U-Net module defaults to:
        # 8 blocks (reduction at 2, recovery at 5), dim 144, 4 heads
        "squeezeformer_unet": EncoderConfig(
            variant="squeezeformer_unet", dim=144, num_squeeze_blocks=8,
            num_heads=4),
    }


def families_phase(smi, reqs, steps: int = 3):
    """parallel_branches and the Temporal U-Net at full width: one step
    against the plain versions, ``steps`` steps with the launch counts,
    nine unfused requests through ``InferenceEngine`` (ids against the
    greedy collapse of the same program's log-probs), ``BatchedEngine``,
    and the fused modes refused with ValueError."""
    import torch

    from ishara_tpu_torch.config import TrainConfig
    from ishara_tpu_torch.decode.greedy import greedy_decode
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.serve.engine import BatchedEngine, InferenceEngine
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    batch = train_batch()
    for name, cfg in family_configs().items():
        torch.manual_seed(5)
        model = build_model(cfg, device=DEVICE)
        tx, _ = make_optimizer(TrainConfig())
        state0 = TrainState.create(model, tx, device=DEVICE)
        step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                         aug_prob=0.2, blank_id=cfg.blank_id)
        blocks = (f"{cfg.num_squeeze_blocks} blocks" if name.endswith("unet")
                  else f"{cfg.num_conform_blocks} || "
                       f"{cfg.num_squeeze_blocks} blocks")
        log(f"{name}: dim {cfg.dim}, {cfg.num_heads} heads, {blocks}, "
            f"{cfg.dtype}, dropout {cfg.dropout}, batch {TB}, "
            f"{state0.params.numel()} parameters")
        step_against_plain(f"{name} train", step, state0, batch)
        state, losses, launches = run_counted(step, state0.clone(), batch,
                                              steps)
        want = FAMILY_KERNELS[name]
        bad = {k: n for k, n in launches.items()
               if n != steps * want.get(k[0], 0)}
        log(f"{name} train: {steps} steps, loss "
            + " ".join(f"{v:.3f}" for v in losses)
            + f"; launches {launches} "
            + ("PASS" if not bad else f"FAIL {bad}")
            + f"; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if bad:
            raise AssertionError(f"{name}: launches off the expected "
                                 f"{want} a step: {bad}")
        log_k7_designs(f"{name} train", steps,
                       wgmma_k7(steps) if want["conv_module_residual"]
                       else {"forward": {}, "backward": {}})
        log_k3_designs(f"{name} train", steps,
                       {"wgmma": want["flash_mhsa"] * steps}
                       if want["flash_mhsa"] else {})
        products = 2 * (want["ffn_residual"] + want["conv_module_residual"])
        log_product_counts(f"{name} train", steps,
                           {"wgmma": products * steps} if products else {})
        time_steps(f"{name} train", step, state, batch, smi, top=8)
        del state0

        model = state.model.eval()
        engine = InferenceEngine(model, device=DEVICE)

        def encoder(x, model=model):
            return model(x[None])[0]

        for label, raw in reqs:
            ids, count = engine(raw)
            lp = request_log_probs(engine, encoder, raw)
            want_ids, want_count = greedy_decode(lp, max_len=engine.max_out)
            want_ids, want_count = with_fallback(
                want_ids.cpu().numpy(), int(want_count), engine.max_out)
            if count != want_count or not np.array_equal(
                    ids[:count], want_ids[:count]):
                raise AssertionError(f"{name} engine, {label}: ids "
                                     f"{ids[:count]} against {want_ids}")
        p50 = host_ms(lambda: engine(reqs[1][1]), runs=20)
        batched = BatchedEngine(model, batch_size=len(reqs), device=DEVICE)
        b_ids, b_counts = batched([r for _, r in reqs])
        for i, (label, raw) in enumerate(reqs):
            ids, count = engine(raw)
            if b_counts[i] != count or not np.array_equal(b_ids[i], ids):
                raise AssertionError(f"{name} BatchedEngine, {label}: "
                                     f"ids differ from InferenceEngine's")
        refused = 0
        for kw in ({"fused": True}, {"fused": "int8"},
                   {"fused": True, "dma": True}):
            try:
                InferenceEngine(model, device=DEVICE, **kw)
            except ValueError:
                refused += 1
        if refused != 3:
            raise AssertionError(f"{name}: a fused mode was not refused")
        log(f"{name} serving: {len(reqs)} unfused requests, ids equal to "
            f"the greedy collapse of the program's log-probs (fallback "
            f"included), BatchedEngine's equal to InferenceEngine's, "
            f"fused True / int8 / dma refused with ValueError PASS; a "
            f"150-frame request {p50:.3f} ms (median of 20, host clock) on "
            f"{smi}")
        del state, model, engine, batched
        torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# QAT, remat, data parallelism and the shard cache
# ---------------------------------------------------------------------------

HALF = TB // 2     # a rank's rows of the flagship batch at two ranks


def offset_kernel_checks(smi):
    """K2, K3 and K4 on a rank's half of the flagship batch (rows [128,
    256)) with the element offset of those rows: each kernel against its
    plain version with the same offset, and against the rows [128, 256)
    of the whole batch's launch (forward and the input gradients, bit for
    bit: every row's arithmetic is the same)."""
    import torch

    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import dropout as dr
    from ishara_tpu_torch.ops import ffn_kernel as fk

    g = torch.Generator(device=DEVICE).manual_seed(15)
    seed = torch.tensor([77], dtype=torch.int32, device=DEVICE)
    bf = torch.bfloat16
    rows = slice(HALF, TB)

    def grads(fn, inputs, dy):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, dy)

    # K2
    x, res, dy = (torch.randn(TB, TT, TD, generator=g, device=DEVICE).to(bf)
                  for _ in range(3))
    off = HALF * TT * TD
    for form in ("fast_dropout", "fast_dropout_add"):
        add = form == "fast_dropout_add"
        w = getattr(dr, form)

        def call(*t, o=0, w=w, add=add):
            return w(t[0], t[1], seed, 0.4, o) if add else w(t[0], seed, 0.4,
                                                            o)
        ins = (res, x) if add else (x,)
        full, fg = grads(call, ins, dy)
        part, pg = grads(lambda *t: call(*t, o=off),
                         [t[rows] for t in ins], dy[rows])
        plain = dr.dropout_plain(x[rows], seed, 0.4,
                                 res[rows] if add else None, off)
        ok = (torch.equal(part, full[rows]) and torch.equal(part, plain)
              and all(torch.equal(a, b[rows]) for a, b in zip(pg, fg)))
        log(f"offset {form} [bf16 {HALF}x{TT}x{TD}] rows [{HALF}, {TB}) at "
            f"offset {off}: equal to the whole batch's launch and to the "
            f"plain version (forward, dx) bit for bit "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{form} with an offset differs")
    # K3
    q, k, v, d_o = (torch.randn(TB, TH, TT, TD // TH, generator=g,
                                device=DEVICE).to(bf) for _ in range(4))
    mask = torch.ones(TB, TT, dtype=torch.bool, device=DEVICE)
    mask[::3, TT - 40:] = False
    bias = at.mask_to_bias(mask)
    scale = TD ** -0.5
    off = HALF * TH * TT * TT

    def attn(q, k, v, o=0, b=bias):
        return at.flash_mhsa(q, k, v, b, seed, scale, 0.4, offset=o)

    full, fg = grads(attn, (q, k, v), d_o)
    part, pg = grads(lambda *t: attn(*t, o=off, b=bias[rows]),
                     [t[rows] for t in (q, k, v)], d_o[rows])
    po, plse = at.mhsa_forward_plain(q[rows], k[rows], v[rows], bias[rows],
                                     seed, scale, 0.4, offset=off)
    pgr = at.mhsa_backward_plain(q[rows], k[rows], v[rows], bias[rows], seed,
                                 po, plse, d_o[rows], scale, 0.4, offset=off)
    same = torch.equal(part, full[rows]) \
        and all(torch.equal(a, b[rows]) for a, b in zip(pg, fg))
    err = max([close("flash_mhsa offset", part, po, TRAIN_TOL["bf16"])]
              + [close("flash_mhsa offset grad", a, b, TRAIN_TOL["bf16"])
                 for a, b in zip(pg, pgr)])
    log(f"offset flash_mhsa [bf16 {HALF}x{TH}x{TT}x{TD // TH}] at offset "
        f"{off}: equal to the whole batch's launch bit for bit {same}; "
        f"against the plain version with the offset max_abs_err {err:.3e} "
        f"{'PASS' if same else 'FAIL'}")
    if not same:
        raise AssertionError("flash_mhsa with an offset differs from the "
                             "whole batch's rows")
    # K4
    seeds = torch.tensor([5, 6], dtype=torch.int32, device=DEVICE)
    w1 = torch.randn(TD, TM, generator=g, device=DEVICE) * TD ** -0.5
    w2 = torch.randn(TM, TD, generator=g, device=DEVICE) * TM ** -0.5
    b1 = torch.randn(TM, generator=g, device=DEVICE) * 0.1
    b2 = torch.randn(TD, generator=g, device=DEVICE) * 0.1
    roff = HALF * TT

    def ffn(x, res, r=0):
        return fk.ffn_residual(x, res, w1, b1, w2, b2, seeds, 0.4, 0.4, r)

    full, fg = grads(ffn, (x, res), dy)
    part, pg = grads(lambda *t: ffn(*t, r=roff), [x[rows], res[rows]],
                     dy[rows])
    n = HALF * TT
    ref = fk.ffn_forward_plain(x[rows].reshape(n, TD),
                               res[rows].reshape(n, TD), w1.to(bf), b1,
                               w2.to(bf), b2, seeds, 0.4, 0.4,
                               row_offset=roff)
    rdx = fk.ffn_backward_plain(x[rows].reshape(n, TD),
                                dy[rows].reshape(n, TD), w1.to(bf), b1,
                                w2.to(bf), seeds, 0.4, 0.4,
                                row_offset=roff)[0]
    m1, m2 = fk.debug_masks(n, TM, TD, seeds, 0.4, 0.4, roff)
    c1, c2 = fk.debug_masks(n, TM, TD, seeds.cpu(), 0.4, 0.4, roff)
    same = (torch.equal(part, full[rows])
            and all(torch.equal(a, b[rows]) for a, b in zip(pg, fg))
            and torch.equal(m1.cpu(), c1) and torch.equal(m2.cpu(), c2))
    err = max(close("ffn_residual offset", part.reshape(n, TD), ref,
                    TRAIN_TOL["bf16"]),
              close("ffn_residual offset dx", pg[0].reshape(n, TD), rdx,
                    TRAIN_TOL["bf16"]))
    log(f"offset ffn_residual [bf16 {n}x{TD}, hidden {TM}] at row offset "
        f"{roff}: equal to the whole batch's launch (forward, dx, dres) bit "
        f"for bit, masks equal to the CPU's Philox {same}; against the plain "
        f"version with the offset max_abs_err {err:.3e} "
        f"{'PASS' if same else 'FAIL'} on {smi}")
    if not same:
        raise AssertionError("ffn_residual with an offset differs")
    del x, res, dy, q, k, v, d_o
    torch.cuda.empty_cache()


def median_step_ms(step, state, batch, runs=5):
    """(state, median host-clock ms of ``runs`` steps, each ending in a
    synchronize) after one warm-up step."""
    import torch

    state, _ = step(state, batch, seed=0)
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch, seed=0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, statistics.median(times)


def qat_phase(smi, steps: int = 10):
    """``baseline_config(4)`` at batch 256, bf16, ``qat=True``: one step on
    the kernels against the plain versions; ``steps`` steps with the launch
    counts (the same as the plain step's); ms a step beside the non-QAT
    step; then the QAT eval step's ids against an
    ``InferenceEngine(fused="int8")`` on the same weights on nine requests
    (the int8 stacks launched). Returns the launches."""
    import torch

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.ops import fused_block as fb
    from ishara_tpu_torch.models.fused import FusedEncoder
    from ishara_tpu_torch.preprocess.pipeline import (
        GroupStats,
        preprocess,
        thin_frames,
    )
    from ishara_tpu_torch.serve import InferenceEngine
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_eval_step,
        make_fused_ctc_train_step,
        make_optimizer,
    )
    from ishara_tpu_torch.train.qat import qat_weights

    cfg = baseline_config(4).model
    tcfg = TrainConfig()
    torch.manual_seed(4)
    state0 = TrainState.create(build_model(cfg, device=DEVICE),
                               make_optimizer(tcfg)[0], device=DEVICE)
    batch = train_batch()
    stats = GroupStats.identity()
    kw = dict(aug_prob=tcfg.aug_prob, blank_id=cfg.blank_id)
    qstep = make_fused_ctc_train_step(stats, cfg.frame_len, qat=True, **kw)
    pstep = make_fused_ctc_train_step(stats, cfg.frame_len, **kw)
    step_against_plain("qat", qstep, state0, batch)
    state, losses, launches = run_counted(qstep, state0.clone(), batch, steps)
    log_k4_designs("qat", steps)
    log_k3_designs("qat", steps, {"wgmma": 8 * steps})
    log_product_counts("qat", steps, {"wgmma": STEP_PRODUCTS * steps})
    for (name, direction), n in launches.items():
        if n != steps * STEP_LAUNCHES.get(name, 0):
            raise AssertionError(f"qat: {name}.{direction} = {n} over "
                                 f"{steps} steps")
    log(f"qat: {steps} steps, loss " + " ".join(f"{v:.3f}" for v in losses)
        + f"; launches {launches} (the plain step's a step) PASS")
    state, q_ms = median_step_ms(qstep, state, batch)
    _, p_ms = median_step_ms(pstep, state.clone(), batch)
    log(f"qat: {q_ms:.2f} ms a QAT step against {p_ms:.2f} ms a plain step "
        f"(median of 5 each, host clock, this run) on {smi}")

    # the QAT eval step on the trained weights against the int8 engine on
    # the same ones: an f32 copy of the model, so the two differ only in
    # the int8 kernels' arithmetic. The engine thins each request's frames
    # on the card; the eval batch takes the same frames already thinned.
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                      device=DEVICE)
    f32.load_state_dict(state.model.state_dict())
    estate = TrainState.create(f32, state.tx, device=DEVICE)
    eng = InferenceEngine(f32, fused="int8", device=DEVICE)
    reqs = requests(seed=0)
    raw = torch.zeros((len(reqs), eng.max_raw_frames, 276), device=DEVICE)
    lengths = torch.zeros(len(reqs), dtype=torch.int32, device=DEVICE)
    for i, (_, r) in enumerate(reqs):
        n = min(r.shape[0], eng.max_raw_frames)
        buf = torch.zeros((eng.max_raw_frames, 276), device=DEVICE)
        buf[:n] = torch.from_numpy(r[:n]).to(DEVICE)
        raw[i], lengths[i] = thin_frames(buf, torch.tensor(max(n, 1),
                                                           device=DEVICE))
    ev = make_fused_ctc_eval_step(stats, cfg.frame_len, cfg.blank_id,
                                  dominant_hand=cfg.dominant_hand,
                                  qat=True)(estate, {
        "raw": raw, "lengths": torch.clamp(lengths, min=1),
        "labels": torch.full((len(reqs), 8), 59, dtype=torch.int32,
                             device=DEVICE)})
    stacks = (fb.fused_squeezeformer_stack, fb.fused_conformer_stack)
    for w in stacks:
        w.launches = 0
    served = [eng(r) for _, r in reqs]
    torch.cuda.synchronize()
    stack_launches = {w.__name__: w.launches for w in stacks}
    # Both sides decode greedily, an argmax a frame, from log-probs that
    # differ by the int8 kernels' arithmetic: by 1.6e-4 to 8.5e-4 at most a
    # request on the card (PERF.md section 6). So the log-probs must agree
    # within QAT_LOGPROB_TOL, and the ids must be equal, or differ only
    # through frames whose two best classes lie within QAT_TIE_GAP of each
    # other (these barely trained weights have such near-ties, 4e-5 apart,
    # which either side may break).
    x = torch.vmap(lambda r, n: preprocess(
        r, n, stats, cfg.frame_len, dominant_hand=cfg.dominant_hand))(
        raw, torch.clamp(lengths, min=1))
    with torch.no_grad(), qat_weights(estate.model, True):
        lq_all = torch.log_softmax(
            estate.model(x, training=False).float(), dim=-1)
    enc8 = FusedEncoder(f32.cfg, fb.quantize_serving_weights(
        f32.state_dict()), compute_dtype="int8", device=DEVICE)
    same = 0
    for i, ((label, r), (ids, count)) in enumerate(zip(reqs, served)):
        want, wn = with_fallback(ev["ids"][i].cpu().numpy(),
                                 int(ev["counts"][i]), eng.max_out)
        equal = wn == count and np.array_equal(np.asarray(ids)[:count],
                                               want[:wn])
        lq, le = lq_all[i], request_log_probs(eng, enc8, r)
        err = (lq - le).abs()
        close = bool((err <= QAT_LOGPROB_TOL).all())
        aq, ae = lq.argmax(-1), le.argmax(-1)
        frames = (aq != ae).nonzero().flatten()
        gap = (lq.gather(-1, aq[:, None]) - lq.gather(-1, ae[:, None]))[:, 0]
        ties = bool((gap[frames] < QAT_TIE_GAP).all())
        # other ids need a frame whose argmax differs, and that a near-tie
        ok = close and (equal or (len(frames) > 0 and ties))
        same += ok
        log(f"  qat eval vs int8 engine {label:14s}: count {count} / {wn}, "
            f"{'same ids' if equal else 'other ids'}; log-probs within "
            f"{QAT_LOGPROB_TOL} {close} (max |diff| {float(err.max()):.3e}); "
            f"argmax differs at frames {frames.tolist()} (top-2 gaps "
            f"{[float(f'{v:.3e}') for v in gap[frames].tolist()]}, all below "
            f"{QAT_TIE_GAP} {ties}) {'PASS' if ok else 'FAIL'}")
    ok = same == len(reqs) and all(v > 0 for v in stack_launches.values())
    log(f"qat: the QAT eval step agrees with InferenceEngine(fused='int8') "
        f"on {same}/{len(reqs)} requests (ids equal up to argmax ties); "
        f"int8 stack launches {stack_launches} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the QAT eval step disagrees with the int8 "
                             "engine")
    del state, state0, estate, eng, f32
    torch.cuda.empty_cache()
    return launches


def remat_phase(smi):
    """The same model with ``remat=True`` against ``remat=False`` from one
    state: one step bit for bit (loss, gradient norm, parameters, batch
    statistics), then ms a step and the peak of allocated memory of each."""
    import torch

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = baseline_config(4).model
    torch.manual_seed(4)
    tx = make_optimizer(TrainConfig())[0]
    batch = train_batch()
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=0.2, blank_id=cfg.blank_id)
    states, out = {}, {}
    base = build_model(cfg, device=DEVICE)
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device=DEVICE)
        model.load_state_dict(base.state_dict())
        states[remat] = TrainState.create(model, tx, device=DEVICE)
    for remat, s in states.items():
        zero_k4_designs()
        zero_k3_designs()
        s, m = step(s.clone(), batch, seed=0)
        torch.cuda.synchronize()
        log_k4_designs(f"remat={remat}", 1)
        log_k3_designs(f"remat={remat}", 1)
        out[remat] = (s, m)
    (a, ma), (b, mb) = out[False], out[True]
    same = (torch.equal(ma["loss"], mb["loss"])
            and torch.equal(ma["grad_norm"], mb["grad_norm"])
            and torch.equal(a.params, b.params)
            and all(torch.equal(x, y) for x, y in
                    zip(a.batch_stats.values(), b.batch_stats.values())))
    log(f"remat: one step with remat=True against remat=False: loss "
        f"{float(mb['loss']):.6f} / {float(ma['loss']):.6f}, grad norm "
        f"{float(mb['grad_norm']):.6f} / {float(ma['grad_norm']):.6f}, "
        f"parameters and batch statistics bit for bit {same} "
        f"{'PASS' if same else 'FAIL'}")
    if not same:
        raise AssertionError("remat=True changed the step")
    del out, a, b
    for remat, s in states.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, ms = median_step_ms(step, s, batch, runs=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"remat={remat}: {ms:.2f} ms a step (median of 3, host clock), "
            f"peak allocated {peak:.2f} GiB on {smi}")
    del states
    torch.cuda.empty_cache()


DP_TOL = {"loss": 1e-5, "param": 1e-5}


def dp_state_and_step(mesh=None):
    """``baseline_config(4)`` at float32 (the tolerances of the sharded
    step against the whole batch's are those of two f32 sums in another
    order), dropout 0.4, the recipe's optimizer; its fused step."""
    import torch

    from ishara_tpu_torch.config import TrainConfig, baseline_config
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.preprocess.pipeline import GroupStats
    from ishara_tpu_torch.train import (
        TrainState,
        make_fused_ctc_train_step,
        make_optimizer,
    )

    cfg = dataclasses.replace(baseline_config(4).model, dtype="float32")
    torch.manual_seed(4)
    state = TrainState.create(build_model(cfg, device=DEVICE),
                              make_optimizer(TrainConfig())[0],
                              device=DEVICE)
    step = make_fused_ctc_train_step(GroupStats.identity(), cfg.frame_len,
                                     aug_prob=0.2, blank_id=cfg.blank_id,
                                     mesh=mesh)
    return state, step


def dp_rank_main(rank: int, port: int, out: str) -> int:
    """One of two gloo ranks on the one card (NCCL takes one rank a
    device): rows [128 rank, 128 rank + 128) of the flagship batch, one
    step on the offset kernels; saves the step's results to ``out``."""
    import torch
    import torch.distributed as dist

    from ishara_tpu_torch.parallel import make_mesh

    # as main() sets them: the reference step is taken at full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = make_mesh()
        state, step = dp_state_and_step(mesh)
        batch = {k: v[HALF * rank:HALF * (rank + 1)]
                 for k, v in train_batch().items()}
        counters = train_counters()
        for w in counters.values():
            w.launches = w.launches_bwd = 0
        state, m = step(state, batch, seed=0)
        torch.cuda.synchronize()
        result = {"loss": m["loss"].cpu(), "grad_norm": m["grad_norm"].cpu(),
                  "params": state.params.cpu(),
                  "stats": [b.cpu() for b in state.batch_stats.values()],
                  "launches": {n: (w.launches, w.launches_bwd)
                               for n, w in counters.items()}}
        # ms a step: both ranks step together (the gradient's all-reduce
        # joins them), sharing the card
        _, result["ms"] = median_step_ms(step, state, batch, runs=3)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()
    return 0


def dp_compare(label, got, ref_m, ref_state):
    """The sharded step's loss and parameters against the unsharded
    step's, at DP_TOL."""
    d_loss = abs(float(got["loss"]) - float(ref_m["loss"])) \
        / abs(float(ref_m["loss"]))
    d_par = float((got["params"].to(DEVICE) - ref_state.params).abs().max())
    d_bn = max(float((a.to(DEVICE) - b).abs().max()) for a, b in
               zip(got["stats"], ref_state.batch_stats.values()))
    ok = d_loss <= DP_TOL["loss"] and d_par <= DP_TOL["param"]
    log(f"{label}: against the single-process batch-{TB} step: loss "
        f"{float(got['loss']):.6f} vs {float(ref_m['loss']):.6f} (rel "
        f"{d_loss:.2e}, tol {DP_TOL['loss']}), grad norm "
        f"{float(got['grad_norm']):.6f} vs {float(ref_m['grad_norm']):.6f}, "
        f"parameters max |diff| {d_par:.2e} (tol {DP_TOL['param']}), batch "
        f"statistics {d_bn:.2e} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the sharded step is not the "
                             f"unsharded step")


def dp_phase(smi, scratch: Path):
    """Data parallelism on the one card: a 1-rank NCCL group (the mesh step
    against the plain step, launch counts), then two spawned gloo ranks of
    128 rows each with the offset kernels, held against the single-process
    batch-256 step, the two replicas bit for bit. Returns the 1-rank
    launches."""
    import socket

    import torch
    import torch.distributed as dist

    from ishara_tpu_torch.parallel import initialize_distributed, make_mesh

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    batch = train_batch()
    ref0, step = dp_state_and_step()
    ref, ref_m = step(ref0.clone(), batch, seed=0)
    torch.cuda.synchronize()

    port = free_port()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)     # NCCL
    try:
        mesh = make_mesh()
        state, mstep = dp_state_and_step(mesh)
        s1, m1 = mstep(state.clone(), batch, seed=0)
        torch.cuda.synchronize()
        dp_compare("data parallel, 1-rank NCCL mesh", {
            "loss": m1["loss"], "grad_norm": m1["grad_norm"],
            "params": s1.params, "stats": list(s1.batch_stats.values())},
            ref_m, ref)
        _, mesh_ms = median_step_ms(mstep, state.clone(), batch, runs=3)
        _, plain_ms = median_step_ms(step, ref0.clone(), batch, runs=3)
        log(f"data parallel, 1-rank NCCL mesh: {mesh_ms:.2f} ms a step "
            f"against {plain_ms:.2f} ms for the step without a mesh (f32, "
            f"median of 3 each, host clock) on {smi}")
        _, losses, launches = run_counted(mstep, state.clone(), batch, 3)
        log_k4_designs("data parallel, 1-rank NCCL mesh", 3)
        log_k7_designs("data parallel, 1-rank NCCL mesh", 3,
                       {"forward": {}, "backward": {}})
        for (name, direction), n in launches.items():
            if n != 3 * DP_STEP_LAUNCHES.get(name, 0):
                raise AssertionError(f"dp: {name}.{direction} = {n}")
        log(f"data parallel, 1-rank NCCL mesh: 3 steps, loss "
            + " ".join(f"{v:.3f}" for v in losses)
            + f"; launches {launches} PASS")
    finally:
        dist.destroy_process_group()

    scratch.mkdir(parents=True, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(r),
         str(port), str(scratch / f"rank{r}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"a data-parallel rank failed:\n{text}")
    wall = time.perf_counter() - t0
    got = [torch.load(scratch / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    same = (torch.equal(got[0]["params"], got[1]["params"])
            and torch.equal(got[0]["loss"], got[1]["loss"])
            and all(torch.equal(a, b) for a, b in
                    zip(got[0]["stats"], got[1]["stats"])))
    log(f"data parallel, 2 gloo ranks on one card ({HALF} rows each, "
        f"{wall:.1f} s for both processes from start to exit): replicas "
        f"bit for bit {same}; rank launches {got[0]['launches']}; "
        f"{got[0]['ms']:.2f} / {got[1]['ms']:.2f} ms a step on rank 0 / 1 "
        f"(f32, median of 3, host clock) on {smi}")
    if not same:
        raise AssertionError("the two replicas differ")
    for r in range(2):
        for name, per in DP_STEP_LAUNCHES.items():
            if tuple(got[r]["launches"][name]) != (per, per):
                raise AssertionError(f"rank {r}: {name} launched "
                                     f"{got[r]['launches'][name]}")
    dp_compare("data parallel, 2 gloo ranks", got[0], ref_m, ref)
    del ref, ref0, s1, state
    torch.cuda.empty_cache()
    return launches


def sharded_trainer_phase(smi, workdir: Path):
    """``write_shards`` of 512 hard-corpus sequences (the training set) and
    256 (validation), read back by ``ShardedASLFR`` and fed to a ``Trainer``
    (preset 4, batch 256, length buckets from ``sequence_lengths``) for one
    epoch with its validation."""
    import shutil

    from ishara_tpu_torch.data.cache import ShardedASLFR, write_shards
    from ishara_tpu_torch.data.sampler import dataset_lengths
    from ishara_tpu_torch.data.synthetic import HardSyntheticASLFR
    from ishara_tpu_torch.data.tokenizer import CTCTokenizer
    from ishara_tpu_torch.train import Trainer

    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    src = HardSyntheticASLFR(num_sequences=2 * TB, seed=0, **HARD)
    train = ShardedASLFR(write_shards(src, workdir / "train",
                                      shard_size=TB, num_workers=4))
    val = ShardedASLFR(write_shards(
        HardSyntheticASLFR(num_sequences=TB, seed=1, **HARD),
        workdir / "val", shard_size=TB))
    write_s = time.perf_counter() - t0
    x, p = train.render(TB + 3)
    want = src.render(TB + 3)
    if p != want[1] or not np.array_equal(np.nan_to_num(x, nan=-7),
                                          np.nan_to_num(want[0], nan=-7)):
        raise AssertionError("ShardedASLFR does not render the corpus")
    cfg = trainer_config()
    cfg.train.num_epochs = 1
    lengths = dataset_lengths(train)
    if list(lengths) != [src.render(i)[0].shape[0] for i in range(len(src))]:
        raise AssertionError("sequence_lengths differs from the corpus")
    t = Trainer(cfg, train, val, CTCTokenizer(), workdir=workdir / "run")
    t0 = time.perf_counter()
    hist = t.train()
    wall = time.perf_counter() - t0
    rec = hist[-1]
    ok = (math.isfinite(rec["train_loss"]) and "val_score" in rec
          and int(t.state.step) >= 1)
    log(f"ShardedASLFR: {len(train)} + {len(val)} sequences written in "
        f"{write_s:.1f} s, {len(lengths)} lengths read from the shards "
        f"(dataset_lengths) equal the corpus's; Trainer 1 epoch "
        f"({int(t.state.step)} steps) in {wall:.1f} s: train "
        f"loss {rec['train_loss']:.3f}, val_score {rec['val_score']:.4f} "
        f"{'PASS' if ok else 'FAIL'} on {smi}")
    if not ok:
        raise AssertionError("the Trainer on ShardedASLFR failed")


# ---------------------------------------------------------------------------
# Tensor parallelism, the native Levenshtein library and the CLI
# ---------------------------------------------------------------------------

TP_PARTS = 2       # the model axis of the tensor-parallel phase
# The tensor-parallel step's launches a step (forward = backward): the
# attention kernel on the rank's 4 of 8 heads of the 8 blocks, the FFN
# kernel's partial sums on the rank's 256 of 512 hidden columns of the 16
# FFNs, none of the conv-module kernel (the step is f32, where the table
# sends the conv module to its composition), the dropout-add of the 4
# Squeezeformer attention branches and of the 8 Squeezeformer FFNs' reduced
# outputs (12: the FFN kernel's own residual
# and output dropout are taken after the reduction), the top dropout, one
# CTC loss.
TP_STEP_LAUNCHES = {"flash_mhsa": 8, "ffn_residual": 16,
                    "conv_module_residual": 0, "fast_dropout_add": 12,
                    "fast_dropout": 1, "ctc_loss_kernel": 1,
                    "flash_mhsa_blocked": 0}


def tp_rank_main(rank: int, port: int, out: str) -> int:
    """One of two gloo ranks on the one card, on a ``(data 1, model 2)``
    mesh: the flagship batch's 256 rows on each, the state sharded by
    ``shard_state_tp``; one counted step, then ms a step; saves the step's
    results (the parameters whole) to ``out``."""
    import torch
    import torch.distributed as dist

    from ishara_tpu_torch.parallel import (
        gather_params_tp,
        make_2d_mesh,
        shard_state_tp,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TP_PARTS, rank=rank)
    try:
        mesh = make_2d_mesh(1, TP_PARTS)
        state, step = dp_state_and_step(mesh)
        shard_state_tp(state, mesh)
        batch = train_batch()
        counters = train_counters()
        for w in counters.values():
            w.launches = w.launches_bwd = 0
        s1, m = step(state.clone(), batch, seed=0)
        torch.cuda.synchronize()
        launches = {n: (w.launches, w.launches_bwd)
                    for n, w in counters.items()}
        full = gather_params_tp(s1)
        local = sum(getattr(mod, "tp_parts", 1) > 1
                    for mod in s1.model.modules())
        result = {"loss": m["loss"].cpu(), "grad_norm": m["grad_norm"].cpu(),
                  "params": torch.cat([v.reshape(-1) for v in
                                       full.values()]).cpu(),
                  "replicated": s1.params[~s1.tp.sharded].cpu(),
                  "stats": [b.cpu() for b in s1.batch_stats.values()],
                  "launches": launches, "sharded": len(s1.tp.dims),
                  "gathered": len(s1.model.tp_gather), "local": local,
                  "local_numel": s1.params.numel()}
        group = s1.tp.group
        del s1
        # ms a step: both ranks step together (each product pair's
        # all-reduce joins them), sharing the card
        _, result["ms"] = median_step_ms(step, state, batch, runs=2)
        # one all-reduce of a block's activations [256, 176, 256] f32 over
        # the model group: a step takes two a sliced module (the forward's
        # reduction, the backward's at the copy)
        buf = torch.randn(TB, TT, TD, device=DEVICE)
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(buf, group=group)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        result["allreduce_ms"] = statistics.median(times)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()
    return 0


def tp_dropout_checks(smi, runs=20):
    """K2 on a tensor-parallel rank's strided slices (f32, rate 0.4): the
    attention probabilities of 4 of 8 heads ``[256, 4, 176, 176]`` and the
    FFN hidden's half ``[256, 176, 256]`` of 512 (``runs``), the
    compositions' masks on a slice. Forward and backward against the plain
    version with the same runs, and against the slice of the whole
    tensor's launch, bit for bit; the kernel timed beside the contiguous
    launch of the same size. The tensor-parallel step itself takes the
    attention and FFN kernels (``tp_kernel_rows``), so these forms have no
    row of the kernels line."""
    import torch

    from ishara_tpu_torch.ops import dropout as dr

    g = torch.Generator(device=DEVICE).manual_seed(16)
    seed = torch.tensor([31337], dtype=torch.int32, device=DEVICE)
    rate = 0.4
    shapes = {"attention": ((TB, TH, TT, TT), 1), "ffn hidden": (
        (TB, TT, 2 * TD), 2)}
    for what, (shape, dim) in shapes.items():
        x = torch.randn(shape, generator=g, device=DEVICE)
        dy = torch.randn(shape, generator=g, device=DEVICE)
        full = dr.fast_dropout(x, seed, rate)
        full_dx = dr.dropout_plain(dy, seed, rate)
        w = shape[dim] // TP_PARTS
        inner = 1
        for d in shape[dim + 1:]:
            inner *= d
        for part in range(TP_PARTS):
            sl = [slice(None)] * len(shape)
            sl[dim] = slice(part * w, (part + 1) * w)
            sl = tuple(sl)
            xs, dys = x[sl].contiguous(), dy[sl].contiguous()
            off, runs_ = part * w * inner, (w * inner, shape[dim] * inner)
            xr = xs.clone().requires_grad_()
            out = dr.fast_dropout(xr, seed, rate, off, runs_)
            dx = torch.autograd.grad(out, xr, dys)[0]
            plain = dr.dropout_plain(xs, seed, rate, None, off, runs_)
            plain_dx = dr.dropout_plain(dys, seed, rate, None, off, runs_)
            if not (torch.equal(out, plain) and torch.equal(dx, plain_dx)
                    and torch.equal(out, full[sl])
                    and torch.equal(dx, full_dx[sl])):
                raise AssertionError(f"strided fast_dropout {what} part "
                                     f"{part} is not the plain version or "
                                     f"the whole launch's slice")
        f_ms = time_ms(lambda: dr.fast_dropout(xs, seed, rate, off, runs_),
                       runs=runs)
        c_ms = time_ms(lambda: dr.fast_dropout(xs, seed, rate), runs=runs)
        log(f"kernel fast_dropout on a tensor-parallel slice ({what}, f32, "
            f"{list(xs.shape)} of {list(shape)}, runs {runs_}), both parts, "
            f"forward and dx: equal to the plain version and to the whole "
            f"launch's slice bit for bit PASS; forward {f_ms:.4f} ms "
            f"(contiguous launch of the same size {c_ms:.4f} ms) on {smi}")
        del x, dy, full, full_dx
    torch.cuda.empty_cache()


def tp_kernel_rows(smi, runs=10):
    """K3 and K4 at a tensor-parallel rank's shapes in the TP step (f32,
    dropout 0.4, two ranks): the attention kernel on 4 of 8 heads (q, k, v
    ``[256, 4, 176, 32]``, ``runs``) and the FFN kernel's partial sum on
    256 of 512 hidden columns (x ``[45056, 256]``, ``hidden``, no residual,
    no ``b2``, no output dropout). Each part's forward and gradients
    against the plain version with the same masks, and against the whole
    launch (the heads of the 8-head launch; the parts' partial sums plus
    the bias against the whole FFN launch); timed beside the plain version
    and the library call at the rank's shapes. Returns the four rows."""
    import torch
    import torch.nn.functional as F

    from ishara_tpu_torch.ops import attention as at
    from ishara_tpu_torch.ops import ffn_kernel as fk

    g = torch.Generator(device=DEVICE).manual_seed(17)
    tol, rate, rows = TRAIN_TOL["f32"], 0.4, []
    Dh, hl = TD // TH, TH // TP_PARTS
    scale = TD ** -0.5
    seed = torch.tensor([4321], dtype=torch.int32, device=DEVICE)
    lengths = torch.randint(TT // 4, TT + 1, (TB,), generator=g,
                            device=DEVICE)
    bias = at.mask_to_bias(torch.arange(TT, device=DEVICE)[None, :]
                           < lengths[:, None])
    qkv = torch.randn((TB, TT, TH, 3 * Dh), generator=g,
                      device=DEVICE).requires_grad_()
    d_o = torch.randn((TB, TH, TT, Dh), generator=g, device=DEVICE)
    q, k, v = qkv.transpose(1, 2).split(Dh, dim=-1)
    o = at.flash_mhsa(q, k, v, bias, seed, scale, rate)
    whole = (o.detach(),) + torch.autograd.grad(o, (q, k, v), d_o)
    del o
    errs = [0.0, 0.0]
    for part in range(TP_PARTS):
        h = slice(part * hl, (part + 1) * hl)
        qs, ks, vs = (t.detach()[:, h].contiguous().requires_grad_()
                      for t in (q, k, v))
        dos = d_o[:, h].contiguous()
        off = part * hl * TT * TT
        runs_ = (hl * TT * TT, TH * TT * TT)
        os_ = at.flash_mhsa(qs, ks, vs, bias, seed, scale, rate, off, runs_)
        grads = torch.autograd.grad(os_, (qs, ks, vs), dos,
                                    retain_graph=True)
        torch.cuda.synchronize()
        with torch.no_grad():
            ro, lse = at.mhsa_forward_plain(qs, ks, vs, bias, seed, scale,
                                            rate, offset=off, runs=runs_)
            rg = at.mhsa_backward_plain(qs, ks, vs, bias, seed, ro, lse, dos,
                                        scale, rate, offset=off, runs=runs_)
        errs[0] = max(errs[0], close(f"tp attention part {part} o", os_, ro,
                                     tol))
        errs[1] = max(errs[1], max(close(f"tp attention part {part} d{n}",
                                         a, b, tol)
                                   for n, a, b in zip("qkv", grads, rg)))
        for n, a, b in zip(("o", "dq", "dk", "dv"), (os_,) + grads, whole):
            close(f"tp attention part {part} {n} against the 8-head launch",
                  a, b[:, h], tol)
        del ro, lse, rg
    with torch.no_grad():
        p_f = time_ms(lambda: at.mhsa_forward_plain(
            qs, ks, vs, bias, seed, scale, rate, offset=off, runs=runs_),
            runs=3, warmup=1, head_start=False)
        ro, lse = at.mhsa_forward_plain(qs, ks, vs, bias, seed, scale, rate,
                                        offset=off, runs=runs_)
        p_b = time_ms(lambda: at.mhsa_backward_plain(
            qs, ks, vs, bias, seed, ro, lse, dos, scale, rate, offset=off,
            runs=runs_), runs=3, warmup=1, head_start=False)
        del ro, lse
    f_ms = time_ms(lambda: at.flash_mhsa(qs, ks, vs, bias, seed, scale, rate,
                                         off, runs_), runs=runs)
    b_ms = time_ms(lambda: torch.autograd.grad(os_, (qs, ks, vs), dos,
                                               retain_graph=True), runs=runs)
    lq = [t.detach().clone().requires_grad_() for t in (qs, ks, vs)]
    mask = bias[:, None, None, :]

    def lib_fwd():
        return F.scaled_dot_product_attention(*lq, attn_mask=mask,
                                              dropout_p=rate, scale=scale)

    lo = lib_fwd()
    lf_ms = time_ms(lib_fwd, runs=runs)
    lb_ms = time_ms(lambda: torch.autograd.grad(lo, lq, dos,
                                                retain_graph=True),
                    runs=runs)
    size = TB * hl * TT * Dh * 4
    small = bias.numel() * 4 + TB * hl * TT * 4
    ops_f = 4 * TB * hl * TT * TT * Dh
    tag = f"[f32 {TB}x{hl}x{TT}x{Dh} tp heads]"
    ref = "ishara_tpu/ops/attention.py"
    log(f"kernel flash_mhsa on a tensor-parallel rank's heads (f32, q, k, v "
        f"[{TB}, {hl}, {TT}, {Dh}] of {TH} heads, runs {runs_}), both parts: "
        f"equal to the plain version (o {errs[0]:.3e}, d(q|k|v) "
        f"{errs[1]:.3e}) and to the 8-head launch's heads PASS")
    rows.append(train_row("flash_mhsa" + tag, at.flash_mhsa, "launches",
                          "attention.cu", f"{ref}:131", errs[0], f_ms, p_f,
                          4 * size + small, ops_f, "f32", lf_ms, smi))
    rows.append(train_row("flash_mhsa[bwd]" + tag, at.flash_mhsa,
                          "launches_bwd", "attention.cu", f"{ref}:168",
                          errs[1], b_ms, p_b, 8 * size + small,
                          5 * ops_f // 2, "f32", lb_ms, smi))
    del q, k, v, qkv, d_o, whole, qs, ks, vs, dos, os_, grads, lq, lo
    torch.cuda.empty_cache()

    N, ml = TB * TT, TM // TP_PARTS
    seeds = torch.tensor([2718, 2819], dtype=torch.int32, device=DEVICE)

    def rand(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * s

    x = rand(N, TD).requires_grad_()
    dy = rand(N, TD)
    w1, b1 = rand(TD, TM, s=TD ** -0.5), rand(TM, s=0.1)
    w2, b2 = rand(TM, TD, s=TM ** -0.5), rand(TD, s=0.1)
    full = fk.ffn_residual(x, torch.zeros_like(x), w1, b1, w2, b2, seeds,
                           rate, 0.0)
    full_dx = torch.autograd.grad(full, x, dy)[0]
    total, dx_sum, errs = b2, 0.0, [0.0, 0.0]
    for part in range(TP_PARTS):
        c = slice(part * ml, (part + 1) * ml)
        p = [w1[:, c].contiguous().requires_grad_(),
             b1[c].contiguous().requires_grad_(),
             w2[c].contiguous().requires_grad_()]
        hidden = (TM, part * ml)
        out = fk.ffn_residual(x, None, *p, None, seeds, rate, 0.0, 0, hidden)
        grads = torch.autograd.grad(out, [x] + p, dy, retain_graph=True)
        torch.cuda.synchronize()
        with torch.no_grad():
            pd = [t.detach() for t in p]
            ref_out = fk.ffn_forward_plain(x.detach(), None, pd[0], pd[1],
                                           pd[2], None, seeds, rate, 0.0,
                                           hidden=hidden)
            rg = fk.ffn_backward_plain(x.detach(), dy, pd[0], pd[1], pd[2],
                                       seeds, rate, 0.0, hidden=hidden)[:4]
        errs[0] = max(errs[0], close(f"tp ffn part {part} out", out,
                                     ref_out, tol))
        errs[1] = max(errs[1], max(close(f"tp ffn part {part} {n}", a, b,
                                         tol) for n, a, b in
                                   zip(("dx", "dw1", "db1", "dw2"), grads,
                                       rg)))
        total = total + out.detach()
        dx_sum = dx_sum + grads[0]
        del ref_out, rg
    close("tp ffn partial sums plus the bias against the whole launch",
          total, full.detach(), tol)
    close("tp ffn dx summed against the whole launch's", dx_sum, full_dx,
          tol)
    del full, full_dx, total, dx_sum
    f_ms = time_ms(lambda: fk.ffn_residual(x, None, *p, None, seeds, rate,
                                           0.0, 0, hidden), runs=runs)
    b_ms = time_ms(lambda: torch.autograd.grad(out, [x] + p, dy,
                                               retain_graph=True), runs=runs)
    with torch.no_grad():
        xd, pd = x.detach(), [t.detach() for t in p]
        p_f = time_ms(lambda: fk.ffn_forward_plain(
            xd, None, pd[0], pd[1], pd[2], None, seeds, rate, 0.0,
            hidden=hidden), runs=3, warmup=1, head_start=False)
        p_b = time_ms(lambda: fk.ffn_backward_plain(
            xd, dy, pd[0], pd[1], pd[2], seeds, rate, 0.0, hidden=hidden),
            runs=3, warmup=1, head_start=False)
    lx = x.detach().clone().requires_grad_()
    lw = [t.detach().clone().requires_grad_() for t in p]

    def lib_fwd():
        h = F.dropout(F.silu(F.linear(lx, lw[0].t(), lw[1])), rate, True)
        return F.linear(h, lw[2].t())

    lo = lib_fwd()
    lf_ms = time_ms(lib_fwd, runs=runs)
    lb_ms = time_ms(lambda: torch.autograd.grad(lo, [lx] + lw, dy,
                                                retain_graph=True),
                    runs=runs)
    log(f"kernel ffn_residual's partial sum on a tensor-parallel rank's "
        f"hidden (f32, x [{N}, {TD}], hidden {ml} of {TM}), both parts: "
        f"equal to the plain version (out {errs[0]:.3e}, gradients "
        f"{errs[1]:.3e}); the parts' sums plus the bias and their dx equal "
        f"the whole launch's PASS")
    size = N * TD * 4
    weights = 2 * TD * ml * 4 + ml * 4
    tag = f"[f32 {N}x{TD} hidden {ml} of {TM} tp partial]"
    ref = "ishara_tpu/ops/ffn_kernel.py"
    rows.append(train_row("ffn_residual" + tag, fk.ffn_residual, "launches",
                          "ffn.cu", f"{ref}:153", errs[0], f_ms, p_f,
                          2 * size + weights, 4 * N * TD * ml, "f32", lf_ms,
                          smi))
    rows.append(train_row("ffn_residual[bwd]" + tag, fk.ffn_residual,
                          "launches_bwd", "ffn.cu", f"{ref}:177", errs[1],
                          b_ms, p_b, 3 * size + 3 * weights,
                          10 * N * TD * ml, "f32", lb_ms, smi))
    del x, dy, out, grads, lx, lw, lo
    torch.cuda.empty_cache()
    return rows


def tp_phase(smi, scratch: Path):
    """Tensor parallelism on the one card: two gloo ranks on a ``(data 1,
    model 2)`` mesh (``chip_smoke.py --tp-rank``), preset 4 at f32, batch
    256, dropout 0.4; one step held to the single-process step (DP_TOL),
    the replicated elements bit for bit on both ranks, the launches of
    every kernel the step takes, ms a step beside the unsharded step's.
    Returns (K3's and K4's rows at the ranks' shapes, rank 0's
    launches)."""
    import socket

    import torch

    tp_dropout_checks(smi)
    rows = tp_kernel_rows(smi)
    batch = train_batch()
    ref0, step = dp_state_and_step()
    ref, ref_m = step(ref0.clone(), batch, seed=0)
    _, plain_ms = median_step_ms(step, ref0.clone(), batch, runs=3)
    del ref0
    torch.cuda.empty_cache()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    scratch.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--tp-rank", str(r),
         str(port), str(scratch / f"rank{r}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(TP_PARTS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"a tensor-parallel rank failed:\n{text}")
    wall = time.perf_counter() - t0
    got = [torch.load(scratch / f"rank{r}.pt", weights_only=False)
           for r in range(TP_PARTS)]
    same = all(torch.equal(g["replicated"], got[0]["replicated"])
               and torch.equal(g["params"], got[0]["params"])
               and torch.equal(g["loss"], got[0]["loss"])
               and all(torch.equal(a, b) for a, b in
                       zip(g["stats"], got[0]["stats"])) for g in got)
    g0 = got[0]
    log(f"tensor parallel, (data 1, model {TP_PARTS}) mesh of gloo ranks on "
        f"one card (preset 4, f32, batch {TB}, dropout 0.4; {wall:.1f} s for "
        f"both processes from start to exit): {g0['sharded']} leaves "
        f"sharded, {g0['local']} attention / FFN modules on their slices, "
        f"{g0['gathered']} gathered, {g0['local_numel']} of "
        f"{ref.params.numel()} parameters a rank; replicated elements and "
        f"the whole state bit for bit on both ranks {same}; launches a step "
        f"{g0['launches']}; {g0['ms']:.2f} / {got[1]['ms']:.2f} ms a step "
        f"on rank 0 / 1 (both ranks at once on the card, median of 2) "
        f"against {plain_ms:.2f} ms for the unsharded step (f32, median of "
        f"3, host clock); {2 * g0['local']} all-reduces of "
        f"{TB * TT * TD * 4 / 1e6:.1f} MB a step at {g0['allreduce_ms']:.2f} "
        f"ms each (gloo, through the host; median of 5) = "
        f"{2 * g0['local'] * g0['allreduce_ms']:.1f} ms on {smi}")
    if not same:
        raise AssertionError("the tensor-parallel ranks differ")
    for r, g in enumerate(got):
        for name, per in TP_STEP_LAUNCHES.items():
            if tuple(g["launches"][name]) != (per, per):
                raise AssertionError(f"tp rank {r}: {name} launched "
                                     f"{g['launches'][name]}, not "
                                     f"{(per, per)}")
    dp_compare("tensor parallel, 2 gloo ranks", g0, ref_m, ref)
    del ref
    torch.cuda.empty_cache()
    launches = {(n, d): v for n, (f, b) in g0["launches"].items()
                for d, v in (("launches", f), ("launches_bwd", b))}
    return rows, launches


def native_phase(smi, n=1000):
    """The native batched Levenshtein on the card's host: it builds
    (``available()``); on ``n`` harness-scale pairs (the synthetic
    corpus's phrases against edited copies) its distances equal the Python
    DP's; both timed."""
    from ishara_tpu_torch import native
    from ishara_tpu_torch.data.synthetic import SyntheticASLFR
    from ishara_tpu_torch.evaluation.metrics import levenshtein

    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the native Levenshtein library did not build")
    rng = np.random.default_rng(0)
    targets = list(SyntheticASLFR(num_sequences=n, seed=1).phrases)
    chars = sorted(set("".join(targets)))
    preds = []
    for t in targets:
        p = list(t)
        for _ in range(int(rng.integers(0, 6))):
            i = int(rng.integers(0, len(p) + 1))
            op = rng.integers(0, 3)
            if op == 0 and i < len(p):
                del p[i]
            elif op == 1 and i < len(p):
                p[i] = chars[int(rng.integers(len(chars)))]
            else:
                p.insert(i, chars[int(rng.integers(len(chars)))])
        preds.append("".join(p))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = native.batch_levenshtein(preds, targets)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    want = [levenshtein(p, t) for p, t in zip(preds, targets)]
    dp_ms = (time.perf_counter() - t0) * 1e3
    if list(got) != want:
        raise AssertionError("the native distances differ from the DP's")
    log(f"native Levenshtein: built and loaded in {build_s:.2f} s; {n} "
        f"pairs (phrases of {min(map(len, targets))}-"
        f"{max(map(len, targets))} characters, up to 5 edits) equal to the "
        f"Python DP PASS; native {statistics.median(times):.3f} ms (median "
        f"of 5) against {dp_ms:.3f} ms for the DP (host clock, the card's "
        f"host) on {smi}")


def cli_phase(smi, workdir: Path):
    """``python -m ishara_tpu_torch`` on the card, in subprocesses with no
    ``--device``: ``train`` (hybrid 1 + 1 at dim 64, 1 epoch of 2 steps on
    the synthetic corpus), ``export``, ``infer`` and ``eval`` (8
    sequences), each with rc 0 and on ``cuda``."""
    from ishara_tpu_torch.config import EncoderConfig, IsharaConfig, TrainConfig

    here = Path(__file__).resolve().parent
    workdir.mkdir(parents=True, exist_ok=True)
    config = workdir / "small.json"
    IsharaConfig(model=EncoderConfig(
        dim=64, variant="hybrid", num_squeeze_blocks=1, num_conform_blocks=1,
        num_heads=4, frame_len=64, transformer_kernel_size=7),
        train=TrainConfig(warmup_epochs=0, validate_every_epochs=1)
    ).to_json(config)
    np.save(workdir / "x.npy", np.random.default_rng(0).random(
        (80, 276)).astype(np.float32))
    run, bundle = workdir / "run", workdir / "bundle"
    commands = {
        "train": ["train", "--config", str(config), "--workdir", str(run),
                  "--epochs", "1", "--max-sequences", "16",
                  "--batch-size", "8"],
        "export": ["export", "--workdir", str(run), "--output", str(bundle)],
        "infer": ["infer", "--bundle", str(bundle), "--input",
                  str(workdir / "x.npy")],
        "eval": ["eval", "--bundle", str(bundle), "--max-sequences", "8",
                 "--num-sequences", "8"]}
    said = []
    # train, then export; infer and eval read the bundle side by side
    for names in (["train"], ["export"], ["infer", "eval"]):
        t0 = time.perf_counter()
        procs = {n: subprocess.Popen(
            [sys.executable, "-m", "ishara_tpu_torch", *commands[n]],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for n in names}
        try:
            outs = {n: p.communicate(timeout=300) for n, p in procs.items()}
        finally:
            for p in procs.values():
                p.kill()
        wall = time.perf_counter() - t0
        for name, (out, err) in outs.items():
            if procs[name].returncode != 0 \
                    or f"ishara_tpu_torch {name}: device cuda" not in err:
                raise AssertionError(f"cli {name}: rc "
                                     f"{procs[name].returncode}\n"
                                     f"{out[-2000:]}\n{err[-3000:]}")
            last = out.strip().splitlines()[-1] if out.strip() else ""
            said.append(f"{name} rc 0 on cuda ({'+'.join(names)} "
                        f"{wall:.1f} s): {last[:160]}")
    if "train_loss" not in said[0]:
        raise AssertionError("cli train printed no train_loss")
    log("cli (python -m ishara_tpu_torch, no --device): "
        + "; ".join(said) + f" PASS on {smi}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    import ishara_tpu_torch
    if Path(ishara_tpu_torch.__file__).resolve().parents[1] != here:
        print("chip_smoke: ishara_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    from ishara_tpu_torch.config import EncoderConfig, baseline_config
    from ishara_tpu_torch.models.encoder import build_model
    from ishara_tpu_torch.ops import _build
    from ishara_tpu_torch.ops import fused_block as fb

    # The plain versions and the unfused path are the references here: keep
    # cuBLAS and cuDNN at full f32 (cuDNN convolutions default to TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for source in _build.sources():
        entry = None
        for line in _build.build_log(source).splitlines():
            m = re.search(
                r"Compiling entry function '\w*?\d+([a-z][a-z_]*_kernel)(\w*)'",
                line)
            if m:
                entry = m.group(1) + " " + m.group(2)[:12]
            elif "spill" in line and not line.strip().startswith("0 bytes"):
                log(f"  ptxas {source}.cu {entry}: {line.strip()}")
            elif "Used" in line and entry:
                log(f"  ptxas {source}.cu {entry}: "
                    f"{line.split(':', 1)[1].strip()}")
                entry = None
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # preset 5 (hybrid 4+4) and preset 3 (conv_hybrid 2+2, kernel sizes
    # 11/5/3, top_mult 2) as the package defines them; the JAX package has
    # no conv_transformer preset, so that family runs at the same widths
    # with two groups and the 4x FFN of its TransformerBlock's default. The
    # unfused model is the serving checks' f32 yardstick, so preset 3 (whose
    # compute dtype is bfloat16) is built at float32 here, as preset 5 is.
    configs = {
        "preset5": baseline_config(5).model,
        "preset3": dataclasses.replace(baseline_config(3).model,
                                       dtype="float32"),
        "conv_transformer": EncoderConfig(
            variant="conv_transformer", dim=256, num_heads=8,
            num_squeeze_blocks=2, num_conform_blocks=0,
            kernel_sizes=(11, 5, 3), num_conv_per_block=3,
            expansion_factor=4, dropout=0.2, top_mult=1),
    }
    models = {}
    for seed, (name, cfg) in enumerate(configs.items()):
        models[name] = build_model(cfg, device=DEVICE)
        randomize(models[name], seed=seed)
    reqs = requests(seed=0)

    # the quantizer gives the same integers and scales for weights on the
    # card and on the CPU (the CPU tests hold it to the reference bit for bit)
    sd = models["preset3"].state_dict()
    on_card = fb.quantize_serving_weights(sd)
    on_cpu = fb.quantize_serving_weights({k: v.cpu() for k, v in sd.items()})
    for k, v in on_cpu.items():
        if isinstance(v, dict) and not (
                torch.equal(v["q"], on_card[k]["q"].cpu())
                and torch.equal(v["scale"], on_card[k]["scale"].cpu())):
            raise AssertionError(f"quantizer differs on the card for {k}")
    log("quantize_serving_weights of weights on the card equals the CPU's "
        "bit for bit PASS")

    rows = kernel_phase(models, reqs)
    launches = engine_phase(models, reqs, smi)
    beam_phase(models, reqs, smi)
    workdir = here / "runs" / "chip_smoke_bundles"   # ignored by git
    try:
        bundle_phase(models, reqs, smi, workdir)
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    del models
    torch.cuda.empty_cache()
    train_rows = train_kernel_phase(smi)
    train_launches = train_phase(smi)
    torch.cuda.empty_cache()
    long_rows = long_kernel_phase(smi)
    long_launches = long_train_phase(smi)
    long_step_against_cpu_phase(smi)
    torch.cuda.empty_cache()
    wide_launches = wide_kernel_train_phase(smi)
    torch.cuda.empty_cache()
    workdir = here / "runs" / "chip_smoke_trainer"   # ignored by git
    try:
        trainer_phase(smi, workdir)
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    tr_rows, tr_launches = translation_phase(smi)
    torch.cuda.empty_cache()
    tr_drop_rows = translation_dropout_rows(smi)
    tr_train_launches = translation_train_phase(smi)
    workdir = here / "runs" / "chip_smoke_translation_trainer"
    try:
        translation_trainer_phase(smi, workdir)
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    causal_drop_rows = dropout_kernel_rows(
        smi, 20, shape=CAUSAL_PROBS, tags=("bf16",), forms=("fast_dropout",),
        suffix=f"[bf16 {'x'.join(map(str, CAUSAL_PROBS))} causal]")
    causal_launches = causal_train_phase(smi)
    causal_step_against_cpu_phase(smi)
    streaming_phase(smi)
    families_phase(smi, requests(seed=0))
    torch.cuda.empty_cache()
    offset_kernel_checks(smi)
    qat_launches = qat_phase(smi)
    remat_phase(smi)
    import shutil
    scratch = here / "runs" / "chip_smoke_dp"        # ignored by git
    try:
        dp_launches = dp_phase(smi, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    workdir = here / "runs" / "chip_smoke_shards"
    try:
        sharded_trainer_phase(smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    scratch = here / "runs" / "chip_smoke_tp"        # ignored by git
    try:
        tp_rows, tp_launches = tp_phase(smi, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    native_phase(smi)
    workdir = here / "runs" / "chip_smoke_cli"
    try:
        cli_phase(smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for counts, names in ((qat_launches, (
            "ctc_loss_kernel", "fast_dropout", "fast_dropout_add",
            "flash_mhsa", "ffn_residual", "conv_module_residual")),
            (dp_launches, ("ctc_loss_kernel", "fast_dropout",
                           "fast_dropout_add", "flash_mhsa",
                           "ffn_residual"))):   # f32: no conv-module kernel
        for name in names:
            if counts[(name, "launches")] <= 0:
                raise AssertionError(f"{name} was not launched by the QAT "
                                     f"or the data-parallel step")

    # every ported kernel form that an engine path runs, with the launches
    # of that path's nine-request run
    line = []
    for (config, kind, tag, dma), row in rows.items():
        fused = {"bf16": True, "int8": "int8"}.get(tag)
        counts = launches.get((config, fused, dma))
        if fused is None or counts is None:
            continue  # f32 storage, or a form that no engine here serves
        wrapper = row["name"].removesuffix(
            f"[{tag}{',dma' if dma else ''}]")
        row["launches"] = counts.get(wrapper, 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} ({config}) was not launched "
                                 f"on its engine path")
        row["config"] = config
        line.append(row)
    # the training kernels, with the launches of the 20-step training run
    for row in train_rows:
        wrapper, direction = row.pop("counter")
        row["launches"] = train_launches[(wrapper.__name__, direction)]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched by the "
                                 f"training run")
        row["config"] = "preset4 training step, batch 256"
        line.append(row)
    # K7 and K8, with the launches of the long step's 10-step run; K7 at 33
    # and 63 taps with those of its wide-kernel training run
    for row in long_rows:
        wrapper, direction = row.pop("counter")
        K = row.pop("run", None)
        counts = long_launches if K is None else wide_launches[K]
        row["launches"] = counts[(wrapper.__name__, direction)]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched by its "
                                 f"training run")
        row["config"] = ("preset4 long-sequence training step (T 512, "
                         "dropout 0), batch 256" if K is None else
                         f"preset4 training step with transformer_kernel_"
                         f"size {K}, batch 256")
        line.append(row)
    # K9, with the launches of its fused engine's nine-request run
    for row in tr_rows:
        wrapper = row.pop("counter").__name__
        row["launches"] = tr_launches.get(wrapper, 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched by its "
                                 f"engine")
        row["config"] = ("translation reference (dim 208, 2 + 2 layers, "
                         "T 176), batch 1")
        line.append(row)
    # K2 at the translation step's attention probabilities, with the
    # launches of its 20-step training run (all 23 sites of a step)
    for row in tr_drop_rows:
        wrapper, direction = row.pop("counter")
        row["launches"] = tr_train_launches[(wrapper.__name__, direction)]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched by the "
                                 f"translation training run")
        row["config"] = ("translation training step (dim 208, 2 + 2 "
                         "layers, T 176, labels of 64), batch 256, f32")
        line.append(row)
    # K2 at the causal attention probabilities, with the launches of the
    # causal step's run (every dropout site of a step)
    for row in causal_drop_rows:
        wrapper, direction = row.pop("counter")
        row["launches"] = causal_launches[(wrapper.__name__, direction)]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched by the "
                                 f"causal training run")
        row["config"] = ("preset4 causal training step (attn_context 176), "
                         "batch 256")
        line.append(row)
    # K3 on a tensor-parallel rank's heads and K4's partial sums on its
    # hidden columns, with the launches of the tensor-parallel step on
    # rank 0 (all of them at these shapes)
    for row in tp_rows:
        wrapper, direction = row.pop("counter")
        row["launches"] = tp_launches[(wrapper.__name__, direction)]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched by the "
                                 f"tensor-parallel step")
        row["config"] = ("preset4 tensor-parallel training step, (data 1, "
                         f"model {TP_PARTS}) mesh, batch 256, f32")
        line.append(row)
    # which kernels take an element offset (a data-parallel rank's rows)
    for row in line:
        wrapper = row["name"].split("[")[0]
        row["offset"] = wrapper in (
            "fast_dropout", "fast_dropout_add", "flash_mhsa", "ffn_residual")
    log(json.dumps({"kernels": line}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    sys.exit(main())
