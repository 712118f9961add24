"""The rank program of ``test_torch_distributed.py``: one process of a gloo
group on the CPU. It imports no JAX, so that each child starts light, and
runs on one torch thread.

``python torch_dist_worker.py RANK WORLD PORT SPEC OUT`` joins the group on
``tcp://127.0.0.1:PORT``; for each run of the spec it builds the mesh the
run names (``"1d"``: a ``data`` mesh over every rank; ``"2x2"``: a ``(dcn,
data)`` mesh of two rows) and runs the run's cases on its rows of each
global batch, then the spec's ``Trainer`` (on a ``data`` mesh), and saves
what each gives to ``OUT/rank{RANK}.pt``. The test runs the same
cases in one process on the whole batch (:func:`run_case` with
``mesh=None``) and compares.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.distributed as dist

from ishara_tpu_torch import config as tconfig
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.models.encoder import build_model
from ishara_tpu_torch.models.seq2seq import ASLTranslationModel
from ishara_tpu_torch.parallel import (
    batch_shard_of,
    host_local_to_global,
    initialize_distributed,
    make_mesh,
    make_multislice_mesh,
    multislice_batch_sharding,
    process_shard,
    replicated,
    shard_batch,
)
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.train import (
    Trainer,
    TrainState,
    make_fused_ctc_eval_step,
    make_fused_ctc_train_step,
    make_fused_translation_eval_step,
    make_fused_translation_train_step,
    make_optimizer,
)


def _model(case):
    kind, kw = case["model"]
    if kind == "encoder":
        return build_model(tconfig.EncoderConfig(**kw), device="cpu")
    return ASLTranslationModel(**kw)


def _rows(batch: dict, mesh) -> dict:
    """This process's rows of the global batch."""
    if mesh is None:
        return batch
    local = len(batch["raw"]) // mesh.size()
    r0 = batch_shard_of(mesh, local).row0
    return {k: v[r0:r0 + local] for k, v in batch.items()}


def run_case(case: dict, mesh=None) -> dict:
    """``case["steps"]`` fused train steps (dropout, augmentation and
    BatchNorm as the case sets them), then the eval step, on this process's
    rows (the whole batch without ``mesh``): the step's metrics and the
    state's tensors."""
    model = _model(case)
    model.load_state_dict(case["state_dict"])
    tx, _ = make_optimizer(tconfig.TrainConfig(**case["tcfg"]))
    state = TrainState.create(model, tx, device="cpu",
                              lookahead_sync_period=case["lookahead"])
    stats, T = GroupStats.identity(), case["frame_len"]
    if case["task"] == "ctc":
        step = make_fused_ctc_train_step(stats, T, case["aug_prob"],
                                         mesh=mesh)
        evaluate = make_fused_ctc_eval_step(stats, T, mesh=mesh)
    else:
        step = make_fused_translation_train_step(stats, T, case["aug_prob"],
                                                 mesh=mesh)
        evaluate = make_fused_translation_eval_step(stats, T, max_len=6,
                                                    mesh=mesh)
    batch = _rows(case["batch"], mesh)
    if case.get("dtensor") and mesh is not None:
        batch = host_local_to_global(batch, mesh)
    out = {"loss": [], "grad_norm": []}
    for _ in range(case["steps"]):
        state, m = step(state, batch, seed=case["seed"])
        out["loss"].append(m["loss"].clone())
        out["grad_norm"].append(m["grad_norm"].clone())
    ev = evaluate(state, _rows(case["batch"], mesh))
    mu, nu = state.moment_dicts()
    out.update(params=state.params.clone(), slow=state.slow_params.clone(),
               stats={k: v.clone() for k, v in state.batch_stats.items()},
               mu=torch.cat([v.reshape(-1) for v in mu.values()]),
               nu=torch.cat([v.reshape(-1) for v in nu.values()]),
               eval={k: v.clone() for k, v in ev.items()})
    return out


def trainer_config(batch_size: int = 4) -> tconfig.IsharaConfig:
    """A hybrid model at dim 32 with dropout, augmentation and BatchNorm
    on, 2 epochs of 2 steps, validated once at the end."""
    model = tconfig.EncoderConfig(
        variant="hybrid", dim=32, num_heads=4, num_squeeze_blocks=1,
        num_conform_blocks=1, frame_len=16, transformer_kernel_size=7,
        dropout=0.1, top_dropout=0.1, top_mult=1)
    train = tconfig.TrainConfig(
        batch_size=batch_size, num_epochs=2, warmup_epochs=0, lr_max=3e-3,
        validate_every_epochs=100, checkpoint_every_epochs=1, aug_prob=0.3,
        seed=5)
    return tconfig.IsharaConfig(model=model, train=train)


def trainer_data():
    kw = dict(frames_per_char=3, min_phrase=2, max_phrase=3)
    return (SyntheticASLFR(num_sequences=8, seed=1, **kw),
            SyntheticASLFR(num_sequences=6, seed=2, **kw))


def run_trainer(workdir: str, mesh=None) -> dict:
    """A ``Trainer`` over 2 epochs (4 steps, one validation at the end);
    then a second ``Trainer`` in the same directory resumes from its last
    checkpoint and trains a third epoch. Returns both histories and the
    states' parameters (and the resumed one's, before its epoch)."""
    train, val = trainer_data()
    torch.manual_seed(0)
    t = Trainer(trainer_config(), train, val, CTCTokenizer(),
                workdir=workdir, mesh=mesh, max_raw_frames=24, device="cpu")
    history = t.train()
    out = {"history": history, "params": t.state.params.clone(),
           "stats": {k: v.clone() for k, v in t.state.batch_stats.items()}}
    if mesh is not None:
        dist.barrier()
    r = Trainer(trainer_config(), train, val, CTCTokenizer(),
                workdir=workdir, mesh=mesh, max_raw_frames=24, device="cpu")
    assert r.resume()
    out["resumed"] = r.state.params.clone()
    out["resumed_epochs"] = r.completed_epochs
    out["history2"] = r.train(num_epochs=3)
    out["params2"] = r.state.params.clone()
    return out


def main(rank: int, world: int, port: int, spec_path: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        spec = torch.load(spec_path, weights_only=False)
        results = {"initialized": initialize_distributed(),
                   "process_shard": process_shard()}
        for layout, cases in spec["runs"]:
            mesh = make_mesh() if layout == "1d" else make_multislice_mesh(2)
            rows = torch.arange(24).reshape(8, 3)
            results[layout] = {
                "mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names)),
                "placements": ([str(p) for p in
                                multislice_batch_sharding(mesh)],
                               [str(p) for p in replicated(mesh)]),
                "shard_batch": torch.equal(
                    shard_batch({"x": rows}, mesh, None)["x"].to_local(),
                    _rows({"raw": rows}, mesh)["raw"])}
            for case in cases:
                results[layout][case["name"]] = run_case(case, mesh)
        mesh = make_mesh()
        if spec.get("trainer"):
            results["trainer"] = run_trainer(spec["trainer"], mesh)
            try:
                Trainer(trainer_config(batch_size=world + 1),
                        *trainer_data(), CTCTokenizer(),
                        workdir=spec["trainer"], mesh=mesh, device="cpu")
            except ValueError as e:
                results["indivisible"] = str(e)
        torch.save(results, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
