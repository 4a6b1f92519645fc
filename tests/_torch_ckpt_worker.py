"""Multi-process gloo jobs of the sharded checkpoint layout, for
tests/test_torch_ckpt_sharded.py, run through
_torch_parallel_worker.World's "call" job on 8 ranks: tp2 x pp2 with
data parallelism taking the rest (dp 2), so ZeRO-1 cuts the optimizer
state too. The loads at other topologies run in the test's own process
(a load needs no collective).

Imports torch and the port only (a spawned child must not import JAX).
save_job writes one TrainState, known from a one-process run, from the
8 ranks' slices into the sharded layout (and rank 0 the same state in
the one-file-per-field layout); train_job runs TrainLoop at tp2 x pp2
x dp2 with ZeRO-1: uninterrupted, saved and resumed, preempted on one rank,
and rolled back after a non-finite step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# a Llama-shaped model: 4 q over 2 kv heads, SwiGLU, untied head; 4
# layers so pp2 x vpp2 can load it too
MODEL = dict(num_layers=4, hidden_size=128, num_attention_heads=4,
             num_kv_heads=2, ffn_hidden_size=256, vocab_size=256,
             seq_length=32)
SAVE_PARALLEL = dict(tensor_parallel=2, pipeline_parallel=2)
ROWS = 8
STEPS = 2
SAVE_ITERATION = 2


def model_cfg(dtype: str = "bfloat16"):
    from megatron_tpu_torch.config import ModelConfig

    return ModelConfig(**MODEL, params_dtype=dtype).validate()


def make_batch(seed: int = 0, rows: int = ROWS):
    rng = np.random.default_rng(seed)
    V, S = MODEL["vocab_size"], MODEL["seq_length"]
    toks = rng.integers(0, V, (rows, S + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "loss_mask": np.ones((rows, S), np.float32)}


def one_process_state(dtype: str = "bfloat16", seed: int = 0,
                      steps: int = STEPS):
    """(cfg, TrainState) of one process after `steps` Adam steps (bf16
    params with fp32 masters: params, master, mu and nu all differ)."""
    from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths,
    )
    from megatron_tpu_torch.training.train_step import make_train_step

    cfg = model_cfg(dtype)
    params = init_params(cfg, seed, device="cpu")
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    state = init_train_state(opt, params)
    if steps:
        train = TrainingConfig(micro_batch_size=1, global_batch_size=ROWS,
                               train_iters=steps)
        step = make_train_step(cfg, opt, train, ROWS, steps)
        batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
        for _ in range(steps):
            state, _ = step(state, batch)
    return cfg, state


def slice_state(state, cfg, mesh, zero1: bool):
    """A rank's TrainState cut from a whole one by the training path's
    own rules (models/params.shard_params, ZeRO-1's zero1_shard), the
    yardstick of every load: cloned, so nothing aliases `state`."""
    import dataclasses

    from megatron_tpu_torch.models.params import leaf_layout, shard_params
    from megatron_tpu_torch.parallel.sharding import zero1_axes
    from megatron_tpu_torch.training.optimizer import (
        leaf_paths, nest_paths, zero1_shard,
    )

    layout = leaf_layout(cfg, mesh, zero1)
    cut = zero1 and mesh.dp > 1

    def tree(t, opt):
        local = shard_params(dict(leaf_paths(t)), cfg, mesh)
        out = {}
        for path, x in local.items():
            zdim = layout[path][1]
            if opt and cut and zdim is not None:
                x = zero1_shard(x, mesh, zdim, zero1_axes(layout[path][0]))
            out[path] = x.detach().clone()
        return nest_paths(out)

    masters = state.master
    if masters is None and cut:
        masters = state.params           # fp32 params: ZeRO-1 keeps them
    return dataclasses.replace(
        state, params=tree(state.params, False),
        master=None if masters is None else tree(masters, True),
        mu=tree(state.mu, True), nu=tree(state.nu, True),
        step=state.step.clone(),
        nonfinite_streak=state.nonfinite_streak.clone())


def save_job(out_dir: str, parallel=None, name: str = "sharded"):
    """The one-process state after STEPS steps, cut into the 8 ranks'
    slices (`parallel`, default tp2 x pp2 x dp2; ZeRO-1) and saved by
    every rank's AsyncCheckpointSaver into out_dir/<name>; for the
    default name rank 0 also saves it whole into out_dir/world1.
    Returns every rank's save record."""
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models.params import StatePlacement
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training import checkpointing as ckpt

    cfg, full = one_process_state()
    mesh = build_mesh(ParallelConfig(**(parallel or SAVE_PARALLEL)))
    state = slice_state(full, cfg, mesh, zero1=True)
    saver = ckpt.AsyncCheckpointSaver(
        os.path.join(out_dir, name),
        placement=StatePlacement.of(cfg, mesh, zero1=True))
    saver.save(state, SAVE_ITERATION, consumed_samples=16)
    saver.close()
    if mesh.rank == 0 and name == "sharded":
        ckpt.save_checkpoint(os.path.join(out_dir, "world1"), full,
                             SAVE_ITERATION, 16)
    history = [None] * mesh.world_size
    dist.all_gather_object(history, saver.history)
    dist.barrier()
    return {"history": history}


# -- TrainLoop at tp2 x pp2 x dp2 with ZeRO-1 -----------------------------

BASE_ARGV = ["--model_name", "tiny", "--fp32", "--num_layers", "2",
             "--seq_length", "32", "--micro_batch_size", "1",
             "--global_batch_size", "4", "--lr", "1e-3",
             "--lr_decay_style", "constant", "--log_interval", "1",
             "--eval_interval", "1000", "--seed", "5", "--device", "cpu"]
TRAIN_ARGV = BASE_ARGV + ["--tensor_model_parallel_size", "2",
                          "--pipeline_model_parallel_size", "2",
                          "--use_distributed_optimizer"]
_MESHES: dict = {}


def _factory(consumed: int, gbs: int):
    """Batch i of the run is drawn from seed 100 + i: a resume at any
    consumed_samples sees the uninterrupted run's batches."""
    def gen():
        i = consumed // gbs
        while True:
            yield make_batch(100 + i, rows=gbs)
            i += 1
    return gen()


def _run(iters: int, *extra, fault=None):
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training.pretrain import pretrain

    cfg = args_to_run_config(parse_args(
        TRAIN_ARGV + ["--train_iters", str(iters), *extra]))
    if cfg.parallel not in _MESHES:     # new_group is collective
        _MESHES[cfg.parallel] = build_mesh(cfg.parallel)
    if fault:
        os.environ["MEGATRON_TPU_FAULT"] = fault
    try:
        return pretrain(cfg, _factory, log=lambda m: None, device="cpu",
                        mesh=_MESHES[cfg.parallel])
    finally:
        os.environ.pop("MEGATRON_TPU_FAULT", None)


def _state_equal(a, b) -> bool:
    from megatron_tpu_torch.training.optimizer import leaf_paths

    for field in ("params", "master", "mu", "nu"):
        x, y = getattr(a, field), getattr(b, field)
        if (x is None) != (y is None):
            return False
        if x is not None and not all(
                torch.equal(p, q) for (_, p), (_, q) in
                zip(leaf_paths(x), leaf_paths(y))):
            return False
    return int(a.step) == int(b.step)


def _full_params(loop):
    """The loop's params put back together from every rank's slices."""
    import torch.distributed as dist
    from _torch_parallel_worker import _unshard_all, flat_numpy

    from megatron_tpu_torch.parallel.mesh import MESH_AXES, rank_grid

    mesh = loop.mesh
    per_rank = [None] * mesh.world_size
    dist.all_gather_object(per_rank, flat_numpy(loop.state.params))
    sizes = {a: mesh.size(a) for a in MESH_AXES}
    return _unshard_all(loop.cfg.model, sizes,
                        rank_grid(mesh.parallel, mesh.world_size), per_rank,
                        mesh.vpp, mesh.pp)


def train_job(out_dir: str):
    """Every rank: (a) 4 steps; (b) 2 steps saved at the end, then a
    resume to 4 from that checkpoint; (c) 4 steps where only rank 1
    gets a SIGTERM before iteration 3; (d) 4 steps, a checkpoint every 2,
    the batch of iteration 3 poisoned on every rank and
    --rollback_on_divergence, against 4 steps with --skip_iters 3; (e) 2
    steps under --save_interval auto.
    Returns rank 0's view of what every rank saw."""
    import torch.distributed as dist

    rank = dist.get_rank()
    save = os.path.join(out_dir, "resume")
    straight = _run(4)
    first = _run(2, "--save", save, "--save_interval", "2")
    saved_params = _full_params(first)
    saves = first.saves
    resumed = _run(4, "--load", save)
    pre = os.path.join(out_dir, "preempt")
    preempted = _run(4, "--save", pre, "--save_interval", "100",
                     fault="preempt_at:3" if rank == 1 else None)
    roll = os.path.join(out_dir, "rollback")
    rolled = _run(4, "--save", roll, "--save_interval", "2",
                  "--rollback_on_divergence", "--divergence_patience", "1",
                  fault="nan_loss:3:1")
    skipped = _run(4, "--skip_iters", "3")
    auto = os.path.join(out_dir, "auto")
    _run(2, "--save", auto, "--save_interval", "auto")
    mine = {
        "rank": rank,
        "straight_losses": [r["loss"] for r in straight.step_records],
        "resumed_losses": [r["loss"] for r in resumed.step_records],
        "resumed_from": resumed.step_records[0]["iteration"],
        "resume_equal": _state_equal(resumed.state, straight.state),
        "load_read_bytes": resumed.load_read_bytes,
        "local_state_bytes": sum(
            t.numel() * t.element_size()
            for f in ("params", "master", "mu", "nu")
            for t in _leaves(getattr(resumed.state, f))),
        "saves": [{k: v for k, v in s.items()} for s in saves],
        "preempt_iteration": preempted.iteration,
        "preempt_signal": preempted._exit_signal,
        "rollback_equal": _state_equal(rolled.state, skipped.state),
        "rollback_iteration": rolled.iteration,
        "rollback_losses": [r["loss"] for r in rolled.step_records],
        "skip_losses": [r["loss"] for r in skipped.step_records],
    }
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, mine)
    return {"ranks": views, "saved_params": saved_params,
            "dirs": {"resume": save, "preempt": pre, "rollback": roll,
                     "auto": auto}}


def _leaves(tree):
    from megatron_tpu_torch.training.optimizer import leaf_paths

    return [] if tree is None else [t for _, t in leaf_paths(tree)]
