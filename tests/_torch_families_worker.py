"""Gloo ranks on the CPU for tests/test_torch_parallel_families.py (run
through _torch_parallel_worker.World's "call" job). Imports torch and
the port only (a spawned child must not import JAX).

eval_job runs the port's parallel eval step with --metrics on this
world's data rows and returns the agreed numbers; argmax_job holds the
vocab-parallel argmax, and the accuracy it gives, against torch.argmax
on the whole logits where the maximum ties across the two vocab shards.
"""

from __future__ import annotations

import numpy as np
import torch

import _torch_parallel_worker as W

METRICS = ("perplexity", "accuracy", "instruct_accuracy", "count_loss_mask")


def eval_batch(model: dict, rows: int = W.GLOBAL_BATCH):
    """The matrix batch with a loss mask of 0, 0.5 and 1 weights (so
    accuracy and instruct_accuracy count different tokens)."""
    batch = W.make_batch(model, rows)
    rng = np.random.default_rng(5)
    batch["loss_mask"] = rng.choice(np.array([0.0, 0.5, 1.0], np.float32),
                                    size=batch["tokens"].shape)
    return batch


def eval_configs(case: dict):
    import dataclasses

    model, _, train, par = W.configs(case)
    return model, dataclasses.replace(train, metrics=METRICS), par


def eval_job(case: dict):
    """The eval step at this world's topology, on this data rank's rows
    of eval_batch: {lm_loss, ntokens, each metric} as floats, and
    whether every rank returned the same numbers."""
    import torch.distributed as dist

    from megatron_tpu_torch.models.params import shard_params
    from megatron_tpu_torch.parallel.distributed import host_batch_slice
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training.optimizer import nest_paths
    from megatron_tpu_torch.training.train_step import make_eval_step

    model, train, par = eval_configs(case)
    if par not in W._MESHES:
        W._MESHES[par] = build_mesh(par)
    mesh = W._MESHES[par]
    flat = W.flat_numpy(W.full_params(model))
    params = nest_paths(shard_params(
        {k: torch.from_numpy(v) for k, v in flat.items()}, model, mesh))
    batch = eval_batch(case.get("model", W.MATRIX_MODEL))
    lo, hi = host_batch_slice(mesh, W.GLOBAL_BATCH)
    out = make_eval_step(model, train, mesh)(
        params, {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()})
    got = {k: float(v) for k, v in out.items()}
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, got)
    got["ranks_agree"] = all(v == views[0] for v in views)
    return got


def argmax_job():
    """vocab_parallel_argmax at tp2 (the world's first two ranks' tensor
    group) on logits whose maximum ties within a shard and across the
    two shards, against torch.argmax of the whole logits; and the
    accuracy metric_sums gives with those ids against the one-process
    accuracy."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.ops.cross_entropy import vocab_parallel_argmax
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training.metrics import (
        compute_metrics, finish_metrics, metric_sums,
    )

    par = ParallelConfig(tensor_parallel=2)
    if par not in W._MESHES:
        W._MESHES[par] = build_mesh(par)
    mesh = W._MESHES[par]
    g = torch.Generator().manual_seed(13)
    V = 16
    logits = torch.randn(2, 6, V, generator=g)
    top = logits.amax(-1, keepdim=True) + 1.0
    logits[0, 0, [3, 11]] = top[0, 0]           # across the shards
    logits[0, 1, [9, 14]] = top[0, 1]           # inside shard 1
    logits[0, 2, [1, 5, 8, 12]] = top[0, 2]     # both, twice each
    logits[1, 0, :] = 0.5                       # every id ties
    labels = torch.tensor([[11, 9, 1, 4, 0, 7], [0, 3, 3, 2, 8, 15]])
    mask = torch.ones(2, 6)
    local = logits.chunk(2, dim=-1)[mesh.tp_rank]
    got = vocab_parallel_argmax(local, mesh)
    want = torch.argmax(logits, -1)
    acc = finish_metrics(("accuracy",), metric_sums(
        ("accuracy",), got, labels, mask, torch.zeros(2, 6)))["accuracy"]
    return {"ids_equal": bool(torch.equal(got, want)),
            "ids": got.tolist(), "want": want.tolist(),
            "accuracy": float(acc),
            "accuracy_one_process": float(compute_metrics(
                ("accuracy",), logits, labels, mask,
                torch.zeros(2, 6))["accuracy"])}
