"""Multi-process gloo runs of the port's encoder families on the CPU, for
tests/test_torch_encoder_parallel.py (one launch of four ranks; each
case runs on all of them in turn, and data parallelism takes the ranks
the case's tensor and pipe axes leave).

Imports torch and the port only (a spawned child must not import JAX).
cases(data, out) reads the parent's weights and batches (flat numpy
trees in data["npz"]) and returns, per case, the agreed loss and the
whole gradient tree put back together from every rank's slices (the
task trees' specs), or a TrainLoop's logged losses and final parameters,
or an entry point's losses (run through its main() on the launch's
process group, as python -m torch.distributed.run would run it).
"""

from __future__ import annotations

import functools
import os
import re

import numpy as np
import torch

BERT_KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
               vocab_size=128, seq_length=32, params_dtype="float32")
ICT_KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
              vocab_size=96, seq_length=32, params_dtype="float32")
T5_KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
             vocab_size=96, seq_length=24, decoder_seq_length=12,
             params_dtype="float32")
T5_ASYM = dict(T5_KW, encoder_num_layers=4, decoder_num_layers=2)
ICT_HEAD = 16
N_MICRO = 2

_MESHES: dict = {}


def mesh_of(**par):
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.parallel.mesh import build_mesh

    key = tuple(sorted(par.items()))
    if key not in _MESHES:          # new_group is collective
        _MESHES[key] = build_mesh(ParallelConfig(**par))
    return _MESHES[key]


def nest(flat):
    from megatron_tpu_torch.training.optimizer import nest_paths

    return nest_paths({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in flat.items()})


def flat_numpy(tree):
    from megatron_tpu_torch.training.optimizer import leaf_paths

    return {k: v.detach().float().cpu().numpy() for k, v in leaf_paths(tree)}


def gather_whole(tree_local, tree, mesh):
    """The whole tensors of a task tree from every rank's slices."""
    import torch.distributed as dist

    from megatron_tpu_torch.parallel.mesh import MESH_AXES, rank_grid
    from megatron_tpu_torch.parallel.sharding import unshard

    per_rank = [None] * mesh.world_size
    dist.all_gather_object(per_rank, flat_numpy(tree_local))
    grid = rank_grid(mesh.parallel, mesh.world_size)
    sizes = {a: mesh.size(a) for a in MESH_AXES}
    out = {}
    for path, (_, spec) in tree.items():
        def slice_at(coords, path=path):
            r = int(grid[tuple(coords[a] for a in MESH_AXES)])
            return torch.from_numpy(per_rank[r][path])

        out[path] = unshard(slice_at, spec, sizes).numpy()
    return out


def rows(batch, mesh, micro):
    """This rank's rows of a global batch (data/samplers.rank_rows)."""
    from megatron_tpu_torch.data.samplers import rank_rows

    return next(rank_rows(iter([batch]), mesh, micro))


def grads_at(mesh, cfg, full, specs, batch, loss_fn, micro,
             pipeline=None):
    """(agreed loss, whole gradient tree) of one step's forward and
    backward at `mesh`: the train step's accumulation and reduce_grads,
    without the optimizer."""
    from megatron_tpu_torch.config import OptimizerConfig
    from megatron_tpu_torch.models.params import (
        leaf_layout, shard_task_params, task_tree,
    )
    from megatron_tpu_torch.training.optimizer import leaf_paths, nest_paths
    from megatron_tpu_torch.training.train_step import (
        agreed_loss, reduce_grads,
    )

    tree = task_tree(full, specs)
    local = shard_task_params(full, tree, mesh)
    leaves = leaf_paths(local)
    for _, p in leaves:
        p.requires_grad_(True)
    acc = {k: torch.zeros_like(p) for k, p in leaves}

    def accumulate():
        for k, p in leaves:
            if p.grad is not None:
                acc[k] += p.grad
                p.grad = None

    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in rows(batch, mesh, micro).items()}
    n = next(iter(tb.values())).shape[0] // micro
    if pipeline is not None:
        losses, _ = pipeline(cfg, mesh, n).forward_backward(
            local, tb, None, accumulate)
    else:
        losses = []
        for i in range(n):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in tb.items()}
            loss, _ = loss_fn(cfg, local, mb, mesh=mesh)
            loss.backward()
            accumulate()
            losses.append(loss.detach())
    for a in acc.values():
        a.div_(n)
    g = reduce_grads(nest_paths(acc), cfg, OptimizerConfig(), mesh,
                     leaf_layout(cfg, mesh, False, tree=tree), task=True)
    return {"loss": float(agreed_loss(losses, mesh, torch.device("cpu"))),
            "grads": gather_whole(g, tree, mesh)}


def eval_at(mesh, cfg, full, specs, batch, loss_fn, micro, pipeline=None):
    """The task eval step's agreed loss of the batch's rows at `mesh`
    (training/train_step.make_task_eval_step; a pipeline's forward-only
    ring)."""
    from megatron_tpu_torch.models.params import shard_task_params, task_tree
    from megatron_tpu_torch.training.train_step import make_task_eval_step

    local = shard_task_params(full, task_tree(full, specs), mesh)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in rows(batch, mesh, micro).items()}
    step = make_task_eval_step(cfg, loss_fn, mesh, pipeline, micro)
    return float(step(local, tb)["lm_loss"])


def _losses(logs):
    return [float(m.group(1)) for m in
            (re.search(r"lm loss: ([0-9.e+-]+)", line) for line in logs)
            if m]


def bert_loop(cfg, tree_np, batches, save=None):
    """Three TrainLoop steps of BERT on the launch's mesh (the JAX weights
    through init_params_fn): (logged losses, whole final params)."""
    from megatron_tpu_torch.models import bert
    from megatron_tpu_torch.models.params import param_specs, params_from_numpy
    from megatron_tpu_torch.training.pretrain import task_loop

    logs = []
    loop = task_loop(
        cfg, log=logs.append, device="cpu",
        init_params_fn=lambda mc, seed, dev: params_from_numpy(
            tree_np, mc, device=dev),
        param_specs_fn=param_specs, loss_fn=bert.bert_loss)

    def factory(consumed, gbs):
        return iter(batches[consumed // gbs:])

    loop.train(factory)
    params = (gather_whole(loop.state.params, loop.tree, loop.mesh)
              if loop.mesh is not None else flat_numpy(loop.state.params))
    return {"losses": _losses(logs), "params": params}


def bert_run_config(micro, parallel, zero1, save=None, load=None):
    from megatron_tpu_torch import config as C
    from megatron_tpu_torch.models.bert import bert_config

    return C.RunConfig(
        model=bert_config(**BERT_KW),
        optimizer=C.OptimizerConfig(lr=1e-3, lr_decay_style="constant",
                                    use_distributed_optimizer=zero1),
        training=C.TrainingConfig(micro_batch_size=micro, global_batch_size=8,
                                  train_iters=3, log_interval=1, seed=5,
                                  save=save, load=load),
        parallel=C.ParallelConfig(**parallel))


def cli_losses(loop):
    return [h["lm_loss"] for h in loop.history]


def cases(data, out):
    """Every case, in order, on every rank; rank 0's results return."""
    from megatron_tpu_torch.models import bert, biencoder as bi, t5
    from megatron_tpu_torch.models.params import params_from_numpy
    from megatron_tpu_torch.training.t5_pipeline import T5Pipeline

    torch.manual_seed(0)
    npz = dict(np.load(data["npz"], allow_pickle=True))

    def tree_of(prefix):
        return {k[len(prefix):]: v for k, v in npz.items()
                if k.startswith(prefix)}

    def batch_of(prefix):
        return {k[len(prefix):]: v for k, v in npz.items()
                if k.startswith(prefix)}

    res = {}
    # BERT: three TrainLoop steps at tp2 + SP with ZeRO-1 (dp 2), saved
    bert_np = tree_of("bert/")
    bert_batches = [batch_of(f"bbatch{i}/") for i in range(3)]
    res["bert_tp2_sp_zero1"] = bert_loop(
        bert_run_config(2, dict(tensor_parallel=2, sequence_parallel=True),
                        True, save=os.path.join(out, "bert_tp2")),
        bert_np, bert_batches)

    # BERT's loss and grads at tp2 + SP (dp 2), one microbatch: the
    # loop's Adam would hide a leaf's gradient off by a constant factor
    from megatron_tpu_torch.models.params import param_specs

    bcfg = bert.bert_config(**BERT_KW)
    res["bert_grads_tp2_sp"] = grads_at(
        mesh_of(tensor_parallel=2, sequence_parallel=True), bcfg,
        params_from_numpy(bert_np, bcfg, device="cpu"), param_specs(bcfg),
        bert_batches[0], bert.bert_loss, 4)

    # ICT: loss and grads at dp 4 and at tp2 + SP (dp 2)
    ict_cfg = bi.biencoder_config(**ICT_KW)
    ict_full = bi.biencoder_params_from_numpy(
        nest(tree_of("ict/")), ict_cfg, device="cpu")
    ict_specs = bi.biencoder_param_specs(ict_cfg, ICT_HEAD, False)
    ict_loss = functools.partial(bi.biencoder_loss, score_scaling=True,
                                 topk=(1, 3))
    ict_batch = batch_of("ibatch/")
    for name, par in (("ict_dp4", {}),
                      ("ict_tp2_sp", dict(tensor_parallel=2,
                                          sequence_parallel=True))):
        mesh = mesh_of(**par)
        res[name] = grads_at(mesh, ict_cfg, ict_full, ict_specs, ict_batch,
                             ict_loss, 8 // mesh.dp)

    # T5: tp2 (dp 2), the pp2 ring at tp1 (dp 2) and tp2, asymmetric
    # stacks with full recompute on the ring
    t5_batch = batch_of("tbatch/")
    for name, kw, par, pipe, recompute in (
            ("t5_tp2", T5_KW, dict(tensor_parallel=2), False, "none"),
            ("t5_pp2", T5_KW, dict(pipeline_parallel=2), True, "none"),
            ("t5_pp2_tp2", T5_KW, dict(pipeline_parallel=2,
                                       tensor_parallel=2), True, "none"),
            ("t5_pp2_asym_full", T5_ASYM, dict(pipeline_parallel=2), True,
             "full")):
        cfg = t5.t5_config(**kw)
        full = t5.t5_params_from_numpy(
            nest(tree_of("t5asym/" if kw is T5_ASYM else "t5/")), cfg,
            device="cpu")
        mesh = mesh_of(**par)
        micro = 8 // (mesh.dp * N_MICRO)
        specs = t5.t5_param_specs(cfg, pipeline=pipe)
        res[name] = grads_at(
            mesh, cfg, full, specs, t5_batch,
            functools.partial(t5.t5_loss, recompute=recompute), micro,
            pipeline=(functools.partial(T5Pipeline, recompute=recompute)
                      if pipe else None))
        res[name]["eval_loss"] = eval_at(
            mesh, cfg, full, specs, t5_batch, t5.t5_loss, micro,
            T5Pipeline if pipe else None)

    res["cli"] = entry_points(data, out)
    return res


def entry_points(data, out):
    """The entry points' main() at a topology each (their losses, and the
    T5 pp2 and BERT tp2 states' whole params)."""
    import torch.distributed as dist

    from megatron_tpu_torch.tasks import main as tasks_main
    from megatron_tpu_torch.tools import (
        pretrain_bert, pretrain_ict, pretrain_t5,
    )

    res = {}
    argv = data["argv"]
    loop = pretrain_bert.main(argv["bert"] + [
        "--tensor_model_parallel_size", "2", "--sequence_parallel",
        "--use_distributed_optimizer", "--save", os.path.join(out, "cbert")],
        log=lambda m: None)
    res["bert"] = cli_losses(loop)
    loop = pretrain_t5.main(argv["t5"] + [
        "--pipeline_model_parallel_size", "2", "--use_distributed_optimizer",
        "--save", os.path.join(out, "ct5")], log=lambda m: None)
    res["t5"] = cli_losses(loop)
    res["t5_params"] = gather_whole(loop.state.params, loop.tree, loop.mesh)
    loop = pretrain_ict.main(argv["ict"] + ["--use_distributed_optimizer"],
                             log=lambda m: None)
    res["ict"] = cli_losses(loop)
    loop = tasks_main.main(argv["mnli"] + [
        "--pretrained_checkpoint", os.path.join(out, "bert_tp2"),
        "--use_distributed_optimizer"], log=lambda m: None)
    res["mnli"] = cli_losses(loop)
    loop, stats = tasks_main.main(argv["orqa"] + [
        "--tensor_model_parallel_size", "2"], log=lambda m: None)
    res["orqa"] = cli_losses(loop)
    res["orqa_eval"] = stats
    dist.barrier()
    return res
