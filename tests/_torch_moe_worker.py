"""Gloo ranks on the CPU for tests/test_torch_moe_parallel.py (run
through _torch_parallel_worker.World's "call" job). Imports torch and
the port only (a spawned child must not import JAX).

  * block_job (4 ranks): one MoE layer (ops/moe.moe_block, then exit_tp
    as the block reduces it) at a topology on this rank's rows of one
    input, every rank's loss dp * sum(y^2) + aux (their mean over the
    batch ranks is sum(y^2) + aux over the whole input), backward, the
    weights' gradients reduced by train_step.reduce_grads; returns the
    whole y, aux, the whole router/w_in/w_out gradients and x's;
  * train_job (4 ranks): make_train_step on a tiny 4-layer MoE for STEPS
    steps at a topology, this rank's rows given by data/samplers.
    rank_rows (microbatch by microbatch, as the loop gives them);
    returns the losses, moe_aux_losses, grad norms, the first step's
    router gradient and the final parameters, all whole;
  * save_job (4 ranks): the one-process MoE state after STEPS steps, cut
    into ep2 x tp2 slices with ZeRO-1 and saved in the sharded layout;
  * serve_job (2 ranks): a tiny MoE served at tp2 (generate_tokens, the
    dense and the paged engine, rank 1 following) and at pp2
    (generate_tokens through the pipelined forward).
"""

from __future__ import annotations

import numpy as np
import torch

import _torch_parallel_worker as W

# tests/test_moe.py's _moe_cfg (the tiny preset's remaining fields)
MOE_KW = dict(vocab_size=96, seq_length=16, hidden_size=32,
              num_attention_heads=4, num_kv_heads=2, ffn_hidden_size=48,
              num_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
              params_dtype="float32")
# variants of the layer: the router saturated toward expert 0 (top-1,
# no renormalization), at the default receive buffer and at factor 1
VARIANTS = {
    "default": {},
    "imbalance": dict(moe_top_k=1, moe_renorm_gates=False),
    "buffer": dict(moe_top_k=1, moe_renorm_gates=False,
                   moe_ep_buffer_factor=1.0),
}
TRAIN_MODEL = dict(MOE_KW, num_layers=4)
STEPS = 2
GLOBAL = 8
# the served MoE: the tp serving tests' tiny model with 4 experts
SERVE_KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas",
                num_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
SERVE_SEED = 0


def _mesh(par):
    from megatron_tpu_torch.parallel.mesh import build_mesh

    if par not in W._MESHES:      # new_group is collective
        W._MESHES[par] = build_mesh(par)
    return W._MESHES[par]


def layer_cfg(dispatch: str, variant: str):
    from megatron_tpu_torch.models import presets

    return presets.tiny(**dict(MOE_KW, moe_dispatch=dispatch,
                               **VARIANTS[variant]))


def _gather_rows(t: torch.Tensor, mesh, rows: tuple):
    """The whole [B, S, ...] tensor from every rank's [rows, S-chunk]
    piece: rank 0 gets it (None elsewhere)."""
    import torch.distributed as dist

    from megatron_tpu_torch.parallel.mappings import SEQ_DIM

    piece = (rows, mesh.tp_rank if mesh.sequence_parallel else 0,
             mesh.tp if mesh.sequence_parallel else 1,
             t.detach().numpy())
    views = [None] * mesh.world_size
    dist.all_gather_object(views, piece)
    if mesh.rank != 0:
        return None
    B = max(v[0][1] for v in views)
    S = piece[3].shape[SEQ_DIM] * piece[2]
    out = np.zeros((B, S) + piece[3].shape[2:], np.float32)
    for (lo, hi), c, n, x in views:
        w = S // n
        out[lo:hi, c * w:(c + 1) * w] = x
    return out


def _unshard_leaf(path, spec, per_rank, cfg, mesh, zdim=None):
    """The whole leaf from every rank's slice (an optimizer-shaped slice
    when zdim, the ZeRO-1 cut, is given)."""
    from megatron_tpu_torch.models.params import (
        _glu_dim, param_shapes, vpp_place_indices,
    )
    from megatron_tpu_torch.parallel.mesh import MESH_AXES, rank_grid
    from megatron_tpu_torch.parallel.sharding import unshard, zero1_spec

    grid = rank_grid(mesh.parallel, mesh.world_size)
    if zdim is not None:
        spec = zero1_spec(spec, param_shapes(cfg)[path], mesh.dp, mesh.ep)
    glu = _glu_dim(path, cfg)
    x = unshard(lambda c: torch.from_numpy(per_rank[int(grid[tuple(
        c[a] for a in MESH_AXES)])]), spec,
        {a: mesh.size(a) for a in MESH_AXES},
        glu_dim=None if glu is None else len(spec) - 1)
    if mesh.vpp > 1:
        inv = vpp_place_indices(cfg.num_layers, mesh.pp, mesh.vpp)[1]
        x = x[torch.from_numpy(inv)]
    return x.numpy()


def block_job(parallel: dict, dispatch: str, variant: str, weights: dict,
              x: np.ndarray):
    """One layer at `parallel` (the module docstring)."""
    import torch.distributed as dist

    from megatron_tpu_torch.config import OptimizerConfig, ParallelConfig
    from megatron_tpu_torch.models.params import leaf_layout, shard_params
    from megatron_tpu_torch.ops.moe import moe_block
    from megatron_tpu_torch.parallel.distributed import host_batch_slice
    from megatron_tpu_torch.parallel.mappings import exit_tp, sp_slice
    from megatron_tpu_torch.training.optimizer import leaf_paths, nest_paths
    from megatron_tpu_torch.training.train_step import reduce_grads

    cfg = layer_cfg(dispatch, variant)
    mesh = _mesh(ParallelConfig(**parallel))
    local = shard_params({f"layers/moe/{k}": torch.from_numpy(v[None])
                          for k, v in weights.items()}, cfg, mesh)
    p = {k.rsplit("/", 1)[1]: v[0].clone().requires_grad_(True)
         for k, v in local.items()}
    lo, hi = host_batch_slice(mesh, x.shape[0])
    xl = sp_slice(torch.from_numpy(x[lo:hi]), mesh).clone()
    xl.requires_grad_(True)
    y, aux = moe_block(cfg, p, xl, mesh)
    y = exit_tp(y, mesh)
    (mesh.dp * y.square().sum() + aux).backward()
    layout = {k: v for k, v in leaf_layout(cfg, mesh, False).items()
              if k in local}
    grads = dict(leaf_paths(reduce_grads(
        nest_paths({k: p[k.rsplit("/", 1)[1]].grad[None].clone()
                    for k in local}), cfg, OptimizerConfig(), mesh, layout)))
    out = {"y": _gather_rows(y, mesh, (lo, hi)),
           "x_grad": _gather_rows(xl.grad / mesh.dp, mesh, (lo, hi)),
           "aux": float(aux), "grads": {}}
    for path, g in grads.items():
        views = [None] * mesh.world_size
        dist.all_gather_object(views, g.numpy())
        if mesh.rank == 0:
            out["grads"][path.rsplit("/", 1)[1]] = _unshard_leaf(
                path, layout[path][0], views, cfg, mesh)[0]
    auxes = [None] * mesh.world_size
    dist.all_gather_object(auxes, out["aux"])
    out["ranks_agree"] = all(a == auxes[0] for a in auxes)
    return out


def train_model():
    from megatron_tpu_torch.models import presets

    return presets.tiny(**TRAIN_MODEL)


def train_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    V, S = TRAIN_MODEL["vocab_size"], TRAIN_MODEL["seq_length"]
    toks = rng.integers(0, V, (GLOBAL, S + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "loss_mask": np.ones((GLOBAL, S), np.float32)}


def train_configs(case: dict):
    import dataclasses

    from megatron_tpu_torch.config import (
        OptimizerConfig, ParallelConfig, TrainingConfig,
    )

    cfg = dataclasses.replace(train_model(), **case.get("model", {}))
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant",
                          use_distributed_optimizer=case.get("zero1", False))
    train = TrainingConfig(micro_batch_size=1, global_batch_size=GLOBAL,
                           train_iters=STEPS,
                           recompute_granularity=case.get("recompute",
                                                          "full"))
    return cfg, opt, train, ParallelConfig(**case.get("parallel", {}))


class _FirstGrads:
    """Records the first optimizer call's gradient tree (the reduced
    grads, as the optimizer takes them) around make_optimizer_step."""

    def __init__(self, module):
        self.module, self.orig, self.grads = module, \
            module.make_optimizer_step, None

    def __enter__(self):
        def wrapped(*a, **kw):
            apply = self.orig(*a, **kw)

            def run(state, grads):
                if self.grads is None:
                    from megatron_tpu_torch.training.optimizer import (
                        leaf_paths,
                    )
                    self.grads = {k: v.detach().clone()
                                  for k, v in leaf_paths(grads)}
                return apply(state, grads)
            return run
        self.module.make_optimizer_step = wrapped
        return self

    def __exit__(self, *exc):
        self.module.make_optimizer_step = self.orig


def run_steps(case: dict, mesh=None, micro: int = 1):
    """The case's STEPS steps: at world 1 (mesh None) on the whole batch
    in microbatches of `micro` rows, else this rank's rows. Returns
    (losses, moe_aux_losses, grad norms, first grads, state)."""
    from megatron_tpu_torch.models.params import (
        init_params, leaf_layout, shard_params,
    )
    from megatron_tpu_torch.data.samplers import rank_rows
    from megatron_tpu_torch.training import train_step as ts
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths, nest_paths,
    )

    cfg, opt, train, _ = train_configs(case)
    batch = train_batch()
    full = init_params(cfg, W.SEED, device="cpu")
    if mesh is None:
        params = full
        layout = None
    else:
        params = nest_paths(shard_params(dict(leaf_paths(full)), cfg, mesh))
        layout = leaf_layout(cfg, mesh, opt.use_distributed_optimizer)
        batch = next(rank_rows(iter([batch]), mesh, train.micro_batch_size))
        micro = train.micro_batch_size
    for _, t in leaf_paths(params):
        t.requires_grad_(True)
    state = init_train_state(opt, params, mesh=mesh, layout=layout)
    rows = next(iter(batch.values())).shape[0]
    with _FirstGrads(ts) as rec:
        step = ts.make_train_step(cfg, opt, train, rows // micro, STEPS,
                                  mesh=mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, auxes, norms = [], [], []
    for _ in range(STEPS):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux_loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, auxes, norms, rec.grads, state


def train_job(case: dict):
    """The case on this world (every rank calls it)."""
    import torch.distributed as dist

    from megatron_tpu_torch.models.params import leaf_layout, param_specs
    from megatron_tpu_torch.parallel.mesh import MESH_AXES, rank_grid
    from megatron_tpu_torch.training.optimizer import leaf_paths

    cfg, opt, _, par = train_configs(case)
    mesh = _mesh(par)
    losses, auxes, norms, grads, state = run_steps(case, mesh)
    layout = leaf_layout(cfg, mesh, opt.use_distributed_optimizer)
    router = "layers/moe/router"
    views = [None] * mesh.world_size
    dist.all_gather_object(views, grads[router].numpy())
    per_rank = [None] * mesh.world_size
    dist.all_gather_object(per_rank, W.flat_numpy(state.params))
    agree = [None] * mesh.world_size
    dist.all_gather_object(agree, (losses, auxes, norms))
    if mesh.rank != 0:
        return None
    zdim = layout[router][1] if opt.use_distributed_optimizer else None
    return {"losses": losses, "moe_aux_losses": auxes, "grad_norms": norms,
            "router_grad": _unshard_leaf(router, param_specs(cfg)[router],
                                         views, cfg, mesh, zdim),
            "params": W._unshard_all(
                cfg, {a: mesh.size(a) for a in MESH_AXES},
                rank_grid(par, mesh.world_size), per_rank, mesh.vpp,
                mesh.pp),
            "ranks_agree": all(a == agree[0] for a in agree),
            "dp": mesh.dp}


# -- the sharded checkpoint with an expert axis -----------------------------

SAVE_PARALLEL = dict(expert_parallel=2, tensor_parallel=2)


def one_process_state(seed: int = 0, steps: int = STEPS):
    """(cfg, TrainState) of one process after `steps` Adam steps of the
    train model in bf16 with fp32 masters (params, master, mu and nu all
    differ)."""
    import dataclasses

    from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths,
    )
    from megatron_tpu_torch.training.train_step import make_train_step

    cfg = dataclasses.replace(train_model(), params_dtype="bfloat16")
    params = init_params(cfg, seed, device="cpu")
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    state = init_train_state(opt, params)
    if steps:
        train = TrainingConfig(micro_batch_size=1, global_batch_size=GLOBAL,
                               train_iters=steps)
        step = make_train_step(cfg, opt, train, GLOBAL, steps)
        batch = {k: torch.from_numpy(v) for k, v in train_batch().items()}
        for _ in range(steps):
            state, _ = step(state, batch)
    return cfg, state


def save_job(out_dir: str):
    """The one-process state cut into this rank's ep2 x tp2 slices (ZeRO-1
    over the data ranks of each leaf) and saved in the sharded layout."""
    import os

    import torch.distributed as dist

    import _torch_ckpt_worker as C
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models.params import StatePlacement
    from megatron_tpu_torch.training import checkpointing as ckpt

    cfg, full = one_process_state()
    mesh = _mesh(ParallelConfig(**SAVE_PARALLEL))
    state = C.slice_state(full, cfg, mesh, zero1=True)
    saver = ckpt.AsyncCheckpointSaver(
        os.path.join(out_dir, "sharded"),
        placement=StatePlacement.of(cfg, mesh, zero1=True))
    saver.save(state, STEPS, consumed_samples=STEPS * GLOBAL)
    saver.close()
    dist.barrier()
    return {"mesh": {a: mesh.size(a) for a in ("data", "expert", "tensor")}}


# -- serving ----------------------------------------------------------------


def serve_cfg(dispatch: str = "capacity"):
    from megatron_tpu_torch.models import presets

    return presets.tiny(**SERVE_KW, moe_dispatch=dispatch)


def serve_job(dispatch: str):
    """The served MoE at tp2 (one-shot, the dense and the paged engine)
    and at pp2 (one-shot), its weights init_params' at SERVE_SEED cut to
    this rank's slices; rank 0's outputs, and whether both ranks' one-
    shot outputs agree."""
    import _torch_pp_serving_worker as P
    import _torch_tp_serving_worker as S
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.inference import generation as g
    from megatron_tpu_torch.models.params import init_params

    cfg = serve_cfg(dispatch)
    out = {}
    for name, par in (("tp2", ParallelConfig(tensor_parallel=2)),
                      ("pp2", ParallelConfig(pipeline_parallel=2))):
        mesh = _mesh(par)
        params = init_params(cfg, SERVE_SEED, device="cpu", mesh=mesh)
        out[f"{name}_generate"] = S._out(g.generate_tokens(
            cfg, params, S.PROMPTS, S.LENGTHS, S.NEW, temperature=0.0,
            vocab_size=S.VOCAB, mesh=mesh))
        out[f"{name}_agree"] = S._agree(out[f"{name}_generate"])
        if name != "tp2":
            continue
        for paged in (False, True):
            kw = (dict(kv_paging=True, page_size=4, prefill_chunk=8,
                       num_pages=10, engine_max_seq_len=32) if paged else {})
            svc = S._service(cfg, params, mesh, **kw)
            if mesh.rank != 0:
                svc.follow()
                continue
            try:
                eng = svc.engine
                key = "paged" if paged else "engine"
                out[key] = (S._out(eng.generate(*P.PAIR, P.PAIR_NEW))
                            if paged else
                            S._out(eng.generate(S.PROMPTS, S.LENGTHS,
                                                S.NEW)))
            finally:
                svc.shutdown()
    return out
