"""Context-parallel attention on gloo ranks (the CPU), for
tests/test_torch_context_parallel.py: a "call" job of
tests/_torch_parallel_worker.World. Imports torch and the port only.

attention_job runs each case's ring or Ulysses on the real context group
(parallel/mappings.p2p and the all-to-alls): every rank builds the same
seeded global q, k, v and cotangent, keeps its contiguous piece of the
sequence, runs the scheme with autograd, and the pieces of the output
and of the three gradients come back put together in sequence order.
"""

from __future__ import annotations

import numpy as np
import torch


def qkv(case: dict):
    """The case's global inputs (float32 numpy): q [B, S, Hq, D], k, v
    [B, S, Hkv, D] and the output's cotangent."""
    r = np.random.default_rng(case.get("seed", 42))
    b, s, hq, hkv, d = (case[k] for k in ("b", "s", "hq", "hkv", "d"))
    return (r.standard_normal((b, s, hq, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            r.standard_normal((b, s, hq, d)).astype(np.float32))


def attention_job(cases: dict):
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.ops.ring_attention import ring_attention
    from megatron_tpu_torch.ops.ulysses import ulysses_attention
    from megatron_tpu_torch.parallel.mesh import build_mesh

    meshes = {}
    out = {}
    for name, case in cases.items():
        cp = case["cp"]
        if cp not in meshes:           # new_group is collective
            meshes[cp] = build_mesh(ParallelConfig(context_parallel=cp))
        mesh = meshes[cp]
        c, n = mesh.cp_rank, case["s"] // cp
        q, k, v, g = (torch.from_numpy(a[:, c * n:(c + 1) * n].copy())
                      for a in qkv(case))
        for t in (q, k, v):
            t.requires_grad_(True)
        fn = ring_attention if case["impl"] == "ring" else ulysses_attention
        o = fn(q, k, v, mesh, mask_type=case.get("mask", "causal"),
               sliding_window=case.get("window"))
        o.backward(g)
        mine = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (mesh.dp_rank, c, mine))
        pieces = sorted((ci, m) for dpr, ci, m in every if dpr == 0)
        out[name] = [np.concatenate([m[i] for _, m in pieces], axis=1)
                     for i in range(4)]
    dist.barrier()
    return out


def fp8_job():
    """fp8_matmul on a tp2 x cp2 mesh, with each operand's amax reduced
    over the groups amax_groups gives: a column-parallel product (x this
    rank's sequence piece, w its column block) and a row-parallel one (x
    also cut along K, w its row block, the partial sums added over the
    tensor group), against the one-process product of the whole
    tensors; the max abs errors of out and dw (dw summed over the
    context group)."""
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.ops.fp8 import amax_groups, fp8_matmul
    from megatron_tpu_torch.parallel.mappings import all_reduce
    from megatron_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(ParallelConfig(tensor_parallel=2, context_parallel=2))
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.standard_normal((2, 16, 32)).astype(np.float32))
    w = torch.from_numpy((r.standard_normal((32, 48)) * 0.1)
                         .astype(np.float32))
    g = torch.from_numpy(r.standard_normal((2, 16, 48)).astype(np.float32))
    c, t = mesh.cp_rank, mesh.tp_rank
    rows, xg, wg = slice(8 * c, 8 * c + 8), *amax_groups(mesh)
    out = {}
    for kind in ("column", "row"):
        xw = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        want = fp8_matmul(xw, ww, fmt="hybrid")
        want.backward(g)
        if kind == "column":
            cols = slice(24 * t, 24 * t + 24)
            xl, wl, gl = x[:, rows], w[:, cols], g[:, rows, cols]
            want_out, want_dw = want[:, rows, cols], ww.grad[:, cols]
        else:
            ks = slice(16 * t, 16 * t + 16)
            xl, wl, gl = x[:, rows, ks], w[ks], g[:, rows]
            want_out, want_dw = want[:, rows], ww.grad[ks]
        wl = wl.clone().requires_grad_(True)
        got = fp8_matmul(xl, wl, fmt="hybrid", x_groups=xg, w_groups=wg)
        got.backward(gl)
        got = got.detach()
        if kind == "row":
            got = all_reduce(got, mesh.group("tensor"))
        dw = all_reduce(wl.grad, mesh.group("context"))
        out[kind] = max(float((got - want_out.detach()).abs().max()),
                        float((dw - want_dw).abs().max()))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


# MULTICHIP_r05's dry run (__graft_entry__.dryrun_multichip(8)): the JAX
# package's tiny Llama at S 64 in fp32, one step of its jitted pipeline
# at pipe2 x context2 x tensor2 with sequence parallelism, ZeRO-1 and two
# virtual chunks a stage, global batch 2
MULTICHIP_MODEL = dict(num_layers=4, hidden_size=512, num_attention_heads=8,
                       num_kv_heads=4, ffn_hidden_size=1408, vocab_size=32000,
                       seq_length=64, params_dtype="float32")
MULTICHIP_PARALLEL = dict(tensor_parallel=2, pipeline_parallel=2,
                          context_parallel=2, sequence_parallel=True,
                          virtual_pipeline_parallel=2)


def multichip_job(params_path: str):
    """The dry run's step on the port at the same topology, from the
    JAX init's weights (an .npz of flat paths): its loss and grad norm."""
    from megatron_tpu_torch.config import (
        ModelConfig, OptimizerConfig, ParallelConfig, TrainingConfig,
    )
    from megatron_tpu_torch.data.samplers import context_piece
    from megatron_tpu_torch.models.params import leaf_layout, shard_params
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths, nest_paths,
    )
    from megatron_tpu_torch.training.train_step import make_train_step

    model = ModelConfig(**MULTICHIP_MODEL).validate()
    mesh = build_mesh(ParallelConfig(**MULTICHIP_PARALLEL))
    opt = OptimizerConfig(lr=1e-4, use_distributed_optimizer=True)
    train = TrainingConfig(micro_batch_size=1, global_batch_size=2,
                           train_iters=10, seed=0)
    with np.load(params_path) as f:
        flat = {k: torch.from_numpy(f[k]) for k in f.files}
    params = nest_paths(shard_params(flat, model, mesh))
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(opt, params, mesh=mesh,
                             layout=leaf_layout(model, mesh, True))
    step = make_train_step(model, opt, train, 2, 10, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 32000, (2, 64)),
             "labels": rng.integers(0, 32000, (2, 64)),
             "loss_mask": np.ones((2, 64), np.float32)}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in context_piece(batch, mesh).items()}
    _, m = step(state, tb)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
