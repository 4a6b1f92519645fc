"""Multi-process gloo runs of the port's parallel training step on the
CPU, for tests/test_torch_parallel_train.py and test_torch_parallel.py.

Imports torch and the port only (a spawned child must not import JAX).
World(world, jobs) spawns `world` ranks once and runs every job in order
on them; rank 0's results come back. A training case returns the two
steps' losses and grad norms (the same numbers on every rank) and the
final parameters, put back together from every rank's slices; the unit
jobs return the largest error of each collective against its unsharded
math.
"""

from __future__ import annotations

import os
import socket
import tempfile
import traceback

import numpy as np
import torch

# the JAX topology matrix's tiny model (tests/_parallel_matrix_cases.py)
MATRIX_MODEL = dict(num_layers=4, hidden_size=32, num_attention_heads=4,
                    num_kv_heads=2, ffn_hidden_size=64, vocab_size=128,
                    seq_length=32, params_dtype="float32")
GPT2_MODEL = dict(MATRIX_MODEL, num_kv_heads=None,
                  position_embedding_type="absolute",
                  max_position_embeddings=64, normalization="layernorm",
                  activation="gelu", use_bias_linear=True,
                  use_bias_qkv=True, tie_embed_logits=True)
GLOBAL_BATCH = 8
STEPS = 2
SEED = 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_batch(model: dict, rows: int = GLOBAL_BATCH, seed: int = SEED):
    rng = np.random.default_rng(seed)
    V, S = model["vocab_size"], model["seq_length"]
    return {"tokens": rng.integers(0, V, (rows, S)).astype(np.int64),
            "labels": rng.integers(0, V, (rows, S)).astype(np.int64),
            "loss_mask": np.ones((rows, S), np.float32)}


def configs(case: dict):
    from megatron_tpu_torch.config import (
        ModelConfig, OptimizerConfig, ParallelConfig, TrainingConfig,
    )

    model = ModelConfig(**case.get("model", MATRIX_MODEL)).validate()
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant",
                          use_distributed_optimizer=case.get("zero1", False))
    train = TrainingConfig(micro_batch_size=1, global_batch_size=GLOBAL_BATCH,
                           train_iters=STEPS,
                           recompute_granularity=case.get("recompute",
                                                          "full"))
    par = ParallelConfig(**case.get("parallel", {})).validate()
    return model, opt, train, par


def full_params(model_cfg, seed: int = SEED):
    """The case's starting weights, the same on every rank."""
    from megatron_tpu_torch.models.params import init_params

    return init_params(model_cfg, seed, device="cpu")


def flat_numpy(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_numpy(v, path))
        else:
            out[path] = v.detach().float().cpu().numpy()
    return out


def single_process_steps(case: dict, batch=None):
    """The port's one-process step on the same weights and batch: the
    yardstick of every case."""
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths,
    )
    from megatron_tpu_torch.training.train_step import make_train_step

    model, opt, train, _ = configs(case)
    batch = batch or make_batch(case.get("model", MATRIX_MODEL))
    params = full_params(model)
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(opt, params)
    step = make_train_step(model, opt, train, GLOBAL_BATCH, STEPS)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "params": flat_numpy(state.params)}


def check_against_single_process(got: dict, case: dict) -> None:
    """A case's result against the port's one-process step: losses
    within 1e-4 and grad norms within a relative 1e-4 (the 5-step JAX
    parity's tolerances, tests/test_torch_train.py), the same numbers on
    every rank, and the final parameters within 1e-5."""
    want = single_process_steps(case)
    assert got["ranks_agree"]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-4)
    for path, x in want["params"].items():
        np.testing.assert_allclose(got["params"][path], x, atol=1e-5,
                                   err_msg=path)


def _unshard_all(model_cfg, mesh_sizes, grid, per_rank, vpp, pp):
    """The full parameters from every rank's flat slices."""
    from megatron_tpu_torch.models.params import (
        _glu_dim, param_specs, vpp_place_indices,
    )
    from megatron_tpu_torch.parallel.mesh import MESH_AXES
    from megatron_tpu_torch.parallel.sharding import unshard

    out = {}
    for path, spec in param_specs(model_cfg).items():
        def slice_at(coords, path=path):
            for stage in (coords["pipe"], pp - 1):
                c = dict(coords, pipe=stage)
                r = int(grid[tuple(c[a] for a in MESH_AXES)])
                if path in per_rank[r]:
                    return torch.from_numpy(per_rank[r][path])
            raise KeyError(path)

        glu = _glu_dim(path, model_cfg)
        x = unshard(slice_at, spec, mesh_sizes,
                    glu_dim=None if glu is None else len(spec) - 1)
        if vpp > 1 and path.startswith("layers/"):
            inv = vpp_place_indices(model_cfg.num_layers, pp, vpp)[1]
            x = x[torch.from_numpy(inv)]
        out[path] = x.numpy()
    return out


_MESHES: dict = {}


def parallel_steps(case: dict, batch=None):
    """The case on this world (every rank calls it)."""
    import torch.distributed as dist

    from megatron_tpu_torch.models.params import leaf_layout
    from megatron_tpu_torch.parallel.distributed import host_batch_slice
    from megatron_tpu_torch.parallel.mesh import (
        MESH_AXES, build_mesh, rank_grid,
    )
    from megatron_tpu_torch.models.params import shard_params
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths, nest_paths,
    )
    from megatron_tpu_torch.training.train_step import make_train_step

    model, opt, train, par = configs(case)
    if par not in _MESHES:      # new_group is collective and slow-ish
        _MESHES[par] = build_mesh(par)
    mesh = _MESHES[par]
    batch = batch or make_batch(case.get("model", MATRIX_MODEL))
    lo, hi = host_batch_slice(mesh, GLOBAL_BATCH)
    flat = flat_numpy(full_params(model))
    local = shard_params({k: torch.from_numpy(v) for k, v in flat.items()},
                         model, mesh)
    params = nest_paths(local)
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(opt, params, mesh=mesh,
                             layout=leaf_layout(model, mesh,
                                                opt.use_distributed_optimizer))
    n_micro = (hi - lo) // train.micro_batch_size
    step = make_train_step(model, opt, train, n_micro, STEPS, mesh=mesh)
    tb = {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    per_rank = [None] * mesh.world_size
    dist.all_gather_object(per_rank, flat_numpy(state.params))
    agree = [None] * mesh.world_size
    dist.all_gather_object(agree, (losses, norms))
    sizes = {a: mesh.size(a) for a in MESH_AXES}
    full = _unshard_all(model, sizes, rank_grid(par, mesh.world_size),
                        per_rank, mesh.vpp, mesh.pp)
    return {"losses": losses, "grad_norms": norms, "params": full,
            "ranks_agree": all(a == agree[0] for a in agree),
            "dp": mesh.dp}


def mappings_job():
    """Each autograd collective at tp2 (sequence parallel) against the
    unsharded math: forward values and input grads, max abs errors."""
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.parallel import mappings as mp_
    from megatron_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(ParallelConfig(tensor_parallel=2,
                                     sequence_parallel=True))
    n, r = mesh.tp, mesh.tp_rank
    g = torch.Generator().manual_seed(7)
    xs = [torch.randn(2, 8, 6, generator=g) for _ in range(n)]   # per rank
    gs = [torch.randn(2, 8, 6, generator=g) for _ in range(n)]   # grads
    err = {}

    def run(fn, x, grad):
        x = x.clone().requires_grad_(True)
        y = fn(x, mesh)
        y.backward(grad)
        return y.detach(), x.grad

    # copy_to_tp: identity forward, gradient summed over the group
    y, gx = run(mp_.copy_to_tp, xs[0], gs[r])
    err["copy_to_tp"] = max((y - xs[0]).abs().max(),
                            (gx - sum(gs)).abs().max()).item()
    # reduce_from_tp: sum forward, identity backward
    y, gx = run(mp_.reduce_from_tp, xs[r], gs[0])
    err["reduce_from_tp"] = max((y - sum(xs)).abs().max(),
                                (gx - gs[0]).abs().max()).item()
    # scatter_to_sp: own chunk forward, gather of the chunk grads backward
    chunk_g = [c.chunk(n, dim=1)[i] for i, c in enumerate(gs)]
    y, gx = run(mp_.scatter_to_sp, xs[0], chunk_g[r])
    err["scatter_to_sp"] = max(
        (y - xs[0].chunk(n, dim=1)[r]).abs().max(),
        (gx - torch.cat(chunk_g, dim=1)).abs().max()).item()
    # gather_from_sp: concatenation forward, reduce-scatter backward
    y, gx = run(mp_.gather_from_sp, xs[r].chunk(n, dim=1)[r], gs[r])
    want = torch.cat([xs[i].chunk(n, dim=1)[i] for i in range(n)], dim=1)
    err["gather_from_sp"] = max(
        (y - want).abs().max(),
        (gx - sum(gs).chunk(n, dim=1)[r]).abs().max()).item()
    # reduce_scatter_to_sp: own chunk of the sum forward, gather backward
    y, gx = run(mp_.reduce_scatter_to_sp, xs[r], chunk_g[r])
    err["reduce_scatter_to_sp"] = max(
        (y - sum(xs).chunk(n, dim=1)[r]).abs().max(),
        (gx - torch.cat(chunk_g, dim=1)).abs().max()).item()
    # at tp 1 (no mesh) every mapping is the very same tensor
    err["identity_at_tp1"] = float(not all(
        f(xs[0], None) is xs[0] for f in (
            mp_.copy_to_tp, mp_.reduce_from_tp, mp_.scatter_to_sp,
            mp_.gather_from_sp, mp_.reduce_scatter_to_sp)))
    dist.barrier()
    return err


def comm_job():
    """Both branches of the plain collectives (gloo's composed ones and
    the native *_single ones, which gloo takes on CPU tensors too) and
    p2p between two ranks that send to each other on both tags."""
    import torch.distributed as dist

    from megatron_tpu_torch.parallel import mappings as mp_

    group = dist.new_group([0, 1])
    r = dist.get_rank()
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(3, 4, 5, generator=g) for _ in range(2)]
    out = {"routes_gloo": not mp_._native(group)}
    total = xs[0] + xs[1]
    for dim in (0, 1, 2):
        if xs[r].shape[dim] % 2:
            continue
        want = total.chunk(2, dim=dim)[r]
        out[f"reduce_scatter_gloo_{dim}"] = (
            mp_._reduce_scatter_gloo(xs[r], group, dim) - want
        ).abs().max().item()
        out[f"reduce_scatter_native_{dim}"] = (
            mp_._reduce_scatter_native(xs[r], group, dim) - want
        ).abs().max().item()
    for dim in (0, 1, 2):
        want = torch.cat(xs, dim=dim)
        out[f"all_gather_gloo_{dim}"] = (
            mp_._all_gather_gloo(xs[r], group, dim) - want).abs().max().item()
        out[f"all_gather_native_{dim}"] = (
            mp_._all_gather_native(xs[r], group, dim) - want
        ).abs().max().item()
    out["all_reduce_max"] = (mp_.all_reduce(xs[r], group, "max")
                             - torch.maximum(*xs)).abs().max().item()
    peer = 1 - r
    act, grad = mp_.p2p(
        [(xs[r] + 1, peer, 1), (xs[r] + 2, peer, 2)],
        [((3, 4, 5), torch.float32, torch.device("cpu"), peer, 1),
         ((3, 4, 5), torch.float32, torch.device("cpu"), peer, 2)])
    out["p2p"] = max((act - xs[peer] - 1).abs().max(),
                     (grad - xs[peer] - 2).abs().max()).item()
    return out


def cross_entropy_job():
    """The vocab-parallel CE at tp2 against cross_entropy_loss on the
    whole logits: loss, per-token loss and the logits' grad, with and
    without label smoothing and z_loss."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.ops.cross_entropy import (
        cross_entropy_loss, vocab_parallel_cross_entropy,
    )
    from megatron_tpu_torch.parallel.mappings import all_gather
    from megatron_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(ParallelConfig(tensor_parallel=2))
    g = torch.Generator().manual_seed(11)
    logits = torch.randn(2, 5, 16, generator=g) * 3
    targets = torch.randint(0, 16, (2, 5), generator=g)
    mask = (torch.rand(2, 5, generator=g) > 0.3).float()
    out = {}
    for ls, z in ((0.0, 0.0), (0.1, 1e-3)):
        full = logits.clone().requires_grad_(True)
        want, want_tok = cross_entropy_loss(full, targets, mask, ls, z)
        want.backward()
        local = logits.chunk(2, dim=-1)[mesh.tp_rank].clone()
        local.requires_grad_(True)
        got, got_tok = vocab_parallel_cross_entropy(local, targets, mesh,
                                                    mask, ls, z)
        got.backward()
        grad = all_gather(local.grad, mesh.group("tensor"), 2)
        out[f"ls{ls}_z{z}"] = max(
            (got - want).abs().item(), (got_tok - want_tok).abs().max().item(),
            (grad - full.grad).abs().max().item())
    return out


JOBS = {"train": parallel_steps, "mappings": mappings_job,
        "comm": comm_job, "cross_entropy": cross_entropy_job}


def _worker(rank, world, port, jobs, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        for name, kind, arg in jobs:
            results[name] = (JOBS[kind](arg) if arg is not None
                             else JOBS[kind]())
    except Exception:  # noqa: BLE001 - reported to the test, then raised
        results["error"] = traceback.format_exc()
        raise
    finally:
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
        dist.destroy_process_group()


class World:
    """`world` gloo ranks on the CPU running `jobs` ([(name, kind,
    argument)]) in order, started at once; results() joins them and
    returns rank 0's {name: result}. The parent may compute meanwhile."""

    def __init__(self, world: int, jobs):
        import torch.multiprocessing as mp

        self._dir = tempfile.TemporaryDirectory()
        self._ctx = mp.spawn(_worker, args=(world, free_port(), list(jobs),
                                            self._dir.name),
                             nprocs=world, join=False)

    def results(self):
        try:
            while not self._ctx.join():
                pass
            return torch.load(os.path.join(self._dir.name, "results.pt"),
                              weights_only=False)
        finally:
            self._dir.cleanup()
