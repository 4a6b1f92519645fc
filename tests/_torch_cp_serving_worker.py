"""Gloo ranks serving with context parallelism on the CPU, for
tests/test_torch_cp_serving.py (run through _torch_parallel_worker.World's
"call" job). Imports torch and the port only (a spawned child must not
import JAX).

cells_job builds one ContextParallelEngine a matrix cell on a context
mesh of all the ranks (the same weights on every rank: an .npz of the
flat tree the test wrote, keys joined by ".") and drives the JAX test's
traffic through it from rank 0 while the other ranks follow the serving
channel: the 13-token ragged prompt (2 chunks, 8 new tokens), two
requests sharing a 24-token prefix (a radix hit whose stripe ends mid
shard), and a 40-token prompt preempted mid-prefill and resumed. It
returns each request's tokens and logprobs and each engine's stats.

collectives_job runs the quant collectives on the world group (or the
2d subgroups) on seeded inputs and returns what each rank got.
"""

from __future__ import annotations

import numpy as np

KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")
ENGINE = dict(num_slots=2, max_seq_len=64, page_size=8, prefill_chunk=8)
RAGGED = [3, 7, 11, 2, 9, 4, 1, 8, 5, 6, 2, 3, 7]
PREFIX = list(range(5, 29))            # 24 tokens = 3 full pages
TAILS = ([30, 31], [40, 41, 42])
NEW = 8
# the JAX test's cells (tests/test_context_parallel.py MATRIX)
CELLS = {
    "ring_serial_dense": dict(cp=2, cp_overlap=False),
    "ring_overlap_dense": dict(cp=2, cp_overlap=True),
    "ring_overlap_int8": dict(cp=2, cp_overlap=True, cp_collectives="int8"),
    "2d_dense": dict(cp=4, cp_geometry="2d", cp_subgroup=2),
    "2d_int8": dict(cp=4, cp_geometry="2d", cp_subgroup=2,
                    cp_collectives="int8"),
}
STAT_KEYS = ("cp_ring_steps", "cp_comm_dense_bytes",
             "cp_comm_compressed_bytes", "cp_comm_a2a_dense_bytes",
             "cp_comm_a2a_compressed_bytes", "prefix_hits", "preemptions",
             "prefill_chunks", "ticks")


def preempt_prompt(seed: int):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 64, 40)]


def load_tree(weights: str) -> dict:
    tree: dict = {}
    for path, v in dict(np.load(weights)).items():
        node = tree
        parts = path.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return tree


def _request(prompt, n):
    from megatron_tpu_torch.inference.engine import Request

    return Request(prompt=np.asarray(prompt, np.int32), max_new_tokens=n)


def _run(eng, prompt, n=6):
    req = eng.submit(_request(prompt, n))
    eng.run_until_idle()
    assert req.error is None, req.error
    return req


def _traffic(eng, preempt_seed: int) -> dict:
    """Rank 0: the JAX test's three scenarios on one engine."""
    out = {}
    g = eng.generate(np.asarray([RAGGED], np.int32),
                     np.asarray([len(RAGGED)], np.int32),
                     max_new_tokens=NEW, temperature=0.0)
    out["fresh"] = {"tokens": g.tokens.tolist(),
                    "logprobs": g.logprobs.tolist()}
    _run(eng, PREFIX + TAILS[0])
    hits0 = eng.stats["prefix_hits"]
    got = _run(eng, PREFIX + TAILS[1])
    out["radix"] = {"generated": got.generated, "logprobs": got.logprobs,
                    "prompt_logprobs": got.prompt_logprobs,
                    "hit": eng.stats["prefix_hits"] > hits0}
    req = eng.submit(_request(preempt_prompt(preempt_seed), 6))
    eng.step()                       # admit + first chunk
    eng.step()                       # second chunk (5 chunks of 8)
    mid = eng.prefill_queue.peek() is not None
    pre0 = eng.stats["preemptions"]
    preempted = eng._preempt_one()
    eng.run_until_idle()
    assert req.error is None, req.error
    out["preempt"] = {"generated": req.generated, "logprobs": req.logprobs,
                      "mid_prefill": mid, "preempted": preempted,
                      "preemptions": eng.stats["preemptions"] - pre0}
    out["stats"] = {k: eng.stats.get(k) for k in STAT_KEYS}
    return out


def cells_job(weights: str, cells, preempt_seed: dict):
    """Each cell's engine on a context mesh of the whole world: rank 0
    drives _traffic, the others follow; returns rank 0's results by
    cell, and each rank's stripe size."""
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.inference.context_parallel import (
        ContextParallelEngine,
    )
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import params_from_numpy
    from megatron_tpu_torch.parallel.distributed import ServingChannel
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    cfg = presets.tiny(**KW)
    world = dist.get_world_size()
    mesh = build_mesh(ParallelConfig(context_parallel=world))
    params = params_from_numpy(load_tree(weights), cfg, device="cpu",
                               mesh=mesh)
    out = {}
    for cell in cells:
        spec = dict(CELLS[cell])
        spec.pop("cp")
        ch = ServingChannel(mesh.control_group, mesh.rank)
        eng = ContextParallelEngine(
            cfg, params, device="cpu", cuda_graph=False,
            metrics=MetricsRegistry(), mesh=mesh, channel=ch, **ENGINE,
            **spec)
        if mesh.rank != 0:
            while True:
                op, payload = ch.recv()
                if op == "stop":
                    break
                if op == "tick":
                    eng.follow(payload)
            continue
        try:
            out[cell] = _traffic(eng, preempt_seed[cell])
            out[cell]["pool_pages_per_rank"] = eng.pool.pages_per_rank
            out[cell]["local_pool_pages"] = eng.caches[0].shape[1]
        finally:
            ch.stop()
    return out


def collectives_job(seed: int = 0):
    """The quant collectives on the world group (2 ranks: psum,
    all-gather, ring hop; 4 ranks: the 2d legs in subgroups of 2), each
    rank's input drawn from `seed` + its rank; returns every rank's
    outputs."""
    import torch
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.quant import collectives as qc

    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.from_numpy(np.random.default_rng(seed + rank).standard_normal(
        (2, 4, 64)).astype(np.float32))
    mine = {}
    if world == 2:
        group = dist.group.WORLD
        for mode in ("dense", "int8", "fp8"):
            mine[f"psum_{mode}"] = qc.compressed_psum(x, group, mode, 16)
            mine[f"gather_{mode}"] = qc.compressed_all_gather(x, group, mode,
                                                              16)
            mine[f"ring_{mode}"] = qc.ring_permute(x, group,
                                                   [(0, 1), (1, 0)], mode,
                                                   16)
    else:
        mesh = build_mesh(ParallelConfig(context_parallel=world))
        cpc = qc.make_cp_comm(mesh, "int8", geometry="2d", subgroup=2)
        for mode in ("dense", "int8"):
            mine[f"a2a_{mode}"] = qc.grouped_all_to_all(
                x, cpc.sub_group, split_axis=1, concat_axis=0, mode=mode,
                chunk=16)
            mine[f"ag_{mode}"] = qc.grouped_all_gather(
                x, cpc.sub_group, gather_axis=1, mode=mode, chunk=16)
            perm = [(r, (r + 2) % world) for r in range(world)]
            mine[f"ring_{mode}"] = qc.ring_permute(x, cpc.group, perm, mode,
                                                   16)
    views = [None] * world
    dist.all_gather_object(views, {k: v.numpy() for k, v in mine.items()})
    return views


def http_job(weights: str):
    """The HTTP server on rank 0 of a cp2 mesh with the context-parallel
    engine (run_server with cp_serving), rank 1 in the follower loop: a
    greedy request, and a scoring request, which context parallelism
    does not serve (400)."""
    import threading

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.inference.server import (
        GenerationService, run_server,
    )
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import params_from_numpy
    from megatron_tpu_torch.parallel.distributed import ServingChannel
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer

    from _torch_tp_serving_worker import _put

    cfg = presets.tiny(**KW)
    mesh = build_mesh(ParallelConfig(context_parallel=2))
    params = params_from_numpy(load_tree(weights), cfg, device="cpu",
                               mesh=mesh)
    kw = dict(engine_slots=2, engine_max_seq_len=64, device="cpu",
              kv_paging=True, page_size=8, prefill_chunk=8, mesh=mesh,
              channel=ServingChannel(mesh.control_group, mesh.rank),
              cuda_graph=False, cp_serving=True, cp_collectives="int8")
    tok = NullTokenizer(cfg.vocab_size)
    if mesh.rank != 0:
        GenerationService(cfg, params, tok, metrics=MetricsRegistry(),
                          **kw).follow()
        return None
    ready, box = threading.Event(), []
    th = threading.Thread(target=run_server, daemon=True, kwargs=dict(
        cfg=cfg, params=params, tokenizer=tok, host="127.0.0.1", port=0,
        ready=ready, service_out=box, **kw))
    th.start()
    assert ready.wait(60)
    port = box[1].server_address[1]
    prompt = " ".join(str(t) for t in RAGGED)
    try:
        out = {"generate": _put(port, {"prompts": [prompt],
                                       "tokens_to_generate": NEW,
                                       "temperature": 0.0}),
               "score": _put(port, {"prompts": [prompt],
                                    "tokens_to_generate": 0}),
               "engine": type(box[0].engine).__name__,
               "stats": dict(box[0].engine.stats)}
    finally:
        box[1].shutdown()
        th.join(60)
    return out
