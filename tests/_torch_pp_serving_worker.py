"""Gloo ranks on the CPU serving at pp2, tp2 x pp2 and with the paged
engine at tp2, for tests/test_torch_pp_serving.py (run through
_torch_parallel_worker.World's "call" job). Imports torch and the port
only (a spawned child must not import JAX).

Every job loads one weight set (an .npz of the flat tree the test
wrote, keys joined by ".") as this rank's slices and returns rank 0's
outputs:

  * pp_job (2 ranks, pp2): generate_tokens through the pipelined
    forward on the JAX pipelined test's case and on a ragged greedy
    batch with logprobs, score_tokens, and the HTTP server on rank 0
    with rank 1 following (greedy text, scoring, beam search's 400);
  * tp2_pp2_job (4 ranks): the same one-shot calls at tp2 x pp2;
  * paged_job (2 ranks, tp2): the paged engine driven by rank 0
    through a ServingChannel, over a pool small enough to preempt and
    a second request that hits the prefix cache, with model-dtype and
    int8 pools;
  * families_job (2 ranks, tp2): Falcon-40B's block and the post-LN
    block served at tp2, one-shot and on the dense engine.
"""

from __future__ import annotations

import threading

import numpy as np

import _torch_tp_serving_worker as S

# tests/test_inference.py's pipelined case (its tiny config)
KW = dict(vocab_size=64, seq_length=64)
JAX_PROMPTS = np.asarray([[5, 11, 3], [9, 2, 0]], np.int32)
JAX_LENGTHS = np.asarray([3, 2], np.int32)
JAX_CASE = dict(max_new_tokens=6, top_k=1, eod=63, want_logprobs=False)
# the ragged greedy batch (S.PROMPTS) and the scored one
SCORED = np.where(np.arange(S.PROMPTS.shape[1])[None] < S.LENGTHS[:, None],
                  S.PROMPTS, S.VOCAB - 1)
# the paged engine's pool: 9 usable pages of 4 tokens cannot hold the
# first pair's two 25-token sequences (6 pages each), so the younger is
# preempted; the third request shares the first's two full pages
PAGED = dict(num_slots=2, max_seq_len=32, page_size=4, prefill_chunk=8,
             num_pages=10)
PAIR = (np.asarray([[3, 7, 11, 2, 9, 4, 1, 8, 5], [5, 8, 1, 6, 2, 7, 0, 0,
                                                   0]], np.int32),
        np.asarray([9, 6], np.int32))
PAIR_NEW = 16
HIT = (np.asarray([[3, 7, 11, 2, 9, 4, 1, 8, 6, 2]], np.int32),
       np.asarray([10], np.int32))


def setup(weights: str, tp: int = 1, pp: int = 1, kw=None):
    """(cfg, this rank's params, mesh) at tp x pp."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import params_from_numpy
    from megatron_tpu_torch.parallel.mesh import build_mesh

    cfg = presets.tiny(**(kw or KW))
    mesh = build_mesh(ParallelConfig(tensor_parallel=tp,
                                     pipeline_parallel=pp))
    flat = dict(np.load(weights))
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return cfg, params_from_numpy(tree, cfg, device="cpu", mesh=mesh), mesh


def _one_shot(cfg, params, mesh):
    from megatron_tpu_torch.inference import generation as g

    out = {"jax_case": S._out(g.generate_tokens(
        cfg, params, JAX_PROMPTS, JAX_LENGTHS, mesh=mesh, **JAX_CASE))}
    out["greedy"] = S._out(g.generate_tokens(
        cfg, params, S.PROMPTS, S.LENGTHS, S.NEW, temperature=0.0,
        vocab_size=S.VOCAB, mesh=mesh))
    out["score"] = g.score_tokens(cfg, params, SCORED, mesh=mesh).tolist()
    beams, scores = g.beam_search_tokens(
        cfg, params, S.PROMPTS[0, :S.LENGTHS[0]], mesh=mesh, **S.BEAM)
    out["beam"] = {"beams": beams.tolist(), "scores": scores.tolist()}
    return out


def pp_job(weights: str):
    """The one-shot calls and the HTTP server at pp2."""
    cfg, params, mesh = setup(weights, pp=2)
    out = _one_shot(cfg, params, mesh)
    out["ranks_agree"] = S._agree(out)
    out["http"] = _http(cfg, params, mesh)
    return out


def tp2_pp2_job(weights: str):
    """The one-shot calls at tp2 x pp2 on four ranks."""
    cfg, params, mesh = setup(weights, tp=2, pp=2)
    out = _one_shot(cfg, params, mesh)
    out["ranks_agree"] = S._agree(out)
    return out


def _http(cfg, params, mesh):
    """The server at pp2 on rank 0, rank 1 following: greedy text with
    logprobs, scoring, and beam search (refused)."""
    from megatron_tpu_torch.inference.server import (
        GenerationService, run_server,
    )
    from megatron_tpu_torch.parallel.distributed import ServingChannel
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer

    tok = NullTokenizer(S.VOCAB - 1)
    kw = dict(engine_slots=0, device="cpu", mesh=mesh, cuda_graph=False,
              channel=ServingChannel(mesh.control_group, mesh.rank))
    if mesh.rank != 0:
        GenerationService(cfg, params, tok, metrics=MetricsRegistry(),
                          **kw).follow()
        return None
    prompt = " ".join(str(t) for t in S.PROMPTS[0, :S.LENGTHS[0]])
    ready, box = threading.Event(), []
    th = threading.Thread(target=run_server, kwargs=dict(
        cfg=cfg, params=params, tokenizer=tok, host="127.0.0.1", port=0,
        ready=ready, service_out=box, **kw), daemon=True)
    th.start()
    assert ready.wait(60)
    port = box[1].server_address[1]
    out = {}
    try:
        out["generate"] = S._put(port, {
            "prompts": [prompt], "tokens_to_generate": S.NEW,
            "temperature": 0.0, "logprobs": True})
        out["score"] = S._put(port, {"prompts": [prompt],
                                     "tokens_to_generate": 0,
                                     "logprobs": True})
        out["beam"] = S._put(port, {"prompts": [prompt],
                                    "tokens_to_generate": 4,
                                    "beam_width": 2})
    finally:
        box[1].shutdown()
        th.join(60)
    return out


def paged_job(weights: str):
    """The paged engine at tp2: a greedy pair that preempts, then a
    sampled request that hits the prefix cache, for model-dtype and
    int8 pools; rank 1 follows."""
    cfg, params, mesh = setup(weights, tp=2, kw=S.KW)
    out = {}
    for int8 in (False, True):
        svc = S._service(cfg, params, mesh, kv_paging=True, page_size=4,
                         prefill_chunk=8, num_pages=10, kv_cache_int8=int8,
                         engine_max_seq_len=32)
        if mesh.rank != 0:
            svc.follow()
            continue
        try:
            eng = svc.engine
            out[f"pair_{int8}"] = S._out(eng.generate(*PAIR, PAIR_NEW))
            out[f"hit_{int8}"] = S._out(eng.generate(
                *HIT, 8, temperature=1.0, top_k=4, seed=11))
            out[f"stats_{int8}"] = dict(eng.stats)
        finally:
            svc.shutdown()
    return out


# the served forms of tests/test_torch_parallel_families.py's blocks
FAMILIES = {
    "falcon40": dict(parallel_attn=True, parallel_layernorm=True,
                     normalization="layernorm", activation="gelu",
                     tie_embed_logits=True),
    "post_ln": dict(use_post_ln=True, normalization="layernorm"),
}


def family_params(form: str, mesh=None):
    """(cfg, params) of a family's tiny form from seed 0: whole, or this
    rank's slices."""
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params

    cfg = presets.tiny(**S.KW, **FAMILIES[form])
    return cfg, init_params(cfg, 0, device="cpu", mesh=mesh)


def families_job():
    """Each family at tp2: greedy generate_tokens, and the dense engine
    driven by rank 0 (rank 1 follows)."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.inference import generation as g
    from megatron_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(ParallelConfig(tensor_parallel=2))
    out = {}
    for form in FAMILIES:
        cfg, params = family_params(form, mesh)
        out[f"{form}_generate"] = S._out(g.generate_tokens(
            cfg, params, S.PROMPTS, S.LENGTHS, S.NEW, temperature=0.0,
            vocab_size=S.VOCAB, mesh=mesh))
        svc = S._service(cfg, params, mesh)
        if mesh.rank != 0:
            svc.follow()
            continue
        try:
            out[f"{form}_engine"] = S._out(svc.engine.generate(
                S.PROMPTS, S.LENGTHS, S.NEW))
        finally:
            svc.shutdown()
    return out
