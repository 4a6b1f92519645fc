"""Two gloo ranks serving at tp2 on the CPU, for
tests/test_torch_tp_serving.py (run through _torch_parallel_worker.World's
"call" job). Imports torch and the port only (a spawned child must not
import JAX).

Every job loads the same weights (an .npz of the flat tree the test
wrote, keys joined by ".") as this rank's slices and returns rank 0's
outputs (the one-shot and load jobs also `ranks_agree`): the server's
load_model at tp2, the one-shot functions called on both ranks, the
dense engine driven by rank 0 through a ServingChannel (three
concurrent requests of different lengths over two slots), and the HTTP
server on rank 0 with the follower loop on rank 1.

fault_rank runs one rank of the server's CLI (tools/
run_text_generation_server.main, as torch.distributed.run starts it)
with a fault planted, and writes what it saw to a JSON file per rank.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np

KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")
VOCAB = 65                     # the null tokenizer's: the eod id is 64
PROMPTS = np.array([[5, 9, 11, 2, 40, 17, 3, 8, 21, 30, 1],
                    [7, 1, 30, 0, 0, 0, 0, 0, 0, 0, 0],
                    [2, 2, 45, 63, 12, 6, 0, 0, 0, 0, 0]], np.int32)
LENGTHS = np.array([11, 3, 6], np.int32)
NEW = 7
# (temperature, top_k, seed): greedy and seeded top-k
SAMPLING = {"greedy": (0.0, 0, 0), "top_k": (1.0, 4, 11)}
BEAM = dict(max_new_tokens=5, beam_size=3, eod=VOCAB - 1)


def setup(weights: str):
    """(cfg, this rank's params, mesh) at tp2."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import params_from_numpy
    from megatron_tpu_torch.parallel.mesh import build_mesh

    cfg = presets.tiny(**KW)
    mesh = build_mesh(ParallelConfig(tensor_parallel=2))
    flat = dict(np.load(weights))
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return cfg, params_from_numpy(tree, cfg, device="cpu", mesh=mesh), mesh


def _agree(mine):
    import torch.distributed as dist

    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, mine)
    return all(json.dumps(v, sort_keys=True) == json.dumps(views[0],
                                                           sort_keys=True)
               for v in views)


def _out(o):
    return {"tokens": o.tokens.tolist(), "lengths": o.lengths.tolist(),
            "logprobs": o.logprobs.tolist()}


def oneshot_job(weights: str):
    """generate_tokens (greedy and top-k, model-dtype and int8 caches),
    score_tokens and beam_search_tokens at tp2."""
    from megatron_tpu_torch.inference import generation as g

    cfg, params, mesh = setup(weights)
    out = {}
    for int8 in (False, True):
        for name, (temp, k, seed) in SAMPLING.items():
            o = g.generate_tokens(cfg, params, PROMPTS, LENGTHS, NEW,
                                  temperature=temp, top_k=k,
                                  vocab_size=VOCAB, seed=seed,
                                  kv_cache_int8=int8, mesh=mesh)
            out[f"generate_{name}_int8_{int8}"] = _out(o)
        beams, scores = g.beam_search_tokens(
            cfg, params, PROMPTS[0, :LENGTHS[0]], kv_cache_int8=int8,
            mesh=mesh, **BEAM)
        out[f"beam_int8_{int8}"] = {"beams": beams.tolist(),
                                    "scores": scores.tolist()}
    padded = np.where(np.arange(PROMPTS.shape[1])[None] < LENGTHS[:, None],
                      PROMPTS, VOCAB - 1)
    out["score"] = g.score_tokens(cfg, params, padded, mesh=mesh).tolist()
    out["ranks_agree"] = _agree(out)
    return out


def load_job(weights: str, load: str):
    """The server's load_model at tp2: from `load` (a world-1 checkpoint
    of the same weights) and, without --load, from the seed; each rank's
    slices against the training path's cut of the whole tree."""
    from megatron_tpu_torch.models.params import init_params, shard_params
    from megatron_tpu_torch.tools import run_text_generation_server as rts
    from megatron_tpu_torch.training.optimizer import leaf_paths

    cfg, want, mesh = setup(weights)
    out = {}
    for name, argv in (("load", ["--load", load]),
                       ("seed", ["--model_name", "tiny", "--seed", "3"])):
        args = rts.parse_args(argv + ["--device", "cpu",
                                      "--tensor_model_parallel_size", "2"])
        got_cfg, got, _ = rts.load_model(args, mesh, log=lambda m: None)
        if name == "seed":
            want = shard_params(dict(leaf_paths(init_params(
                got_cfg, 3, device="cpu"))), got_cfg, mesh)
        else:
            want = dict(leaf_paths(want))
        got = dict(leaf_paths(got))
        out[name] = sorted(set(got)) == sorted(set(want)) and all(
            t.dtype == want[n].dtype and bool((t == want[n]).all())
            for n, t in got.items())
    out["ranks_agree"] = _agree(out)
    return out


def _service(cfg, params, mesh, **kw):
    from megatron_tpu_torch.inference.server import GenerationService
    from megatron_tpu_torch.parallel.distributed import ServingChannel
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer

    kw.setdefault("engine_slots", 2)
    kw.setdefault("engine_max_seq_len", 64)
    return GenerationService(
        cfg, params, NullTokenizer(cfg.vocab_size),
        device="cpu", metrics=MetricsRegistry(), mesh=mesh,
        channel=ServingChannel(mesh.control_group, mesh.rank),
        cuda_graph=False, **kw)


def engine_job(weights: str):
    """The dense engine at tp2: three concurrent requests (greedy and
    seeded top-k rows, prompts of 11, 3 and 6 tokens) through two slots,
    with model-dtype and int8 caches; rank 1 follows."""
    cfg, params, mesh = setup(weights)
    out = {}
    for int8 in (False, True):
        svc = _service(cfg, params, mesh, kv_cache_int8=int8)
        if mesh.rank != 0:
            svc.follow()
            continue
        try:
            for name, (temp, k, seed) in SAMPLING.items():
                o = svc.engine.generate(PROMPTS, LENGTHS, NEW,
                                        temperature=temp, top_k=k,
                                        seed=seed)
                out[f"engine_{name}_int8_{int8}"] = _out(o)
            out[f"stats_int8_{int8}"] = dict(svc.engine.stats)
        finally:
            svc.shutdown()
    return out


def _put(port, body, path="/api", method="PUT"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_job(weights: str):
    """The HTTP server at tp2 on rank 0 (the engine, then engine_slots
    0), rank 1 in the follower loop: greedy generation, scoring, beam
    search, and POST /admin/reload refused."""
    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.parallel.distributed import ServingChannel
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg, params, mesh = setup(weights)
    prompt = " ".join(str(t) for t in PROMPTS[0, :LENGTHS[0]])
    out = {}
    for slots in (2, 0):
        if mesh.rank != 0:
            _service(cfg, params, mesh, engine_slots=slots).follow()
            continue
        ready, box = threading.Event(), []
        th = threading.Thread(target=run_server, kwargs=dict(
            cfg=cfg, params=params, tokenizer=NullTokenizer(VOCAB - 1),
            host="127.0.0.1", port=0, engine_slots=slots,
            engine_max_seq_len=64, device="cpu", ready=ready,
            service_out=box, mesh=mesh, cuda_graph=False,
            channel=ServingChannel(mesh.control_group, 0)),
            daemon=True)
        th.start()
        assert ready.wait(60)
        port = box[1].server_address[1]
        try:
            out[f"generate_{slots}"] = _put(port, {
                "prompts": [prompt], "tokens_to_generate": NEW,
                "temperature": 0.0, "logprobs": True})
            out[f"score_{slots}"] = _put(port, {
                "prompts": [prompt], "tokens_to_generate": 0,
                "logprobs": True})
            out[f"beam_{slots}"] = _put(port, {
                "prompts": [prompt], "tokens_to_generate": 5,
                "beam_width": 3})
            out[f"reload_{slots}"] = _put(port, {}, "/admin/reload", "POST")
        finally:
            box[1].shutdown()
            th.join(60)
    return out


FAULT_ARGV = ["--model_name", "tiny", "--seed", "0", "--tokenizer_type",
              "null", "--device", "cpu", "--tensor_model_parallel_size", "2",
              "--serve_num_slots", "2", "--host", "127.0.0.1", "--port", "0"]


def fault_rank(rank: int, port: int, fault: str, out_dir: str) -> None:
    """One rank of a two-rank CLI server with `fault` planted on rank 0:

      * "missed_clear": with two requests decoding, slot 0 is cleared
        and the clear left out of the next control record;
      * "rank0_dies": after one request is served, rank 0's process ends
        at once (os._exit);
      * "paged_chunk_fails": the paged engine (--serve_kv_paging), whose
        follower fails the first prefill chunk rank 0 announces.

    Each rank writes {"error", "seconds"} to rank<r>.json: the exception
    that ended its main() (None if it returned) and when, on the
    monotonic clock since the fault. The exception still ends the
    process, non-zero."""
    import torch

    from megatron_tpu_torch.inference.engine import Request
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    seen = {"error": None, "seconds": None, "request": None}
    path = os.path.join(out_dir, f"rank{rank}.json")
    stamp = os.path.join(out_dir, "fault_at")

    def write(e=None):
        seen["error"] = None if e is None else f"{type(e).__name__}: {e}"
        if os.path.exists(stamp):
            with open(stamp) as f:
                seen["seconds"] = time.monotonic() - float(f.read())
        with open(path, "w") as f:
            json.dump(seen, f)

    argv = FAULT_ARGV
    if fault == "paged_chunk_fails":
        argv = argv + ["--serve_kv_paging", "--serve_page_size", "8",
                       "--serve_prefill_chunk", "8"]
    if rank != 0:
        if fault == "paged_chunk_fails":
            from megatron_tpu_torch.inference.paging import (
                PagedInferenceEngine,
            )

            def broken(self, *a, **k):
                with open(stamp, "w") as f:
                    f.write(str(time.monotonic()))
                raise RuntimeError("injected: a follower's chunk failed")

            PagedInferenceEngine._chunk_forward = broken
        try:
            rts.main(argv)
        except BaseException as e:
            write(e)
            raise
        write()
        return

    ready, box, ended = threading.Event(), [], []

    def serve():
        try:
            rts.main(argv, ready=ready, service_out=box)
        except BaseException as e:  # noqa: BLE001 - what the test reads
            ended.append(e)
        else:
            ended.append(None)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert ready.wait(60)
    svc = box[0]
    engine = svc.engine
    if fault == "paged_chunk_fails":
        req = engine.submit(Request(prompt=np.array([5, 9, 11], np.int32),
                                    max_new_tokens=4))
        req.done.wait(60)
        seen["request"] = req.error
        th.join(60)
        write(ended[0] if ended else RuntimeError("main() still running"))
        if ended and ended[0] is not None:
            raise ended[0]
        return
    if fault == "rank0_dies":
        svc.handle({"prompts": ["5 9 11"], "tokens_to_generate": 4,
                    "temperature": 0.0})
        with open(stamp, "w") as f:
            f.write(str(time.monotonic()))
        os._exit(9)
    reqs = [engine.submit(Request(prompt=np.array([5, 9, 11], np.int32),
                                  max_new_tokens=120)) for _ in range(2)]
    while engine.num_active < 2:
        time.sleep(0.001)
    with svc.channel.lock:          # between two ticks
        engine._clear_slot(0)       # a rank-0 decision ...
        engine._cleared.clear()     # ... that the record misses
        with open(stamp, "w") as f:
            f.write(str(time.monotonic()))
    reqs[1].done.wait(60)
    seen["request"] = reqs[1].error
    th.join(60)
    write(ended[0] if ended else RuntimeError("main() still running"))
    if ended and ended[0] is not None:
        raise ended[0]


# the compressed-collective cases (quant/): the JAX test's geometry
# (tests/test_quant_comm.py tiny_cfg, its teacher-forced tokens)
QCFG = dict(num_layers=4, hidden_size=32, num_attention_heads=4,
            num_kv_heads=2, ffn_hidden_size=64, vocab_size=128,
            seq_length=32, params_dtype="float32")
QTOKENS = np.random.default_rng(0).integers(1, 128, (8, 32)).astype(np.int32)
QPROMPTS = np.random.default_rng(1).integers(1, 128, (4, 8)).astype(np.int32)
QNEW = 12


def compress_job(weights: str):
    """lm_forward at tp2 on QTOKENS with no plan (its vocab-parallel
    logits gathered densely) and with a dense, int8 and fp8 TpComm; then
    the dense engine and an int8-compressed one at tp2 (4 greedy prompts
    of 8 tokens x QNEW, rank 1 following), with the compressed engine's
    counters and the byte model's prices of its tick and prefill."""
    import torch

    from megatron_tpu_torch.config import ModelConfig, ParallelConfig
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.models.params import params_from_numpy
    from megatron_tpu_torch.parallel.mappings import all_gather
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.quant.collectives import (
        forward_comm_bytes, make_tp_comm,
    )

    cfg = ModelConfig(**QCFG).validate()
    mesh = build_mesh(ParallelConfig(tensor_parallel=2))
    tree: dict = {}
    for path, v in dict(np.load(weights)).items():
        node = tree
        parts = path.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    params = params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
    toks = torch.from_numpy(QTOKENS).long()
    out = {}
    with torch.no_grad():
        local = lm_forward(cfg, params, toks, mesh=mesh)
        out["logits_none"] = all_gather(local, mesh.group("tensor"),
                                        -1).numpy()
        for mode in ("dense", "int8", "fp8"):
            tpc = make_tp_comm(mesh, mode, cfg=cfg)
            out[f"logits_{mode}"] = lm_forward(cfg, params, toks, mesh=mesh,
                                               tp_comm=tpc).numpy()
    for mode in ("none", "int8"):
        svc = _service(cfg, params, mesh, engine_slots=4,
                       engine_max_seq_len=32, compress_collectives=mode)
        if mesh.rank != 0:
            svc.follow()
            continue
        try:
            eng = svc.engine
            o = eng.generate(QPROMPTS, np.full(4, 8, np.int32), QNEW)
            out[f"engine_{mode}"] = _out(o)
            out[f"stats_{mode}"] = dict(eng.stats)
            out[f"tick_bytes_{mode}"] = forward_comm_bytes(
                cfg, eng.tp_comm, 4, 1)
            out[f"prefill_bytes_{mode}"] = forward_comm_bytes(
                cfg, eng.tp_comm, 1, eng._bucket(8))
        finally:
            svc.shutdown()
    return out
