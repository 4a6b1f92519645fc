"""REST text-generation server (counterpart of
megatron_tpu/inference/server.py), on the stdlib http.server.

PUT/POST /api takes the JAX server's request schema:

  {"prompts": [...], "tokens_to_generate": N, "temperature": T,
   "top_k": K, "top_p": P, "add_BOS": bool, "logprobs": bool,
   "random_seed": S, "spec": bool, "deadline_s": F,
   "beam_width": W, "length_penalty": F}

and answers {"text": [...], "segments": [...], "logprobs": [...]?,
"weights_version": N?}. Three execution models behind the schema:

  * engine_slots > 0: sampling requests go through the continuous-
    batching InferenceEngine, or with kv_paging the PagedInferenceEngine
    (shared page pool, radix prefix cache, chunked prefill, preemption),
    so concurrent handlers share each decode tick; with speculative (a
    SpecConfig) the engine speculates (inference/speculative.py), and
    "spec": false keeps a request to one token a tick. kv_cache_int8
    makes the engine's caches int8 (ops/kv_quant.py).
  * engine_slots == 0: the reference's shape, one request at a time
    under a lock through the one-shot loop (generation.generate_tokens).
  * "beam_width" (beam search, one prompt) and "tokens_to_generate": 0
    (scoring: teacher-forced logprobs of the prompts) always take the
    one-shot path under the lock.

Request lifecycle: engine_max_queue bounds the engine's queue (a full
queue answers 503 with Retry-After); request_timeout is the server's
deadline and a request's "deadline_s" may shorten it but never extend it
(an expired deadline answers 504 with "timeout": true). "weights_version"
names the checkpoint iteration that served the request, only when it did
not change between submit and completion.

Probes and the control plane:

  GET  /metrics          the metrics registry, Prometheus text format
  GET  /healthz          liveness ("the step loop exists"); stays 200
                         through warmup, drains and reloads
  GET  /readyz           readiness: 503 until warmup() has run, while
                         draining or reloading, and while the step loop
                         has work but makes no progress
  GET  /admin/status     ready/draining/reloading/weights_version and the
                         engine's stats
  POST /admin/drain      {"timeout_s": F, "handoff": [urls]?}: stop
                         admitting (new /api requests answer 503 +
                         Retry-After); with handoff peers (the field, or
                         the server's peers) migrate the requests in
                         flight and queued to them, else wait for the
                         engine and any one-shot request to finish
  POST /admin/readmit    {}: resume admission
  POST /admin/reload     {"load": DIR?, "iteration": N?}: hot weight
                         reload from a manifest-verified checkpoint
                         (inference/fleet/reload.py) swapped in between
                         decode ticks; 409 when no checkpoint verifies
  POST /admin/import     <binary frame>: a migrated request's state
                         (inference/fleet/migration.py), run to
                         completion here, its output returned; 409 on a
                         torn or corrupt frame
  POST /admin/export_prefix {"tokens": [...]}: a radix-cached prefix's
                         pages as a binary frame (404 when not cached)
  POST /admin/import_prefix <binary frame>: install exported prefix
                         pages into this replica's radix cache
  POST /admin/register_prefix {"tokens": [...]}: make a prefix radix-
                         resident (one greedy token primes it if not)
  POST /admin/profile    {"steps": N, "timeout_s": F?, "dir": D?}: a
                         torch.profiler capture of N decode ticks under
                         live traffic into profile_dir (--serve_profile_
                         dir), as the loop's --profile window writes it
                         (decode_tick ranges); 409 while another runs

A drain with handoff walks each request down the JAX server's ladder:
migrate (the whole state, KV included, to a peer's /admin/import; the
peer finishes it and the client's response is completed from the
peer's output), recompute (the same frame without the KV), retry (no
peer took it: the request fails as overloaded, a 503 the fleet router
re-runs) and reject (the drain budget is spent: 504). Greedy and seeded
requests resume token-identically (the engines' migration).

Parallel serving (a MeshRuntime as `mesh` and a
parallel/distributed.ServingChannel): one GenerationService per rank,
each over its slices of the params. Rank 0 binds the HTTP port and
runs the engine's step thread; a one-shot request is announced on the
channel (the function's name and arguments) and then run, and either
engine announces each tick's control record (inference/engine.py,
inference/paging/engine.py). The other ranks run follow(): the same
calls, in rank 0's order, until shutdown() sends the stop. Under tensor
parallelism the engine's tick runs eagerly (no CUDA graph). Under
pipeline parallelism (pp > 1) the one-shot paths run the pipelined
forward (inference/pipelined.py), as on the JAX server: the engine,
int8 KV caches and beam search (a 400) are refused there.
/admin/reload is refused at more than one rank, as on the JAX server's
mesh.

Context-parallel serving (cp_serving, a mesh with a context axis) runs
generation through the ContextParallelEngine
(inference/context_parallel/); the one-shot paths (scoring, beam search,
engine_slots 0) are refused there with a 400.

Not ported yet: context-parallel lanes (--serve_cp_lanes).
"""

from __future__ import annotations

import json
import math
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.api import (
    ONE_SHOT, beam_search_and_post_process, generate_and_post_process,
    run_direct,
)
from megatron_tpu_torch.inference.engine import (
    EngineOverloadedError, InferenceEngine, RequestTimeoutError,
)
from megatron_tpu_torch.inference.fleet.reload import (
    NoValidCheckpointError, load_verified_params,
)
from megatron_tpu_torch.inference.generation import (
    check_one_shot, pipelined,
)
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.models.params import empty_params
from megatron_tpu_torch.ops.flash import flash_template
from megatron_tpu_torch.ops.weight_quant import (
    quantize_params_for_serving, quantized_mode,
)
from megatron_tpu_torch.telemetry.metrics import (
    MetricsRegistry, default_registry,
)
from megatron_tpu_torch.training.optimizer import tree_map

MAX_TOKENS_TO_GENERATE = 1024
MAX_PROMPTS = 128
#: Retry-After on 503s (full queue, draining): about one decode tick's
#: wait is enough for a slot to free in steady traffic
RETRY_AFTER_SECONDS = 1
#: /readyz turns 503 when the step loop has work but no progress for this
#: long (a hung device call keeps the thread alive)
STALL_THRESHOLD_SECONDS = 10.0
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ServiceDrainingError(RuntimeError):
    """The server is draining (SIGTERM grace or a rolling update): new
    requests answer 503 + Retry-After."""


class GenerationService:
    """Engine construction, request handling and the control plane behind
    the HTTP layer."""

    def __init__(self, cfg: ModelConfig, params: Any, tokenizer,
                 engine_slots: int = 8, engine_max_seq_len=None,
                 metrics: Optional[MetricsRegistry] = None, device="cuda",
                 kv_paging: bool = False, page_size: int = 16,
                 prefill_chunk: int = 32, num_pages: Optional[int] = None,
                 speculative: Optional[SpecConfig] = None,
                 kv_cache_int8: bool = False,
                 engine_max_queue: Optional[int] = None,
                 request_timeout: Optional[float] = None,
                 reload_dir: Optional[str] = None,
                 weights_version: Optional[int] = None,
                 warmup: bool = False, mesh=None, channel=None,
                 cuda_graph: bool = True,
                 compress_collectives: str = "none",
                 comm_policy: Optional[str] = None,
                 cp_serving: bool = False, cp_collectives: str = "dense",
                 cp_comm_policy: Optional[str] = None,
                 cp_geometry: str = "ring", cp_subgroup: int = 0,
                 cp_overlap: bool = True, peers: Optional[list] = None,
                 profile_dir: Optional[str] = None):
        """engine_slots > 0 builds the engine (kv_paging: the paged one,
        with page_size-token pages, prefill_chunk-token chunks and a pool
        of num_pages pages) and its step-loop thread; 0 serves one
        request at a time through the one-shot loop on the params'
        device. speculative turns on speculative decoding in the engine;
        kv_cache_int8 int8 caches on either path. engine_max_queue
        bounds the engine's queue (503 + Retry-After beyond it).
        request_timeout: the server's deadline for engine requests (504
        past it). reload_dir: the default checkpoint dir of
        /admin/reload; weights_version: the iteration served at start.
        warmup=True keeps /readyz at 503 until warmup() has run. A
        weight-quantized params tree (ops/weight_quant.py) is reloaded in
        its own mode: the checkpoint's weights are read on the host and
        quantized into the served tensors. mesh, channel: parallel
        serving (the module docstring); the engine then runs eagerly, and
        only rank 0's service starts its step thread; a mesh with pp > 1
        serves one-shot only. cuda_graph: the engine's (False: an eager
        tick).

        compress_collectives ("none" | "int8" | "fp8";
        --serve_compress_collectives) and comm_policy (a site-policy JSON
        path): the engine's compressed tensor-parallel collectives
        (quant/collectives.py; a no-op at tp 1). cp_serving
        (--serve_context_parallel): the ContextParallelEngine over the
        mesh's context axis (needs kv_paging; int8 KV and speculation
        refused), with cp_collectives ("dense" | "int8" | "fp8") the ring
        hop's transport, cp_comm_policy its site policy, cp_geometry
        "ring" or "2d" (cp_subgroup = cp_head), cp_overlap the overlapped
        ring schedule. peers: the base URLs a drain hands its requests
        off to; profile_dir: /admin/profile's default output directory."""
        if engine_slots < 0:
            raise ValueError("engine_slots must be >= 0 (0: one-shot)")
        if speculative is not None and not engine_slots:
            raise ValueError("speculative decoding runs inside the "
                             "continuous-batching engine: serve with "
                             "engine_slots > 0")
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.kv_cache_int8 = bool(kv_cache_int8)
        self.request_timeout = request_timeout
        self.reload_dir = reload_dir
        self.weights_version = weights_version
        self.weight_quant = quantized_mode(params)
        self.device = torch.device(device)
        self.mesh = (mesh if mesh is not None and mesh.world_size > 1
                     else None)
        self.channel = channel if self.mesh is not None else None
        # fails at construction, not on every request
        self.pipelined = pipelined(self.mesh, kv_cache_int8)
        self.leads = self.mesh is None or self.mesh.rank == 0
        self.draining = False
        self.reloading = False
        # readiness gate: set once warmup() ran (or no warmup was asked)
        self._warmed = threading.Event()
        # one admin mutation (drain/readmit/reload) at a time
        self._admin_lock = threading.Lock()
        # one-shot requests (and a reload's swap) run one at a time
        self.lock = threading.Lock()
        self.metrics = metrics if metrics is not None else default_registry()
        self._m_requests = self.metrics.counter(
            "server_requests_total", "API requests by outcome",
            label_names=("status",))
        self._m_latency = self.metrics.histogram(
            "server_request_seconds", "API request wall time")
        self.peers = [str(p).rstrip("/") for p in (peers or [])]
        self.profile_dir = profile_dir or os.path.join("runs",
                                                      "serve_profile")
        self._m_migrations = self.metrics.counter(
            "server_migrations_total",
            "request handoffs by degradation-ladder outcome",
            label_names=("outcome",))
        # migration frames' wire bytes, apart from the engine's
        # TP-collective byte counters
        self._m_migrate_bytes = self.metrics.counter(
            "server_migrate_wire_bytes_total",
            "KV-state migration wire bytes (manifest cost model)",
            label_names=("direction",))
        self.engine = None
        if cp_serving and not (engine_slots and kv_paging):
            raise ValueError("context-parallel serving runs over the paged "
                             "engine: engine_slots > 0 and kv_paging")
        if engine_slots:
            kw = dict(num_slots=engine_slots, max_seq_len=engine_max_seq_len,
                      vocab_size=tokenizer.vocab_size, metrics=self.metrics,
                      device=device, speculative=speculative,
                      kv_cache_int8=kv_cache_int8,
                      max_queue=engine_max_queue, cuda_graph=cuda_graph,
                      compress_collectives=compress_collectives,
                      comm_policy=comm_policy)
            if self.mesh is not None:
                kw.update(mesh=self.mesh, channel=self.channel)
            if cp_serving:
                from megatron_tpu_torch.inference.context_parallel import (
                    ContextParallelEngine,
                )

                self.engine = ContextParallelEngine(
                    cfg, params, page_size=page_size,
                    prefill_chunk=prefill_chunk, num_pages=num_pages,
                    cp_collectives=cp_collectives,
                    cp_comm_policy=cp_comm_policy, cp_geometry=cp_geometry,
                    cp_subgroup=cp_subgroup, cp_overlap=cp_overlap, **kw)
            elif kv_paging:
                self.engine = PagedInferenceEngine(
                    cfg, params, page_size=page_size,
                    prefill_chunk=prefill_chunk, num_pages=num_pages, **kw)
            else:
                self.engine = InferenceEngine(cfg, params, **kw)
            if self.leads:
                self.engine.start()
        if self.channel is not None and self.leads:
            self.channel.start_heartbeat()
        if not (warmup and self.engine is not None):
            self._warmed.set()

    def shutdown(self) -> None:
        """Stop the engine; at tp > 1 (rank 0) then stop the followers."""
        try:
            if self.engine is not None:
                self.engine.stop()
        finally:
            if self.channel is not None and self.leads:
                self.channel.stop()

    def _run(self, name: str, cfg, params, **kwargs):
        """A one-shot token function: at more than one rank checked,
        then announced to the other ranks, and run under the channel's
        lock."""
        if self.channel is None:
            return run_direct(name, cfg, params, **kwargs)
        if self.mesh.cp > 1:
            raise ValueError(
                f"{name} is not served under context parallelism: the "
                "one-shot forward has no striped cache (the engine serves "
                "generation requests)")
        check_one_shot(name, cfg, **kwargs)
        with self.channel.announce(name, kwargs):
            return ONE_SHOT[name](cfg, params, mesh=self.mesh, **kwargs)

    def follow(self) -> None:
        """A follower rank's loop (rank > 0 at tp > 1): each command rank
        0 announces, in its order, until the stop. Rank 0 checked the
        request before announcing it, so a command that fails here is a
        fault of the group: it propagates and ends the process (the
        launcher then tears the group down, and rank 0's next collective
        fails)."""
        while True:
            op, payload = self.channel.recv()
            if op == "stop":
                return
            if op == "tick":
                self.engine.follow(payload)
            elif op != "idle":
                ONE_SHOT[op](self.cfg, self.params, mesh=self.mesh,
                             **payload)

    # ----- control plane ---------------------------------------------------

    def warmup(self) -> None:
        """One throwaway request through the engine (its first prefill
        bucket and decode ticks; on CUDA the kernels build at first use),
        then readiness turns green. run_server calls it on a side thread
        so probes get answers meanwhile."""
        if self.engine is not None and not self._warmed.is_set():
            self.engine.generate(np.array([[1]], np.int32),
                                 np.array([1], np.int32), max_new_tokens=2)
        self._warmed.set()

    def ready(self) -> tuple:
        """(ok, detail) for /readyz: 503 while unwarmed, draining,
        mid-reload, or when the step loop has pending work but stopped
        making progress."""
        detail: dict = {"warmed": self._warmed.is_set(),
                        "draining": self.draining,
                        "reloading": self.reloading}
        ok = detail["warmed"] and not self.draining and not self.reloading
        if self.engine is not None:
            t = self.engine._thread
            alive = t is None or t.is_alive()
            stalled = self.engine.stalled(STALL_THRESHOLD_SECONDS)
            detail["step_loop_alive"] = alive
            detail["stalled"] = stalled
            ok = ok and alive and not stalled
        if self.weights_version is not None:
            detail["weights_version"] = self.weights_version
        detail["ok"] = ok
        return ok, detail

    @staticmethod
    def _journal(kind: str, **fields) -> None:
        from megatron_tpu_torch.telemetry import journal

        j = journal.get_global_journal()
        if j is not None:
            j.emit(kind, **fields)

    def drain(self, timeout_s: float = 30.0,
              handoff_urls: Optional[list] = None) -> bool:
        """Stop admitting (new /api requests answer 503 + Retry-After) and
        wait for the work in flight: the engine's requests, then any
        one-shot request (beam search, scoring, the engine-less path)
        under self.lock. True when drained within timeout_s. Probes and
        admin requests keep answering; readmit() undoes it. With handoff
        peers (handoff_urls, else the server's peers) the engine's
        requests in flight and queued are migrated to them first
        (migrate_out) instead of waited on."""
        with self._admin_lock:
            self.draining = True
            peers = [str(p).rstrip("/") for p in
                     (handoff_urls if handoff_urls else self.peers)]
            self._journal("serve_drain_begin", timeout_s=timeout_s,
                          handoff_peers=len(peers))
            deadline = time.monotonic() + timeout_s
            if peers and self.engine is not None:
                self.migrate_out(peers, timeout_s=timeout_s)
            drained = (self.engine.wait_idle(
                timeout=max(deadline - time.monotonic(), 0.001))
                if self.engine is not None else True)
            if drained:
                drained = self.lock.acquire(
                    timeout=max(deadline - time.monotonic(), 0.001))
                if drained:
                    self.lock.release()
            self._journal("serve_drain_done", drained=drained)
            return drained

    def readmit(self) -> None:
        """Resume admission after a drain."""
        with self._admin_lock:
            self.draining = False
            self._journal("serve_readmit")

    # ----- KV-state migration ------------------------------------------------

    def migrate_out(self, peers: list, timeout_s: float = 30.0) -> dict:
        """Hand every engine request in flight or queued to a peer:
        export_all_requests empties the engine (the waiters stay blocked
        on req.done), then each request walks the ladder (_handoff_one)
        and its waiter is completed or failed. Returns {outcome: count}."""
        if self.mesh is not None:
            raise ValueError("a drain's handoff exports a one-rank "
                             "engine's requests (not wired above one rank)")
        deadline = time.monotonic() + timeout_s
        exported = self.engine.export_all_requests()
        outcomes: dict = {}
        for req, meta, sections in exported:
            budget = max(deadline - time.monotonic(), 0.0)
            outcome = self._handoff_one(req, meta, sections, peers, budget)
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            self._m_migrations.inc(outcome=outcome)
        if exported:
            self._journal("serve_handoff", requests=len(exported),
                          peers=len(peers), **outcomes)
        return outcomes

    def _handoff_one(self, req, meta: dict, sections: dict, peers: list,
                     budget_s: float) -> str:
        """One request down the ladder (the module docstring): migrate,
        recompute, retry, reject. Each rung's attempt is journaled
        (serve_migrate stage "handoff") and the outcome (stage
        "handoff_done"). Returns the outcome's label."""
        from megatron_tpu_torch.inference.fleet import migration
        from megatron_tpu_torch.training import resilience

        deadline = time.monotonic() + budget_s

        def _done(outcome: str) -> str:
            self._journal("serve_migrate", stage="handoff_done",
                          outcome=outcome, prompt_len=len(req.prompt),
                          generated=len(req.generated))
            return outcome

        rungs = []
        if "kv" in meta:
            rungs.append(("migrate", meta, sections))
        rungs.append(("recompute",
                      {k: v for k, v in meta.items() if k != "kv"},
                      {k: v for k, v in sections.items()
                       if not k.startswith("kv_")}))
        for rung, m, sec in rungs:
            if deadline - time.monotonic() <= 0:
                break
            blob = migration.pack_state(m, sec)
            # migrate_fail:N tears the first N outbound frames: the
            # peer's crc check rejects each, and the ladder goes on
            blob = resilience.maybe_corrupt("migrate_fail", blob)
            for peer in peers:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                t0 = time.monotonic()
                status, body = migration.post_blob(
                    peer + "/admin/import", blob, timeout=remaining)
                ok = status == 200 and isinstance(body, dict)
                fields = {"stage": "handoff", "rung": rung, "ok": ok,
                          "peer": peer, "status": status,
                          "wire_bytes": len(blob),
                          "wall_s": round(time.monotonic() - t0, 3)}
                if not ok:
                    err = (body or {}).get("message") or (
                        body or {}).get("error")
                    if err:
                        fields["error"] = str(err)[:200]
                self._journal("serve_migrate", **fields)
                if not ok:
                    continue
                self._m_migrate_bytes.inc(len(blob), direction="out")
                req.generated[:] = [int(t) for t in
                                    body.get("generated", [])]
                if body.get("logprobs") is not None:
                    req.logprobs[:] = [float(x) for x in body["logprobs"]]
                plp = body.get("prompt_logprobs")
                if plp and not req.prompt_logprobs:
                    req.prompt_logprobs = [float(x) for x in plp]
                req._finish()
                return _done("migrated" if body.get("path") == "kv_import"
                             else "recomputed")
        if time.monotonic() >= deadline:
            self._journal("serve_migrate", stage="handoff", rung="reject",
                          ok=False, reason="drain budget spent")
            self.engine._fail_timeout(req, "migrating")
            return _done("rejected")
        self._journal("serve_migrate", stage="handoff", rung="retry",
                      ok=True)
        req.overloaded = True
        req._finish("handoff failed on every peer; the request is "
                    "retryable (the fleet router re-runs it: greedy and "
                    "seeded requests replay identically)")
        return _done("retried")

    def import_state(self, blob: bytes) -> dict:
        """POST /admin/import: verify the frame (a torn one raises
        MigrationIntegrityError before the engine is touched), rebuild
        the request in the engine (KV install or recompute-resume), run
        it to completion and return its output for the exporter."""
        from megatron_tpu_torch.inference.fleet import migration

        if self.engine is None:
            raise ValueError("state import needs the continuous-batching "
                             "engine (engine_slots > 0)")
        if self.draining:
            raise ServiceDrainingError(
                "server is draining; migrate elsewhere")
        meta, sections = migration.unpack_state(blob)
        if meta.get("kind") != "request":
            raise ValueError(
                f"expected a request-state frame, got {meta.get('kind')!r}")
        self._m_migrate_bytes.inc(len(blob), direction="in")
        req, path = self.engine.import_request_state(meta, sections)
        budget = meta.get("deadline_remaining_s")
        if budget is None:
            budget = self.request_timeout or 60.0
        if not req.done.wait(timeout=float(budget) + 5.0):
            raise RequestTimeoutError("imported request did not complete "
                                      "within its migrated deadline")
        if req.timed_out:
            raise RequestTimeoutError(req.error or "deadline exceeded")
        if req.error:
            raise ValueError(req.error)
        return {"path": path,
                "generated": [int(t) for t in req.generated],
                "logprobs": [float(x) for x in req.logprobs],
                "prompt_logprobs": [float(x) for x in req.prompt_logprobs]}

    def _paged_engine(self):
        if self.engine is None or not hasattr(self.engine,
                                              "export_prefix_state"):
            raise ValueError("prefix export/import needs the paged engine "
                             "(kv_paging)")
        return self.engine

    def export_prefix_blob(self, tokens: list) -> Optional[bytes]:
        """A cached prefix's pages as a frame (/admin/export_prefix);
        None when the radix cache holds nothing of it (404)."""
        from megatron_tpu_torch.inference.fleet import migration

        out = self._paged_engine().export_prefix_state(
            [int(t) for t in tokens])
        if out is None:
            return None
        blob = migration.pack_state(*out)
        self._m_migrate_bytes.inc(len(blob), direction="out")
        return blob

    def import_prefix_blob(self, blob: bytes) -> dict:
        """/admin/import_prefix: install a prefix frame into the radix
        cache, so the next prompt sharing it hits here."""
        from megatron_tpu_torch.inference.fleet import migration

        eng = self._paged_engine()
        meta, sections = migration.unpack_state(blob)
        if meta.get("kind") != "prefix":
            raise ValueError(
                f"expected a prefix frame, got {meta.get('kind')!r}")
        self._m_migrate_bytes.inc(len(blob), direction="in")
        pages = eng.import_prefix_state(meta, sections)
        self._journal("serve_prefix_import", pages=pages,
                      wire_bytes=len(blob))
        return {"pages": pages}

    def register_prefix(self, tokens: list) -> dict:
        """/admin/register_prefix: make a prefix (a system prompt)
        radix-resident here, priming it with one greedy token if it is
        not; the router then fans its pages out (replicate_prefix)."""
        eng = self._paged_engine()
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("tokens: non-empty int list required")
        pages, _ = eng.prefix_cache.lookup(toks)
        if len(pages) < len(toks) // eng.page_size:
            eng.generate(np.array([toks], np.int32),
                         np.array([len(toks)], np.int32), max_new_tokens=1)
            pages, _ = eng.prefix_cache.lookup(toks)
        self._journal("serve_prefix_register", tokens=len(toks),
                      pages=len(pages))
        return {"pages": len(pages), "tokens": len(toks)}

    def profile(self, steps: int = 4, timeout_s: float = 30.0,
                out_dir: Optional[str] = None) -> dict:
        """/admin/profile: a torch.profiler capture of `steps` decode
        ticks under live traffic (engine.capture_trace), journaled
        (profile_begin / profile_end, or profile_aborted)."""
        if self.engine is None:
            raise ValueError("on-demand profiling needs the continuous-"
                             "batching engine (engine_slots > 0)")
        steps = int(steps)
        if not 1 <= steps <= 10_000:
            raise ValueError("steps must be in [1, 10000]")
        timeout_s = float(timeout_s)
        if not 0 < timeout_s <= 600:
            raise ValueError("timeout_s must be in (0, 600]")
        out = out_dir or self.profile_dir
        self._journal("profile_begin", source="admin", dir=out, steps=steps)
        try:
            result = self.engine.capture_trace(out, ticks=steps,
                                               timeout_s=timeout_s)
        except BaseException as e:  # noqa: BLE001 - journaled, re-raised
            self._journal("profile_aborted", source="admin",
                          reason=type(e).__name__, flushed=False)
            raise
        self._journal("profile_end", source="admin", **result)
        return result

    def reload(self, load: Optional[str] = None,
               iteration: Optional[int] = None,
               apply_timeout_s: float = 60.0) -> int:
        """Hot weight reload: manifest-verify a committed checkpoint
        (fleet/reload.py; a torn save raises NoValidCheckpointError),
        stage it with engine.update_params and wait for the swap between
        ticks. The engine copies the weights into its own tensors, which
        are this service's params too, so the one-shot paths serve them
        as well; the swap holds self.lock so no one-shot request reads
        half-copied weights. Returns the iteration now served."""
        if self.mesh is not None:
            raise ValueError(
                "hot reload under tensor parallelism (or pipeline "
                "parallelism) is not supported (as "
                "on the JAX server's mesh): roll the replica instead "
                "(restart with the new checkpoint)")
        with self._admin_lock:
            src = load or self.reload_dir
            if not src:
                raise ValueError(
                    "no checkpoint dir to reload from: pass \"load\" in "
                    "the request or start the server with reload_dir=")
            self.reloading = True
            try:
                params, it = self._load_reload_params(src, iteration)
                with self.lock:
                    if self.engine is not None:
                        applied = self.engine.update_params(params,
                                                            version=it)
                        if not applied.wait(timeout=apply_timeout_s):
                            raise RuntimeError(
                                f"weight swap staged but not applied "
                                f"within {apply_timeout_s}s: is the step "
                                "loop wedged? (/readyz would say)")
                    else:
                        self.params = params
                self.weights_version = it
                return it
            finally:
                self.reloading = False

    def _load_reload_params(self, src: str, iteration: Optional[int]):
        """(params, iteration) of a reload, in the served tree's form: a
        quantized server reads the checkpoint into a host template and
        quantizes it there (no second model-sized tree on the card), and
        the engine's swap copies the result into the served tensors."""
        if not self.weight_quant:
            return load_verified_params(src, self.params,
                                        iteration=iteration)
        params, it = load_verified_params(
            src, empty_params(self.cfg, device="cpu"), iteration=iteration)
        params = quantize_params_for_serving(params, self.weight_quant)
        if self.engine is None:
            params = tree_map(lambda t: t.to(self.device), params)
        return params, it

    def admin_status(self) -> dict:
        ok, detail = self.ready()
        out = {"ready": ok, "detail": detail, "draining": self.draining,
               "reloading": self.reloading,
               "weights_version": self.weights_version}
        if self.engine is not None:
            out["engine"] = dict(self.engine.stats)
        # the flash kernels' launches in this process (a fleet's chip
        # check sums them over its replicas); a captured tick's replays
        # are added by the engine (inference/cuda_graph.py)
        out["kernel_launches"] = flash_template.launch_counts()
        return out

    # ----- requests --------------------------------------------------------

    def handle(self, req: dict) -> dict:
        if self.draining:
            raise ServiceDrainingError("server is draining; retry")
        prompts = req.get("prompts")
        if not isinstance(prompts, list) or not prompts:
            raise ValueError("prompts: non-empty list of strings required")
        if len(prompts) > MAX_PROMPTS:
            raise ValueError(f"at most {MAX_PROMPTS} prompts per request")
        if not all(isinstance(p, str) and p for p in prompts):
            raise ValueError("prompts must be non-empty strings")
        n = int(req.get("tokens_to_generate", 64))
        if not 0 <= n <= MAX_TOKENS_TO_GENERATE:
            raise ValueError(
                f"tokens_to_generate in [0, {MAX_TOKENS_TO_GENERATE}]")

        if req.get("beam_width"):
            if self.pipelined:
                raise ValueError(
                    "beam search is not supported on pipelined (pp>1) "
                    "serving; use sampling or serve at pp=1")
            with self.lock:
                texts, segments, scores = beam_search_and_post_process(
                    self.cfg, self.params, self.tokenizer, prompts,
                    tokens_to_generate=n, beam_size=int(req["beam_width"]),
                    add_BOS=bool(req.get("add_BOS", False)),
                    length_penalty=float(req.get("length_penalty", 1.0)),
                    kv_cache_int8=self.kv_cache_int8, run=self._run)
            return {"text": texts, "segments": segments,
                    "scores": [float(s) for s in scores]}

        # scoring (n == 0) takes the one-shot teacher-forced pass
        use_engine = self.engine is not None and n > 0
        # a request may shorten the server's deadline but never extend
        # past it: a client (an explicit null included) cannot opt out
        deadline_s = req.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                raise ValueError("deadline_s must be a number (seconds)")
            # NaN would pass every comparison and never expire
            if not math.isfinite(deadline_s):
                raise ValueError("deadline_s must be a finite number "
                                 "(seconds)")
        if self.request_timeout is not None:
            deadline_s = (self.request_timeout if deadline_s is None
                          else min(deadline_s, self.request_timeout))
        spec = req.get("spec", True)
        if not isinstance(spec, bool):
            raise ValueError("spec must be a JSON boolean")

        def generate():
            v0 = self.weights_version
            texts, segments, logprobs, _ = generate_and_post_process(
                self.cfg, self.params, self.tokenizer, prompts,
                tokens_to_generate=n,
                temperature=float(req.get("temperature", 1.0)),
                top_k_sampling=int(req.get("top_k", 0)),
                top_p_sampling=float(req.get("top_p", 0.0)),
                add_BOS=bool(req.get("add_BOS", False)),
                return_output_log_probs=bool(req.get("logprobs", False)),
                random_seed=int(req.get("random_seed", 0)),
                kv_cache_int8=self.kv_cache_int8,
                engine=self.engine if use_engine else None,
                deadline_s=deadline_s if use_engine else None, spec=spec,
                run=self._run)
            out = {"text": texts, "segments": segments}
            if logprobs is not None:
                out["logprobs"] = [list(map(float, row)) for row in logprobs]
            # claimed only when it cannot lie: the same version before
            # submit and after completion
            if v0 is not None and v0 == self.weights_version:
                out["weights_version"] = v0
            return out

        if use_engine:
            return generate()
        with self.lock:
            return generate()


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _read_body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))

        def _reply_blob(self, blob: bytes):
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _handle(self):
            path = self.path.split("?", 1)[0]
            if path.startswith("/admin/"):
                self._handle_admin(path)
                return
            t0 = time.monotonic()
            status = "500"
            retry = (("Retry-After", str(RETRY_AFTER_SECONDS)),)
            try:
                req = self._read_json()
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                payload = service.handle(req)
                status = "200"
                self._reply(200, payload)
            except ServiceDrainingError as e:
                status = "503"
                self._reply(503, {"message": str(e), "draining": True},
                            headers=retry)
            except EngineOverloadedError as e:
                # bounded admission: a fast 503 clients can back off on
                status = "503"
                self._reply(503, {"message": str(e)}, headers=retry)
            except RequestTimeoutError as e:
                status = "504"
                self._reply(504, {"message": str(e), "timeout": True})
            except ValueError as e:
                status = "400"
                self._reply(400, {"message": str(e)})
            except Exception as e:  # noqa: BLE001 - server must not die
                self._reply(500, {"message": f"internal error: {e}"})
            finally:
                service._m_requests.inc(status=status)
                service._m_latency.observe(time.monotonic() - t0)

        def _handle_admin(self, path: str):
            from megatron_tpu_torch.inference.fleet.migration import (
                MigrationIntegrityError,
            )

            retry = (("Retry-After", str(RETRY_AFTER_SECONDS)),)
            if path in ("/admin/import", "/admin/import_prefix"):
                # migration frames are binary, never read through JSON
                try:
                    blob = self._read_body()
                    self._reply(200, service.import_state(blob)
                                if path == "/admin/import"
                                else service.import_prefix_blob(blob))
                except MigrationIntegrityError as e:
                    # torn or corrupt: the exporter's ladder goes on
                    self._reply(409, {"message": str(e), "torn": True})
                except ServiceDrainingError as e:
                    self._reply(503, {"message": str(e)}, headers=retry)
                except RequestTimeoutError as e:
                    self._reply(504, {"message": str(e), "timeout": True})
                except ValueError as e:
                    self._reply(400, {"message": str(e)})
                except Exception as e:  # noqa: BLE001 - must not die
                    self._reply(500, {"message": f"admin failed: {e}"})
                return
            try:
                req = self._read_json()
                if not isinstance(req, dict):
                    raise ValueError
            except ValueError:
                self._reply(400, {"message": "admin body must be a JSON "
                                             "object"})
                return
            try:
                if path == "/admin/drain":
                    drained = service.drain(float(req.get("timeout_s", 30.0)),
                                            handoff_urls=req.get("handoff"))
                    self._reply(200, {"drained": drained, "draining": True})
                elif path == "/admin/readmit":
                    service.readmit()
                    self._reply(200, {"draining": False})
                elif path == "/admin/reload":
                    version = service.reload(load=req.get("load"),
                                             iteration=req.get("iteration"))
                    self._reply(200, {"version": version})
                elif path == "/admin/profile":
                    try:
                        self._reply(200, service.profile(
                            steps=int(req.get("steps", 4)),
                            timeout_s=float(req.get("timeout_s", 30.0)),
                            out_dir=req.get("dir")))
                    except RuntimeError as e:
                        # another capture owns the profiler: conflict
                        self._reply(409, {"message": str(e)})
                elif path == "/admin/export_prefix":
                    blob = service.export_prefix_blob(req.get("tokens")
                                                      or [])
                    if blob is None:
                        self._reply(404, {"message": "prefix not cached "
                                                     "here"})
                    else:
                        self._reply_blob(blob)
                elif path == "/admin/register_prefix":
                    self._reply(200, service.register_prefix(
                        req.get("tokens") or []))
                else:
                    self._reply(404, {"message": "POST /admin/{drain,"
                                      "readmit,reload,profile,import,"
                                      "export_prefix,import_prefix,"
                                      "register_prefix}"})
            except NoValidCheckpointError as e:
                # an operator or checkpoint problem, not a server fault
                self._reply(409, {"message": str(e)})
            except ValueError as e:
                self._reply(400, {"message": str(e)})
            except Exception as e:  # noqa: BLE001 - server must not die
                self._reply(500, {"message": f"admin failed: {e}"})

        do_PUT = _handle
        do_POST = _handle

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                body = service.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/healthz":
                t = service.engine._thread if service.engine else None
                alive = t is None or t.is_alive()
                self._reply(200 if alive else 500,
                            {"ok": bool(alive),
                             "engine": service.engine is not None})
            elif path == "/readyz":
                ok, detail = service.ready()
                self._reply(200 if ok else 503, detail)
            elif path == "/admin/status":
                self._reply(200, service.admin_status())
            else:
                self._reply(404, {"message": "GET serves /metrics, "
                                             "/healthz, /readyz, "
                                             "/admin/status; the API is "
                                             "PUT/POST /api"})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def run_server(cfg: ModelConfig, params: Any, tokenizer,
               host: str = "0.0.0.0", port: int = 5000,
               engine_slots: int = 8, engine_max_seq_len=None,
               device="cuda", ready: Optional[threading.Event] = None,
               service_out: Optional[list] = None, kv_paging: bool = False,
               page_size: int = 16, prefill_chunk: int = 32,
               num_pages: Optional[int] = None,
               speculative: Optional[SpecConfig] = None,
               kv_cache_int8: bool = False,
               engine_max_queue: Optional[int] = None,
               request_timeout: Optional[float] = None,
               drain_timeout: float = 30.0, warmup: bool = False,
               reload_dir: Optional[str] = None,
               weights_version: Optional[int] = None, mesh=None,
               channel=None, cuda_graph: bool = True,
               port_file: Optional[str] = None, **engine_kw) -> None:
    """Serve until ``server.shutdown()`` or a signal; port=0 binds an
    ephemeral port. In-process callers may pass `service_out` (a list
    that receives (service, server)) and `ready` (set once listening).
    The other arguments go to GenerationService.

    Run from the main thread, SIGTERM and SIGINT start a graceful drain:
    stop admitting (503 + Retry-After), finish the requests in flight
    within drain_timeout seconds, then exit; a second signal exits at
    once with 128 + signum. warmup=True runs GenerationService.warmup()
    on a side thread, so /healthz and /readyz answer meanwhile. At more
    than one rank this is rank 0's (the other ranks run
    GenerationService.follow). port_file: the bound port is published
    there as {"port", "pid"} (written whole, then renamed), for a parent
    that bound port 0 (inference/fleet/replica.py). engine_kw:
    GenerationService's compressed-collective, context-parallel, peers
    and profile_dir keywords."""
    service = GenerationService(
        cfg, params, tokenizer, engine_slots=engine_slots,
        engine_max_seq_len=engine_max_seq_len, device=device,
        kv_paging=kv_paging, page_size=page_size,
        prefill_chunk=prefill_chunk, num_pages=num_pages,
        speculative=speculative, kv_cache_int8=kv_cache_int8,
        engine_max_queue=engine_max_queue, request_timeout=request_timeout,
        reload_dir=reload_dir, weights_version=weights_version,
        warmup=warmup, mesh=mesh, channel=channel, cuda_graph=cuda_graph,
        **engine_kw)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    bound_port = server.server_address[1]
    if port_file:
        tmp = port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"port": bound_port, "pid": os.getpid()}, f)
        os.replace(tmp, port_file)
    if service_out is not None:
        service_out.extend([service, server])

    received: list = []

    def _graceful(signum, frame):
        if received:
            # a second signal: the drain is presumed wedged, exit now
            sys.stderr.write(
                f"received {signal.Signals(signum).name} after "
                f"{signal.Signals(received[0]).name}; exiting without "
                "waiting for the drain\n")
            sys.stderr.flush()
            os._exit(128 + signum)
        received.append(signum)

        def _shutdown():
            drained = service.drain(drain_timeout)
            print(f"drain {'complete' if drained else 'TIMED OUT'}; "
                  "shutting down", flush=True)
            server.shutdown()

        # the drain blocks for seconds: off the signal handler
        threading.Thread(target=_shutdown, daemon=True,
                         name="drain-on-signal").start()

    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, _graceful)

    if warmup and service.engine is not None:
        def _warmup():
            try:
                service.warmup()
            except Exception as e:  # noqa: BLE001 - readiness stays red,
                # and the reason must reach the log
                sys.stderr.write(f"warmup failed: {e}\n")
                sys.stderr.flush()

        threading.Thread(target=_warmup, daemon=True,
                         name="serve-warmup").start()

    if engine_slots:
        mode = (f"paged KV, {page_size}-token pages, {prefill_chunk}-token "
                "prefill chunks" if kv_paging else "continuous batching")
        if speculative:
            mode += f", speculative {speculative.drafter} k={speculative.k}"
        mode += f", {engine_slots} slots"
    else:
        mode = "one-shot"
    if kv_cache_int8:
        mode += ", int8 KV"
    if service.mesh is not None:
        backend = torch.distributed.get_backend()
        mode += (f", tensor parallel {service.mesh.tp} x pipeline "
                 f"{service.mesh.pp} x context {service.mesh.cp} over "
                 f"{backend}")
    if service.engine is not None and service.engine.tp_comm is not None:
        mode += f", {service.engine.tp_comm.mode} TP collectives"
    if service.channel is not None:
        # a fault of the tensor-parallel group stops the server, and the
        # process ends non-zero (below), so the launcher tears it down
        service.channel.on_fault = lambda e: threading.Thread(
            target=server.shutdown, daemon=True).start()
    print(f"serving generation API on http://{host}:{bound_port}/api "
          f"({mode}, {device})", flush=True)
    if ready is not None:
        ready.set()
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.shutdown()
    if service.channel is not None and service.channel.fault is not None:
        raise RuntimeError("the tensor-parallel group failed: "
                           f"{service.channel.fault}") \
            from service.channel.fault
