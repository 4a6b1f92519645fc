"""REST text-generation server (counterpart of
megatron_tpu/inference/server.py), on the stdlib http.server.

PUT/POST /api takes the JAX server's request schema:

  {"prompts": [...], "tokens_to_generate": N, "temperature": T,
   "top_k": K, "top_p": P, "add_BOS": bool, "logprobs": bool,
   "random_seed": S, "spec": bool}

and answers {"text": [...], "segments": [...], "logprobs": [...]?}.
Every request goes through the continuous-batching InferenceEngine, or
with kv_paging through the PagedInferenceEngine (shared page pool, radix
prefix cache, chunked prefill, preemption), so concurrent handlers share
each decode tick. With speculative (a SpecConfig: "ngram" or "model")
either engine speculates (inference/speculative.py); "spec": false in a
request keeps it to one token a tick. GET /metrics serves the metrics
registry in Prometheus text format, GET /healthz is liveness
("the step loop exists"), GET /readyz readiness (503 while the step
loop has work but makes no progress).

Not ported yet: the one-shot path (engine_slots == 0), beam search,
scoring, warmup, bounded queues and deadlines, int8 caches, sharded
serving and the fleet control plane (/admin/*).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.api import generate_and_post_process
from megatron_tpu_torch.inference.engine import InferenceEngine
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.telemetry.metrics import (
    MetricsRegistry, default_registry,
)

MAX_TOKENS_TO_GENERATE = 1024
MAX_PROMPTS = 128
#: /readyz turns 503 when the step loop has work but no progress for this
#: long (a hung device call keeps the thread alive)
STALL_THRESHOLD_SECONDS = 10.0
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class GenerationService:
    """Engine construction + request handling behind the HTTP layer."""

    def __init__(self, cfg: ModelConfig, params: Any, tokenizer,
                 engine_slots: int = 8, engine_max_seq_len=None,
                 metrics: Optional[MetricsRegistry] = None, device="cuda",
                 kv_paging: bool = False, page_size: int = 16,
                 prefill_chunk: int = 32, num_pages: Optional[int] = None,
                 speculative: Optional[SpecConfig] = None):
        """engine_slots KV-cache slots (>= 1) with a background step-loop
        thread. kv_paging swaps in the PagedInferenceEngine with
        page_size-token pages, prefill_chunk-token prefill chunks and a
        pool of num_pages pages (default: every slot can grow to
        engine_max_seq_len). speculative turns on speculative decoding
        in the engine."""
        if engine_slots < 1:
            raise ValueError("the port serves through the continuous-"
                             "batching engine: engine_slots must be >= 1")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.metrics = metrics if metrics is not None else default_registry()
        self._m_requests = self.metrics.counter(
            "server_requests_total", "API requests by outcome",
            label_names=("status",))
        self._m_latency = self.metrics.histogram(
            "server_request_seconds", "API request wall time")
        kw = dict(num_slots=engine_slots, max_seq_len=engine_max_seq_len,
                  vocab_size=tokenizer.vocab_size, metrics=self.metrics,
                  device=device, speculative=speculative)
        if kv_paging:
            self.engine = PagedInferenceEngine(
                cfg, params, page_size=page_size,
                prefill_chunk=prefill_chunk, num_pages=num_pages, **kw)
        else:
            self.engine = InferenceEngine(cfg, params, **kw)
        self.engine.start()

    def shutdown(self) -> None:
        self.engine.stop()

    def ready(self) -> tuple:
        alive = (self.engine._thread is None
                 or self.engine._thread.is_alive())
        stalled = self.engine.stalled(STALL_THRESHOLD_SECONDS)
        detail = {"step_loop_alive": alive, "stalled": stalled,
                  "ok": alive and not stalled}
        return detail["ok"], detail

    def handle(self, req: dict) -> dict:
        prompts = req.get("prompts")
        if not isinstance(prompts, list) or not prompts:
            raise ValueError("prompts: non-empty list of strings required")
        if len(prompts) > MAX_PROMPTS:
            raise ValueError(f"at most {MAX_PROMPTS} prompts per request")
        if not all(isinstance(p, str) and p for p in prompts):
            raise ValueError("prompts must be non-empty strings")
        n = int(req.get("tokens_to_generate", 64))
        if not 1 <= n <= MAX_TOKENS_TO_GENERATE:
            raise ValueError(
                f"tokens_to_generate in [1, {MAX_TOKENS_TO_GENERATE}]")
        if req.get("beam_width"):
            raise ValueError("beam search is not ported yet")
        # per-request speculation knob; a no-op unless the engine
        # speculates (greedy output is the same either way)
        spec = req.get("spec", True)
        if not isinstance(spec, bool):
            raise ValueError("spec must be a JSON boolean")
        texts, segments, logprobs, _ = generate_and_post_process(
            self.engine, self.tokenizer, prompts, tokens_to_generate=n,
            temperature=float(req.get("temperature", 1.0)),
            top_k_sampling=int(req.get("top_k", 0)),
            top_p_sampling=float(req.get("top_p", 0.0)),
            add_BOS=bool(req.get("add_BOS", False)),
            return_output_log_probs=bool(req.get("logprobs", False)),
            random_seed=int(req.get("random_seed", 0)), spec=spec)
        out = {"text": texts, "segments": segments}
        if logprobs is not None:
            out["logprobs"] = [list(map(float, row)) for row in logprobs]
        return out


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _handle(self):
            t0 = time.monotonic()
            status = "500"
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                payload = service.handle(req)
                status = "200"
                self._reply(200, payload)
            except ValueError as e:
                status = "400"
                self._reply(400, {"message": str(e)})
            except Exception as e:  # noqa: BLE001 - server must not die
                self._reply(500, {"message": f"internal error: {e}"})
            finally:
                service._m_requests.inc(status=status)
                service._m_latency.observe(time.monotonic() - t0)

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
                t = service.engine._thread
                alive = t is None or t.is_alive()
                self._reply(200 if alive else 500,
                            {"ok": bool(alive), "engine": True})
            elif path == "/readyz":
                ok, detail = service.ready()
                self._reply(200 if ok else 503, detail)
            else:
                self._reply(404, {"message": "GET serves /metrics, /healthz, "
                                             "/readyz; the API is PUT/POST "
                                             "/api"})

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
               speculative: Optional[SpecConfig] = None) -> None:
    """Serve until interrupted (KeyboardInterrupt) or until
    ``server.shutdown()`` is called from another thread; port=0 binds an
    ephemeral port. In-process callers may pass `service_out` (a list
    that receives (service, server)) and `ready` (set once listening).
    kv_paging, page_size, prefill_chunk and num_pages select and size
    the paged engine; speculative (a SpecConfig) turns on speculative
    decoding (GenerationService)."""
    service = GenerationService(cfg, params, tokenizer,
                                engine_slots=engine_slots,
                                engine_max_seq_len=engine_max_seq_len,
                                device=device, kv_paging=kv_paging,
                                page_size=page_size,
                                prefill_chunk=prefill_chunk,
                                num_pages=num_pages, speculative=speculative)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    bound_port = server.server_address[1]
    if service_out is not None:
        service_out.extend([service, server])
    mode = (f"paged KV, {page_size}-token pages, {prefill_chunk}-token "
            "prefill chunks" if kv_paging else "continuous batching")
    if speculative:
        mode += f", speculative {speculative.drafter} k={speculative.k}"
    print(f"serving generation API on http://{host}:{bound_port}/api "
          f"({mode}, {engine_slots} slots, {device})", flush=True)
    if ready is not None:
        ready.set()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.shutdown()
