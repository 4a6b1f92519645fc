"""Sidecar HTTP listener: /metrics (Prometheus text), /healthz, /readyz.

A copy of megatron_tpu/telemetry/http.py (stdlib only), kept here so the
port imports nothing of the JAX package; it serves the port's own
telemetry/metrics.py registry.

The serving server mounts /metrics on its own port (inference/server.py);
this listener is for processes that are NOT otherwise HTTP servers — the
train loop (`--metrics_port`) and batch tools — so Prometheus can scrape
them too. Stdlib-only (ThreadingHTTPServer on a daemon thread), like the
generation server.

Liveness vs readiness (docs/observability.md): /healthz answers "is the
process worth keeping alive" (500 = restart me), /readyz answers "should
traffic route here right now" (503 = skip me, I'm warming up / draining /
wedged). A process that serves no traffic can ignore `ready` — /readyz
then mirrors /healthz — but anything behind the fleet router
(inference/fleet/router.py) or a k8s-style prober should wire both.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def metrics_app(registry: MetricsRegistry,
                health: Optional[Callable[[], dict]] = None,
                ready: Optional[Callable[[], dict]] = None):
    """Handler class serving GET /metrics, /healthz, /readyz off
    `registry`. `health`/`ready` return dicts whose "ok" key decides the
    status code (healthz: 500 when false; readyz: 503 — "not ready" is a
    routing hint, not a process fault); a raising probe IS the negative
    signal. ready=None mirrors liveness on /readyz."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _probe(self, fn: Optional[Callable[[], dict]],
                   fail_code: int) -> None:
            payload = {"ok": True}
            if fn is not None:
                try:
                    payload.update(fn())
                except Exception as e:  # noqa: BLE001 - health probe
                    # failing IS the health signal
                    payload = {"ok": False, "error": str(e)}
            self._send(200 if payload.get("ok") else fail_code,
                       json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._send(200, registry.render().encode(),
                           PROMETHEUS_CONTENT_TYPE)
            elif path == "/healthz":
                self._probe(health, 500)
            elif path == "/readyz":
                self._probe(ready if ready is not None else health, 503)
            else:
                self._send(404, b'{"message": "try /metrics, /healthz '
                                b'or /readyz"}',
                           "application/json")

        def log_message(self, *a):  # quiet, like the generation server
            pass

    return Handler


class MetricsServer:
    """Owns the sidecar ThreadingHTTPServer + its daemon serve thread."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "0.0.0.0",
                 health: Optional[Callable[[], dict]] = None,
                 ready: Optional[Callable[[], dict]] = None):
        self._server = ThreadingHTTPServer(
            (host, port), metrics_app(registry, health, ready=ready))
        self.port = self._server.server_address[1]  # resolved when port=0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"metrics-server-:{self.port}")

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def start_metrics_server(registry: MetricsRegistry, port: int,
                         host: str = "0.0.0.0",
                         health: Optional[Callable[[], dict]] = None,
                         ready: Optional[Callable[[], dict]] = None
                         ) -> MetricsServer:
    """Bind + serve; port=0 picks a free port (read it off .port)."""
    return MetricsServer(registry, port, host=host, health=health,
                         ready=ready).start()
