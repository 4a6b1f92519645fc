"""The port's serving fleet (inference/fleet/: scrape, router, replica and
the server's handoff) against the JAX package's tests/test_fleet.py, on
the CPU.

  * scrape: both packages' exposition parses to the same values through
    both parsers, strict mode round-trips every family, window diffs and
    fleet merges; the engine gauges the router reads are the ones the
    port's engine exports;
  * the router's decisions, the port's and the JAX package's on the same
    scripted stub replicas (host code, no model): least-loaded pick,
    failover, 503 routed around without a breaker penalty, 4xx and 504
    passed through, the breaker opening and the probe readmitting, all
    dead, the rolling update's admin choreography and its cleanup;
  * one HTTP drill with real replica subprocesses (three spawns, at once,
    for the file): a SIGTERM drain hands every request in flight and
    queued to the peer with zero failures and the solo answers, greedy
    and seeded-sampled; then migrate_fail:1 tears the first outbound
    frame, the peer's crc check rejects it (409) and the request still
    finishes through the recompute rung.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from megatron_tpu.inference.fleet import scrape as jscrape
from megatron_tpu.inference.fleet.router import (
    ReplicaRouter as JRouter,
)
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.inference.fleet import scrape
from megatron_tpu_torch.inference.fleet.replica import ReplicaProcess
from megatron_tpu_torch.inference.fleet.router import ReplicaRouter
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTERS = {"port": (ReplicaRouter, MetricsRegistry),
           "jax": (JRouter, JRegistry)}


# ---------------------------------------------------------------------------
# scrape


def _fill(reg):
    g = reg.gauge("engine_slots_active", "busy slots")
    c = reg.counter("engine_requests_admitted_total", "admissions",
                    label_names=("status",))
    h = reg.histogram("engine_ttft_seconds", "ttft")
    g.set(3)
    c.inc(status="200")
    c.inc(status="200")
    for v in (0.002, 0.02, 0.02, 0.2, 2.0):
        h.observe(v)
    return h


def test_scrape_parses_both_packages_exposition_to_the_same_values():
    texts = []
    for reg in (MetricsRegistry(), JRegistry()):
        h = _fill(reg)
        texts.append((reg.render(), h))
    for text, h in texts:
        for parse in (scrape.parse_prom_text, jscrape.parse_prom_text):
            s = parse(text)
            assert scrape.sample_value(s, "engine_slots_active") == 3
            assert scrape.sample_value(
                s, "engine_requests_admitted_total", status="200") == 2
            for q in (0.5, 0.95, 0.99):
                assert scrape.histogram_percentile(
                    s, "engine_ttft_seconds", q) == h.percentile(q)
        assert scrape.parse_prom_text(text) == jscrape.parse_prom_text(text)
        assert scrape.parse_prom_metadata(text) == \
            jscrape.parse_prom_metadata(text)
    esc = scrape.parse_prom_text(r'm{p="C:\\new",q="a\nb"} 1')
    assert esc["m"][0][0] == {"p": "C:\\new", "q": "a\nb"}


def test_strict_scrape_roundtrips_every_family():
    reg = MetricsRegistry()
    nasty = 'quo"te\nnew\\line\\nliteral'
    c = reg.counter("requests_total", "first line\nsecond \\ line",
                    label_names=("path",))
    c.inc(path=nasty)
    reg.gauge("depth", "").set(7)
    h = reg.histogram("latency_seconds", "lat")
    h.observe(0.3)
    text = reg.render()
    samples = scrape.parse_prom_text(text, strict=True)
    assert scrape.sample_value(samples, "requests_total", path=nasty) == 1
    assert scrape.sample_value(samples, "depth") == 7
    assert scrape.histogram_percentile(samples, "latency_seconds",
                                       0.5) == h.percentile(0.5)
    for bad in ("garbage line here", "undeclared_metric 1",
                "# TYPE m counter\nm{x=\"a\\qb\"} 1",
                "# TYPE m counter\nm not_a_number"):
        with pytest.raises(scrape.ScrapeFormatError):
            scrape.parse_prom_text(bad, strict=True)
        scrape.parse_prom_text(bad)


def test_scrape_diff_and_merge():
    reg = MetricsRegistry()
    h = reg.histogram("engine_ttft_seconds", "ttft")
    h.observe(5.0)
    before = scrape.parse_prom_text(reg.render())
    for _ in range(10):
        h.observe(0.01)
    delta = scrape.diff_samples(before, scrape.parse_prom_text(reg.render()))
    assert scrape.histogram_percentile(delta, "engine_ttft_seconds",
                                       0.99) == 0.01
    assert scrape.merged_histogram_percentile(
        [delta, delta], "engine_ttft_seconds", 0.5) == 0.01


def test_the_router_reads_the_gauges_the_port_engine_exports():
    """replica_load sums engine_slots_active and engine_queue_depth: the
    port's engine registers both, and a busy engine's load reads back."""
    from megatron_tpu_torch.inference.engine import InferenceEngine, Request
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params

    cfg = presets.tiny(vocab_size=64, seq_length=64)
    reg = MetricsRegistry()
    eng = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"),
                          num_slots=1, max_seq_len=64, device="cpu",
                          metrics=reg)
    for p in ([3, 4], [5, 6], [7, 8]):
        eng.submit(Request(prompt=np.array(p, np.int32), max_new_tokens=4))
    eng.step()
    samples = scrape.parse_prom_text(reg.render(), strict=True)
    assert scrape.sample_value(samples, "engine_slots_active") == 1
    assert scrape.sample_value(samples, "engine_queue_depth") == 2
    assert scrape.replica_load(samples) == 3.0
    assert jscrape.replica_load(samples) == 3.0
    eng.run_until_idle()


# ---------------------------------------------------------------------------
# the router against scripted stub replicas


class StubReplica:
    """A scripted replica: /readyz, /metrics gauges, /api, /admin."""

    def __init__(self, ready=True, load=0.0, api_status=200):
        self.ready, self.load, self.api_status = ready, load, api_status
        self.api_calls = 0
        self.admin_calls = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code, payload, ctype="application/json"):
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/readyz":
                    self._reply(200 if stub.ready else 503,
                                {"ok": stub.ready})
                elif path == "/metrics":
                    self._reply(200, (f"engine_slots_active {stub.load}\n"
                                      "engine_queue_depth 0\n").encode(),
                                ctype="text/plain")
                else:
                    self._reply(404, {})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if path == "/api":
                    stub.api_calls += 1
                    self._reply(stub.api_status,
                                {"text": [f"stub:{stub.port}"]})
                elif path.startswith("/admin/"):
                    stub.admin_calls.append(path)
                    self._reply(200, {"drained": True} if path ==
                                "/admin/drain" else {"version": 42}
                                if path == "/admin/reload" else {})
                else:
                    self._reply(404, {})

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


BODY = json.dumps({"prompts": ["1 2"], "tokens_to_generate": 2}).encode()


def _counter(router, name, **labels):
    samples = scrape.parse_prom_text(router.metrics.render())
    return scrape.sample_value(samples, name, default=0.0, **labels)


def _router(impl, urls, **kw):
    cls, reg = ROUTERS[impl]
    return cls(urls, metrics=reg(), **kw)


@pytest.mark.parametrize("impl", sorted(ROUTERS))
def test_router_picks_least_loaded(impl):
    busy, idle = StubReplica(load=5.0), StubReplica(load=0.0)
    try:
        router = _router(impl, [busy.url, idle.url])
        router.probe_once()
        status, _, body = router.dispatch(BODY)
        assert status == 200 and f"stub:{idle.port}" in body.decode()
        assert idle.api_calls == 1 and busy.api_calls == 0
    finally:
        busy.close()
        idle.close()


@pytest.mark.parametrize("impl", sorted(ROUTERS))
def test_router_failover_on_dead_replica(impl):
    live = StubReplica()
    try:
        router = _router(impl, [_dead_url(), live.url], retry_backoff_s=0.0)
        assert router.dispatch(BODY)[0] == 200
        assert live.api_calls == 1
        assert _counter(router, "router_failovers_total") == 1
        assert _counter(router, "router_retries_total") == 1
    finally:
        live.close()


@pytest.mark.parametrize("impl", sorted(ROUTERS))
@pytest.mark.parametrize("code,retried", [(503, True), (400, False),
                                          (504, False)])
def test_router_status_pass_through_and_breaker_penalty(impl, code,
                                                        retried):
    """503 (busy) is routed around without a breaker penalty; 4xx and
    504 (the client's spent budget) pass through untried elsewhere."""
    first, other = StubReplica(api_status=code), StubReplica(load=9.0)
    try:
        router = _router(impl, [first.url, other.url], retry_backoff_s=0.0)
        router.probe_once()
        status = router.dispatch(BODY)[0]
        assert status == (200 if retried else code)
        assert first.api_calls == 1
        assert other.api_calls == (1 if retried else 0)
        assert router.replicas[0].failures == 0
        assert _counter(router, "router_breaker_opens_total") == 0
    finally:
        first.close()
        other.close()


@pytest.mark.parametrize("impl", sorted(ROUTERS))
def test_router_breaker_opens_then_probe_readmits(impl):
    stub = StubReplica(api_status=500)
    try:
        router = _router(impl, [stub.url], retry_backoff_s=0.0,
                         breaker_failures=3, breaker_base_s=60.0,
                         readmit_streak=2)
        assert router.dispatch(BODY)[0] == 500
        assert router.dispatch(BODY)[0] in (500, 503)
        rep = router.replicas[0]
        assert rep.breaker_open(time.monotonic())
        assert _counter(router, "router_breaker_opens_total") == 1
        calls = stub.api_calls
        status, headers, _ = router.dispatch(BODY)
        assert status == 503 and "Retry-After" in headers
        assert stub.api_calls == calls
        stub.api_status = 200
        router.probe_once()
        assert router._num_routable() == 0
        router.probe_once()
        assert router._num_routable() == 1
        assert router.dispatch(BODY)[0] == 200
    finally:
        stub.close()


@pytest.mark.parametrize("impl", sorted(ROUTERS))
def test_router_all_dead_answers_502_then_503_with_retry_after(impl):
    router = _router(impl, [_dead_url()], retry_backoff_s=0.0)
    assert router.dispatch(BODY)[0] == 502
    router.replicas[0].breaker_open_until = time.monotonic() + 60
    status, headers, _ = router.dispatch(BODY)
    assert status == 503 and "Retry-After" in headers


@pytest.mark.parametrize("impl", sorted(ROUTERS))
def test_rolling_update_choreography_and_cleanup(impl):
    a, b = StubReplica(), StubReplica()
    try:
        router = _router(impl, [a.url, b.url])
        results = router.rolling_update(load="ckpts", iteration=2,
                                        drain_timeout=5.0)
        assert [r.get("version") for r in results] == [42, 42]
        assert all(r["ready"] is True for r in results)
        for stub in (a, b):
            assert stub.admin_calls == ["/admin/drain", "/admin/reload",
                                        "/admin/readmit"]
        router = _router(impl, [_dead_url(), a.url], retry_backoff_s=0.0)
        results = router.rolling_update(load="ckpts", drain_timeout=1.0,
                                        ready_timeout=1.0)
        assert len(results) == 1 and "error" in results[0]
        assert not any(r.updating for r in router.replicas)
        assert router.dispatch(BODY)[0] == 200
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# real replica subprocesses: the handoff drill


def _spec(tmp_path, name, **kw):
    spec = {"preset": "tiny", "cfg": {"vocab_size": 64, "seq_length": 64},
            "seed": 0, "engine_slots": 2, "port": 0, "warmup": True,
            "device": "cpu", "drain_timeout": 30.0,
            "port_file": str(tmp_path / f"{name}.port"),
            "profile_dir": str(tmp_path / f"{name}_profile")}
    spec.update(kw)
    return spec


def _spawn(tmp_path, name, fault="", **kw):
    env = dict(os.environ, MEGATRON_TPU_FAULT=fault, PYTHONPATH=REPO)
    return ReplicaProcess(_spec(tmp_path, name, **kw), env=env,
                          log_path=str(tmp_path / f"{name}.log")).spawn()


def _post(url, path, payload, timeout=120):
    req = urllib.request.Request(url + path, method="POST",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _events(tel):
    with open(os.path.join(tel, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Three replicas spawned at once: the peer r1, the victim r0 (handoff
    to r1) and r2 (handoff to r1 with migrate_fail:1), every tick slowed
    to 30 ms so that requests are in flight when the drain comes."""
    tmp = tmp_path_factory.mktemp("fleet")
    r1 = _spawn(tmp, "r1", fault="slow_tick:30")
    r1.wait_port(timeout=120)
    tel0, tel2 = str(tmp / "tel0"), str(tmp / "tel2")
    r0 = _spawn(tmp, "r0", fault="slow_tick:30", peers=[r1.url],
                telemetry_dir=tel0)
    r2 = _spawn(tmp, "r2", fault="migrate_fail:1,slow_tick:30",
                peers=[r1.url], telemetry_dir=tel2)
    try:
        for r in (r1, r0, r2):
            r.wait_ready(timeout=120)
        yield {"r0": r0, "r1": r1, "r2": r2, "tel0": tel0, "tel2": tel2}
    finally:
        for r in (r0, r1, r2):
            r.close()


def test_sigterm_handoff_zero_failures(fleet):
    """SIGTERM the victim mid-traffic behind the router: its drain
    migrates every request in flight and queued to the peer, so no
    request fails and each answer is the peer's solo one, greedy and
    seeded-sampled; the journal names each outcome, KV bytes crossed,
    and the peer counted the imports."""
    r0, r1 = fleet["r0"], fleet["r1"]
    cases = []
    for i in range(6):
        case = {"prompts": [f"{3 + i} {4 + i} {5 + i}"],
                "tokens_to_generate": 16}
        case.update({"temperature": 0.8, "random_seed": 100 + i} if i % 2
                    else {"temperature": 0.0})
        cases.append(case)
    refs = []
    for c in cases:
        code, body = _post(r1.url, "/api", c)
        assert code == 200
        refs.append(body["text"])
    results = [None] * len(cases)

    def client(i):
        results[i] = _post(r0.url, "/api", cases[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(cases))]
    for th in threads:
        th.start()
    time.sleep(0.5)
    r0.terminate()
    for th in threads:
        th.join(timeout=120)
    for i, (code, body) in enumerate(results):
        assert code == 200, (i, code, body)
        assert body["text"] == refs[i], i
    assert r0.wait(timeout=60) == 0
    events = _events(fleet["tel0"])
    done = [e for e in events if e.get("kind") == "serve_migrate"
            and e.get("stage") == "handoff_done"]
    assert done, "the SIGTERM landed after the traffic"
    assert all(e["outcome"] in ("migrated", "recomputed") for e in done)
    assert any(e["outcome"] == "migrated" for e in done)
    assert sum(e.get("wire_bytes", 0) for e in events
               if e.get("stage") == "handoff" and e.get("ok")) > 0
    with urllib.request.urlopen(r1.url + "/metrics", timeout=10) as r:
        samples = scrape.parse_prom_text(r.read().decode())
    assert scrape.sample_value(samples, "server_migrate_wire_bytes_total",
                               direction="in") > 0


def test_migrate_fail_tears_the_first_frame_and_the_request_finishes(fleet):
    """migrate_fail:1: the migrate rung's frame is torn, the peer's crc
    check rejects it (409, nothing imported), and the recompute rung's
    frame carries the request to the end: the client gets the solo
    answer, and the journal names each step."""
    r1, r2 = fleet["r1"], fleet["r2"]
    case = {"prompts": ["5 6 7"], "tokens_to_generate": 30,
            "temperature": 0.0}
    code, ref = _post(r1.url, "/api", case)
    assert code == 200
    result = {}
    th = threading.Thread(target=lambda: result.update(
        r=_post(r2.url, "/api", case)))
    th.start()
    time.sleep(0.4)
    code, body = _post(r2.url, "/admin/drain", {"timeout_s": 30})
    assert code == 200 and body["draining"]
    th.join(timeout=120)
    code, body = result["r"]
    assert code == 200 and body["text"] == ref["text"]
    events = _events(fleet["tel2"])
    hand = [e for e in events if e.get("kind") == "serve_migrate"
            and e.get("stage") == "handoff"]
    assert [(e["rung"], e["ok"], e["status"]) for e in hand] == [
        ("migrate", False, 409), ("recompute", True, 200)]
    assert "torn transfer" in hand[0].get("error", "")
    done = [e for e in events if e.get("stage") == "handoff_done"]
    assert [e["outcome"] for e in done] == ["recomputed"]


def test_admin_profile_traces_exactly_the_requested_ticks(fleet):
    """POST /admin/profile under live traffic: a torch.profiler window of
    exactly N decode ticks (the step loop parks between ticks at the
    window's ends), whose Chrome trace holds N decode_tick ranges."""
    r1 = fleet["r1"]
    result = {}
    th = threading.Thread(target=lambda: result.update(r=_post(
        r1.url, "/api", {"prompts": ["9 8 7"], "tokens_to_generate": 30,
                         "temperature": 0.0})))
    th.start()
    time.sleep(0.3)
    code, body = _post(r1.url, "/admin/profile", {"steps": 3,
                                                  "timeout_s": 30})
    th.join(timeout=120)
    assert code == 200 and body["ticks"] == 3 and body["complete"]
    with open(body["trace"]) as f:
        events = json.load(f)["traceEvents"]
    ticks = [e for e in events if e.get("name") == "decode_tick"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert len(ticks) == 3
    assert result["r"][0] == 200
    code, _ = _post(r1.url, "/admin/profile", {"steps": 0})
    assert code == 400
