"""megatron_tpu_torch's serving control plane on the CPU: bounded queues,
deadlines, warmup, drain and readmit, weight reload, the admin endpoints,
the SIGTERM drain and the new server flags.

The behaviour is held to the JAX package's tests of the same features
(tests/test_serving_engine.py bounded admission and the 503, and
tests/test_fleet.py readiness, drain/readmit and deadlines), with the
port's means: ticks are slowed by wrapping the engine's decode step
(the JAX tests arm a fault injector the port does not have). A reload is
held against an engine built fresh on the new weights, on both engines.
Every test runs a tiny model (2 layers, hidden 64) in fp32.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from megatron_tpu_torch.inference.engine import (
    EngineOverloadedError, InferenceEngine, Request, RequestTimeoutError,
)
from megatron_tpu_torch.inference.fleet.reload import (
    NoValidCheckpointError, load_verified_params, save_params_checkpoint,
)
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.server import GenerationService, make_handler
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import init_params
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.tokenizer import NullTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = presets.tiny(vocab_size=64, seq_length=64, attention_impl="pallas")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, 0, device="cpu")


def _engine(params, paged=False, **kw):
    kw.setdefault("num_slots", 2)
    kw.update(max_seq_len=64, vocab_size=65, device="cpu",
              metrics=MetricsRegistry())
    if paged:
        return PagedInferenceEngine(CFG, params, page_size=8,
                                    prefill_chunk=8, **kw)
    return InferenceEngine(CFG, params, **kw)


def _slow(eng, seconds=0.02):
    """Slow every decode tick of `eng` by `seconds`."""
    fast = eng._decode_step

    def slow(*a):
        time.sleep(seconds)
        return fast(*a)

    eng._decode_step = slow
    return eng


class _Server:
    """A GenerationService behind the HTTP handler on an ephemeral port."""

    def __init__(self, params, **kw):
        kw.setdefault("engine_slots", 2)
        self.service = GenerationService(
            CFG, params, NullTokenizer(64), engine_max_seq_len=64,
            device="cpu", metrics=MetricsRegistry(), **kw)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         make_handler(self.service))
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.shutdown()


def _call(url, body=None, method="POST"):
    """(status, payload, headers); an HTTP error is a result."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url):
    return _call(url, method="GET")


def test_engine_max_queue_rejects_overload(params):
    """Past max_queue waiting requests submit() rejects (overloaded)
    instead of queueing; generate() refuses a batch the queue cannot take
    whole before submitting any row (tests/test_serving_engine.py:479)."""
    with pytest.raises(ValueError, match="max_queue"):
        _engine(params, max_queue=0)
    eng = _engine(params, num_slots=1, max_queue=2)
    held = [eng.submit(Request(prompt=np.array([1], np.int32),
                               max_new_tokens=3)) for _ in range(2)]
    rejected = eng.submit(Request(prompt=np.array([2], np.int32),
                                  max_new_tokens=3))
    assert rejected.done.is_set() and rejected.overloaded
    assert "queue full" in rejected.error and eng.stats["rejected"] == 1
    eng.run_until_idle()
    assert all(r.error is None and len(r.generated) == 3 for r in held)
    eng = _engine(params, num_slots=1, max_queue=1)
    eng.submit(Request(prompt=np.array([1], np.int32), max_new_tokens=1))
    with pytest.raises(EngineOverloadedError):
        eng.generate(np.array([[1]], np.int32), np.array([1]),
                     max_new_tokens=1)
    assert len(eng._queue) == 1 and eng.stats["rejected"] == 1


def test_server_answers_a_full_queue_with_503_and_retry_after(params):
    srv = _Server(params, engine_slots=1, engine_max_queue=1)
    eng = _slow(srv.service.engine)
    out = []

    def fire(n):
        out.append(_call(srv.url + "/api", {"prompts": ["3 7"],
                                            "tokens_to_generate": n}))

    try:
        t1 = threading.Thread(target=fire, args=(30,))
        t1.start()
        deadline = time.monotonic() + 30
        while eng.stats["admitted"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        t2 = threading.Thread(target=fire, args=(30,))
        t2.start()
        while not eng._queue:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, body, headers = _call(srv.url + "/api", {
            "prompts": ["5"], "tokens_to_generate": 2})
        assert status == 503 and "queue" in body["message"]
        assert headers["Retry-After"] == "1"
        t1.join(60)
        t2.join(60)
        assert [o[0] for o in out] == [200, 200]
    finally:
        srv.close()


def test_deadline_expires_queued_and_mid_decode_then_serves(params):
    """A queued request past its deadline fails while queued, one in a
    slot fails mid-decode (its slot freed); the engine keeps serving and
    its other requests finish (tests/test_fleet.py:616-645)."""
    eng = _slow(_engine(params, num_slots=1))
    eng.start()
    try:
        long = eng.submit(Request(prompt=np.array([7, 8], np.int32),
                                  max_new_tokens=30))
        queued = eng.submit(Request(prompt=np.array([9], np.int32),
                                    max_new_tokens=4, deadline_s=0.15))
        assert queued.done.wait(10)
        assert queued.timed_out and "queued" in queued.error
        assert long.done.wait(30) and long.error is None
        mid = eng.submit(Request(prompt=np.array([3, 4], np.int32),
                                 max_new_tokens=60, deadline_s=0.3))
        assert mid.done.wait(10)
        assert mid.timed_out and "mid-decode" in mid.error
        assert 0 < len(mid.generated) < 60
        assert eng.stats["timeouts"] == 2 and eng.num_active == 0
        after = eng.submit(Request(prompt=np.array([3, 4], np.int32),
                                   max_new_tokens=5))
        assert after.done.wait(30) and after.error is None
        assert eng.metrics.render().count(
            "engine_requests_timeout_total 2") == 1
    finally:
        eng.stop()
    with pytest.raises(RequestTimeoutError):
        _slow(_engine(params)).generate(
            np.array([[3, 4]], np.int32), np.array([2]), max_new_tokens=40,
            deadline_s=0.1)


def test_deadlines_over_http(params):
    """504 with "timeout": true; deadline_s <= 0 rejected; a client can
    shorten the server bound but not lengthen it or opt out with null;
    a non-numeric or non-finite deadline is a 400
    (tests/test_fleet.py:648-676)."""
    srv = _Server(params, request_timeout=0.3)
    _slow(srv.service.engine)
    try:
        for deadline in (None, 1e9, 0.2):
            status, body, _ = _call(srv.url + "/api", {
                "prompts": ["3 4"], "tokens_to_generate": 60,
                "deadline_s": deadline})
            assert status == 504 and body["timeout"] is True, deadline
        # a bare NaN (which json.loads accepts) would never expire
        for bad in ([], float("nan"), float("inf")):
            status, body, _ = _call(srv.url + "/api", {
                "prompts": ["3"], "tokens_to_generate": 2,
                "deadline_s": bad})
            assert status == 400 and "deadline_s" in body["message"], bad
        srv.service.request_timeout = None
        status, body, _ = _call(srv.url + "/api", {
            "prompts": ["3"], "tokens_to_generate": 2, "deadline_s": 0})
        assert status == 400 and "deadline_s" in body["message"]
        assert _call(srv.url + "/api", {"prompts": ["3 4"],
                                        "tokens_to_generate": 2})[0] == 200
    finally:
        srv.close()


def test_readiness_waits_for_warmup(params):
    srv = _Server(params, warmup=True)
    try:
        status, body, _ = _get(srv.url + "/readyz")
        assert status == 503 and body["warmed"] is False
        assert _get(srv.url + "/healthz")[0] == 200
        srv.service.warmup()
        status, body, _ = _get(srv.url + "/readyz")
        assert status == 200 and body["ok"] is True
        assert srv.service.engine.stats["retired"] == 1
    finally:
        srv.close()


@pytest.mark.parametrize("engine_slots", [2, 0])
def test_drain_and_readmit_over_http(params, engine_slots):
    """A drain answers new requests 503 + Retry-After and /readyz 503
    while /healthz stays 200; it waits for one-shot work (beam search,
    scoring, the engine-less path) under the service lock too."""
    srv = _Server(params, engine_slots=engine_slots)
    svc = srv.service
    try:
        svc.lock.acquire()          # a one-shot request in flight
        assert svc.drain(timeout_s=0.2) is False
        svc.lock.release()
        status, body, _ = _call(srv.url + "/admin/drain", {"timeout_s": 10})
        assert status == 200 and body == {"drained": True, "draining": True}
        status, body, headers = _call(srv.url + "/api", {
            "prompts": ["3 4"], "tokens_to_generate": 2})
        assert status == 503 and body["draining"] is True
        assert headers["Retry-After"] == "1"
        assert _get(srv.url + "/readyz")[0] == 503
        assert _get(srv.url + "/healthz")[0] == 200
        assert _get(srv.url + "/admin/status")[1]["draining"] is True
        assert _call(srv.url + "/admin/readmit", {})[0] == 200
        assert _get(srv.url + "/readyz")[0] == 200
        status, body, _ = _call(srv.url + "/api", {
            "prompts": ["3 4"], "tokens_to_generate": 2,
            "temperature": 0.0})
        assert status == 200 and len(body["text"][0].split()) == 4
    finally:
        srv.close()


def test_admin_status_and_unknown_paths(params):
    srv = _Server(params, weights_version=3)
    try:
        status, body, _ = _get(srv.url + "/admin/status")
        assert status == 200 and body["ready"] is True
        assert body["weights_version"] == 3
        assert body["engine"]["timeouts"] == 0
        assert body["engine"]["weight_reloads"] == 0
        status, body, _ = _call(srv.url + "/admin/profile", {})
        assert status == 404
        assert body["message"] == "POST /admin/{drain,readmit,reload}"
        assert _call(srv.url + "/admin/reload", {})[0] == 400  # no dir
        status, body, _ = _call(srv.url + "/api", {
            "prompts": ["3 4"], "tokens_to_generate": 2})
        assert body["weights_version"] == 3
        assert _get(srv.url + "/nope")[0] == 404
    finally:
        srv.close()


def test_update_params_refuses_a_mismatched_tree(params):
    eng = _engine(params)
    other = init_params(presets.tiny(vocab_size=64, seq_length=64,
                                     hidden_size=32), 0, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        eng.update_params(other)
    missing = {k: v for k, v in params.items() if k != "final_ln"}
    with pytest.raises(ValueError, match="leaves differ"):
        eng.update_params(missing)
    half = {k: v for k, v in params.items()}
    half["embed"] = {"tokens": params["embed"]["tokens"].double()}
    with pytest.raises(ValueError, match="mismatch"):
        eng.update_params(half)
    assert eng._pending_params is None


def test_reload_verified_checkpoints(tmp_path, params):
    """load_verified_params takes the newest checkpoint whose manifest
    verifies (a torn newer one is skipped); a pinned torn one, or none
    at all, raises NoValidCheckpointError."""
    new = init_params(CFG, 1, device="cpu")
    save_params_checkpoint(str(tmp_path), 1, new)
    torn = save_params_checkpoint(str(tmp_path), 2, params)
    pt = os.path.join(torn, "state", "params.pt")
    with open(pt, "r+b") as f:
        f.truncate(os.path.getsize(pt) // 2)
    got, it = load_verified_params(str(tmp_path), params)
    assert it == 1
    assert torch.equal(got["embed"]["tokens"], new["embed"]["tokens"])
    with pytest.raises(NoValidCheckpointError, match="iter 2"):
        load_verified_params(str(tmp_path), params, iteration=2)
    with pytest.raises(NoValidCheckpointError):
        load_verified_params(str(tmp_path / "empty"), params)


@pytest.mark.parametrize("paged", [False, True])
def test_reload_over_http_serves_the_new_weights(tmp_path, params, paged):
    """POST /admin/reload swaps a saved checkpoint's weights in between
    ticks: the tokens then equal an engine built fresh on them (the paged
    engine's prefix cache is emptied, so a repeated prompt does not hit
    the old weights' pages), responses carry the new weights_version,
    and a torn checkpoint answers 409 with the weights unchanged."""
    served = init_params(CFG, 0, device="cpu")   # reloaded in place
    new = init_params(CFG, 1, device="cpu")
    save_params_checkpoint(str(tmp_path), 1, new)
    torn = save_params_checkpoint(str(tmp_path), 2, params)
    pt = os.path.join(torn, "state", "params.pt")
    with open(pt, "r+b") as f:
        f.truncate(os.path.getsize(pt) // 2)
    kw = dict(kv_paging=True, page_size=8, prefill_chunk=8) if paged else {}
    srv = _Server(served, reload_dir=str(tmp_path), weights_version=0, **kw)
    prompts = ["3 7 11 2 9 4 1 8 5 2", "40 2 2 17"]
    req = {"prompts": prompts, "tokens_to_generate": 6, "temperature": 0.0}
    try:
        before = _call(srv.url + "/api", req)[1]
        assert before["weights_version"] == 0
        status, body, _ = _call(srv.url + "/admin/reload", {"iteration": 1})
        assert status == 200 and body == {"version": 1}
        after = _call(srv.url + "/api", req)[1]
        status, body, _ = _call(srv.url + "/admin/reload", {"iteration": 2})
        assert status == 409 and "iter 2" in body["message"]
        again = _call(srv.url + "/api", req)[1]
        st = _get(srv.url + "/admin/status")[1]
    finally:
        srv.close()
    fresh = _Server(new, **kw)
    try:
        want = _call(fresh.url + "/api", req)[1]
    finally:
        fresh.close()
    assert after["text"] == want["text"] != before["text"]
    assert after["weights_version"] == 1 and again["text"] == want["text"]
    assert st["weights_version"] == 1
    assert st["engine"]["weight_reloads"] == 1
    assert st["engine"]["decode_recompiles"] == 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(args):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "megatron_tpu_torch.tools.run_text_generation_server",
         "--model_name", "tiny", "--tokenizer_type", "null", "--host",
         "127.0.0.1", "--port", str(port), "--seed", "3", "--device",
         "cpu", *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    while True:
        try:
            _get(url + "/healthz")
            return proc, url
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                raise AssertionError(proc.communicate()[0])
            time.sleep(0.2)


def test_cli_engine_flags_and_sigterm_drain():
    """--kv_cache_int8 --serve_max_queue --serve_request_timeout
    --serve_warmup through the CLI; SIGTERM drains and exits 0, printing
    "drain complete"."""
    proc, url = _boot(["--serve_num_slots", "2", "--serve_max_seq_len",
                       "64", "--kv_cache_int8", "--serve_max_queue", "4",
                       "--serve_request_timeout", "30",
                       "--serve_drain_timeout", "10", "--serve_warmup"])
    try:
        deadline = time.monotonic() + 60
        while _get(url + "/readyz")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        status, body, _ = _call(url + "/api", {
            "prompts": ["3 4 5"], "tokens_to_generate": 3,
            "temperature": 0.0})
        assert status == 200 and len(body["text"][0].split()) == 6
        st = _get(url + "/admin/status")[1]
        assert st["engine"]["retired"] == 2       # warmup + the request
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "int8 KV" in out and "drain complete" in out


def test_cli_one_shot_serves_generation_scoring_and_beams():
    """--serve_num_slots 0: one request at a time through the one-shot
    loop; scoring and beam search answer; SIGINT exits 0."""
    proc, url = _boot(["--serve_num_slots", "0"])
    try:
        status, body, _ = _call(url + "/api", {
            "prompts": ["3 4 5", "6"], "tokens_to_generate": 3,
            "temperature": 0.0, "logprobs": True})
        assert status == 200 and len(body["text"][1].split()) == 1 + 2 + 3
        status, body, _ = _call(url + "/api", {
            "prompts": ["3 4 5"], "tokens_to_generate": 0})
        assert status == 200 and len(body["logprobs"][0]) == 2
        status, body, _ = _call(url + "/api", {
            "prompts": ["3 4 5"], "tokens_to_generate": 3,
            "beam_width": 2, "length_penalty": 0.5})
        assert status == 200 and len(body["scores"]) == 2
        assert _get(url + "/healthz")[1]["engine"] is False
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "one-shot" in out and "drain complete" in out
