"""megatron_tpu_torch serving: the continuous-batching engine against the
JAX engine, the HTTP server, and the port's import boundary.

Engine parity runs both engines on one weight set (a JAX init_params
tree converted through numpy) on the CPU in fp32: a ragged batch of 3
greedy requests through 2 slots, so one slot is reused. Greedy tokens
must be identical and logprobs within 1e-4. Sampled requests cannot
match jax.random's noise; they are checked for determinism under one
seed instead.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_tpu.inference.engine import InferenceEngine as JEngine
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.server import run_server
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import init_params, params_from_numpy
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.tokenizer import NullTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = j_presets.tiny(**KW), presets.tiny(**KW)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(tcfg, tparams, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 64)
    return InferenceEngine(tcfg, tparams, vocab_size=65, device="cpu",
                           metrics=MetricsRegistry(), **kw)


def test_engine_greedy_matches_jax_engine(weights):
    jcfg, jparams, tcfg, tparams = weights
    prompts = np.zeros((3, 11), np.int32)
    lengths = np.array([11, 3, 6], np.int32)
    r = np.random.default_rng(0)
    for b, p in enumerate(lengths):
        prompts[b, :p] = r.integers(0, 64, size=p)
    jeng = JEngine(jcfg, jparams, num_slots=2, max_seq_len=64,
                   vocab_size=65, metrics=JRegistry())
    want = jeng.generate(prompts, lengths, max_new_tokens=7)
    teng = _engine(tcfg, tparams)
    got = teng.generate(prompts, lengths, max_new_tokens=7)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)
    # 3 requests through 2 slots: one slot was reused
    assert teng.stats["admitted"] == 3 and teng.stats["retired"] == 3
    assert teng.num_active == 0


def test_engine_sampling_is_deterministic_per_seed(weights):
    _, _, tcfg, tparams = weights
    prompts = np.array([[5, 9, 11, 2]], np.int32)
    lengths = np.array([4], np.int32)

    def run(seed, **kw):
        eng = _engine(tcfg, tparams)
        return eng.generate(prompts, lengths, max_new_tokens=12,
                            temperature=1.0, seed=seed, **kw).tokens

    a, b = run(3), run(3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, run(4))
    np.testing.assert_array_equal(run(3, top_k=4, top_p=0.9),
                                  run(3, top_k=4, top_p=0.9))


def test_engine_request_isolated_from_other_slots(weights):
    """A sampled request's tokens do not depend on which other requests
    share its decode ticks (each slot owns its generator)."""
    _, _, tcfg, tparams = weights
    prompt = np.array([7, 1, 30], np.int32)
    alone = _engine(tcfg, tparams)
    r1 = alone.submit(Request(prompt=prompt, max_new_tokens=8,
                              temperature=0.8, seed=11))
    alone.run_until_idle()
    mixed = _engine(tcfg, tparams, num_slots=3)
    mixed.submit(Request(prompt=np.array([2, 2], np.int32),
                         max_new_tokens=5, temperature=1.0, seed=1))
    r2 = mixed.submit(Request(prompt=prompt, max_new_tokens=8,
                              temperature=0.8, seed=11))
    mixed.submit(Request(prompt=np.array([40], np.int32), max_new_tokens=9))
    mixed.run_until_idle()
    assert r1.generated == r2.generated


def test_engine_rejects_bad_requests(weights):
    _, _, tcfg, tparams = weights
    eng = _engine(tcfg, tparams)
    bad = [Request(prompt=np.array([], np.int32), max_new_tokens=2),
           Request(prompt=np.array([1], np.int32), max_new_tokens=0),
           Request(prompt=np.arange(60, dtype=np.int32) % 64,
                   max_new_tokens=10),
           Request(prompt=np.array([64], np.int32), max_new_tokens=2)]
    for req in bad:
        eng.submit(req)
        assert req.done.is_set() and req.error
    assert eng.stats["rejected"] == 4
    assert "embedding table" in bad[-1].error


def test_engine_max_seq_len_rounding():
    """Rounded to the decode kernel's tile only on the CUDA kernel path."""
    cfg = presets.tiny(**KW)
    params = init_params(cfg, 0, device="cpu")
    eng = InferenceEngine(cfg, params, num_slots=1, max_seq_len=50,
                          device="cpu", metrics=MetricsRegistry())
    assert eng.max_seq_len == 50
    assert eng._bucket(5) == 49 and eng._bucket(1) == 49
    eng = InferenceEngine(cfg, params, num_slots=1, max_seq_len=200,
                          device="cpu", metrics=MetricsRegistry())
    assert (eng._bucket(5), eng._bucket(64), eng._bucket(65)) == (64, 64, 128)
    assert (eng._bucket(190), eng._bucket(197)) == (192, 199)


def _http(url, body=None, method="GET"):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read().decode()


def test_http_server_api_health_metrics(weights):
    _, _, tcfg, tparams = weights
    ready, out = threading.Event(), []
    t = threading.Thread(
        target=run_server, daemon=True,
        kwargs=dict(cfg=tcfg, params=tparams, tokenizer=NullTokenizer(64),
                    host="127.0.0.1", port=0, engine_slots=2,
                    engine_max_seq_len=64, device="cpu", ready=ready,
                    service_out=out))
    t.start()
    assert ready.wait(60)
    service, server = out
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, body = _http(base + "/api", {
            "prompts": ["1 2 3", "4 5"], "tokens_to_generate": 4,
            "temperature": 0.0, "logprobs": True}, method="PUT")
        assert status == 200
        payload = json.loads(body)
        assert len(payload["text"]) == 2
        assert len(payload["text"][0].split()) == 3 + 4
        assert len(payload["logprobs"][1]) == 3 + 4 - 1
        status, body = _http(base + "/healthz")
        assert status == 200 and json.loads(body)["ok"]
        status, body = _http(base + "/readyz")
        assert status == 200 and json.loads(body)["ok"]
        status, body = _http(base + "/metrics")
        assert status == 200
        assert "engine_requests_retired_total 2" in body
        assert 'server_requests_total{status="200"} 1' in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _http(base + "/api", {"prompts": ["1"], "beam_width": 2},
                  method="POST")
        assert e.value.code == 400
    finally:
        server.shutdown()
        t.join(30)
    assert not t.is_alive()
    assert service.engine._thread is None


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of megatron_tpu_torch (the serving, training
    and data modules alike), and chip_smoke.py, in a fresh interpreter:
    neither jax nor megatron_tpu may be loaded."""
    expected = ["megatron_tpu_torch." + m for m in (
        "inference.server", "ops.flash.flash_template", "ops.cross_entropy",
        "training.pretrain", "training.optimizer", "training.train_step",
        "training.scheduler", "training.microbatches", "data.gpt_dataset",
        "data.indexed_dataset", "data.samplers", "data.helpers",
        "data.blendable_dataset", "arguments", "tools.pretrain_gpt",
        "tools.profile_training")]
    code = (
        "import importlib, pkgutil, sys\n"
        "import megatron_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"missing = [m for m in {expected!r} if m not in sys.modules]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'megatron_tpu' or m.startswith('megatron_tpu.')]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sampling_filters_and_greedy_match_jax():
    """The deterministic parts of sampling: greedy argmax with the padded
    vocab clamp, and the per-row top-k/top-p filter."""
    import jax.numpy as jnp

    from megatron_tpu.inference import sampling as js
    from megatron_tpu_torch.inference import sampling as ts

    r = np.random.default_rng(5)
    logits = r.normal(size=(4, 50)).astype(np.float32) * 2
    top_k = np.array([0, 3, 10, 0], np.int32)
    top_p = np.array([0.0, 0.0, 0.7, 0.9], np.float32)
    got = ts.filter_top_k_top_p(torch.from_numpy(logits),
                                torch.from_numpy(top_k).long(),
                                torch.from_numpy(top_p))
    want = js.filter_top_k_top_p(jnp.asarray(logits), jnp.asarray(top_k),
                                 jnp.asarray(top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ts.sample_logits(torch.from_numpy(logits), None,
                         vocab_size=40).numpy(),
        np.asarray(js.sample_logits(jnp.asarray(logits), None,
                                    vocab_size=40)))
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    toks = ts.sample_logits_batched(
        torch.from_numpy(logits), gens, torch.tensor([0.0, 1.0, 0.5, 2.0]),
        torch.from_numpy(top_k).long(), torch.from_numpy(top_p))
    assert toks[0] == int(np.argmax(logits[0]))
    # a top-k row samples from its k best tokens only
    assert int(toks[1]) in np.argsort(-logits[1])[:3].tolist()


def test_cli_serves_on_cpu(tmp_path):
    """python -m megatron_tpu_torch.tools.run_text_generation_server with
    --device cpu boots, answers /healthz and one PUT /api, and exits on
    SIGINT."""
    import signal
    import socket
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "megatron_tpu_torch.tools.run_text_generation_server",
         "--model_name", "tiny", "--tokenizer_type", "null",
         "--serve_num_slots", "2", "--host", "127.0.0.1",
         "--port", str(port), "--seed", "3", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                status, _ = _http(base + "/healthz")
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        assert status == 200
        status, body = _http(base + "/api", {
            "prompts": ["3 4 5"], "tokens_to_generate": 3,
            "temperature": 0.0}, method="PUT")
        assert status == 200
        assert len(json.loads(body)["text"][0].split()) == 6
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "serving generation API" in out
