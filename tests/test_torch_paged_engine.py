"""megatron_tpu_torch's PagedInferenceEngine against the JAX package's.

Both engines run one weight set (a JAX init_params tree converted through
numpy) on the CPU in fp32 on the JAX package's paged serving matrix
(tests/test_serving_engine.py, tests/test_paging.py): a multi-chunk
prompt, a ragged batch, a prefix-cache hit, preemption mid-stream in a
10-page pool, interleaved traffic, chunked prefill interleaving with
decode, rounding to a page multiple and the sliding-window page release.
Greedy tokens must be identical, prompt logprobs within 1e-4, and the
prefix, preemption and chunk counters equal. Sampled requests cannot
match jax.random's noise; the port's own checks hold a sampled request's
tokens fixed across chunk sizes and a forced preemption, and the paged
engine's greedy tokens to the port's dense engine.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest

from megatron_tpu.inference.engine import Request as JRequest
from megatron_tpu.inference.paging import PagedInferenceEngine as JPaged
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")
STATS = ("prefix_hits", "prefix_tokens_saved", "preemptions",
         "prefill_chunks")


def _weights(**kw):
    jcfg, tcfg = j_presets.tiny(**kw), presets.tiny(**kw)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def weights():
    return _weights(**KW)


def _pair(weights, **kw):
    """(JAX paged engine, port paged engine) with the same settings."""
    jcfg, jparams, tcfg, tparams = weights
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return (JPaged(jcfg, jparams, vocab_size=65, metrics=JRegistry(), **kw),
            PagedInferenceEngine(tcfg, tparams, vocab_size=65, device="cpu",
                                 metrics=MetricsRegistry(), **kw))


def _same_stats(jeng, teng):
    assert {k: jeng.stats[k] for k in STATS} == \
        {k: teng.stats[k] for k in STATS}


def _submit_both(jeng, teng, prompt, **kw):
    prompt = np.asarray(prompt, np.int32)
    return (jeng.submit(JRequest(prompt=prompt, **kw)),
            teng.submit(Request(prompt=prompt, **kw)))


def _same_request(jr, tr):
    assert jr.error is None and tr.error is None, (jr.error, tr.error)
    assert tr.generated == jr.generated
    np.testing.assert_allclose(tr.prompt_logprobs, jr.prompt_logprobs,
                               atol=1e-4)
    np.testing.assert_allclose(tr.logprobs, jr.logprobs, atol=1e-4)


def test_multi_chunk_prompt_and_ragged_batch_match_jax(weights):
    """Chunk 4 < prompt 10 < 2 pages: 3 chunks with page-spanning
    writes; then a ragged batch (4 and 1 prompt tokens) on the same
    engines."""
    jeng, teng = _pair(weights, prefill_chunk=4)
    prompts = np.asarray([[3, 7, 11, 2, 9, 4, 1, 8, 5, 2]], np.int32)
    lengths = np.asarray([10], np.int32)
    want = jeng.generate(prompts, lengths, max_new_tokens=8)
    got = teng.generate(prompts, lengths, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)
    assert teng.stats["prefill_chunks"] == 3
    prompts = np.asarray([[3, 7, 11, 2], [5, 0, 0, 0]], np.int32)
    lengths = np.asarray([4, 1], np.int32)
    want = jeng.generate(prompts, lengths, max_new_tokens=6)
    got = teng.generate(prompts, lengths, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)
    _same_stats(jeng, teng)


def test_prefix_cache_hit_matches_jax(weights):
    """A request sharing another's 16-token prefix aliases its 2 pages
    and recomputes only the boundary token + suffix (15 positions saved),
    with the same tokens and teacher-forced prompt logprobs."""
    jeng, teng = _pair(weights)
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 60, 16)
    for suffix in ([7, 3], [9, 5, 2]):
        jr, tr = _submit_both(jeng, teng, np.concatenate([shared, suffix]),
                              max_new_tokens=6)
        jeng.run_until_idle()
        teng.run_until_idle()
        _same_request(jr, tr)
    assert teng.stats["prefix_hits"] == 1
    assert teng.stats["prefix_tokens_saved"] == 15
    _same_stats(jeng, teng)
    # drained: only the radix tree holds pages
    assert teng.pool.used_pages == len(teng.prefix_cache) == \
        jeng.pool.used_pages


def test_preemption_midstream_matches_jax(weights):
    """9 usable pages of 4 cannot hold two 22-token sequences (6 pages
    each): the younger request is preempted mid-stream, resumed by
    teacher-forced recompute of prompt + generated, and both finish
    token-identical to the JAX engine."""
    jeng, teng = _pair(weights, num_slots=2, max_seq_len=32, page_size=4,
                       prefill_chunk=8, num_pages=10)
    pairs = [_submit_both(jeng, teng, p, max_new_tokens=16)
             for p in ([3, 7, 11, 2, 9, 4], [5, 8, 1, 6, 2, 7])]
    jeng.run_until_idle()
    teng.run_until_idle()
    for jr, tr in pairs:
        _same_request(jr, tr)
    assert teng.stats["preemptions"] >= 1
    _same_stats(jeng, teng)
    assert teng.pool.used_pages == len(teng.prefix_cache)


def test_interleaved_traffic_and_chunked_prefill_match_jax(weights):
    """Requests joining mid-stream, and a 24-token prompt entering the
    cache one 4-token chunk per tick while an active request keeps
    decoding: tick-for-tick the same schedule and tokens as JAX."""
    jeng, teng = _pair(weights, prefill_chunk=4)
    a = _submit_both(jeng, teng, [3, 7], max_new_tokens=20)
    for _ in range(2):
        jeng.step()
        teng.step()
    b = _submit_both(jeng, teng, np.arange(1, 25), max_new_tokens=2)
    c = _submit_both(jeng, teng, [9, 2], max_new_tokens=5)
    progressed = 0
    while b[1].first_token_time is None and not b[1].done.is_set():
        before = len(a[1].generated)
        jeng.step()
        teng.step()
        progressed += int(len(a[1].generated) > before)
        assert a[1].generated == a[0].generated
    # A kept decoding during B's 6-chunk prefill
    assert progressed >= 4
    jeng.run_until_idle()
    teng.run_until_idle()
    for jr, tr in (a, b, c):
        _same_request(jr, tr)
    assert teng.stats["prefill_chunks"] >= 7
    _same_stats(jeng, teng)


def test_rounding_and_pool_validation(weights):
    _, _, tcfg, tparams = weights

    def make(**kw):
        return PagedInferenceEngine(tcfg, tparams, num_slots=1,
                                    device="cpu", metrics=MetricsRegistry(),
                                    **kw)

    with pytest.warns(UserWarning, match="rounding"):
        eng = make(max_seq_len=60, page_size=8)
    assert eng.max_seq_len == 64 and eng.max_pages == 8
    assert eng.num_pages == 1 * 8 + 1 and eng.caches[0].shape[1:3] == (9, 8)
    with pytest.raises(ValueError, match="cannot hold even one"):
        PagedInferenceEngine(tcfg, tparams, num_slots=2, max_seq_len=64,
                             page_size=8, num_pages=4, device="cpu",
                             metrics=MetricsRegistry())
    with pytest.raises(ValueError, match="num_pages"):
        make(max_seq_len=64, page_size=8, num_pages=1)
    with pytest.raises(ValueError, match="page_size"):
        make(max_seq_len=64, page_size=0)
    # the CUDA kernel's page rule, checked when the engine is built
    with pytest.raises(ValueError, match="power of two"):
        make(max_seq_len=64, page_size=12)


def test_sliding_window_release_matches_jax():
    """Pages fully behind a 16-token window return to the pool while the
    requests still decode (to length 72): token-identical to the JAX
    engine with the same release count; a drained engine holds only the
    radix pages (one full page per 12-token prompt), and the same traffic
    drains again through prefix hits."""
    weights = _weights(vocab_size=64, seq_length=128, num_layers=2,
                       sliding_window_size=16, attention_impl="pallas")
    jeng, teng = _pair(weights, num_slots=2, max_seq_len=128,
                       prefill_chunk=16)
    prompts = np.random.default_rng(0).integers(1, 64, (2, 12)).astype(
        np.int32)
    lengths = np.full((2,), 12, np.int32)
    want = jeng.generate(prompts, lengths, max_new_tokens=60)
    got = teng.generate(prompts, lengths, max_new_tokens=60)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)
    assert teng.stats["window_pages_released"] > 0
    assert (teng.stats["window_pages_released"]
            == jeng.stats["window_pages_released"])
    held = [p for p in range(1, teng.num_pages)
            if teng.pool.refcount(p) > 0]
    assert len(held) == 2
    assert teng.pool.free_pages == teng.num_pages - 1 - len(held)
    again = teng.generate(prompts, lengths, max_new_tokens=60)
    np.testing.assert_array_equal(again.tokens, want.tokens)
    assert teng.stats["prefix_hits"] == 2


def test_paged_greedy_matches_the_dense_engine(weights):
    _, _, tcfg, tparams = weights
    prompts = np.zeros((3, 11), np.int32)
    lengths = np.array([11, 3, 6], np.int32)
    r = np.random.default_rng(0)
    for b, p in enumerate(lengths):
        prompts[b, :p] = r.integers(0, 64, size=p)
    dense = InferenceEngine(tcfg, tparams, num_slots=2, max_seq_len=64,
                            vocab_size=65, device="cpu",
                            metrics=MetricsRegistry())
    paged = PagedInferenceEngine(tcfg, tparams, num_slots=2, max_seq_len=64,
                                 page_size=8, prefill_chunk=4, vocab_size=65,
                                 device="cpu", metrics=MetricsRegistry())
    want = dense.generate(prompts, lengths, max_new_tokens=7)
    got = paged.generate(prompts, lengths, max_new_tokens=7)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)


def test_sampled_tokens_ignore_chunk_size_and_preemption(weights):
    """Only the final chunk draws from a sampled request's generator, and
    a preempted request resumes from the generator state saved at
    preemption: the same seed gives the same tokens with chunks of 4 or
    64, and with or without a forced preemption mid-decode."""
    _, _, tcfg, tparams = weights
    prompt = np.asarray([5, 8, 1, 6, 2, 7, 3, 9, 4, 11], np.int32)
    sampled = dict(max_new_tokens=12, temperature=0.9, top_k=20, seed=5)

    def run(chunk, preempt_at=None):
        eng = PagedInferenceEngine(tcfg, tparams, num_slots=2,
                                   max_seq_len=64, page_size=8,
                                   prefill_chunk=chunk, vocab_size=65,
                                   device="cpu", metrics=MetricsRegistry())
        req = eng.submit(Request(prompt=prompt, **sampled))
        while not req.done.is_set():
            eng.step()
            if len(req.generated) == preempt_at:
                assert eng._preempt_one()
                preempt_at = None
        assert req.error is None, req.error
        return eng, req

    _, base = run(4)
    _, wide = run(64)
    eng, pre = run(4, preempt_at=5)
    assert eng.stats["preemptions"] == 1 and pre.resume_key is not None
    assert wide.generated == base.generated == pre.generated
    # and the draws are real: another seed gives other tokens
    sampled["seed"] = 6
    _, reseeded = run(4)
    assert reseeded.generated != base.generated


def test_dense_engine_resumes_by_recompute(weights):
    """The base engine's admission resumes a request that carries
    generated tokens and a saved generator state (what a preemption
    leaves): prompt + generated is teacher-forced and the next token is
    the one the uninterrupted run sampled, greedy or sampled."""
    _, _, tcfg, tparams = weights
    prompt = np.asarray([7, 1, 30, 4, 9], np.int32)

    def engine():
        return InferenceEngine(tcfg, tparams, num_slots=2, max_seq_len=64,
                               vocab_size=65, device="cpu",
                               metrics=MetricsRegistry())

    for knobs in ({}, dict(temperature=0.8, top_k=10, seed=3)):
        eng = engine()
        whole = eng.submit(Request(prompt=prompt, max_new_tokens=9, **knobs))
        eng.run_until_idle()
        eng = engine()
        part = eng.submit(Request(prompt=prompt, max_new_tokens=9, **knobs))
        while len(part.generated) < 4:
            eng.step()
        state = (eng.generators[0].get_state() if knobs else None)
        resumed = Request(prompt=prompt, max_new_tokens=9,
                          generated=list(part.generated),
                          logprobs=list(part.logprobs),
                          prompt_logprobs=list(part.prompt_logprobs),
                          resume_key=state, **knobs)
        eng = engine()
        eng.submit(resumed)
        eng.run_until_idle()
        assert resumed.error is None
        assert resumed.generated == whole.generated
        np.testing.assert_allclose(resumed.logprobs, whole.logprobs,
                                   atol=1e-4)
        assert resumed.prompt_logprobs == part.prompt_logprobs


def _http(url, body=None, method="GET"):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read().decode()


def test_cli_serves_paged_on_cpu():
    """run_text_generation_server --serve_kv_paging --device cpu boots the
    paged engine, prints its pool, answers PUT /api, and exports the page
    and prefix metrics."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "megatron_tpu_torch.tools.run_text_generation_server",
         "--model_name", "tiny", "--tokenizer_type", "null",
         "--serve_num_slots", "2", "--serve_max_seq_len", "64",
         "--serve_kv_paging", "--serve_page_size", "8",
         "--serve_prefill_chunk", "4", "--host", "127.0.0.1",
         "--port", str(port), "--seed", "3", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                _http(base + "/healthz")
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        prompt = " ".join(str(t) for t in range(3, 20))
        for _ in range(2):
            status, body = _http(base + "/api", {
                "prompts": [prompt], "tokens_to_generate": 3,
                "temperature": 0.0}, method="PUT")
            assert status == 200
            assert len(json.loads(body)["text"][0].split()) == 17 + 3
        status, metrics = _http(base + "/metrics")
        assert "engine_pages_total 16" in metrics
        assert "engine_pages_free " in metrics
        # the repeat aliased the first request's two full pages
        assert "engine_prefix_cache_hits_total 1" in metrics
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "paged KV pool: 17 pages x 8 tokens" in out
    assert "paged KV" in out and "serving generation API" in out
