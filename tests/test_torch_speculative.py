"""megatron_tpu_torch speculative decoding and the captured decode step's
CPU form, against the JAX package (tests/test_speculative.py's cases).

Both packages run one weight set (the `tiny` preset, vocab 64, a JAX
init_params tree converted through numpy) on the CPU in fp32:

  * the accept/reject core: greedy counts, tokens and logprobs equal to
    JAX's speculative_accept (tokens and counts exactly, logprobs within
    1e-6); spec_rows off; the vocab clamp; sampled point-mass exactness;
    the acceptance probability (statistical: 4096 independent rows of a
    50/50 distribution accept at 0.5 within 0.04, 5.1 sigma);
  * validate_spec and the verify kernel's row limit; ngram_propose equal
    to JAX's on seeded histories;
  * the multi-query (verify) attention forms against the JAX kernels in
    interpret mode (within 2e-6) and the dense mq mask (1e-6);
  * both engines with both drafters: greedy speculative tokens equal to
    the JAX speculative engine's and to the port's plain engine's, token
    for token, logprobs within 1e-4, and the spec counters
    (proposed/accepted/emitted, ticks) equal to JAX's on the same
    traffic, through chunked prefill, a prefix hit with a draft, and
    preemption and resume in the middle of a speculation;
  * the per-request opt-out, eod and max_new_tokens inside a
    speculation, the capacity margin, an all-greedy tick that draws and
    sorts nothing, sampled determinism for a seed;
  * the step body on static device buffers: a plain tick gives the
    tokens and logprobs of an engine that rebuilds its inputs every tick
    (the tick before the carry), the device carry stays equal to the
    host mirrors, a failed step fails the requests and rebuilds the
    caches, the paged engine keeps one static page table, and the launch
    counters' capture arithmetic.

Sampled tokens cannot match jax.random's noise (the port draws from
torch.Generators); they are held to determinism instead.
"""

import dataclasses
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.inference.engine import InferenceEngine as JEngine
from megatron_tpu.inference.engine import Request as JRequest
from megatron_tpu.inference.paging import PagedInferenceEngine as JPaged
from megatron_tpu.inference.speculative import SpecConfig as JSpec
from megatron_tpu.inference.speculative import ngram_propose as j_ngram
from megatron_tpu.inference.speculative import speculative_accept as j_accept
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.ops.attention import attention as j_attention
from megatron_tpu.ops.pallas import flash_template as jft
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.inference import speculative as spec_mod
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.sampling import sample_logits_batched
from megatron_tpu_torch.inference.server import (
    GenerationService, make_handler,
)
from megatron_tpu_torch.inference.speculative import (
    SpecConfig, check_verify_rows, ngram_propose, speculative_accept,
    validate_spec,
)
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.ops.flash import flash_template as tft
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.tokenizer import NullTokenizer

KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")
SPEC_STATS = ("spec_proposed", "spec_accepted", "spec_emitted", "ticks")
PAGED_STATS = SPEC_STATS + ("prefix_hits", "preemptions", "prefill_chunks")


def _pair(seed=0, **kw):
    jcfg, tcfg = j_presets.tiny(**KW, **kw), presets.tiny(**KW, **kw)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def weights():
    """The target, and a 1-layer draft of another seed (a draft that
    proposes mostly wrong tokens)."""
    return {"target": _pair(), "small": _pair(num_layers=1, seed=7)}


def _specs(weights, drafter, k=3):
    """(JAX SpecConfig, port SpecConfig) for the drafter: "ngram",
    "model" (draft = the target itself: every draft accepted) or
    "small" (the 1-layer draft)."""
    if drafter == "ngram":
        return JSpec(k=k, drafter="ngram"), SpecConfig(k=k, drafter="ngram")
    jcfg, jparams, tcfg, tparams = weights[
        "target" if drafter == "model" else "small"]
    return (JSpec(k=k, drafter="model", draft_cfg=jcfg, draft_params=jparams),
            SpecConfig(k=k, drafter="model", draft_cfg=tcfg,
                       draft_params=tparams))


def _engines(weights, drafter=None, paged=False, **kw):
    """(JAX engine, port engine), speculative unless drafter is None."""
    jcfg, jparams, tcfg, tparams = weights["target"]
    js, ts = _specs(weights, drafter) if drafter else (None, None)
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 64)
    if paged:
        kw.setdefault("page_size", 8)
        kw.setdefault("prefill_chunk", 8)
    J, T = (JPaged, PagedInferenceEngine) if paged else (JEngine,
                                                        InferenceEngine)
    return (J(jcfg, jparams, vocab_size=65, metrics=JRegistry(),
              speculative=js, **kw),
            T(tcfg, tparams, vocab_size=65, metrics=MetricsRegistry(),
              device="cpu", speculative=ts, **kw))


def _plain(weights, paged=False, **kw):
    return _engines(weights, None, paged, **kw)[1]


def _run(eng, prompts, n=12, req=Request, **kw):
    reqs = [eng.submit(req(prompt=np.asarray(p, np.int32), max_new_tokens=n,
                           **kw)) for p in prompts]
    eng.run_until_idle()
    for r in reqs:
        assert r.error is None, r.error
    return reqs


def _same(jreqs, treqs, prompt_logprobs=False):
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, atol=1e-4)
        if prompt_logprobs:
            np.testing.assert_allclose(tr.prompt_logprobs,
                                       jr.prompt_logprobs, atol=1e-4)


def _same_stats(jeng, teng, keys=SPEC_STATS):
    assert {k: teng.stats[k] for k in keys} == \
        {k: jeng.stats[k] for k in keys}


# ---------------------------------------------------------------------------
# accept/reject (pure functions)
# ---------------------------------------------------------------------------


def _crafted_logits(rows, V=16):
    """[N, K1, V] with a dominant token per (row, position)."""
    N, K1 = len(rows), len(rows[0])
    logits = np.full((N, K1, V), -8.0, np.float32)
    for i, row in enumerate(rows):
        for j, t in enumerate(row):
            logits[i, j, t] = 8.0
    return logits


def _j_accept(logits, drafts, spec_rows=None, vocab=None):
    N = logits.shape[0]
    return [np.asarray(x) for x in j_accept(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jnp.zeros(N, jnp.int32),
        jax.vmap(jax.random.PRNGKey)(jnp.arange(N, dtype=jnp.uint32)),
        jnp.zeros(N), jnp.zeros(N, jnp.int32), jnp.zeros(N),
        vocab_size=vocab,
        spec_rows=None if spec_rows is None else jnp.asarray(spec_rows))]


def _t_accept(logits, drafts, temps=None, top_ks=None, top_ps=None,
              spec_rows=None, vocab=None, seed=0):
    N = logits.shape[0]
    temps = np.zeros(N) if temps is None else np.asarray(temps)
    gens = [torch.Generator().manual_seed(seed + i) if temps[i] > 0
            else None for i in range(N)]
    return [x.numpy() for x in speculative_accept(
        torch.from_numpy(np.asarray(logits)),
        torch.tensor(drafts, dtype=torch.long), temps,
        np.zeros(N, np.int64) if top_ks is None else top_ks,
        np.zeros(N) if top_ps is None else top_ps, gens, vocab_size=vocab,
        spec_rows=None if spec_rows is None else torch.tensor(spec_rows))]


def test_accept_greedy_counts_and_tokens_match_jax():
    """Greedy: accepts = the longest matching draft prefix, tokens the
    target argmax at every position, logprobs the fp32 log-softmax at
    them: equal to JAX's (exactly; logprobs within 1e-6)."""
    logits = _crafted_logits([[2, 3, 4, 5], [1, 6, 0, 7], [9, 9, 9, 9]])
    logits += np.random.default_rng(0).normal(
        0, 0.5, logits.shape).astype(np.float32)
    drafts = [[2, 3, 11], [0, 6, 0], [9, 9, 9]]
    toks, lps, accepts = _t_accept(logits, drafts)
    jt, jl, ja = _j_accept(logits, drafts)
    assert accepts.tolist() == ja.tolist() == [2, 0, 3]
    np.testing.assert_array_equal(toks, jt)
    np.testing.assert_allclose(lps, jl, atol=1e-6)
    assert toks[0].tolist() == [2, 3, 4, 5]


def test_accept_spec_rows_off_forces_single_token():
    logits = _crafted_logits([[2, 3, 4, 5], [2, 3, 4, 5]])
    for temps in ([0, 0], [1.0, 1.0]):
        toks, _, accepts = _t_accept(logits, [[2, 3, 4]] * 2, temps=temps,
                                     spec_rows=[False, True])
        assert accepts.tolist() == [0, 3]
        assert toks[0, 0] == 2        # the greedy / ~certain token
    _, _, ja = _j_accept(logits, [[2, 3, 4]] * 2, spec_rows=[False, True])
    assert ja.tolist() == [0, 3]


def test_accept_sampled_point_mass_exactness():
    """Sampled rows: a draft of a ~certain token is accepted; a
    ~impossible draft is rejected and the residual sample excludes it
    (here the dominant token, everything else being ~0)."""
    logits = _crafted_logits([[3, 3, 3, 3], [3, 3, 3, 3]])
    toks, _, accepts = _t_accept(logits, [[3, 3, 3], [4, 3, 3]],
                                 temps=[1.0, 1.0])
    assert accepts.tolist() == [3, 0]
    assert toks[0].tolist() == [3, 3, 3, 3]
    assert toks[1, 0] == 3
    # a residual never re-emits the rejected draft: with p(4) = 0.5 the
    # rejected rows' token is 3
    logits = np.full((256, 2, 16), -30.0, np.float32)
    logits[:, :, 3] = logits[:, :, 4] = 5.0
    toks, _, accepts = _t_accept(logits, [[4]] * 256, temps=np.ones(256))
    assert (toks[accepts == 0, 0] == 3).all()
    assert (toks[accepts == 1, 0] == 4).all()


def test_accept_sampled_acceptance_probability():
    """The accept test fires with probability p(draft): 4096 independent
    rows of a 50/50 two-token distribution accept the drafted token at
    0.5 within 0.04 (5.1 sigma; sigma = sqrt(0.25 / 4096))."""
    V, N = 16, 4096
    logits = np.full((N, 2, V), -30.0, np.float32)
    logits[:, :, 3] = logits[:, :, 5] = 5.0
    _, _, accepts = _t_accept(logits, [[3]] * N, temps=np.ones(N), seed=11)
    assert abs(accepts.mean() - 0.5) < 0.04, accepts.mean()


def test_accept_vocab_clamp():
    """Padded vocab columns are never emitted, even where a draft points
    at one, greedy (equal to JAX's) or sampled."""
    logits = np.zeros((2, 3, 16), np.float32) + np.arange(16,
                                                          dtype=np.float32)
    drafts = [[15, 15], [14, 14]]
    toks, _, _ = _t_accept(logits, drafts, vocab=8)
    jt, _, _ = _j_accept(logits, drafts, vocab=8)
    np.testing.assert_array_equal(toks, jt)
    assert (toks < 8).all()
    toks, _, _ = _t_accept(logits, drafts, temps=[1.0, 0.7], top_ks=[3, 0],
                           top_ps=[0.0, 0.9], vocab=8)
    assert (toks < 8).all()


def test_validate_spec_and_verify_rows_errors():
    cfg = presets.tiny(**KW)
    with pytest.raises(ValueError, match="k must be"):
        validate_spec(cfg, SpecConfig(k=0))
    with pytest.raises(ValueError, match="drafter"):
        validate_spec(cfg, SpecConfig(drafter="oracle"))
    with pytest.raises(ValueError, match="draft_cfg"):
        validate_spec(cfg, SpecConfig(drafter="model"))
    with pytest.raises(ValueError, match="ngram must be"):
        validate_spec(cfg, SpecConfig(ngram=0))
    bad = presets.tiny(vocab_size=32, seq_length=64)
    with pytest.raises(ValueError, match="vocab"):
        validate_spec(cfg, SpecConfig(drafter="model", draft_cfg=bad,
                                      draft_params={}))
    # the decode kernel's verify limit: (k+1) * G <= 64 query rows
    gqa = presets.tiny(num_attention_heads=32, num_kv_heads=4, **KW)  # G 8
    check_verify_rows(gqa, SpecConfig(k=7))
    with pytest.raises(ValueError, match="query rows per kv head"):
        check_verify_rows(gqa, SpecConfig(k=8))
    with pytest.raises(ValueError, match="k must be"):
        InferenceEngine(cfg, None, device="cpu", speculative=SpecConfig(k=0))


def test_ngram_propose_lookup_fallbacks_and_jax_parity():
    h = np.asarray([1, 2, 3, 4, 1, 2], np.int32)
    assert ngram_propose(h, 3, 2).tolist() == [3, 4, 1]
    h2 = np.asarray([1, 2, 9, 1, 2, 7, 1, 2], np.int32)
    assert ngram_propose(h2, 2, 2).tolist() == [7, 1]   # newest match
    assert ngram_propose(np.asarray([5, 5, 5], np.int32), 2, 2).tolist() \
        == [5, 5]
    assert ngram_propose(np.asarray([1, 2, 3], np.int32), 2, 2).tolist() \
        == [3, 3]
    h3 = np.asarray([1, 2, 9, 1, 2], np.int32)
    assert ngram_propose(h3, 4, 2).tolist() == [9, 1, 2, 2]
    r = np.random.default_rng(3)
    for _ in range(300):
        hist = r.integers(0, r.integers(2, 9), size=r.integers(1, 40))
        k, n = int(r.integers(1, 6)), int(r.integers(1, 4))
        assert ngram_propose(hist, k, n).tolist() == \
            j_ngram(hist, k, n).tolist()


# ---------------------------------------------------------------------------
# the verify pass's attention (Sq = k + 1)
# ---------------------------------------------------------------------------


def test_multi_query_kv_lengths_attention_matches_jax():
    """attention(kv_lengths, Sq > 1): query j sees k_pos < kv_lengths + j,
    on the dense path and through the kernel route's plain version."""
    r = np.random.default_rng(1)
    B, S, H, D, SQ = 2, 32, 2, 8, 4
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, SQ, H, D), (B, S, H, D), (B, S, H, D)))
    lens = np.asarray([5, 28], np.int32)
    want = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  kv_lengths=jnp.asarray(lens)))
    for impl in ("xla", "pallas"):
        got = attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v),
                        kv_lengths=torch.from_numpy(lens), impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_flash_decode_mq_matches_jax_interpret():
    """The verify form of the dense decode kernel's plain version against
    the JAX kernel in interpret mode: GQA, per-row lengths, a window."""
    r = np.random.default_rng(0)
    B, S, Hq, Hkv, D, SQ = 3, 256, 4, 2, 16, 3
    q = r.standard_normal((B, SQ, Hq, D)).astype(np.float32)
    k, v = (r.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray([1, 100, 254], np.int32)
    for window in (None, 32):
        want = jft.flash_decode_mq(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lens),
                                   sliding_window=window, block_k=128)
        got = tft.flash_decode_mq(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(lens),
                                  sliding_window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-6)


def test_paged_flash_decode_mq_matches_jax_interpret():
    """The paged verify form through a page table against the JAX paged
    kernel in interpret mode."""
    r = np.random.default_rng(2)
    B, S, Hq, Hkv, D, SQ, ps = 2, 64, 4, 2, 8, 3, 8
    P = B * (S // ps) + 1
    kp = r.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = r.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    q = r.standard_normal((B, SQ, Hq, D)).astype(np.float32)
    table = (r.permutation(P - 1) + 1).reshape(B, S // ps).astype(np.int32)
    lens = np.asarray([5, 60], np.int32)
    want = jft.paged_flash_decode_mq(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(table),
                                     jnp.asarray(lens))
    got = tft.paged_flash_decode_mq(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


# ---------------------------------------------------------------------------
# engines against JAX
# ---------------------------------------------------------------------------

PROMPTS = ([3, 7, 11, 2], [5, 9, 1, 5, 9, 1, 5, 9], [1, 2, 3],
           [4, 4, 4, 4, 4, 4])


@pytest.mark.parametrize("drafter", ["ngram", "model", "small"])
def test_dense_spec_matches_jax_and_the_plain_engine(weights, drafter):
    """4 greedy requests through 4 slots: tokens equal to the JAX
    speculative engine's and to the port's plain engine's, counters equal
    to JAX's. The model drafter with draft = target accepts every draft;
    the 1-layer draft accepts fewer."""
    jeng, teng = _engines(weights, drafter)
    jr = _run(jeng, PROMPTS, req=JRequest)
    tr = _run(teng, PROMPTS)
    _same(jr, tr, prompt_logprobs=True)
    _same_stats(jeng, teng)
    _same(tr, _run(_plain(weights), PROMPTS))
    assert teng.stats["decode_recompiles"] == 0
    acc, prop = teng.stats["spec_accepted"], teng.stats["spec_proposed"]
    if drafter == "model":
        assert acc == prop > 0
        assert teng.stats["spec_emitted"] / teng.stats["ticks"] > 3.0
    elif drafter == "small":
        assert acc < prop


@pytest.fixture(scope="module")
def zero_engines(weights):
    """(plain, speculative-ngram k=3) port engines over ZERO weights: the
    constant greedy continuation (token 0) drives the n-gram drafter to
    near-full acceptance. Reused by the tests below after each drain."""
    _, _, tcfg, tparams = weights["target"]
    def zero(tree):
        return {k: zero(v) if isinstance(v, dict) else torch.zeros_like(v)
                for k, v in tree.items()}

    zeros = zero(tparams)
    kw = dict(num_slots=4, max_seq_len=64, vocab_size=65, device="cpu")
    return (zeros,
            InferenceEngine(tcfg, zeros, metrics=MetricsRegistry(), **kw),
            InferenceEngine(tcfg, zeros, metrics=MetricsRegistry(),
                            speculative=SpecConfig(k=3), **kw))


def test_spec_request_knob_opt_out(zero_engines):
    """Request(spec=False): no drafts counted for it, the same tokens;
    spec=True traffic in the same engine is unaffected."""
    _, base, eng = zero_engines
    a = _run(base, [[9, 4, 2]], n=8)[0]
    prop0, ticks0 = eng.stats["spec_proposed"], eng.stats["ticks"]
    off = _run(eng, [[9, 4, 2]], n=8, spec=False)[0]
    assert off.generated == a.generated
    assert eng.stats["spec_proposed"] == prop0
    assert eng.stats["ticks"] - ticks0 == 7        # one token a tick
    on = _run(eng, [[9, 4, 2]], n=8)[0]
    assert on.generated == a.generated
    assert eng.stats["spec_proposed"] > prop0


def test_spec_eod_and_max_new_inside_a_speculation(zero_engines, weights):
    """eod emitted inside a multi-token tick: the accepted tokens after
    it are dropped, as plain decode stops there; max_new_tokens = 7 with
    k + 1 = 4 tokens a tick cuts the last tick to exactly 7."""
    _, base, eng = zero_engines
    got = _run(eng, [[3]], n=8, eod=0)[0]
    assert got.generated == _run(base, [[3]], n=8, eod=0)[0].generated \
        == [0]
    # the draft = target accepts every draft: the first tick emits plain
    # decode's tokens 1..4, and an eod equal to token 2 lands inside it
    for prompt in PROMPTS:
        plain = _run(_plain(weights), [prompt])[0].generated
        cut = [j for j in (2, 3) if plain[j] not in plain[:j]]
        if cut:
            break
    j = cut[0]
    _, spec = _engines(weights, "model")
    got = _run(spec, [prompt], eod=plain[j])[0]
    assert got.generated == plain[:j + 1]
    assert spec.stats["ticks"] == 1 and spec.stats["spec_emitted"] == j
    t0, e0 = eng.stats["ticks"], eng.stats["spec_emitted"]
    r7 = _run(eng, [[5, 9]], n=7)[0]
    assert r7.generated == _run(base, [[5, 9]], n=7)[0].generated
    assert len(r7.generated) == 7
    # 1 token from the prefill, then 4 + 2 (the last tick cut)
    assert eng.stats["ticks"] - t0 == 2
    assert eng.stats["spec_emitted"] - e0 == 6


def test_spec_capacity_margin_enforced(zero_engines):
    """A speculating engine reserves k positions: prompt + max_new must
    fit max_seq_len - k (plain engines keep the old bound)."""
    _, base, eng = zero_engines                   # k = 3
    r = eng.submit(Request(prompt=np.asarray([1] * 30, np.int32),
                           max_new_tokens=32))    # 62 > 64 - 3
    assert r.done.is_set() and "headroom" in r.error
    ok = eng.submit(Request(prompt=np.asarray([1] * 30, np.int32),
                            max_new_tokens=31))   # 61 = 64 - 3
    assert not ok.done.is_set()
    eng.run_until_idle()
    assert ok.error is None and len(ok.generated) == 31
    r = base.submit(Request(prompt=np.asarray([1] * 30, np.int32),
                            max_new_tokens=34))
    assert not r.done.is_set()
    base.run_until_idle()
    assert r.error is None


def test_all_greedy_spec_tick_draws_nothing(zero_engines, monkeypatch):
    """After a sampled request retires, every knob of its row is reset,
    so the following all-greedy ticks draw no noise and run no filter
    sort (the port's form of JAX's dead filter branch)."""
    _, _, eng = zero_engines
    greedy = eng.submit(Request(prompt=np.asarray([3, 7], np.int32),
                                max_new_tokens=30))
    sampled = eng.submit(Request(prompt=np.asarray([5], np.int32),
                                 max_new_tokens=2, temperature=0.9,
                                 top_k=7, top_p=0.5, seed=3))
    while not sampled.done.is_set():
        eng.step()
    assert sampled.error is None

    def boom(*a, **k):
        raise AssertionError("an all-greedy tick drew or sorted")

    monkeypatch.setattr(spec_mod, "_gumbel", boom)
    monkeypatch.setattr(spec_mod, "filter_top_k_top_p", boom)
    monkeypatch.setattr(torch, "sort", boom)
    eng.step()
    assert not eng.temps.any() and not eng.top_ks.any() \
        and not eng.top_ps.any()
    assert all(g is None for g in eng.generators)
    eng.run_until_idle()
    assert greedy.error is None and len(greedy.generated) == 30


def test_spec_high_acceptance_and_sampled_determinism(zero_engines, weights):
    """A constant-continuation model with the n-gram drafter nears full
    acceptance: tokens per forward > 3 at k = 3, the output still the
    plain engine's. Sampled speculative requests are deterministic for a
    seed."""
    _, base, eng = zero_engines
    t0, e0 = eng.stats["ticks"], eng.stats["spec_emitted"]
    r = _run(eng, [[3, 7, 11]], n=16)[0]
    assert (eng.stats["spec_emitted"] - e0) / (eng.stats["ticks"] - t0) > 3
    assert r.generated == _run(base, [[3, 7, 11]], n=16)[0].generated
    assert eng.stats["decode_recompiles"] == 0

    _, teng = _engines(weights, "ngram")
    outs = [_run(teng, [[5, 9, 1, 5]], n=10, temperature=0.8, top_k=5,
                 seed=9)[0].generated for _ in range(2)]
    assert outs[0] == outs[1] and len(outs[0]) == 10


def test_paged_spec_ngram_multi_chunk_matches_jax(weights):
    """Chunked prefill across page boundaries (chunk 4, a 10-token
    prompt), then n-gram speculation: tokens, prompt logprobs and
    counters equal to JAX's paged speculative engine."""
    p = [[3, 7, 11, 2, 9, 4, 1, 8, 5, 2], [6, 1, 6, 1, 6]]
    jeng, teng = _engines(weights, "ngram", paged=True, prefill_chunk=4)
    _same(_run(jeng, p, req=JRequest), _run(teng, p), prompt_logprobs=True)
    _same_stats(jeng, teng, PAGED_STATS)
    assert teng.stats["prefill_chunks"] >= 3


def test_paged_spec_model_prefix_hit_matches_jax(weights):
    """The draft pools ride the target's page tables: a prefix hit
    aliases pages in both trees. Tokens, prompt logprobs and counters
    equal to JAX's; every draft accepted (draft = target)."""
    p1 = [3, 7, 11, 2, 9, 4, 1, 8, 5, 2]
    p2 = p1[:8] + [9, 5]
    jeng, teng = _engines(weights, "model", paged=True)
    for p in (p1, p2):
        _same(_run(jeng, [p], req=JRequest), _run(teng, [p]),
              prompt_logprobs=True)
    _same_stats(jeng, teng, PAGED_STATS)
    assert teng.stats["prefix_hits"] == 1
    assert teng.stats["spec_accepted"] == teng.stats["spec_proposed"]


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_paged_spec_preempt_and_resume_matches_jax(weights, drafter):
    """A 10-page pool preempts a slot in the middle of a speculation; the
    resumed request recomputes both trees through the chunks. Greedy
    tokens equal JAX's and an uncontended run's, the counters (preemptions
    included) equal JAX's, every page is accounted for."""
    pa, pb = [3, 7, 11, 2, 9, 4], [5, 8, 1, 6, 2, 7]
    kw = dict(num_slots=2, max_seq_len=32, page_size=4, prefill_chunk=8)
    jeng, teng = _engines(weights, drafter, paged=True, num_pages=10, **kw)
    jr = _run(jeng, [pa, pb], n=16, req=JRequest)
    tr = _run(teng, [pa, pb], n=16)
    _same(jr, tr)
    _same_stats(jeng, teng, PAGED_STATS)
    assert teng.stats["preemptions"] >= 1
    assert teng.pool.used_pages == len(teng.prefix_cache)
    solo = _engines(weights, drafter, paged=True, **kw)[1]
    assert tr[0].generated == _run(solo, [pa], n=16)[0].generated


def test_paged_spec_sampled_preemption_is_deterministic(weights):
    """A sampled request preempted mid-speculation finishes, and two
    identical contended runs agree."""
    pa, pb = [3, 7, 11, 2, 9, 4], [5, 8, 1, 6, 2, 7]

    def contended():
        _, eng = _engines(weights, "ngram", paged=True, num_slots=2,
                          max_seq_len=32, page_size=4, prefill_chunk=8,
                          num_pages=10)
        ra = eng.submit(Request(prompt=np.asarray(pa, np.int32),
                                max_new_tokens=16))
        rb = eng.submit(Request(prompt=np.asarray(pb, np.int32),
                                max_new_tokens=16, temperature=0.7,
                                top_k=8, seed=5))
        eng.run_until_idle()
        assert ra.error is None and rb.error is None
        assert eng.stats["preemptions"] >= 1
        return ra.generated, rb.generated

    a, b = contended(), contended()
    assert a == b and len(a[1]) == 16


# ---------------------------------------------------------------------------
# the step body on static buffers
# ---------------------------------------------------------------------------


class _RebuildEveryTick(InferenceEngine):
    """The tick before the carry: the fed tokens and lengths rebuilt on
    the device from the host mirrors every tick, the forward, then the
    batched sampler over every row."""

    @torch.no_grad()
    def _decode_step(self, rows):
        last = torch.from_numpy(self.last_tok).to(self.device)[:, None]
        lens = torch.from_numpy(self.lengths).to(self.device)
        logits, _ = lm_forward(self.cfg, self.params, last,
                               kv_caches=self.caches, cache_index=lens,
                               rope=self.rope, **self._decode_extra_args())
        logits = logits[:, 0]
        toks = sample_logits_batched(
            logits, self.generators, torch.from_numpy(self.temps),
            torch.from_numpy(self.top_ks), torch.from_numpy(self.top_ps),
            self.vocab_size)
        lps = torch.gather(torch.log_softmax(logits.float(), dim=-1), 1,
                           toks[:, None])[:, 0]
        return (toks[:, None].numpy(), lps[:, None].numpy(),
                np.zeros(self.num_slots, np.int64))


def _mixed(eng):
    """Greedy and sampled requests of mixed lengths through 3 slots (one
    reused), stepping by hand; after every tick the device carry of the
    decode rows equals the host mirrors."""
    reqs = [eng.submit(Request(prompt=np.arange(1, 1 + p, dtype=np.int32),
                               max_new_tokens=n, temperature=t, seed=s))
            for p, n, t, s in ((5, 9, 0.0, 0), (2, 12, 0.9, 4),
                               (11, 4, 0.0, 0), (7, 6, 1.1, 8))]
    while eng.step():
        c, rows = eng._carry, eng._decode_rows()
        if not eng._carry_dirty:
            assert c["lengths"][rows].tolist() == eng.lengths[rows].tolist()
            assert c["last_tok"][rows].tolist() == \
                eng.last_tok[rows].tolist()
    for r in reqs:
        assert r.error is None
    return reqs


def test_plain_step_on_static_buffers_matches_the_rebuilt_tick(weights):
    """The plain step body on the static carry gives the tokens (greedy
    and sampled) and logprobs of the engine that rebuilds its inputs
    every tick, and the carry tracks the host mirrors."""
    _, _, tcfg, tparams = weights["target"]
    kw = dict(num_slots=3, max_seq_len=64, vocab_size=65, device="cpu")
    new = _mixed(InferenceEngine(tcfg, tparams, metrics=MetricsRegistry(),
                                 **kw))
    old = _mixed(_RebuildEveryTick(tcfg, tparams,
                                   metrics=MetricsRegistry(), **kw))
    for a, b in zip(new, old):
        assert a.generated == b.generated
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-6)


def test_speculative_carry_tracks_the_host_mirrors(weights):
    _, teng = _engines(weights, "small", num_slots=3)
    _mixed(teng)


def test_failed_step_fails_requests_and_rebuilds_the_caches(weights):
    """A step that raises fails every request in flight, rebuilds the
    caches (new tensors, the draft's too) and leaves the engine serving
    the same tokens as a fresh one."""
    _, eng = _engines(weights, "model", num_slots=2)
    reqs = [eng.submit(Request(prompt=np.asarray(p, np.int32),
                               max_new_tokens=8)) for p in PROMPTS[:2]]
    eng.step()
    old = (eng.caches[0], eng.draft_caches[0])
    good = eng._step

    def broken():
        raise RuntimeError("injected")

    eng._step = broken
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert all(r.done.is_set() and "decode step failed" in r.error
               for r in reqs)
    assert eng.num_active == 0 and eng._step is not good
    assert eng.caches[0] is not old[0] and eng.draft_caches[0] is not old[1]
    assert eng.stats["decode_recompiles"] == 0      # no capture on the CPU
    again = _run(eng, PROMPTS[:2], n=8)
    fresh = _run(_engines(weights, "model", num_slots=2)[1], PROMPTS[:2],
                 n=8)
    assert [r.generated for r in again] == [r.generated for r in fresh]


def test_paged_failed_step_drops_the_prefix_cache(weights):
    _, eng = _engines(weights, "ngram", paged=True)
    _run(eng, [list(range(1, 20))], n=4)
    assert len(eng.prefix_cache) > 0
    eng.submit(Request(prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=8))
    eng.step()
    eng._step = lambda: (_ for _ in ()).throw(RuntimeError("injected"))
    with pytest.raises(RuntimeError):
        while True:
            eng.step()
    assert len(eng.prefix_cache) == 0 and eng.pool.used_pages == 0
    assert _run(eng, [list(range(1, 20))], n=4)[0].generated == \
        _run(_plain(weights, paged=True), [list(range(1, 20))],
             n=4)[0].generated


def test_paged_engine_keeps_one_static_page_table(weights):
    """The paged tick reads one device table, allocated at construction
    and refreshed in place from the host tables."""
    _, eng = _engines(weights, "ngram", paged=True)
    table = eng._decode_extra_args()["page_table"]
    reqs = [eng.submit(Request(prompt=np.arange(1, p, dtype=np.int32),
                               max_new_tokens=20)) for p in (3, 12, 20)]
    while eng.step():
        assert eng._decode_extra_args()["page_table"] is table
        if not eng._table_dirty:
            assert table.tolist() == eng.tables.tolist()
    assert all(r.error is None for r in reqs)


def test_launch_counters_add_a_capture_difference():
    """The counters' capture arithmetic: a snapshot, a difference, and
    its replay added by name and by query length."""
    before = tft.launch_counts()
    try:
        tft.set_launch_counts({"flash_decode": 5, "flash_decode/sq1": 5,
                               "paged_flash_decode": 2})
        assert tft.flash_decode.launches_by_sq == {1: 5}
        snap = tft.launch_counts()
        tft.add_launch_counts({"flash_decode": 32, "flash_decode/sq5": 32})
        tft.add_launch_counts({"flash_decode": 32, "flash_decode/sq5": 32})
        now = tft.launch_counts()
        assert now["flash_decode"] == 69 and now["flash_decode/sq5"] == 64
        assert now["flash_decode/sq1"] == 5 == snap["flash_decode/sq1"]
        assert now["paged_flash_decode"] == 2 and now["flash_fwd"] == 0
    finally:
        tft.set_launch_counts(before)
    assert tft.launch_counts() == before


# ---------------------------------------------------------------------------
# the server and the CLI
# ---------------------------------------------------------------------------


def _http(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "PUT")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_spec_knob_and_metrics(weights):
    """The server with speculative n-gram: "spec": true and false give the
    same greedy text, a non-boolean spec is a 400, and /metrics carries
    the spec counters and engine_decode_recompiles_total 0."""
    _, _, tcfg, tparams = weights["target"]
    # its own registry: the process-wide default is other tests' too
    service = GenerationService(
        tcfg, tparams, NullTokenizer(64), engine_slots=2,
        engine_max_seq_len=64, metrics=MetricsRegistry(), device="cpu",
        speculative=SpecConfig(k=3))
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = {"prompts": ["3 7 3 7 3"], "tokens_to_generate": 8,
                "temperature": 0.0}
        texts = []
        for spec in (True, False):
            code, out = _http(base + "/api", {**body, "spec": spec})
            assert code == 200, out
            texts.append(json.loads(out)["text"])
        assert texts[0] == texts[1]
        code, out = _http(base + "/api", {**body, "spec": "yes"})
        assert code == 400 and "JSON boolean" in out
        _, metrics = _http(base + "/metrics")
        assert "engine_spec_proposed_total" in metrics
        assert "engine_decode_recompiles_total 0" in metrics
    finally:
        server.shutdown()
        server.server_close()
        t.join(30)
        service.shutdown()


def test_cli_draft_from_the_target_layers(weights):
    """--serve_speculative model without a draft checkpoint: the draft is
    the target's first N layers, slices sharing the target's memory."""
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    _, _, tcfg, tparams = weights["target"]
    args = rts.parse_args(["--serve_speculative", "model",
                           "--serve_draft_layers", "1", "--device", "cpu"])
    spec = rts.load_spec(args, tcfg, tparams)
    dcfg, dparams = spec.draft_cfg, spec.draft_params
    assert (spec.drafter, spec.k, dcfg.num_layers) == ("model", 4, 1)
    wq, dwq = tparams["layers"]["attn"]["wq"], dparams["layers"]["attn"]["wq"]
    assert dwq.shape[0] == 1 and dwq.data_ptr() == wq.data_ptr()
    assert dparams["embed"] is tparams["embed"]
    args = rts.parse_args(["--serve_speculative", "ngram",
                           "--serve_spec_k", "3"])
    assert rts.load_spec(args, tcfg, tparams) == SpecConfig(k=3)
    assert rts.load_spec(rts.parse_args([]), tcfg, tparams) is None
    with pytest.raises(SystemExit):
        rts.load_spec(rts.parse_args(["--serve_speculative", "model",
                                       "--serve_draft_layers", "3"]),
                       tcfg, tparams)


def test_cli_draft_from_a_deeper_checkpoint(weights, tmp_path):
    """--serve_draft_checkpoint: a 2-layer checkpoint loaded into a
    1-layer draft gives the checkpoint's first layer, read through the
    checkpoint loader, and a speculating engine with it
    serves the plain engine's greedy tokens."""
    from megatron_tpu_torch.config import OptimizerConfig, RunConfig
    from megatron_tpu_torch.tools import run_text_generation_server as rts
    from megatron_tpu_torch.training import checkpointing
    from megatron_tpu_torch.training.optimizer import init_train_state

    _, _, tcfg, tparams = weights["target"]
    state = init_train_state(OptimizerConfig(), tparams)
    ck = str(tmp_path / "ck")
    checkpointing.save_checkpoint(ck, state, 5,
                                  config=RunConfig(model=tcfg).to_dict())
    args = rts.parse_args(["--serve_speculative", "model",
                           "--serve_draft_layers", "1",
                           "--serve_draft_checkpoint", ck, "--device", "cpu"])
    loaded = rts.load_spec(args, tcfg, tparams)
    dcfg, dparams = loaded.draft_cfg, loaded.draft_params
    assert dcfg.num_layers == 1
    saved = state.master or state.params      # fp32: no separate masters
    for name, t in dparams["layers"]["mlp"].items():
        assert torch.equal(t, saved["layers"]["mlp"][name][:1])
        assert t.data_ptr() != tparams["layers"]["mlp"][name].data_ptr()
    spec = InferenceEngine(tcfg, tparams, num_slots=2, max_seq_len=64,
                           vocab_size=65, metrics=MetricsRegistry(),
                           device="cpu",
                           speculative=dataclasses.replace(loaded, k=3))
    assert [r.generated for r in _run(spec, PROMPTS[:2])] == \
        [r.generated for r in _run(_plain(weights), PROMPTS[:2])]
