"""megatron_tpu_torch's int8 KV caches against the JAX package's.

ops/kv_quant.py is held bit for bit against megatron_tpu/ops/kv_quant.py
(half-way values included: both round half to even). The int8 cache
paths run on one weight set (a JAX init_params tree converted through
numpy) on the CPU in fp32: a cached int8 decode tracks the full forward
(tests/test_kv_quant.py), and the dense and paged int8 engines match the
JAX int8 engines token for token (tests/test_serving_engine.py), with a
prefix-cache hit, a preemption mid-stream and n-gram speculation.
Greedy tokens must be identical and logprobs within 1e-4.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.inference.engine import InferenceEngine as JEngine
from megatron_tpu.inference.engine import Request as JRequest
from megatron_tpu.inference.generation import _init_caches as j_init_caches
from megatron_tpu.inference.paging import PagedInferenceEngine as JPaged
from megatron_tpu.inference.speculative import SpecConfig as JSpec
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_forward as j_lm_forward
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.ops import kv_quant as jq
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.generation import _init_caches
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.ops import kv_quant as tq
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = j_presets.tiny(**KW), presets.tiny(**KW)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _halfway_rows():
    """Rows whose amax is 127 (scale exactly 1.0), so x / scale lands on
    .5 values; a zero row (the 1e-8 floor); and seeded normal rows."""
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    rng = np.random.default_rng(0)
    return np.stack([half, np.zeros(8, np.float32),
                     *rng.normal(size=(6, 8)).astype(np.float32) * 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_the_jax_quantize(dtype):
    x = _halfway_rows().reshape(2, 4, 8)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jqv, jscale = jq.quantize_kv(jx)
    tqv, tscale = tq.quantize_kv(tx)
    assert tqv.dtype == torch.int8 and tscale.dtype == torch.float32
    assert tuple(tscale.shape) == (2, 4, 1)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    # round half to even at the .5 values
    assert tqv[0, 0, :7].tolist() == [127, 0, 2, 2, 0, -2, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_is_bitwise_the_jax_dequantize(dtype):
    x = _halfway_rows().reshape(2, 4, 8)
    jqv, jscale = jq.quantize_kv(jnp.asarray(x))
    want = jq.dequantize_kv(jqv, jscale, dtype=getattr(jnp, dtype))
    got = tq.dequantize_kv(torch.from_numpy(np.array(jqv)),
                           torch.from_numpy(np.array(jscale)),
                           dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_int8_caches_layout_and_bytes(weights):
    _, _, tcfg, _ = weights
    full = _init_caches(tcfg, 2, 16, device="cpu")
    quant = _init_caches(tcfg, 2, 16, device="cpu", int8=True)
    assert [c.dtype for c in quant] == [torch.int8, torch.int8,
                                        torch.float32, torch.float32]
    assert tuple(quant[2].shape) == tuple(full[0].shape[:-1]) + (1,)
    # int8 payload is a quarter of the fp32 cache; one fp32 scale per D
    payload = sum(c.nbytes for c in quant[:2])
    assert payload * 4 == sum(c.nbytes for c in full)
    assert sum(c.nbytes for c in quant[2:]) * tcfg.head_dim == payload * 4


def test_cached_int8_decode_matches_jax_and_tracks_the_full_forward(
        weights):
    """Prefill 8 positions into an int8 cache, then decode 8 tokens one
    at a time: the logits equal the JAX int8 path's within 1e-4 and stay
    within 5% of the uncached forward's scale (argmax agreement >= 0.9,
    tests/test_kv_quant.py)."""
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, (2, 16)).astype(np.int32)
    jc = j_init_caches(jcfg, 2, 16, int8=True)
    tc = _init_caches(tcfg, 2, 16, device="cpu", int8=True)
    jl, jc = j_lm_forward(jcfg, jparams, jnp.asarray(toks[:, :8]),
                          positions=jnp.arange(8)[None, :], kv_caches=jc,
                          cache_index=0)
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        tl, _ = lm_forward(tcfg, tparams, tt[:, :8],
                           positions=torch.arange(8)[None, :],
                           kv_caches=tc, cache_index=0)
        outs_j, outs_t = [np.asarray(jl)], [tl.numpy()]
        for t in range(8, 16):
            jl, jc = j_lm_forward(jcfg, jparams, jnp.asarray(toks[:, t:t + 1]),
                                  positions=jnp.full((2, 1), t),
                                  kv_caches=jc, cache_index=t)
            tl, _ = lm_forward(tcfg, tparams, tt[:, t:t + 1],
                               positions=torch.full((2, 1), t),
                               kv_caches=tc, cache_index=t)
            outs_j.append(np.asarray(jl))
            outs_t.append(tl.numpy())
        ref = lm_forward(tcfg, tparams, tt).numpy()
    got = np.concatenate(outs_t, axis=1)
    np.testing.assert_allclose(got, np.concatenate(outs_j, axis=1),
                               atol=1e-4)
    # the caches: K/V come from fp32 GEMMs that round differently in the
    # last bit, so a value on a rounding edge may land one step away
    for jcache, tcache in zip(jc[:2], tc[:2]):
        d = np.abs(tcache.numpy().astype(int) - np.asarray(jcache, int))
        assert d.max() <= 1 and (d == 0).mean() > 0.99
    for jcache, tcache in zip(jc[2:], tc[2:]):
        np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                                   rtol=1e-5)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


def _same(jr, tr):
    assert jr.error is None and tr.error is None, (jr.error, tr.error)
    assert tr.generated == jr.generated
    np.testing.assert_allclose(tr.prompt_logprobs, jr.prompt_logprobs,
                               atol=1e-4)
    np.testing.assert_allclose(tr.logprobs, jr.logprobs, atol=1e-4)


def _run(engines, prompts, max_new_tokens):
    pairs = []
    for p in prompts:
        p = np.asarray(p, np.int32)
        pairs.append((engines[0].submit(JRequest(prompt=p,
                                                 max_new_tokens=max_new_tokens)),
                      engines[1].submit(Request(prompt=p,
                                                max_new_tokens=max_new_tokens))))
    for eng in engines:
        eng.run_until_idle()
    for jr, tr in pairs:
        _same(jr, tr)


def test_dense_int8_engine_matches_the_jax_int8_engine(weights):
    """A ragged batch through 2 int8 slots (one slot reused): token for
    token the JAX int8 engine's, which matches its own one-shot int8
    path (tests/test_serving_engine.py)."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(num_slots=2, max_seq_len=64, vocab_size=65,
              kv_cache_int8=True)
    jeng = JEngine(jcfg, jparams, metrics=JRegistry(), **kw)
    teng = InferenceEngine(tcfg, tparams, device="cpu",
                           metrics=MetricsRegistry(), **kw)
    assert teng.caches[0].dtype == torch.int8
    _run((jeng, teng), ([3, 7, 11, 2, 9, 4, 1, 8, 5, 2, 6], [5, 9, 3],
                        [40, 2, 2, 17, 30, 1]), 8)


def test_paged_int8_engine_matches_jax_with_a_prefix_hit_and_preemption(
        weights):
    """int8 pools: a request sharing a 16-token prefix aliases its pages
    (the scale pools too), and in a 10-page pool of 4-token pages the
    younger of two 22-token sequences is preempted and resumed by
    recompute; tokens, logprobs and the counters equal JAX's."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(num_slots=4, max_seq_len=64, page_size=8, prefill_chunk=8,
              vocab_size=65, kv_cache_int8=True)
    engines = (JPaged(jcfg, jparams, metrics=JRegistry(), **kw),
               PagedInferenceEngine(tcfg, tparams, device="cpu",
                                    metrics=MetricsRegistry(), **kw))
    shared = np.random.default_rng(3).integers(1, 60, 16)
    for suffix in ([7, 3], [9, 5, 2]):
        _run(engines, [np.concatenate([shared, suffix])], 6)
    assert engines[1].stats["prefix_hits"] == 1
    kw.update(num_slots=2, max_seq_len=32, page_size=4, num_pages=10)
    engines = (JPaged(jcfg, jparams, metrics=JRegistry(), **kw),
               PagedInferenceEngine(tcfg, tparams, device="cpu",
                                    metrics=MetricsRegistry(), **kw))
    _run(engines, [[3, 7, 11, 2, 9, 4], [5, 8, 1, 6, 2, 7]], 16)
    assert engines[1].stats["preemptions"] >= 1
    assert engines[1].stats["preemptions"] == engines[0].stats["preemptions"]
    assert [c.dtype for c in engines[1].caches] == [
        torch.int8, torch.int8, torch.float32, torch.float32]


@pytest.mark.parametrize("paged", [False, True])
def test_int8_ngram_speculation_matches_jax(weights, paged):
    """n-gram speculation (k 3) over int8 caches on both engines: the
    [N, k+1] verify writes k+1 quantized positions a tick and rolls back
    by length; tokens and accept counters equal the JAX engine's."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(num_slots=2, max_seq_len=64, vocab_size=65,
              kv_cache_int8=True)
    if paged:
        kw.update(page_size=8, prefill_chunk=8)
        engines = (JPaged(jcfg, jparams, metrics=JRegistry(),
                          speculative=JSpec(k=3), **kw),
                   PagedInferenceEngine(tcfg, tparams, device="cpu",
                                        metrics=MetricsRegistry(),
                                        speculative=SpecConfig(k=3), **kw))
    else:
        engines = (JEngine(jcfg, jparams, metrics=JRegistry(),
                           speculative=JSpec(k=3), **kw),
                   InferenceEngine(tcfg, tparams, device="cpu",
                                   metrics=MetricsRegistry(),
                                   speculative=SpecConfig(k=3), **kw))
    _run(engines, [[5, 9, 5, 9, 5, 9, 5, 9], [3, 7, 11, 2]], 12)
    for key in ("spec_proposed", "spec_accepted", "spec_emitted"):
        assert engines[1].stats[key] == engines[0].stats[key], key
