"""KV-state migration in the port (inference/fleet/migration.py and the
engines' export/import) against the JAX package's tests/test_migration.py,
on the CPU with the JAX tests' tiny model (2 layers, h 64, vocab 64, S
64, fp32), the JAX init carried over through params_from_numpy.

  * the wire format: round trips, bf16 through torch, every torn or
    corrupt frame rejected, and the bytes the JAX package's: a JAX frame
    unpacks here and the port's frame is byte-identical to JAX's for the
    same meta and arrays;
  * a request interrupted mid-decode, shipped through the wire bytes and
    resumed on another engine emits the uninterrupted run's tokens,
    greedy and seeded-sampled, dense and paged, across geometries (page
    size, slot count, dense <-> paged), with int8 KV, mid-speculation,
    and through the recompute path when a sliding window released pages;
  * a greedy request exported by the JAX engine continues on the port's
    engine with the JAX engine's tokens; a sampled one whose chain is a
    JAX key is refused;
  * export_all_requests empties the engine; a prefix primed on one paged
    engine becomes a radix hit on another; the prefix directory and the
    router's retry-after and global admission.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from megatron_tpu.inference.engine import InferenceEngine as JEngine
from megatron_tpu.inference.engine import Request as JRequest
from megatron_tpu.inference.fleet import migration as jmig
from megatron_tpu.inference.fleet import router as jrouter
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.fleet.migration import (
    MigrationIntegrityError, PrefixDirectory, pack_state, unpack_state,
)
from megatron_tpu_torch.inference.fleet.router import (
    ReplicaRouter, fleet_retry_after,
)
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

KW = dict(vocab_size=64, seq_length=64)
JCFG, CFG = j_presets.tiny(**KW), presets.tiny(**KW)
JPARAMS = j_init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = params_from_numpy(jax.device_get(JPARAMS), CFG, device="cpu")
PROMPT = np.array([3, 7, 11, 2, 9], np.int32)


def mk(paged=False, cfg=CFG, params=PARAMS, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 64)
    kw.update(device="cpu", metrics=MetricsRegistry())
    if paged:
        kw.setdefault("page_size", 8)
        kw.setdefault("prefill_chunk", 8)
        return PagedInferenceEngine(cfg, params, **kw)
    return InferenceEngine(cfg, params, **kw)


def run_solo(temperature, prompt=PROMPT, n=12, seed=5, **ekw):
    """The uninterrupted run: the answer a migration must give."""
    eng = mk(**ekw)
    r = eng.submit(Request(prompt=prompt.copy(), max_new_tokens=n,
                           temperature=temperature, seed=seed))
    eng.run_until_idle()
    assert r.error is None, r.error
    return r.generated


def mid_export(temperature, ticks, src_kw=None, dst_kw=None):
    """Interrupt a request after `ticks` steps, ship it through the wire
    bytes, resume it on a fresh engine: (tokens, the import's path)."""
    src = mk(**(src_kw or {}))
    r = src.submit(Request(prompt=PROMPT.copy(), max_new_tokens=12,
                           temperature=temperature, seed=5))
    for _ in range(ticks):
        src.step()
    assert not r.done.is_set(), f"done after {ticks} ticks: {r.generated}"
    meta, sections = unpack_state(pack_state(*src.export_request_state(r)))
    dst = mk(**(dst_kw or {}))
    req2, path = dst.import_request_state(meta, sections)
    dst.run_until_idle()
    assert req2.done.is_set() and req2.error is None, req2.error
    return req2.generated, path


# ---------------------------------------------------------------------------
# the wire format


def test_wire_roundtrip_exact_and_bf16_through_torch():
    meta = {"kind": "request", "position": 7, "knobs": {"t": 0.5}}
    sections = {"a": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                "b": np.array([1, -2, 3], np.int32),
                "empty": np.zeros((0,), np.float32),
                "kv": torch.arange(8, dtype=torch.float32).to(
                    torch.bfloat16).reshape(2, 4)}
    m2, s2 = unpack_state(pack_state(meta, sections))
    assert m2 == meta and set(s2) == set(sections)
    for k in ("a", "b", "empty"):
        assert s2[k].dtype == sections[k].dtype
        np.testing.assert_array_equal(s2[k], sections[k])
    assert s2["kv"].dtype == torch.bfloat16
    assert torch.equal(s2["kv"], sections["kv"])


def test_wire_torn_and_corrupt_rejected():
    blob = pack_state({"kind": "request"},
                      {"kv": np.arange(100, dtype=np.float32),
                       "tok": np.array([1, 2, 3], np.int32)})
    for cut in (3, len(blob) // 2, len(blob) - 1):
        with pytest.raises(MigrationIntegrityError):
            unpack_state(blob[:cut])
    flipped = bytearray(blob)
    flipped[-10] ^= 0x40
    with pytest.raises(MigrationIntegrityError, match="crc"):
        unpack_state(bytes(flipped))
    with pytest.raises(MigrationIntegrityError, match="magic"):
        unpack_state(b"HTTP" + blob[4:])
    unpack_state(blob)


def test_wire_bytes_are_the_jax_package_s():
    """The same meta and arrays pack to the same bytes in both packages
    (bf16 as ml_dtypes there, as a torch tensor here), and each unpacks
    the other's frame to the same meta and values."""
    vals = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    meta = {"kind": "request", "prompt": [1, 2], "kv": {"length": 3}}
    jsec = {"kv_k": vals.astype(ml_dtypes.bfloat16),
            "tok": np.array([5, 6], np.int32),
            "resume_key": np.array([1, 2], np.uint32)}
    tsec = {"kv_k": torch.from_numpy(vals).to(torch.bfloat16),
            "tok": np.array([5, 6], np.int32),
            "resume_key": np.array([1, 2], np.uint32)}
    jblob, tblob = jmig.pack_state(meta, jsec), pack_state(meta, tsec)
    assert jblob == tblob
    m, s = unpack_state(jblob)
    assert m == meta
    np.testing.assert_array_equal(s["kv_k"].float().numpy(),
                                  jsec["kv_k"].astype(np.float32))
    m, s = jmig.unpack_state(tblob)
    assert m == meta and s["kv_k"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(s["tok"], tsec["tok"])


# ---------------------------------------------------------------------------
# token-identical resume


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
def test_dense_migration_token_identity(temp):
    want = run_solo(temp)
    got, path = mid_export(temp, ticks=4)
    assert path == "kv_import", path
    assert got == want


def test_int8_kv_cache_migration_token_identity():
    want = run_solo(0.8, kv_cache_int8=True)
    got, path = mid_export(0.8, 4, {"kv_cache_int8": True},
                           {"kv_cache_int8": True})
    assert path == "kv_import" and got == want
    # int8 KV into a float cache cannot install: recompute (the float
    # engine's own tokens)
    got, path = mid_export(0.0, 4, {"kv_cache_int8": True}, {})
    assert path == "recompute"


@pytest.mark.parametrize("case", ["paged_to_paged", "dense_to_paged",
                                  "paged_to_dense", "page_size_16",
                                  "four_slots"])
def test_paged_and_cross_geometry_migration(case):
    """Paged -> paged keeps the pool's accounting; dense <-> paged, a
    different page size and slot count resume token-identically (the
    wire layout is geometry-free)."""
    src, dst = {
        "paged_to_paged": ({"paged": True}, {"paged": True}),
        "dense_to_paged": ({}, {"paged": True}),
        "paged_to_dense": ({"paged": True}, {}),
        "page_size_16": ({"paged": True},
                         {"paged": True, "page_size": 16,
                          "prefill_chunk": 16}),
        "four_slots": ({}, {"num_slots": 4}),
    }[case]
    want = run_solo(0.8, **src)
    got, path = mid_export(0.8, 6 if src.get("paged") else 4, src, dst)
    assert path == "kv_import" and got == want
    if case == "paged_to_paged":
        s = mk(paged=True)
        r = s.submit(Request(prompt=PROMPT.copy(), max_new_tokens=12,
                             temperature=0.8, seed=5))
        for _ in range(6):
            s.step()
        d = mk(paged=True)
        free0 = d.pool.free_pages
        req2, path = d.import_request_state(
            *unpack_state(pack_state(*s.export_request_state(r))))
        assert path == "kv_import" and d.pool.free_pages < free0
        d.run_until_idle()
        assert req2.generated == want and d.num_active == 0
        assert d.pool.free_pages >= free0 - 1


def test_sliding_window_release_migrates_via_recompute():
    cfg = presets.tiny(vocab_size=64, seq_length=128, num_layers=2,
                       sliding_window_size=16)
    jc = j_presets.tiny(vocab_size=64, seq_length=128, num_layers=2,
                        sliding_window_size=16)
    params = params_from_numpy(jax.device_get(
        j_init_params(jc, jax.random.PRNGKey(0))), cfg, device="cpu")

    def mkw():
        return mk(paged=True, cfg=cfg, params=params, max_seq_len=128,
                  prefill_chunk=16)

    prompt = np.arange(1, 13, dtype=np.int32)
    solo = mkw()
    rs = solo.submit(Request(prompt=prompt.copy(), max_new_tokens=40,
                             temperature=0.8, seed=3))
    solo.run_until_idle()
    src = mkw()
    r = src.submit(Request(prompt=prompt.copy(), max_new_tokens=40,
                           temperature=0.8, seed=3))
    while src.stats["window_pages_released"] == 0:
        assert src.step() > 0, "request finished before any release"
    meta, sections = src.export_request_state(r)
    assert "kv" not in meta
    dst = mkw()
    req2, path = dst.import_request_state(
        *unpack_state(pack_state(meta, sections)))
    dst.run_until_idle()
    assert path == "recompute" and req2.generated == rs.generated


def test_mid_speculation_migration_token_identity():
    spec = SpecConfig(k=3, drafter="ngram")
    want = run_solo(0.8, speculative=spec)
    got, path = mid_export(0.8, 2, {"speculative": spec},
                           {"speculative": spec})
    assert path == "kv_import" and got == want


def test_jax_engine_export_continues_on_the_port_engine():
    """A greedy request interrupted on the JAX engine and imported into
    the port's engine (the same weights) emits the JAX engine's tokens;
    a sampled one, whose chain is a JAX key, is refused."""
    def jmk():
        return JEngine(JCFG, JPARAMS, num_slots=2, max_seq_len=64,
                       metrics=JRegistry())

    solo = jmk()
    rs = JRequest(prompt=PROMPT.copy(), max_new_tokens=12)
    solo.submit(rs)
    solo.run_until_idle()
    src = jmk()
    r = JRequest(prompt=PROMPT.copy(), max_new_tokens=12)
    src.submit(r)
    for _ in range(4):
        src.step()
    blob = jmig.pack_state(*src.export_request_state(r))
    dst = mk()
    req2, path = dst.import_request_state(*unpack_state(blob))
    dst.run_until_idle()
    assert path == "kv_import" and req2.generated == rs.generated

    rj = JRequest(prompt=PROMPT.copy(), max_new_tokens=12, temperature=0.8,
                  seed=5)
    src.submit(rj)
    for _ in range(3):
        src.step()
    blob = jmig.pack_state(*src.export_request_state(rj))
    with pytest.raises(ValueError, match="JAX"):
        mk().import_request_state(*unpack_state(blob))


# ---------------------------------------------------------------------------
# the drain primitive, prefixes


def test_export_all_requests_empties_the_engine_and_resumes_elsewhere():
    """Every active and queued request leaves in one sweep (the waiters
    stay parked); imported elsewhere they all finish with the tokens of
    an uninterrupted run, and the drained engine serves new traffic."""
    prompts = [np.array([10 * (i + 1), 3, 4], np.int32) for i in range(3)]
    want = []
    for p in prompts:
        want.append(run_solo(0.0, prompt=p, n=6))
    a = mk()
    reqs = [a.submit(Request(prompt=p.copy(), max_new_tokens=6))
            for p in prompts]
    for _ in range(2):
        a.step()
    exported = a.export_all_requests()
    assert len(exported) == 3
    assert a.num_active == 0 and len(a._queue) == 0
    b = mk()
    imported = []
    for req, meta, sections in exported:
        assert any(req is r for r in reqs) and not req.done.is_set()
        req2, _ = b.import_request_state(
            *unpack_state(pack_state(meta, sections)))
        imported.append(req2)
    b.run_until_idle()
    assert sorted(r.generated for r in imported) == sorted(want)
    r = a.submit(Request(prompt=prompts[0].copy(), max_new_tokens=6))
    a.run_until_idle()
    assert r.generated == want[0]
    for req in reqs:
        req._finish("test cleanup")


def test_prefix_export_import_cross_replica():
    a = mk(paged=True)
    sys_prompt = np.arange(1, 17, dtype=np.int32)      # two full pages
    lens = np.array([16], np.int32)
    ref = a.generate(sys_prompt[None, :], lens, max_new_tokens=8)
    exported = a.export_prefix_state(sys_prompt.tolist())
    assert exported is not None and exported[0]["kind"] == "prefix"
    b = mk(paged=True)
    assert b.import_prefix_state(
        *unpack_state(pack_state(*exported))) >= 1
    hits0 = b.stats["prefix_hits"]
    out = b.generate(sys_prompt[None, :], lens, max_new_tokens=8)
    assert b.stats["prefix_hits"] > hits0
    np.testing.assert_array_equal(out.tokens, ref.tokens)


def test_prefix_directory_bookkeeping():
    d = PrefixDirectory()
    toks = [1, 2, 3, 4]
    assert d.locations(toks) == []
    d.register(toks, "http://b:1")
    d.register(toks, "http://a:1")
    assert d.locations(toks) == ["http://a:1", "http://b:1"]
    d.forget_replica("http://a:1")
    assert d.locations(toks) == ["http://b:1"]
    assert d.snapshot()[0]["replicas"] == ["http://b:1"]


def test_fleet_retry_after_equals_jax_over_a_grid():
    for depth in (0, 1, 3.5, 17, 400):
        for routable in (0, 1, 2, 5):
            for rps in (0.5, 2.0, 10.0):
                for eta in (None, 0.2, 7.0, 500.0):
                    assert fleet_retry_after(
                        depth, routable, rps, eta) == \
                        jrouter.fleet_retry_after(depth, routable, rps, eta)


def test_router_global_admission_rejects_with_retry_after():
    """At the fleet-wide queue bound dispatch answers 503 with the
    fleet-derived Retry-After before any replica is tried, as the JAX
    router does on the same state."""
    import json

    out = []
    for cls, reg in ((ReplicaRouter, MetricsRegistry),
                     (jrouter.ReplicaRouter, JRegistry)):
        router = cls(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                     global_max_queue=4, metrics=reg())
        for st in router.replicas:
            st.load = 3.0
        status, headers, body = router.dispatch(json.dumps(
            {"prompts": ["1 2"], "tokens_to_generate": 2}).encode())
        out.append((status, headers["Retry-After"], b"admission" in body,
                    router.metrics.counter(
                        "router_admission_rejected_total").value()))
    assert out[0] == out[1]
    assert out[0][0] == 503 and out[0][2] and out[0][3] == 1.0
