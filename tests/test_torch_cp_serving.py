"""Context-parallel serving (megatron_tpu_torch/inference/context_parallel/
and the quant collectives under it) on the CPU, against the JAX
package's ContextParallelEngine on the fake CPU mesh.

One launch of 2 gloo ranks and one of 4 (tests/_torch_cp_serving_worker.py)
serve the same weights (a JAX init_params tree of the tiny preset, vocab
64, fp32) through the port's ContextParallelEngine (2 slots, max_seq_len
64, pages of 8, chunks of 8) in each cell of the JAX test's matrix
(tests/test_context_parallel.py): ring_serial_dense, ring_overlap_dense
and ring_overlap_int8 at cp2, 2d_dense and 2d_int8 (cp_head 2) at cp4,
each with the JAX test's traffic (the 13-token ragged prompt, a radix hit
mid-shard, a preemption mid-prefill). Held against the JAX engine of the
same cell with the same traffic: tokens equal, logprobs within the JAX
test's _logprob_atol (1e-5 dense, 5e-3 int8), and the engine_cp_*
counters (stats) equal. The decode partial runs B5's partial form
(paged_flash_decode(return_lse=True), its plain version here), the
chunk partial the plain stripe path; both are held against the JAX
stripe partial directly, a rank with local length 0 included. The
collectives (compressed psum, all-gather and ring hop at 2 ranks, the 2d
head legs at 4) are held against the JAX functions in shard_map on a
context-only fake mesh: data movement exact, int8/fp8 payloads bitwise
(their dequantized results equal). Host-only parts (the striped pool,
the local tables, the refusals, pool exhaustion) run in this process on
a rank-0 view of the mesh.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_cp_serving_worker as C
import _torch_parallel_worker as W
from megatron_tpu.config import ParallelConfig as JParallel
from megatron_tpu.inference.context_parallel import (
    ContextParallelEngine as JCPEngine,
)
from megatron_tpu.inference.context_parallel import ring_kv as j_ring_kv
from megatron_tpu.inference.engine import Request as JRequest
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.models.params import param_specs as j_param_specs
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.parallel.sharding import shard_tree
from megatron_tpu.quant import collectives as jc
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.config import ParallelConfig
from megatron_tpu_torch.inference.context_parallel import (
    ContextParallelEngine, StripedPagePool,
)
from megatron_tpu_torch.inference.context_parallel import ring_kv
from megatron_tpu_torch.inference.paging.pool import SCRATCH_PAGE
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.ops.flash import flash_template as ft
from megatron_tpu_torch.ops.flash.masks import NEG_INF
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.tools import run_text_generation_server as srv

CP2 = ("ring_serial_dense", "ring_overlap_dense", "ring_overlap_int8")
CP4 = ("2d_dense", "2d_int8")
# the JAX test's seeds of the preempted prompt: 7 for its fixture engine
# (ring_overlap_dense), 11 for the matrix cells
SEEDS = {c: (7 if c == "ring_overlap_dense" else 11) for c in CP2 + CP4}


def _logprob_atol(cell: str) -> float:
    """tests/test_context_parallel.py's: the int8 cells carry the ring and
    head-leg quantization noise in their logprobs."""
    return 5e-3 if "int8" in cell else 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = j_presets.tiny(vocab_size=64, seq_length=64)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("cp") / "weights.npz")
    np.savez(path, **_flat(jax.device_get(jparams)))
    return path, jcfg, jparams


@pytest.fixture(scope="module", autouse=True)
def ranks(weights):
    """Both launches, started with the module's first test (the host-only
    tests run meanwhile); results() of each joins it."""
    path = weights[0]
    worlds = {
        2: W.World(2, [
            ("cells", "call", ("_torch_cp_serving_worker:cells_job",
                               {"weights": path, "cells": CP2,
                                "preempt_seed": SEEDS})),
            ("collectives", "call",
             ("_torch_cp_serving_worker:collectives_job", {})),
            ("http", "call", ("_torch_cp_serving_worker:http_job",
                              {"weights": path}))]),
        4: W.World(4, [
            ("cells", "call", ("_torch_cp_serving_worker:cells_job",
                               {"weights": path, "cells": CP4,
                                "preempt_seed": SEEDS})),
            ("collectives", "call",
             ("_torch_cp_serving_worker:collectives_job", {}))])}
    done = {}

    def results(world):
        if world not in done:
            done[world] = worlds[world].results()
            assert "error" not in done[world], done[world]["error"]
        return done[world]

    yield results
    for world in worlds:
        results(world)


@pytest.fixture(scope="module")
def jax_cells(weights):
    """The JAX ContextParallelEngine of a cell with the same traffic,
    built on first use."""
    _, jcfg, jparams = weights
    done = {}

    def cell(name):
        if name not in done:
            spec = dict(C.CELLS[name])
            cp = spec.pop("cp")
            rt = j_build_mesh(JParallel(context_parallel=cp),
                              devices=jax.devices()[:cp])
            eng = JCPEngine(jcfg, shard_tree(rt, jparams,
                                             j_param_specs(jcfg)),
                            metrics=JRegistry(), mesh=rt.mesh, **C.ENGINE,
                            **spec)
            real = C._request
            C._request = lambda p, n: JRequest(
                prompt=np.asarray(p, np.int32), max_new_tokens=n)
            try:
                done[name] = C._traffic(eng, SEEDS[name])
            finally:
                C._request = real
            done[name]["engine"] = eng
        return done[name]

    return cell


def _port(ranks, cell):
    return ranks(2 if cell in CP2 else 4)["cells"][cell]


# ---------------------------------------------------------------------------
# B5's partial form and the plain stripe partial, against the JAX stripe
# partial (ring_kv.py's per-rank (o, lse) before the merge)

CP, PS, NPL, HQ, HKV, D = 2, 4, 8, 4, 2, 16
MAX_PAGES = 6
NS = types.SimpleNamespace(cp=CP, _npl=NPL, _mpl=-(-MAX_PAGES // CP))
# pre-increment lengths: the new key lands at this position. Row 0 and 1
# put every key on rank 0 (rank 1's local length 0), row 3 ends on a
# page boundary (L = 8), row 4 spans two pages a rank
LENGTHS = np.array([0, 2, 4, 7, 13], np.int32)


def _tables():
    pool = StripedPagePool(CP * NPL, CP)
    rows = np.zeros((len(LENGTHS), MAX_PAGES), np.int32)
    for i, n in enumerate(LENGTHS):
        pages = pool.alloc(-(-(int(n) + 1) // PS))
        rows[i, :len(pages)] = pages
    return rows


def _stripe_inputs(b, s, seed=3):
    """q, k_new, v_new [b, s, ...] and the global pools, seeded."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, HQ, D), (b, s, HKV, D), (b, s, HKV, D),
        (CP * NPL, PS, HKV, D), (CP * NPL, PS, HKV, D)))


def _jax_partials(monkeypatch, q, kn, vn, kp, vp, loc, idx, per_slot,
                  ws=None, we=None, window=None):
    """The JAX ring_kv partial of every rank: its merge replaced by an
    all-gather of the (o, lse) partials. Returns (o [cp, B, S, Hq, D],
    lse [cp, B, S, Hq], the written pools)."""
    def gather(cpc, o, lse, perm, hops):
        og = jax.lax.all_gather(o, cpc.axis)
        lg = jax.lax.all_gather(lse, cpc.axis)
        return jnp.concatenate([og, lg[..., None]], -1), None

    monkeypatch.setattr(j_ring_kv, "_ring_merge", gather)
    # a context-only mesh: its one axis is the island's manual axis
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:CP]), ("context",))
    cpc = jc.make_cp_comm(mesh, "dense")
    fences = () if ws is None else (jnp.int32(ws), jnp.int32(we))
    ctx, (kp2, vp2) = jax.jit(
        lambda q, kn, vn, kp, vp, loc, idx, *f:
        j_ring_kv.paged_ring_attention(cpc, q, kn, vn, (kp, vp), loc, idx,
                                       per_slot, *f,
                                       sliding_window=window))(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(loc), jnp.asarray(idx), *fences)
    ctx = np.asarray(ctx)
    return ctx[..., :D], ctx[..., D], np.asarray(kp2), np.asarray(vp2)


def _local(pool, r):
    return torch.from_numpy(pool[r * NPL:(r + 1) * NPL].copy())


@pytest.mark.parametrize("window", [None, 3])
def test_decode_partial_equals_the_jax_stripe_partial(monkeypatch, window):
    """Decode: each rank's write of the new key into its stripe, then its
    partial against the JAX stripe partial: without a window B5's partial
    form (the plain version on the CPU) over the local table at the
    local length, with one the plain stripe path (B5's window mask cannot
    express a stripe's range). o within 1e-5, lse within 1e-5 where
    finite; a rank with local length 0 gives o = 0 and lse at NEG_INF's
    depth (-inf on the stripe path) where JAX's is -inf."""
    q, kn, vn, kp, vp = _stripe_inputs(len(LENGTHS), 1)
    loc = ContextParallelEngine._loc_tables(NS, _tables())
    jo, jl, jkp, jvp = _jax_partials(monkeypatch, q, kn, vn, kp, vp, loc,
                                     LENGTHS, True, window=window)
    empty = 0
    for r in range(CP):
        kpr, vpr = _local(kp, r), _local(vp, r)
        lt = torch.from_numpy(loc[r])
        pos = torch.from_numpy(LENGTHS).long()
        keep = torch.ones(len(LENGTHS), dtype=torch.bool)
        rows = torch.arange(len(LENGTHS))
        ring_kv._write_stripe(kpr, torch.from_numpy(kn[:, 0]), lt, pos, rows,
                              CP, r, keep)
        ring_kv._write_stripe(vpr, torch.from_numpy(vn[:, 0]), lt, pos, rows,
                              CP, r, keep)
        np.testing.assert_array_equal(kpr.numpy(),
                                      jkp[r * NPL:(r + 1) * NPL])
        np.testing.assert_array_equal(vpr.numpy(),
                                      jvp[r * NPL:(r + 1) * NPL])
        lens = ring_kv.local_lengths(pos + 1, CP, r, PS, loc.shape[2])
        if window is None:
            o, lse = ft.paged_flash_decode(
                torch.from_numpy(q), kpr, vpr,
                torch.clamp(lt, max=NPL - 1).int(), lens, return_lse=True)
        else:
            o, lse = ring_kv.stripe_partial(torch.from_numpy(q), kpr, vpr,
                                            lt, CP, r, pos, True, window)
        assert o.dtype == lse.dtype == torch.float32
        want_l = jl[r].transpose(0, 2, 1)             # [B, Hq, S]
        np.testing.assert_allclose(o.numpy(), jo[r], atol=1e-5, rtol=0)
        finite = np.isfinite(want_l)
        np.testing.assert_allclose(lse.numpy()[finite], want_l[finite],
                                   atol=1e-5, rtol=0)
        assert (lse.numpy()[~finite] <= NEG_INF / 2).all()
        for i in np.nonzero(lens.numpy() == 0)[0]:
            empty += 1
            assert not finite[i].any() and not o[i].any()
    assert empty >= 2           # rows 0 and 1 on rank 1


@pytest.mark.parametrize("window", [None, 5])
def test_stripe_partial_of_a_chunk_equals_jax(monkeypatch, window):
    """A prefill chunk (row 4's table, 8 positions at offset 6, writes
    fenced to [7, 12)) through the plain stripe partial against JAX's,
    with and without a sliding window (the route B5 cannot take)."""
    q, kn, vn, kp, vp = _stripe_inputs(1, 8, seed=4)
    loc = ContextParallelEngine._loc_tables(NS, _tables()[4:5])
    jo, jl, jkp, _ = _jax_partials(monkeypatch, q, kn, vn, kp, vp, loc, 6,
                                   False, 7, 12, window)
    for r in range(CP):
        kpr, vpr = _local(kp, r), _local(vp, r)
        lt = torch.from_numpy(loc[r])
        pos = 6 + torch.arange(8)
        keep = (pos >= 7) & (pos < 12)
        rows = torch.zeros(8, dtype=torch.long)
        ring_kv._write_stripe(kpr, torch.from_numpy(kn[0]), lt, pos, rows,
                              CP, r, keep)
        ring_kv._write_stripe(vpr, torch.from_numpy(vn[0]), lt, pos, rows,
                              CP, r, keep)
        np.testing.assert_array_equal(kpr.numpy(),
                                      jkp[r * NPL:(r + 1) * NPL])
        o, lse = ring_kv.stripe_partial(torch.from_numpy(q), kpr, vpr, lt,
                                        CP, r, 6, False, window)
        want_l = jl[r].transpose(0, 2, 1)
        np.testing.assert_allclose(o.numpy(), jo[r], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.isfinite(lse.numpy()),
                                      np.isfinite(want_l))
        finite = np.isfinite(want_l)
        np.testing.assert_allclose(lse.numpy()[finite], want_l[finite],
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# host-side parts, on a rank-0 view of the mesh


def test_striped_pool_ownership_and_striping():
    pool = StripedPagePool(8, 2)
    assert pool.pages_per_rank == 4
    assert pool.free_pages_by_rank() == [3, 4]
    pages = pool.alloc(4)
    assert [pool.owner(p) for p in pages] == [0, 1, 0, 1]
    assert pool.free_pages_by_rank() == [1, 2]
    more = pool.alloc(2, logical_start=4)
    assert [pool.owner(p) for p in more] == [0, 1]


def test_striped_pool_all_or_nothing_per_rank():
    pool = StripedPagePool(8, 2)
    assert pool.alloc(7) is None
    assert pool.free_pages_by_rank() == [3, 4]
    pages = pool.alloc(6)
    assert pages is not None and pool.free_pages_by_rank() == [0, 1]
    pool.release(pages)
    assert pool.free_pages_by_rank() == [3, 4]
    with pytest.raises(ValueError):
        StripedPagePool(9, 2)
    (p,) = pool.alloc(1)
    pool.release([p])
    with pytest.raises(ValueError):
        pool.release([p])
    pool.retain([SCRATCH_PAGE])
    pool.release([SCRATCH_PAGE])


def _engine(weights, cp=2, **kw):
    cfg = presets.tiny(**C.KW)
    mesh = build_mesh(ParallelConfig(context_parallel=cp), world_size=cp,
                      rank=0)
    params = params_from_numpy(jax.device_get(weights[2]), cfg,
                               device="cpu", mesh=mesh)
    args = dict(C.ENGINE, device="cpu", cuda_graph=False,
                metrics=MetricsRegistry(), mesh=mesh,
                channel=types.SimpleNamespace(fault=None))
    args.update(kw)
    return ContextParallelEngine(cfg, params, **args)


def test_loc_tables_equal_jax_and_keep_the_invariant(weights):
    eng = _engine(weights)
    npl, mpl = eng._npl, eng._mpl
    row = np.zeros((1, eng.max_pages), np.int32)
    row[0, 0], row[0, 1] = 1, npl + 2
    loc = eng._loc_tables(row)
    assert loc.shape == (2, 1, mpl)
    assert loc[0, 0, 0] == 1 and loc[1, 0, 0] == 2
    assert loc[0, 0, 1] == 0 and loc[1, 0, 1] == npl
    for n in (1, 5, 8):
        pages = eng.pool.alloc(n)
        rows = np.zeros((2, eng.max_pages), np.int32)
        rows[0, :n] = pages
        np.testing.assert_array_equal(
            eng._loc_tables(rows), JCPEngine._loc_tables(
                types.SimpleNamespace(cp=2, _npl=npl, _mpl=mpl), rows))
        eng.pool.release(pages)
    bad = np.zeros((1, eng.max_pages), np.int32)
    bad[0, 1] = 1
    with pytest.raises(AssertionError, match="striping invariant"):
        eng._loc_tables(bad)


def test_engine_rounds_pool_and_holds_a_stripe(weights):
    eng = _engine(weights, num_pages=11)
    assert eng.num_pages == 12 and eng.pool.pages_per_rank == 6
    assert eng.caches[0].shape[:2] == (2, 6)       # [L, pages a rank]
    assert eng._device_table.shape == (2, eng._mpl)


def test_engine_refuses_what_jax_refuses(weights):
    cfg = presets.tiny(**C.KW)
    with pytest.raises(ValueError, match="requires a mesh"):
        ContextParallelEngine(cfg, {}, mesh=None, device="cpu")
    solo = build_mesh(ParallelConfig(), world_size=1, rank=0)
    with pytest.raises(ValueError, match="cp == 1"):
        ContextParallelEngine(cfg, {}, mesh=solo, device="cpu")
    with pytest.raises(ValueError, match="ring transport"):
        _engine(weights, cp_collectives="none")
    with pytest.raises(ValueError, match="int8 KV"):
        _engine(weights, kv_cache_int8=True)
    with pytest.raises(ValueError, match="speculative"):
        _engine(weights, speculative=SpecConfig(k=2, drafter="ngram"))
    with pytest.raises(ValueError, match="cuda_graph=True"):
        _engine(weights, cuda_graph=True)
    # a context mesh is the CP engine's: the paged engine refuses it
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine

    with pytest.raises(ValueError, match="context-parallel engine"):
        PagedInferenceEngine(
            cfg, {}, device="cpu", cuda_graph=False,
            mesh=build_mesh(ParallelConfig(context_parallel=2),
                            world_size=2, rank=0),
            channel=types.SimpleNamespace(fault=None))


def test_pool_exhaustion_names_the_dry_shards(weights, tmp_path):
    from megatron_tpu_torch.telemetry.journal import (
        EventJournal, set_global_journal,
    )

    eng = _engine(weights)
    set_global_journal(EventJournal(str(tmp_path)))
    try:
        f = eng.pool.free_pages_by_rank()
        grabbed = eng._alloc_pages(2 * min(f))
        assert grabbed is not None
        for r, extra in enumerate(f):
            for _ in range(extra - min(f)):
                tail = eng._alloc_pages(1, logical_start=r)
                assert tail is not None
                grabbed += tail
        assert eng.pool.free_pages == 0 and eng._overload_detail() == ""
        assert eng._alloc_pages(2) is None
        assert eng.stats["cp_admission_blocked"] == 1
        blocked = eng.metrics.counter("engine_cp_admission_blocked_total",
                                      label_names=("shard",))
        assert blocked.value(shard="0") == blocked.value(shard="1") == 1.0
        assert "cp shard(s) 0,1 exhausted" in eng._overload_detail()
        assert eng._alloc_pages(2) is None
        assert eng.stats["cp_admission_blocked"] == 2
        eng.max_queue = 0
        rej = eng.submit(C._request([1, 2, 3], 2))
        assert rej.overloaded and "cp shard(s) 0,1 exhausted" in rej.error
        page1 = next(p for p in grabbed if eng.pool.owner(p) == 1)
        eng.pool.release([page1])
        assert eng._alloc_pages(2) is None
        assert "cp shard(s) 0 exhausted" in eng._overload_detail()
        assert eng._alloc_pages(1, logical_start=1) is not None
        assert eng._overload_detail() == ""
    finally:
        set_global_journal(None)
    events = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    dry = [e for e in events if e["kind"] == "cp_admission_blocked"]
    assert [e["shards"] for e in dry] == [[0, 1], [0]]
    assert dry[0]["free_by_rank"] == [0, 0] and dry[0]["need"] == [1, 1]


@pytest.mark.parametrize("flags,match", [
    (["--context_parallel_size", "2"], "add --serve_context_parallel"),
    (["--serve_context_parallel"], "--context_parallel_size >= 2"),
    (["--context_parallel_size", "2", "--serve_context_parallel"],
     "add --serve_kv_paging"),
    (["--context_parallel_size", "2", "--serve_context_parallel",
      "--serve_kv_paging", "--kv_cache_int8"], "no int8 KV"),
    (["--context_parallel_size", "2", "--serve_context_parallel",
      "--serve_kv_paging", "--serve_cp_lanes", "2"], "ROADMAP.md item 12"),
    (["--context_parallel_size", "2", "--serve_context_parallel",
      "--serve_kv_paging"], "needs one process per rank"),
])
def test_the_server_cli_refuses_what_cp_serving_does_not_cover(flags, match):
    with pytest.raises(SystemExit, match=match):
        srv.main(["--model_name", "tiny", "--device", "cpu", *flags])


# ---------------------------------------------------------------------------
# the engine matrix, against the JAX engine


@pytest.mark.parametrize("cell", CP2 + CP4)
def test_fresh_ragged_prompt_equals_jax(ranks, jax_cells, cell):
    """13 tokens: 2 chunks, neither aligned to page_size x cp; the ragged
    tail crosses a shard boundary mid-page."""
    got, want = _port(ranks, cell)["fresh"], jax_cells(cell)["fresh"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                               atol=_logprob_atol(cell), rtol=0)


@pytest.mark.parametrize("cell", CP2 + CP4)
def test_radix_hit_mid_shard_equals_jax(ranks, jax_cells, cell):
    """The second request aliases 3 cached pages whose stripe spans every
    rank."""
    got, want = _port(ranks, cell)["radix"], jax_cells(cell)["radix"]
    assert got["hit"] and want["hit"]
    assert got["generated"] == want["generated"]
    np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                               atol=_logprob_atol(cell), rtol=0)
    np.testing.assert_allclose(got["prompt_logprobs"],
                               want["prompt_logprobs"],
                               atol=_logprob_atol(cell), rtol=0)


@pytest.mark.parametrize("cell", CP2 + CP4)
def test_preempt_resume_mid_prefill_equals_jax(ranks, jax_cells, cell):
    got, want = _port(ranks, cell)["preempt"], jax_cells(cell)["preempt"]
    assert got["mid_prefill"] and got["preempted"]
    assert got["preemptions"] == want["preemptions"] == 1
    assert got["generated"] == want["generated"]
    np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                               atol=_logprob_atol(cell), rtol=0)


@pytest.mark.parametrize("cell", CP2 + CP4)
def test_cp_counters_equal_jax(ranks, jax_cells, cell):
    """engine_cp_ring_steps_total and the cp byte counters (the engine's
    stats) after the same traffic: the JAX engine's numbers; each rank
    holds num_pages / cp pages of the pools."""
    got, want = _port(ranks, cell), jax_cells(cell)
    assert got["stats"] == want["stats"]
    assert got["stats"]["cp_ring_steps"] > 0
    if "int8" in cell:
        assert (got["stats"]["cp_comm_compressed_bytes"]
                < got["stats"]["cp_comm_dense_bytes"])
    cp = C.CELLS[cell]["cp"]
    assert got["local_pool_pages"] == got["pool_pages_per_rank"]
    assert got["pool_pages_per_rank"] * cp == want["engine"].num_pages


def test_http_server_at_cp2(ranks, weights):
    """run_server with cp_serving at cp2 (int8 hops): a greedy request
    answers the JAX cell's tokens (the fresh prompt's, cp2 int8);
    scoring is refused with a 400."""
    got = ranks(2)["http"]
    status, body = got["generate"]
    assert status == 200 and got["engine"] == "ContextParallelEngine"
    toks = [int(t) for t in body["text"][0].split()]
    want = _port(ranks, "ring_overlap_int8")["fresh"]["tokens"][0]
    assert toks == want[:len(toks)] and len(toks) == len(C.RAGGED) + C.NEW
    status, body = got["score"]
    assert status == 400 and "context parallelism" in body["message"]
    assert got["stats"]["cp_ring_steps"] > 0


# ---------------------------------------------------------------------------
# the collectives on gloo ranks, against the JAX functions


def _inputs(world):
    return np.stack([np.random.default_rng(r).standard_normal(
        (2, 4, 64)).astype(np.float32) for r in range(world)])


def _jax_per_device(fn, xs):
    """fn on each device's block of xs [n, ...] inside a shard_map over a
    context-only mesh of n fake devices; each device's result."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:len(xs)]), ("context",))
    # eager, not jitted: under jit XLA may turn the scale's division by
    # 127 into a product with its reciprocal, one bit off the division
    # both packages write
    out = jax.shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                        in_specs=P("context"), out_specs=P("context"),
                        check_vma=False)(jnp.asarray(xs))
    return np.asarray(out)


def _same(got_views, key, want, mode):
    for r, view in enumerate(got_views):
        if mode == "dense":
            np.testing.assert_allclose(view[key], want[r], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(view[key], want[r])


@pytest.mark.parametrize("mode", ["dense", "int8", "fp8"])
def test_two_rank_collectives_equal_jax(ranks, mode):
    """compressed_psum, compressed_all_gather and ring_permute at 2 gloo
    ranks against the JAX functions on each device's input."""
    views = ranks(2)["collectives"]
    xs = _inputs(2)
    _same(views, f"psum_{mode}", _jax_per_device(
        lambda x: jc.compressed_psum(x, "context", mode, 16), xs), mode)
    _same(views, f"gather_{mode}", _jax_per_device(
        lambda x: jc.compressed_all_gather(x, "context", mode, 16), xs),
        mode)
    _same(views, f"ring_{mode}", _jax_per_device(
        lambda x: jc.ring_permute(x, "context", [(0, 1), (1, 0)], mode, 16),
        xs), mode)
    if mode == "dense":
        np.testing.assert_allclose(views[0]["psum_dense"], xs.sum(0),
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_four_rank_2d_legs_equal_jax(ranks, mode):
    """grouped_all_to_all / grouped_all_gather in subgroups {0, 1},
    {2, 3} and the ring across them (r -> r + 2) against the JAX
    functions with axis_index_groups."""
    views = ranks(4)["collectives"]
    xs = _inputs(4)
    groups = [[0, 1], [2, 3]]
    perm = [(r, (r + 2) % 4) for r in range(4)]
    _same(views, f"a2a_{mode}", _jax_per_device(
        lambda x: jc.grouped_all_to_all(x, "context", 1, 0, groups, mode,
                                        16), xs), mode)
    _same(views, f"ag_{mode}", _jax_per_device(
        lambda x: jc.grouped_all_gather(x, "context", 1, groups, mode, 16),
        xs), mode)
    _same(views, f"ring_{mode}", _jax_per_device(
        lambda x: jc.ring_permute(x, "context", perm, mode, 16), xs), mode)
