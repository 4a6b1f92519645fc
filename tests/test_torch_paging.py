"""megatron_tpu_torch paging units against the JAX package.

  * pool / radix / scheduler: one seeded random sequence of calls goes to
    the JAX classes and to the port's copies; every call returns the same
    value (or raises ValueError on both) and leaves both in the same
    state. The JAX package's unit tests of these classes (misuse errors
    included) run on both implementations.
  * kernel B5's plain version, paged_flash_decode_reference (through the
    CPU wrappers paged_flash_decode / paged_flash_decode_mq), against the
    Pallas paged decode kernel run as the JAX package's own tests run it
    on the CPU (interpret mode), fp32, atol 1e-5: GQA, Sq 1 and 3, ragged
    kv_lengths down to 1, a window with scratch entries behind it, rows
    sharing prefix pages, pages out of order.
  * attention(page_table=...) and lm_forward with paged pools (one decode
    tick, two fenced chunks) against the JAX functions: outputs within
    1e-5 and every non-scratch page of the pools equal.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.inference.paging import pool as jpool
from megatron_tpu.inference.paging import radix as jradix
from megatron_tpu.inference.paging import scheduler as jsched
from megatron_tpu.ops.pallas import flash_template as jft
from megatron_tpu_torch.inference.paging import pool as tpool
from megatron_tpu_torch.inference.paging import radix as tradix
from megatron_tpu_torch.inference.paging import scheduler as tsched
from megatron_tpu_torch.ops.flash import flash_template as tft

ATOL = 1e-5
IMPLS = {"jax": (jpool, jradix, jsched), "torch": (tpool, tradix, tsched)}


# ---------------------------------------------------------------------------
# pool / radix / scheduler: the same random calls on both implementations
# ---------------------------------------------------------------------------


def _tree(level):
    return {k: (n.page, [float(x) for x in n.lp], n.last_used,
                _tree(n.children)) for k, n in level.items()}


def _state(pool, cache, queue):
    return (list(pool._free), list(pool._refs), _tree(cache._children),
            cache._clock, len(cache),
            [(t.slot, t.start, t.off, t.total) for t in queue._tasks])


def _norm(out):
    """A call's return value in comparable form."""
    if isinstance(out, tuple):          # lookup: (pages, per-page logprobs)
        return [int(p) for p in out[0]], [np.asarray(x).tolist()
                                          for x in out[1]]
    if hasattr(out, "slot"):            # a PrefillTask
        return ("task", out.slot, out.off)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_pool_radix_scheduler_match_jax_under_random_calls(seed):
    rng = np.random.default_rng(seed)
    ps, n_pages = 4, 14
    sides = {}
    for name, (pool_m, radix_m, sched_m) in IMPLS.items():
        pool = pool_m.PagePool(n_pages)
        sides[name] = (pool, radix_m.RadixPrefixCache(pool, ps),
                       sched_m.ChunkedPrefillQueue(3), sched_m)
    j_state = sides["jax"]
    calls = []
    for _ in range(120):
        pool = j_state[0]
        live = [p for p in range(1, n_pages) if pool.refcount(p) > 0]
        free = [p for p in range(1, n_pages) if pool.refcount(p) == 0]

        def pick(cands, k):
            return [int(p) for p in rng.choice(cands, size=min(k, len(cands)),
                                               replace=False)] if cands else []

        op = rng.choice(["alloc", "retain", "release", "insert", "lookup",
                         "evict", "clear", "add", "advance", "drop_slot",
                         "misuse"], p=[.15, .08, .12, .14, .12, .07, .02,
                                       .1, .1, .05, .05])
        # tokens from a 3-letter alphabet, so prefixes are often shared
        toks = rng.integers(0, 3, size=int(rng.integers(0, 14))).tolist()
        if op == "alloc":
            args = (int(rng.integers(0, 5)),)
        elif op in ("retain", "release"):
            args = (pick(live, int(rng.integers(1, 3))),)
        elif op == "insert":
            pages = pick(live, len(toks) // ps)
            args = (toks, pages, rng.normal(size=max(len(toks) - 1, 0))
                    .astype(np.float32).tolist())
        elif op == "lookup":
            args = (toks,)
        elif op == "evict":
            args = (int(rng.integers(0, 4)),)
        elif op == "add":
            n = int(rng.integers(1, 9))
            args = (int(rng.integers(0, 4)), n, int(rng.integers(0, n + 1)))
        elif op == "advance":
            args = (int(rng.integers(1, 4)),)
        elif op == "drop_slot":
            args = (int(rng.integers(0, 4)),)
        elif op == "misuse":
            args = (pick(free, 1) or [n_pages - 1],
                    str(rng.choice(["retain", "release"])))
        else:
            args = ()
        results = {}
        for name, (pool, cache, queue, sched_m) in sides.items():
            try:
                if op in ("alloc", "retain", "release"):
                    out = getattr(pool, op)(*args)
                elif op in ("insert", "lookup", "evict", "clear"):
                    out = getattr(cache, op)(*args)
                elif op == "add":
                    slot, n, start = args
                    out = queue.add(sched_m.PrefillTask(
                        slot=slot, tokens=np.arange(n, dtype=np.int32),
                        start=start, off=0))
                elif op == "advance":
                    task = queue.peek()
                    out = None if task is None else queue.advance(task,
                                                                  *args)
                elif op == "drop_slot":
                    out = queue.drop_slot(*args)
                else:
                    out = getattr(pool, args[1])(args[0])
                results[name] = ("ok", _norm(out))
            except ValueError as e:
                results[name] = ("ValueError", str(e))
        calls.append((op, args))
        assert results["jax"] == results["torch"], calls[-3:]
        assert _state(*sides["jax"][:3]) == _state(*sides["torch"][:3]), \
            calls[-3:]
    ops = {op for op, _ in calls}
    assert {"alloc", "insert", "lookup", "evict", "add"} <= ops


# the JAX package's own unit tests of these classes (tests/test_paging.py),
# on both implementations


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_pool_refcounts_and_misuse(impl):
    pool_m = IMPLS[impl][0]
    pool = pool_m.PagePool(6)
    assert pool.free_pages == 5 and pool.used_pages == 0
    a = pool.alloc(2)
    assert len(a) == 2 and pool_m.SCRATCH_PAGE not in a
    pool.retain(a)
    assert pool.release(a) == 0 and pool.release(a) == 2
    assert pool.free_pages == 5
    assert pool.alloc(6) is None and pool.free_pages == 5
    (p,) = pool.alloc(1)
    pool.release([p])
    with pytest.raises(ValueError):
        pool.release([p])
    with pytest.raises(ValueError):
        pool.retain([p])
    with pytest.raises(ValueError):
        pool.alloc(-1)
    with pytest.raises(ValueError):
        pool_m.PagePool(1)
    pool.retain([pool_m.SCRATCH_PAGE])
    pool.release([pool_m.SCRATCH_PAGE])


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_radix_lookup_insert_evict_clear(impl):
    pool_m, radix_m, _ = IMPLS[impl]
    pool = pool_m.PagePool(32)
    cache = radix_m.RadixPrefixCache(pool, 4)
    toks = list(range(10, 22))
    pages = pool.alloc(3)
    lps = [float(-t) for t in range(1, 12)]
    assert cache.insert(toks, pages, lps) == 3
    hit, hlps = cache.lookup(toks)
    assert hit == pages
    np.testing.assert_allclose(np.concatenate(hlps), lps)
    assert cache.lookup(toks[:8] + [99, 98, 97, 96])[0] == pages[:2]
    assert cache.lookup(toks[:6])[0] == pages[:1]
    dup = pool.alloc(3)
    assert cache.insert(toks, dup, lps) == 0          # existing copy wins
    assert pool.refcount(pages[0]) == 2 and pool.refcount(dup[0]) == 1
    assert cache.evict(3) == 0                        # slots still hold them
    pool.release(pages)
    other = pool.alloc(2)
    cache.insert(list(range(100, 108)), other, [0.0] * 7)
    pool.release(other)
    cache.lookup(list(range(100, 108)))               # most recently used
    assert cache.evict(3) == 3
    assert cache.lookup(toks)[0] == []
    assert cache.lookup(list(range(100, 108)))[0] == other
    assert cache.clear() == 2 and len(cache) == 0
    pool.release(dup)
    assert pool.free_pages == pool.num_pages - 1


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_prefill_queue_fifo_and_validation(impl):
    sched_m = IMPLS[impl][2]
    q = sched_m.ChunkedPrefillQueue(chunk=4)
    t1 = sched_m.PrefillTask(slot=0, tokens=np.arange(10, dtype=np.int32),
                             start=0, off=0)
    t2 = sched_m.PrefillTask(slot=1, tokens=np.arange(6, dtype=np.int32),
                             start=2, off=0)
    q.add(t1)
    q.add(t2)
    assert q.slots == {0, 1} and q.peek() is t1 and t2.off == 2
    assert not q.advance(t1, 4) and not q.advance(t1, 4)
    assert q.advance(t1, 2) and q.peek() is t2
    assert q.drop_slot(1) is t2 and q.drop_slot(1) is None
    assert q.peek() is None and len(q) == 0
    with pytest.raises(ValueError):
        q.add(sched_m.PrefillTask(slot=0, tokens=np.arange(4, dtype=np.int32),
                                  start=4, off=0))
    with pytest.raises(ValueError):
        sched_m.ChunkedPrefillQueue(chunk=0)


# ---------------------------------------------------------------------------
# kernel B5: the plain version vs the Pallas paged kernel (interpret mode)
# ---------------------------------------------------------------------------


def _paged_case(r, sq, hq, hkv, d=16, ps=8, max_pages=5, n_pages=14):
    """Pools, a table whose physical pages are out of order, and rows 0/1
    sharing their first two pages (a prefix-cache hit). Row 2's entries
    past its length are scratch (0); row 3 is an idle row of scratch."""
    b = 4
    q = r.normal(size=(b, sq, hq, d)).astype(np.float32)
    kp = r.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    vp = r.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    perm = r.permutation(np.arange(1, n_pages))
    table = np.zeros((b, max_pages), np.int32)
    table[0] = perm[:5]
    table[1, :2] = perm[:2]
    table[1, 2:] = perm[5:8]
    table[2, :2] = perm[8:10]
    lens = np.array([max_pages * ps - sq + 1, 23, 1, 1], np.int32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("sq,hq,hkv", [(1, 4, 2), (1, 4, 4), (3, 4, 2),
                                       (3, 4, 4)])
@pytest.mark.parametrize("window", [None, 9])
def test_paged_decode_reference_matches_pallas(sq, hq, hkv, window):
    r = np.random.default_rng(20 + sq + hkv)
    q, kp, vp, table, lens = _paged_case(r, sq, hq, hkv)
    if window is not None:
        # pages fully behind row 0's window were released to scratch
        table[0, :2] = 0
    jfn = jft.paged_flash_decode if sq == 1 else jft.paged_flash_decode_mq
    tfn = tft.paged_flash_decode if sq == 1 else tft.paged_flash_decode_mq
    want = jfn(*(jnp.asarray(x) for x in (q, kp, vp, table, lens)),
               sliding_window=window)
    before = tft.paged_flash_decode.launches
    got = tfn(*(torch.from_numpy(x) for x in (q, kp, vp, table, lens)),
              sliding_window=window)
    assert tft.paged_flash_decode.launches == before   # plain on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)
    assert np.isfinite(got.numpy()).all()
    # the same function over the gathered dense view
    kd = torch.from_numpy(kp[table].reshape(4, -1, hkv, 16))
    vd = torch.from_numpy(vp[table].reshape(4, -1, hkv, 16))
    dense = tft.flash_decode_reference(torch.from_numpy(q), kd, vd,
                                       torch.from_numpy(lens), window)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def test_paged_decode_wrappers_refuse_what_they_do_not_cover():
    q = torch.zeros(2, 3, 4, 16)
    kp = torch.zeros(6, 8, 2, 16)
    table = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="single-token"):
        tft.paged_flash_decode(q, kp, kp, table, lens)
    meta = torch.empty(2, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tft.paged_flash_decode(meta, kp, kp, table, lens)
    for ps in (8, 16, 64, 1):
        tft.check_page_size(ps)
    for ps in (0, 12, 24, -8):
        with pytest.raises(ValueError, match="power of two"):
            tft.check_page_size(ps)


# ---------------------------------------------------------------------------
# attention(page_table=...) and lm_forward on pools vs the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_attention_page_table_matches_jax(impl, monkeypatch):
    """Decode (kv_lengths; the JAX side dispatches to its interpret-mode
    kernel under impl="pallas") and a chunk with q_offset (both sides
    gather the pages and take the dense path)."""
    from megatron_tpu.ops.attention import attention as jattention
    from megatron_tpu_torch.ops.attention import attention as tattention

    monkeypatch.setenv("MEGATRON_TPU_FLASH_INTERPRET", "1")
    r = np.random.default_rng(31)
    q, kp, vp, table, lens = _paged_case(r, 1, 4, 2)
    T = [torch.from_numpy(x) for x in (q, kp, vp, table, lens)]
    J = [jnp.asarray(x) for x in (q, kp, vp, table, lens)]
    got = tattention(T[0], T[1], T[2], kv_lengths=T[4], page_table=T[3],
                     impl=impl, sliding_window=12)
    want = jattention(J[0], J[1], J[2], kv_lengths=J[4], page_table=J[3],
                      impl=impl, sliding_window=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    qc = r.normal(size=(1, 6, 4, 16)).astype(np.float32)
    got = tattention(torch.from_numpy(qc), T[1], T[2], q_offset=9,
                     page_table=T[3][1:2], impl=impl)
    want = jattention(jnp.asarray(qc), J[1], J[2], q_offset=9,
                      page_table=J[3][1:2], impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_lm_forward_paged_pools_match_jax():
    """Tiny fp32 model, pools of 10 pages x 8: two prefill chunks of one
    row (the first fenced below position 3, as after a prefix hit; the
    second fenced past the prompt end), then one decode tick of 3 rows
    (one idle on scratch). Logits within 1e-5 and every page but the
    scratch page equal after each call."""
    from megatron_tpu.models import presets as jpresets
    from megatron_tpu.models.language_model import lm_forward as jlm
    from megatron_tpu.models.params import init_params as jinit
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.models.params import params_from_numpy

    kw = dict(vocab_size=64, seq_length=64, num_layers=2,
              attention_impl="pallas")
    jcfg, tcfg = jpresets.tiny(**kw), presets.tiny(**kw)
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    shape = (tcfg.num_layers, 10, 8, tcfg.n_kv_heads, tcfg.head_dim)
    r = np.random.default_rng(7)
    init = [r.normal(size=shape).astype(np.float32) for _ in range(2)]
    jc = tuple(jnp.asarray(x) for x in init)
    tc = tuple(torch.from_numpy(x.copy()) for x in init)
    table = np.array([[4, 2, 7, 0], [9, 5, 0, 0], [0, 0, 0, 0]], np.int32)

    def check(tl, jl, jc):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=1e-5)
        for t, j in zip(tc, jc):
            np.testing.assert_allclose(t[:, 1:].numpy(),
                                       np.asarray(j)[:, 1:], atol=ATOL)

    toks = r.integers(0, 64, size=(1, 20))
    with torch.no_grad():
        for off, start, end in ((0, 3, 20), (12, 0, 17)):
            chunk = toks[:, off:off + 8]
            tl, _ = lm_forward(tcfg, tparams, torch.from_numpy(chunk),
                               kv_caches=tc, cache_index=off,
                               page_table=torch.from_numpy(table[:1]),
                               page_write_start=start, page_write_end=end)
            jl, jc = jlm(jcfg, jparams, jnp.asarray(chunk), kv_caches=jc,
                         cache_index=off, page_table=jnp.asarray(table[:1]),
                         page_write_start=jnp.int32(start),
                         page_write_end=jnp.int32(end))
            check(tl, jl, jc)
        last = r.integers(0, 64, size=(3, 1))
        depth = np.array([17, 11, 0])
        tl, _ = lm_forward(tcfg, tparams, torch.from_numpy(last),
                           kv_caches=tc, cache_index=torch.from_numpy(depth),
                           page_table=torch.from_numpy(table))
        jl, jc = jlm(jcfg, jparams, jnp.asarray(last), kv_caches=jc,
                     cache_index=jnp.asarray(depth),
                     page_table=jnp.asarray(table))
        check(tl, jl, jc)
    with pytest.raises(ValueError, match="single-row"):
        lm_forward(tcfg, tparams, torch.from_numpy(toks[:, :8]).repeat(2, 1),
                   kv_caches=tc, cache_index=0,
                   page_table=torch.from_numpy(table[:2]))
