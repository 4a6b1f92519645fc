"""PagedInferenceEngine: the serving engine over a shared page pool
(counterpart of megatron_tpu/inference/paging/engine.py).

The paged mode of the slot engine (inference/engine.py,
``--serve_kv_paging``). The per-slot ``[N, max_seq_len, ...]`` cache rows
become one pool of fixed-size pages shared by every slot:

  * admission allocates pages for the PROMPT span only (a young sequence
    holds the pages it has, not its worst case); decode grows a slot one
    page at a time as its length crosses page boundaries;
  * requests sharing a prompt prefix alias the same refcounted pages via
    the radix tree (radix.py) and skip prefill for the shared span;
  * prompts enter the cache ``prefill_chunk`` tokens per tick, one chunk
    before each batched decode (scheduler.py), so one long prompt can
    never stall the whole batch;
  * under memory pressure the engine first evicts cache-only prefix
    pages (LRU), then preempts the lowest-priority slot — the most
    recently admitted request (LIFO, so later arrivals yield to earlier
    ones). A preempted request keeps its sampled tokens and its
    generator's state (Request.resume_key) and resumes by teacher-forced
    recompute of prompt + generated, which is exact: it finishes with
    the tokens it would have produced without the preemption.

The decode tick runs every slot's row through lm_forward with the
[N, max_pages] device page table (idle and mid-prefill rows point at
the scratch page): K/V writes go through the table, and attention is the
paged flash-decode kernel (csrc/flash_decode.cu) on CUDA tensors under
attention_impl="pallas". The table is a static device buffer, refreshed
in place from the host tables after an edit, so the tick is captured as
one CUDA graph like the dense engine's (inference/engine.py). A prefill
chunk gathers its row's pages into a dense view and takes the dense
attention path, as the JAX package routes it; chunks stay eager.

Speculative decoding (speculative=SpecConfig) writes k+1 positions a
tick (_decode_write_span), so page allocation covers the whole span. The
model drafter's page pools have the target pools' page count and size
and are addressed through the SAME page tables: every prefill chunk is
mirrored into them through the same table row and write fences, so a
prefix-cache hit aliases pages in both trees, and a preempted request
recomputes both trees on resume. Uncommitted draft positions are never
registered in the radix tree (only the original prompt's full pages
are).

Differences from the JAX engine, by design:
  * The chunks are eager torch.no_grad methods (the JAX engine jits and
    donates); the pools are updated in place.
  * Sampling draws from the request's torch.Generator, and only on the
    final chunk of a prompt: a draw advances the generator, so sampling
    on every chunk (as JAX's split keys allow for free) would make a
    sampled request's tokens depend on the chunk size.
  * The page size follows the CUDA kernel's rule (a power of two, see
    flash_template.check_page_size) under attention_impl="pallas", and
    raises ValueError otherwise; the TPU's multiple-of-8 rule is gone.

kv_cache_int8=True makes the pools int8 with fp32 scale pools [L, P,
ps, nkv, 1]: writes through the table quantize, and attention reads the
whole pool dequantized (the paged decode kernel over the dequantized
pool, a chunk's gather from it), the JAX package's numerics, so the
paged engine stays token-identical to the slot engine in int8 too. The
draft pools stay in the model dtype. Bounded queues, deadlines, weight
reload and wait_idle are the slot engine's (step() runs its _pre_tick
first); a weight swap also empties the radix prefix cache, whose pages
hold the old weights' K/V.

Tensor parallelism (mesh and channel, as the slot engine's): each rank
holds its nkv/tp heads of every page (the JAX engine's _kv_sharding
cuts the pools on the head axis), and page ids are global. Rank 0
alone runs the pool, the radix prefix cache, the chunk queue and
preemption; before each piece of device work it announces what the
other ranks must apply: a chunk's slot table row, tokens, offset and
write fences, then the decode rows with the host page tables and carry
mirrors whenever they changed. The followers keep no scheduler state:
they run the same chunk and the same decode tick, so every collective
meets its peer in order. Tokens are rank 0's, broadcast (the final
chunk's first token, each tick's). The tick runs eagerly (the slot
engine's rule), and int8 pools are cut the same way.

compress_collectives runs the chunk and the tick through the compressed
TP collectives (the slot engine's), each chunk counted at its static
wire price. Context-parallel paging is the subclass in
inference/context_parallel/.

State migration (the slot engine's export/import, inference/engine.py)
gathers a slot's pages into the canonical [L, T, H, D] layout, and an
import allocates pages and writes each page IN PLACE into the pools the
captured tick reads, publishes the slot's table row and re-enters the
prompt's full pages into the radix tree. export_prefix_state and
import_prefix_state move a radix-cached prefix's pages between replicas
(the fleet's prefix directory), so a prompt primed on one replica hits
on another without a prefill.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.generation import from_rank0
from megatron_tpu_torch.inference.paging.pool import SCRATCH_PAGE, PagePool
from megatron_tpu_torch.inference.paging.radix import RadixPrefixCache
from megatron_tpu_torch.inference.paging.scheduler import (
    ChunkedPrefillQueue, PrefillTask,
)
from megatron_tpu_torch.inference.sampling import sample_logits_batched
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.ops.flash.flash_template import check_page_size
from megatron_tpu_torch.ops.kv_quant import kv_buffers
from megatron_tpu_torch.quant.collectives import forward_comm_bytes
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry


class PagedInferenceEngine(InferenceEngine):
    """Slot scheduler + paged KV pool + radix prefix cache.

    Same threading contract as the base engine: submit() from any
    thread, step()/run_until_idle() from one driver thread.
    """

    def __init__(self, cfg: ModelConfig, params, num_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 page_size: int = 16, prefill_chunk: int = 32,
                 num_pages: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, device="cuda",
                 speculative: Optional[SpecConfig] = None,
                 cuda_graph: bool = True, kv_cache_int8: bool = False,
                 max_queue: Optional[int] = None, mesh=None, channel=None,
                 compress_collectives: str = "none", comm_policy=None,
                 comm_chunk: int = 32):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages is not None and num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is scratch), got {num_pages}")
        if cfg.attention_impl == "pallas":
            check_page_size(page_size)
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk)  # validated by the queue
        self.num_pages = num_pages
        self.max_pages = 0          # set by _fresh_caches (needs max_seq_len)
        super().__init__(cfg, params, num_slots=num_slots,
                         max_seq_len=max_seq_len, vocab_size=vocab_size,
                         metrics=metrics, device=device,
                         speculative=speculative, cuda_graph=cuda_graph,
                         kv_cache_int8=kv_cache_int8, max_queue=max_queue,
                         mesh=mesh, channel=channel,
                         compress_collectives=compress_collectives,
                         comm_policy=comm_policy, comm_chunk=comm_chunk)
        if self.num_pages - 1 < self.max_pages:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold even one full "
                f"sequence ({self.max_pages} pages of {self.page_size} for "
                f"max_seq_len {self.max_seq_len}, + the scratch page)")

        N = num_slots
        self.pool = PagePool(self.num_pages)
        self.prefix_cache = RadixPrefixCache(self.pool, self.page_size)
        # host page tables: tables[i] is slot i's logical->physical map.
        # Mid-prefill slots keep their REAL row in _pending_rows and a
        # scratch row here, so the shared decode table can never route an
        # idle-row write into a half-filled (possibly shared) page.
        self.tables = np.zeros((N, self.max_pages), np.int32)
        self._pending_rows = {}
        self._table_dirty = True
        self.prefill_queue = ChunkedPrefillQueue(self.prefill_chunk)
        # one chunk's static wire price for the compressed-collective
        # counters (a [1, C] forward)
        self._comm_chunk_bytes = forward_comm_bytes(
            cfg, self.tp_comm, 1, self.prefill_chunk)
        # admission order for the preemption policy (higher = younger)
        self._admit_seq = [0] * N
        self._admit_counter = 0
        # sliding-window release cursor: first page index of each slot
        # NOT yet released (lengths never shrink, so release progress is
        # monotone — the per-tick scan starts here instead of at page 0)
        self._window_cursor = [0] * N

        self.stats.update({
            "prefix_hits": 0, "prefix_misses": 0,
            "prefix_tokens_saved": 0, "prefill_tokens": 0,
            "prefill_chunks": 0, "preemptions": 0,
            "window_pages_released": 0,
        })
        m = self.metrics
        self._m_pages_total = m.gauge("engine_pages_total",
                                      "KV pool pages (minus scratch)")
        self._m_pages_free = m.gauge("engine_pages_free",
                                     "KV pool pages on the free list")
        self._m_prefix_hits = m.counter(
            "engine_prefix_cache_hits_total",
            "admissions that aliased cached prefix pages")
        self._m_prefix_misses = m.counter(
            "engine_prefix_cache_misses_total",
            "admissions with no cached prefix")
        self._m_prefix_saved = m.counter(
            "engine_prefix_tokens_saved_total",
            "prefill positions skipped via the prefix cache")
        self._m_preempted = m.counter(
            "engine_preemptions_total",
            "slots preempted under page-pool pressure")
        self._m_chunks = m.counter("engine_prefill_chunks_total",
                                   "chunked-prefill steps executed")
        self._m_window_released = m.counter(
            "engine_window_pages_released_total",
            "pages freed from behind the sliding attention window")
        self._m_chunk = m.histogram("engine_prefill_chunk_seconds",
                                    "one prefill chunk's wall time")
        self._m_pages_total.set(self.num_pages - 1)
        self._m_pages_free.set(self.pool.free_pages)

    # ----- cache + shape policy -------------------------------------------

    def _kernel_seq_multiple(self) -> int:
        # logical capacity is whole pages (on every device, as in JAX)
        return self.page_size

    def _fresh_caches(self):
        """Paged pools [L, num_pages, page_size, nkv, D] x2 in the model
        dtype (int8: the 4-tuple with fp32 scale pools [..., 1]) on the
        engine's device, zeroed (so every page, scratch included, holds
        finite values); a tensor-parallel rank's hold its nkv/tp heads
        of every page. The default pool is the slot engine's capacity:
        every slot can grow to max_seq_len."""
        self.max_pages = -(-self.max_seq_len // self.page_size)
        if self.num_pages is None:
            self.num_pages = self.num_slots * self.max_pages + 1
        cfg = self.cfg
        shape = (cfg.num_layers, self.num_pages, self.page_size,
                 cfg.n_kv_heads // self.tp, cfg.head_dim)
        return kv_buffers(shape, cfg.dtype, self.kv_cache_int8, self.device)

    def _fresh_draft_caches(self):
        """The draft model's page pools: the target pools' page count and
        page size, the draft config's own layers and heads, addressed
        through the same page tables (a page shared through the radix
        tree is shared in both pools)."""
        dcfg = self.spec.draft_cfg
        shape = (dcfg.num_layers, self.num_pages, self.page_size,
                 dcfg.n_kv_heads, dcfg.head_dim)
        return (torch.zeros(shape, dtype=dcfg.dtype, device=self.device),
                torch.zeros(shape, dtype=dcfg.dtype, device=self.device))

    def _init_static(self) -> None:
        # the [N, max_pages] device page table the captured tick reads:
        # allocated once, refreshed in place (all scratch until then)
        self._device_table = torch.full(
            (self.num_slots, self.max_pages), SCRATCH_PAGE,
            dtype=torch.int32, device=self.device)

    def _apply_pending_params(self) -> bool:
        # the radix tree's pages hold K/V and logprobs computed with the
        # old weights: a swap drops them (slots in flight keep their own
        # references), so a request after a reload prefills as on an
        # engine built fresh on the new weights. The JAX engine keeps
        # serving the stale pages.
        if not super()._apply_pending_params():
            return False
        self.prefix_cache.clear()
        self._m_pages_free.set(self.pool.free_pages)
        return True

    def _rebuild_caches(self) -> None:
        # the radix tree's pages lose their contents with the pools
        self.prefix_cache.clear()
        self._m_pages_free.set(self.pool.free_pages)
        super()._rebuild_caches()

    # ----- device steps ----------------------------------------------------

    @torch.no_grad()
    def _chunk_forward(self, row: np.ndarray, toks_ext: np.ndarray, off: int,
                       write_start: int, total: int):
        """The device work of one prefill chunk: positions off .. off + C
        - 1 of toks_ext [1, C + 1] through the table row `row`, writes
        fenced to [write_start, total) (and mirrored into the draft
        pools). Returns (logits [1, C, V], the tokens on the device)."""
        C, dev = self.prefill_chunk, self.device
        tokens = torch.from_numpy(toks_ext).to(dev)
        # padded-tail positions past the table clamp to the rope's last
        # row (their outputs and writes are discarded)
        positions = (off + torch.arange(C, device=dev)).clamp(
            max=self.max_seq_len - 1)[None]
        logits, _ = lm_forward(self.cfg, self.params, tokens[:, :C],
                               positions=positions, kv_caches=self.caches,
                               cache_index=off, rope=self.rope,
                               page_write_start=write_start,
                               page_write_end=total, mesh=self.mesh,
                               tp_comm=self.tp_comm,
                               **self._chunk_table_args(row))
        if self._has_draft_model():
            # mirror the chunk into the draft pools through the same
            # table row and write fences (write-only)
            lm_forward(self.spec.draft_cfg, self.draft_params,
                       tokens[:, :C], positions=positions,
                       kv_caches=self.draft_caches, cache_index=off,
                       rope=self.draft_rope,
                       page_write_start=write_start, page_write_end=total,
                       return_hidden=True, **self._chunk_table_args(row))
        return logits, tokens

    def _count_chunk(self) -> None:
        """A prefill chunk's wire price."""
        self._count_comm(self._comm_chunk_bytes)

    def _chunk_table_args(self, row: np.ndarray) -> dict:
        """The lm_forward keywords that address a chunk's table row (the
        context-parallel engine passes this rank's local row)."""
        return {"page_table": torch.tensor(row[None], device=self.device)}

    def _chunk_tokens(self, task: PrefillTask) -> np.ndarray:
        """The chunk's tokens plus the next one, [1, C + 1], zero-padded."""
        C, off = self.prefill_chunk, task.off
        toks_ext = np.zeros((1, C + 1), np.int64)
        avail = task.tokens[off:off + C + 1]
        toks_ext[0, :len(avail)] = avail
        return toks_ext

    @torch.no_grad()
    def _chunk_step(self, task: PrefillTask, req: Request, final: bool):
        """One prefill chunk of one prompt: positions task.off ..
        task.off + C - 1 through the slot's pending table row. Writes
        outside [task.write_start, task.total) land on the scratch page
        (shared-prefix overlap + padded tail).

        The chunk also scores the NEXT prompt token after its last
        position (tokens_ext is the chunk plus one token), so its
        teacher-forced logprobs never wait for the next chunk. Only the
        final chunk samples: from the logits at position total - 1, with
        the request's generator restored from task.key (at tp > 1 rank
        0's token is broadcast). Returns (token, logprob, generator) —
        None for a non-final chunk — and the chunk's prompt logprobs
        [C]."""
        off, dev = task.off, self.device
        logits, tokens = self._chunk_forward(
            self._pending_rows[task.slot], self._chunk_tokens(task), off,
            task.write_start, task.total)
        lsm = torch.log_softmax(logits[0].float(), dim=-1)
        plp = torch.gather(lsm, 1, tokens[0, 1:, None])[:, 0].cpu().numpy()
        if not final:
            return None, plp
        last = logits[:, task.total - 1 - off]
        gen = None
        if task.key is not None:
            gen = torch.Generator(device=dev)
            gen.set_state(task.key)
        tok = sample_logits_batched(
            last, [gen], torch.tensor([req.temperature]),
            torch.tensor([req.top_k]), torch.tensor([req.top_p]),
            self.vocab_size)
        if self.ranks > 1:
            tok = from_rank0(tok.to(dev), self.mesh)
        lp = float(torch.log_softmax(last.float(), dim=-1)[0, tok[0]])
        return (int(tok[0]), lp, gen), plp

    # ----- page accounting -------------------------------------------------

    def _alloc_pages(self, n: int,
                     logical_start: int = 0) -> Optional[List[int]]:
        """n fresh pages, evicting LRU cache-only prefix pages if the
        free list can't cover it. None = still dry (caller defers or
        preempts). logical_start: the logical page index the run starts
        at within its row, unused here; the context-parallel engine's
        striped pool draws each page from the rank that owns its logical
        slot."""
        pages = self.pool.alloc(n)
        if pages is None:
            self.prefix_cache.evict(n - self.pool.free_pages)
            pages = self.pool.alloc(n)
        if pages is not None:
            self._m_pages_free.set(self.pool.free_pages)
        return pages

    def _release_slot_pages(self, i: int) -> None:
        row = self._pending_rows.pop(i, self.tables[i])
        live = [int(p) for p in row if p != SCRATCH_PAGE]
        if live:
            self.pool.release(live)
        self.tables[i] = SCRATCH_PAGE
        self._table_dirty = True
        self._m_pages_free.set(self.pool.free_pages)

    def _clear_slot(self, i: int):
        self._release_slot_pages(i)
        self.prefill_queue.drop_slot(i)
        self._window_cursor[i] = 0
        super()._clear_slot(i)

    # ----- admission -------------------------------------------------------

    def _admit(self) -> int:
        n = 0
        for i in range(self.num_slots):
            if self.slots[i] is not None:
                continue
            with self._cv:
                req = self._queue.popleft() if self._queue else None
                if req is not None:
                    # visible to stalled(): popped but not yet in a slot
                    self._admitting += 1
            if req is None:
                break
            try:
                if not self._try_assign(i, req):
                    # pool can't cover the prompt right now: keep arrival
                    # order (front of the queue) and stop admitting —
                    # active slots retiring will free pages
                    with self._cv:
                        self._queue.appendleft(req)
                        self._m_queue.set(len(self._queue))
                    break
                n += 1
                with self._cv:
                    self._m_queue.set(len(self._queue))
            finally:
                with self._cv:
                    self._admitting -= 1
                self.last_progress_time = time.monotonic()
        return n

    def _try_assign(self, i: int, req: Request) -> bool:
        """Give req slot i: alias cached prefix pages, allocate the rest
        of the prompt span, queue the chunked prefill. False = defer
        (req untouched); a request no idle engine could EVER fit is
        failed loudly instead (returns True: req was consumed)."""
        resumed = req.resume_key is not None or bool(req.generated)
        toks = req.tokens if resumed else np.asarray(req.prompt, np.int32)
        p_ext = len(toks)
        ps = self.page_size
        hit_pages, hit_lps = self.prefix_cache.lookup(toks)
        span = len(hit_pages) * ps
        n_prompt_pages = -(-p_ext // ps)
        # retain the hits BEFORE allocating: _alloc_pages may evict
        # cache-only pages, and un-pinned hit pages are exactly that —
        # an eviction here would free a hit page and hand it back as
        # "fresh", mapping one physical page at two logical blocks
        self.pool.retain(hit_pages)
        fresh = self._alloc_pages(n_prompt_pages - len(hit_pages),
                                  logical_start=len(hit_pages))
        if fresh is None:
            self.pool.release(hit_pages)
            if self.num_active == 0:
                self._reject(
                    req, f"prompt needs {n_prompt_pages} pages but the pool "
                         f"has {self.pool.free_pages} free with no active "
                         f"slots to wait for (num_pages={self.num_pages})")
                return True
            return False
        self._m_pages_free.set(self.pool.free_pages)

        row = np.zeros(self.max_pages, np.int32)
        row[:len(hit_pages)] = hit_pages
        row[len(hit_pages):n_prompt_pages] = fresh
        self._pending_rows[i] = row
        self.slots[i] = req
        self._admit_counter += 1
        self._admit_seq[i] = self._admit_counter

        # recompute starts one position INSIDE the shared span so the
        # boundary token's teacher-forced logprob comes from real logits;
        # its K/V write is fenced onto scratch (write_start = span)
        start = max(span - 1, 0)
        gen = self._generator(req)
        task = PrefillTask(
            slot=i, tokens=toks, start=start, off=start, write_start=span,
            key=None if gen is None else gen.get_state(),
            resumed=resumed, t_start=time.monotonic())
        if not resumed and span > 0:
            # cached teacher-forced logprobs for tokens 1..span-1; the
            # recomputed chunks continue seamlessly from token `span`
            task.plp_parts.extend(hit_lps)
        self.prefill_queue.add(task)

        if span > 0:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += start
            self._m_prefix_hits.inc()
            self._m_prefix_saved.inc(start)
        else:
            self.stats["prefix_misses"] += 1
            self._m_prefix_misses.inc()
        self.stats["admitted"] += 1
        self._m_admitted.inc()
        self._m_active.set(self.num_active)
        return True

    # ----- chunked prefill -------------------------------------------------

    def _prefill_tick(self) -> int:
        """Run at most ONE chunk of the oldest incomplete prefill.
        Returns 1 when a chunk ran (progress signal for run_until_idle)."""
        task = self.prefill_queue.peek()
        if task is None:
            return 0
        i = task.slot
        req = self.slots[i]
        C = self.prefill_chunk
        off = task.off
        t0 = time.monotonic()
        try:
            sampled, plp = self._chunk_step(task, req,
                                            final=off + C >= task.total)
        except Exception as e:  # noqa: BLE001 - a failing chunk must fail
            # THIS request, not strand it un-signalled and kill the loop;
            # at tp > 1 the ranks' collectives are out of step: a fault
            if self.ranks > 1:
                raise
            self._clear_slot(i)
            self._reject(req, f"prefill failed: {e}")
            self._m_active.set(self.num_active)
            return 1
        n = min(C, task.total - off)
        task.plp_parts.append(plp)
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += n
        self._count_chunk()
        self._m_chunks.inc()
        self._m_chunk.observe(time.monotonic() - t0)
        if self.prefill_queue.advance(task, n):
            self._finish_prefill(i, task, *sampled)
        return 1

    def _finish_prefill(self, i: int, task: PrefillTask, tok: int,
                        lp: float, gen: Optional[torch.Generator]):
        """The prompt is fully in the cache: publish the slot's table row
        to the shared decode table, arm the decode mirrors, record the
        first sampled token, and register the prompt's full pages in the
        radix tree."""
        req = self.slots[i]
        row = self._pending_rows.pop(i)
        self.tables[i] = row
        self._table_dirty = True
        p_ext = task.total
        self.lengths[i] = p_ext
        self.last_tok[i] = tok
        self.temps[i] = req.temperature
        self.top_ks[i] = req.top_k
        self.top_ps[i] = req.top_p
        self.generators[i] = gen
        self.spec_on[i] = bool(req.spec)
        self._carry_dirty = True
        req.generated.append(tok)
        req.logprobs.append(lp)
        if not task.resumed:
            req.prompt_logprobs = [
                float(x) for x in np.concatenate(task.plp_parts)[:p_ext - 1]
            ] if task.plp_parts else []
        p0 = len(req.prompt)
        if p0 >= self.page_size:
            # only FULL pages of the ORIGINAL prompt enter the tree (the
            # partially-filled tail page stays private — decode writes
            # into it); resumes re-register recomputed pages, and insert
            # skips paths already cached
            self.prefix_cache.insert(
                req.prompt, [int(p) for p in row[:p0 // self.page_size]],
                req.prompt_logprobs)
        now = time.monotonic()
        self._m_prefill.observe(now - task.t_start)
        if not task.resumed:
            req.first_token_time = now
            if req.submit_time is not None:
                self._m_ttft.observe(now - req.submit_time)
        self._m_tokens.inc()
        if self._req_finished(req):
            self._retire(i)

    # ----- preemption ------------------------------------------------------

    def _preempt_one(self) -> bool:
        """Preempt the youngest active slot (LIFO — later arrivals yield
        pages to earlier ones). Its request re-enters the queue FRONT and
        resumes by exact teacher-forced recompute."""
        cands = [i for i in range(self.num_slots) if self.slots[i] is not None]
        if not cands:
            return False
        i = max(cands, key=lambda j: self._admit_seq[j])
        req = self.slots[i]
        gen = self.generators[i]
        if i not in self.prefill_queue.slots and gen is not None:
            # mid-decode: save the generator so the resumed request
            # samples exactly the tokens it would have sampled
            req.resume_key = gen.get_state()
        self._clear_slot(i)
        with self._cv:
            self._queue.appendleft(req)
            self._m_queue.set(len(self._queue))
        self.stats["preemptions"] += 1
        self._m_preempted.inc()
        self._m_active.set(self.num_active)
        return True

    def _ensure_decode_pages(self) -> None:
        """Before a decode tick, every decodable slot needs real pages
        under its write span (lengths[i] .. lengths[i] + span - 1; shared
        prefix pages are never in the span). Allocate across page
        boundaries, preempting the youngest slot when the pool is dry.
        Each preemption frees that slot's pages, so this terminates."""
        span = self._decode_write_span()
        ps = self.page_size
        while True:
            dry = False
            for i in self._decode_rows():
                first = int(self.lengths[i]) // ps
                last_pg = (int(self.lengths[i]) + span - 1) // ps
                for pg in range(first, last_pg + 1):
                    if self.tables[i, pg] != SCRATCH_PAGE:
                        continue
                    pages = self._alloc_pages(1, logical_start=pg)
                    if pages is None:
                        if not self._preempt_one():
                            # unreachable: slot i itself is preemptible
                            return
                        dry = True
                        break  # re-derive rows (the victim may be gone)
                    self.tables[i, pg] = pages[0]
                    self._table_dirty = True
                if dry:
                    break
            if not dry:
                return

    # ----- stepping --------------------------------------------------------

    def _decode_rows(self) -> List[int]:
        busy = self.prefill_queue.slots
        return [i for i, s in enumerate(self.slots)
                if s is not None and i not in busy]

    def _decode_extra_args(self) -> dict:
        return {"page_table": self._device_table}

    def _refresh_carry(self, rows: List[int]) -> None:
        # the host tables go to the static device table only after an
        # edit, not every tick
        if self._table_dirty:
            self._device_table.copy_(torch.from_numpy(self.tables))
            self._table_dirty = False
        super()._refresh_carry(rows)

    def _release_window_pages(self) -> None:
        """Sliding-window page release: pages every position of which
        sits fully behind a slot's attention window can never be attended
        again — the decode mask only allows k_pos >= length + 1 - window
        and lengths never shrink — so the slot's reference goes back to
        the pool and the table entry parks on scratch (reads of it are
        exactly masked; scratch holds finite values, so the masked scores
        stay well-defined). Pages the radix prefix cache also holds keep
        their cache reference: a later request sharing the prompt still
        hits them."""
        window = self.cfg.sliding_window_size
        if window is None:
            return
        ps = self.page_size
        freed = 0
        for i in self._decode_rows():
            limit = int(self.lengths[i]) - int(window)
            if limit < ps:
                continue
            # O(1) amortized: at most one page per slot newly crosses the
            # window per tick, and the cursor never rewinds (a cleared or
            # preempted slot resets it in _clear_slot)
            for pg in range(self._window_cursor[i], limit // ps):
                if self.tables[i, pg] != SCRATCH_PAGE:
                    self.pool.release([int(self.tables[i, pg])])
                    self.tables[i, pg] = SCRATCH_PAGE
                    self._table_dirty = True
                    freed += 1
            self._window_cursor[i] = max(self._window_cursor[i],
                                         limit // ps)
        if freed:
            self.stats["window_pages_released"] += freed
            self._m_window_released.inc(freed)
            self._m_pages_free.set(self.pool.free_pages)

    def step(self) -> int:
        """One engine tick: admit, run one prefill chunk, then one
        batched decode for every slot whose prompt is fully cached.
        Returns slots served + chunks run (0 = idle)."""
        if self.ranks > 1:
            return self._step_tensor_parallel()
        self._pre_tick()
        self._admit()
        chunked = self._prefill_tick()
        if chunked:
            # chunked prefill with no decodable slots is still progress —
            # without this a long multi-chunk prompt would trip the
            # stalled() readiness check while prefilling normally
            self.last_progress_time = time.monotonic()
        self._release_window_pages()
        self._ensure_decode_pages()
        return self._decode_tick() + chunked

    # ----- tensor parallelism ---------------------------------------------

    def _step_tensor_parallel(self) -> int:
        """Rank 0's tick at tp > 1: the single-rank tick's scheduling on
        the host (admission, the radix cache, the chunk queue, window
        release, decode pages and preemption), with each piece of device
        work announced first: the chunk (its slot's table row, tokens,
        offset and fences), then the decode (the rows, and the host
        tables and carry mirrors when they changed). A failure after an
        announcement is a fault of the group: the step loop stops and
        every request fails."""
        with self.channel.lock:
            self._cleared = []          # the slot engine's record only
            self._pre_tick()
            try:
                self._admit()
                task = self.prefill_queue.peek()
                chunked = 0
                if task is not None:
                    rec = {"chunk": dict(
                        row=self._pending_rows[task.slot].tolist(),
                        tokens=self._chunk_tokens(task).tolist(),
                        off=task.off, write_start=task.write_start,
                        total=task.total,
                        final=task.off + self.prefill_chunk >= task.total)}
                    with self.channel.announce("tick", rec):
                        chunked = self._prefill_tick()
                    self.last_progress_time = time.monotonic()
                self._release_window_pages()
                self._ensure_decode_pages()
                rows = self._decode_rows()
                if not rows:
                    return chunked
                rec = {"decode": dict(
                    rows=rows,
                    tables=(self.tables.tolist() if self._table_dirty
                            else None),
                    carry=((self.lengths.tolist(), self.last_tok.tolist())
                           if self._carry_dirty else None))}
                with self.channel.announce("tick", rec):
                    return self._decode_tick() + chunked
            except BaseException as e:
                if self.channel.fault is not None:
                    self._abandon([], e)
                raise

    def follow(self, record: dict) -> int:
        """A follower's piece of a tick (rank > 0 at tp > 1): rank 0's
        chunk through the table row it sent, or its decode over the
        tables and carry mirrors it sent. The follower keeps no
        scheduler state (no pool, radix tree or queue of its own)."""
        if "chunk" in record:
            c = record["chunk"]
            with torch.no_grad():
                self._chunk_forward(np.asarray(c["row"], np.int32),
                                    np.asarray(c["tokens"], np.int64),
                                    c["off"], c["write_start"], c["total"])
                if c["final"]:
                    from_rank0(torch.zeros(1, dtype=torch.long,
                                           device=self.device), self.mesh)
            return 1
        d = record["decode"]
        if d["tables"] is not None:
            self.tables[:] = np.asarray(d["tables"], np.int32)
            self._table_dirty = True
        if d["carry"] is not None:
            self.lengths[:] = d["carry"][0]
            self.last_tok[:] = d["carry"][1]
            self._carry_dirty = True
        self._decode_step(d["rows"])
        return len(d["rows"])

    # ----- state migration (fleet/migration.py) ----------------------------

    def _gather_pages(self, pages: List[int], length: int):
        """The pools' rows of `pages`, in order, as canonical [L, T, ...]
        leaves cut to `length` positions."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        out = []
        for leaf in self.caches:
            g = leaf[:, idx]                              # [L, n, ps, ...]
            out.append(g.reshape(g.shape[0], -1, *g.shape[3:])[:, :length])
        return out

    def _export_slot_kv(self, i: int):
        """Slot i's pages in the canonical layout; None when a page of
        the span is gone (the sliding window released it to scratch):
        nothing exact to ship, so the importer recompute-resumes (the
        window mask is a function of position)."""
        length = int(self.lengths[i])
        if length <= 0:
            return None
        n_pages = -(-length // self.page_size)
        row = self._pending_rows.get(i, self.tables[i])
        pages = [int(p) for p in row[:n_pages]]
        if any(p == SCRATCH_PAGE for p in pages):
            return None
        return self._pack_kv_sections(self._gather_pages(pages, length),
                                      length)

    def _write_pages(self, pages: List[int], leaves) -> None:
        """Canonical leaves [L, T, ...] into `pages` of the pools, in
        place (positions past T keep what the page held: never read)."""
        ps = self.page_size
        for cache, leaf in zip(self.caches, leaves):
            for j, pg in enumerate(pages):
                block = leaf[:, j * ps:(j + 1) * ps]
                cache[:, pg, :block.shape[1]].copy_(block)

    def _install_request_kv(self, req: Request, kv: dict, sections) -> bool:
        """Paged install: allocate the span's pages, write them, publish
        the table row, and put the prompt's full pages in the radix tree
        (so requests sharing the prompt hit on this replica too)."""
        i = self._free_slot_for_import()
        if i is None:
            return False
        length = int(kv["length"])
        ps = self.page_size
        n_pages = -(-length // ps)
        pages = self._alloc_pages(n_pages)
        if pages is None:
            return False
        self._write_pages(pages, self._decode_kv_sections(kv, sections))
        row = np.full(self.max_pages, SCRATCH_PAGE, np.int32)
        row[:n_pages] = pages
        self.tables[i] = row
        self._table_dirty = True
        self._admit_counter += 1
        self._admit_seq[i] = self._admit_counter
        self._arm_imported_slot(i, req, length)
        p0 = len(req.prompt)
        if p0 >= ps and req.prompt_logprobs:
            self.prefix_cache.insert(req.prompt, [int(p) for p in
                                                  row[:p0 // ps]],
                                     req.prompt_logprobs)
        self._m_pages_free.set(self.pool.free_pages)
        return True

    def export_prefix_state(self, tokens):
        """The radix-cached whole-page prefix of `tokens` as (meta,
        sections) of kind "prefix", or None when nothing is cached."""
        toks = [int(t) for t in tokens]
        with self.paused():
            pages, lps = self.prefix_cache.lookup(toks)
            if not pages:
                return None
            span = len(pages) * self.page_size
            kv_meta, sections = self._pack_kv_sections(
                self._gather_pages([int(p) for p in pages], span), span)
        meta = {"kind": "prefix", "tokens": toks[:span], "kv": kv_meta}
        # the per-node logprob slices concatenate back into the
        # (position - 1)-indexed prompt_logprobs of tokens[1:span]
        sections["prefix_logprobs"] = (
            np.concatenate([np.asarray(x, np.float32) for x in lps])
            if lps else np.zeros(0, np.float32))
        return meta, sections

    def import_prefix_state(self, meta: dict, sections) -> int:
        """Install a replicated prefix's pages into the pool and the
        radix tree. Returns the pages added (0: incompatible, or already
        cached here)."""
        kv = meta.get("kv") or {}
        ok, _ = self._kv_import_compatible(kv)
        if not ok or not kv.get("exact"):
            return 0
        toks = [int(t) for t in meta.get("tokens", [])]
        span = int(kv.get("length", 0))
        ps = self.page_size
        if span <= 0 or span % ps or span > len(toks):
            return 0
        n_pages = span // ps
        with self.paused():
            have, _ = self.prefix_cache.lookup(toks)
            if len(have) >= n_pages:
                return 0            # the local copy stays authoritative
            pages = self._alloc_pages(n_pages)
            if pages is None:
                return 0
            self._write_pages(pages, self._decode_kv_sections(kv, sections))
            lps = np.asarray(sections.get("prefix_logprobs",
                                          np.zeros(0)), np.float32)
            added = self.prefix_cache.insert(toks[:span], pages, lps)
            # the tree retained its own references: drop the
            # allocation's, so the pages are cache-only (evictable)
            self.pool.release(pages)
            self._m_pages_free.set(self.pool.free_pages)
        return added

    def _retire(self, i: int):
        # base _retire -> _clear_slot releases this slot's page refs;
        # pages also held by the radix tree stay cached for future hits
        super()._retire(i)
        self._m_pages_free.set(self.pool.free_pages)
