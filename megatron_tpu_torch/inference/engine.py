"""Continuous-batching decode engine with a persistent slot-based KV cache
(counterpart of megatron_tpu/inference/engine.py).

The engine owns ONE long-lived cache [L, num_slots, S, nkv, D] and runs
a step loop: every tick it admits queued requests into free slots (a
bucketed prefill writes the slot's rows) and then runs ONE batched
single-token decode over all slots. Sequences of different ages share
the batch because attention masks each slot to its own valid prefix
(ops/attention.py kv_lengths -> the flash_decode kernel on CUDA).

Differences from the JAX engine, by design:
  * PyTorch runs eagerly: there is no jit, donation or recompile
    tracking. The cache is updated in place; the prefill writes straight
    into the slot's rows of the big cache (a [1, P] view), which is what
    the JAX engine's small-cache prefill + paste computes.
  * The RoPE table is built once per engine at the cache length.
  * Each request samples from its own torch.Generator seeded with the
    request's seed, so its tokens never depend on the other slots.
    Greedy requests draw nothing; greedy output matches the JAX engine.
  * Prompt token ids outside the embedding table are rejected at submit
    (an out-of-range index faults the CUDA device; jax clamps it).

Speculative decoding, paging, migration, weight reload, profiling,
fault injection, bounded queues and request deadlines are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
import warnings
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.generation import (
    GenerationOutput, _init_caches,
)
from megatron_tpu_torch.inference.sampling import sample_logits_batched
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.ops.flash.flash_template import DECODE_BLOCK
from megatron_tpu_torch.ops.rotary import precompute_rope
from megatron_tpu_torch.telemetry.metrics import (
    MetricsRegistry, default_registry,
)


#: prompts are padded up to a multiple of this many tokens for prefill
PREFILL_BUCKET = 64


@dataclasses.dataclass
class Request:
    """One sequence's lifecycle through the engine."""
    prompt: np.ndarray                 # [p] int32 token ids
    max_new_tokens: int
    temperature: float = 0.0           # 0 = greedy
    top_k: int = 0
    top_p: float = 0.0
    eod: Optional[int] = None
    seed: int = 0
    # engine-filled
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # teacher-forced logprobs of prompt[1:] from the admission prefill
    prompt_logprobs: List[float] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    error: Optional[str] = None
    submit_time: Optional[float] = None
    first_token_time: Optional[float] = None

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generated (eod included when emitted)."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])

    def _finish(self, error: Optional[str] = None):
        self.error = error
        self.done.set()


class InferenceEngine:
    """Slot scheduler + prefill/decode steps over one shared cache.

    submit() may be called from any thread (the HTTP handlers);
    step()/run_until_idle() from one driver thread (start() spawns it).
    """

    def __init__(self, cfg: ModelConfig, params: Any, num_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, device="cuda"):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.num_slots = num_slots
        self.max_seq_len = self._round_seq_len(
            int(max_seq_len or cfg.seq_length))
        self.vocab_size = vocab_size
        self.caches = _init_caches(cfg, num_slots, self.max_seq_len,
                                   device=self.device)
        self.rope = precompute_rope(cfg.head_dim, self.max_seq_len,
                                    cfg.rope_theta, cfg.rope_scaling_factor,
                                    device=self.device)

        N = num_slots
        self.slots: List[Optional[Request]] = [None] * N
        self.lengths = np.zeros(N, np.int64)     # valid context per slot
        self.last_tok = np.zeros(N, np.int64)    # sampled, not yet in cache
        self.temps = np.zeros(N, np.float32)
        self.top_ks = np.zeros(N, np.int64)
        self.top_ps = np.zeros(N, np.float32)
        self.generators: List[Optional[torch.Generator]] = [None] * N

        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # admissions popped from the queue but not yet in a slot
        self._admitting = 0
        self.last_progress_time = time.monotonic()
        self.stats = {"admitted": 0, "retired": 0, "ticks": 0,
                      "rejected": 0}

        m = metrics if metrics is not None else default_registry()
        self.metrics = m
        self._m_slots = m.gauge("engine_slots_total", "KV-cache slots")
        self._m_active = m.gauge("engine_slots_active",
                                 "slots with a live request")
        self._m_queue = m.gauge("engine_queue_depth",
                                "requests waiting for a slot")
        self._m_admitted = m.counter("engine_requests_admitted_total",
                                     "requests admitted into a slot")
        self._m_retired = m.counter("engine_requests_retired_total",
                                    "requests completed")
        self._m_rejected = m.counter("engine_requests_rejected_total",
                                     "requests rejected (invalid/oversized/"
                                     "failed prefill)")
        self._m_ticks = m.counter("engine_ticks_total",
                                  "batched decode steps executed")
        self._m_tokens = m.counter("engine_tokens_generated_total",
                                   "tokens sampled across all requests")
        self._m_ttft = m.histogram("engine_ttft_seconds",
                                   "submit -> first generated token")
        self._m_per_token = m.histogram(
            "engine_time_per_output_token_seconds",
            "per-request decode latency per generated token")
        self._m_prefill = m.histogram("engine_prefill_seconds",
                                      "admission prefill wall time")
        self._m_tick = m.histogram("engine_decode_tick_seconds",
                                   "batched decode tick wall time")
        self._m_slots.set(num_slots)

    # ----- cache + shape policy -------------------------------------------

    def _round_seq_len(self, n: int) -> int:
        """On the CUDA kernel path, round the cache length up to the
        decode kernel's kv tile, so no tile of the cache is ragged."""
        if self.cfg.attention_impl != "pallas" or self.device.type != "cuda":
            return n
        m = DECODE_BLOCK
        if n % m == 0:
            return n
        rounded = -(-n // m) * m
        warnings.warn(
            f"engine max_seq_len {n} is not a multiple of {m}; rounding up "
            f"to {rounded} (the flash-decode kernel's kv tile)",
            stacklevel=3)
        return rounded

    def _bucket(self, p: int) -> int:
        b = PREFILL_BUCKET
        return min(self.max_seq_len - 1, max(1, -(-p // b) * b))

    # ----- device steps ----------------------------------------------------

    @torch.no_grad()
    def _prefill(self, i: int, req: Request):
        """Bucketed prefill of req's prompt into slot i, then sample its
        first token. Returns (token, logprob, prompt logprobs)."""
        prompt = np.asarray(req.prompt, np.int64)
        p = len(prompt)
        P = self._bucket(p)
        toks = np.zeros((1, P), np.int64)
        toks[0, :p] = prompt
        tokens = torch.from_numpy(toks).to(self.device)
        # the slot's first P cache rows, as a [L, 1, P, nkv, D] view: the
        # forward writes them in place (JAX: a [1, P] cache + paste)
        rows = tuple(c[:, i:i + 1, :P] for c in self.caches)
        positions = torch.arange(P, device=self.device)[None, :]
        logits, _ = lm_forward(self.cfg, self.params, tokens,
                               positions=positions, kv_caches=rows,
                               cache_index=0, rope=self.rope)
        last = logits[:, p - 1]
        tok = sample_logits_batched(
            last, [self.generators[i]],
            torch.tensor([req.temperature]), torch.tensor([req.top_k]),
            torch.tensor([req.top_p]), self.vocab_size)
        lp = float(torch.log_softmax(last.float(), dim=-1)[0, tok[0]])
        plp: List[float] = []
        if p > 1:
            lsm = torch.log_softmax(logits[0, :p - 1].float(), dim=-1)
            plp = torch.gather(lsm, 1, tokens[0, 1:p, None])[:, 0] \
                .cpu().tolist()
        return int(tok[0]), lp, plp

    @torch.no_grad()
    def _decode_step(self):
        """One batched token for every slot: each slot writes K/V at its
        own depth and attends its own valid prefix. Returns host
        (tokens [N], logprobs [N])."""
        last = torch.from_numpy(self.last_tok).to(self.device)[:, None]
        lens = torch.from_numpy(self.lengths).to(self.device)
        logits, _ = lm_forward(self.cfg, self.params, last,
                               kv_caches=self.caches, cache_index=lens,
                               rope=self.rope)
        logits = logits[:, 0]
        toks = sample_logits_batched(
            logits, self.generators, torch.from_numpy(self.temps),
            torch.from_numpy(self.top_ks), torch.from_numpy(self.top_ps),
            self.vocab_size)
        lps = torch.gather(torch.log_softmax(logits.float(), dim=-1), 1,
                           toks[:, None])[:, 0]
        return toks.cpu().numpy(), lps.cpu().numpy()

    # ----- scheduling ------------------------------------------------------

    def _reject(self, req: Request, why: str) -> Request:
        req._finish(why)
        self.stats["rejected"] += 1
        self._m_rejected.inc()
        return req

    def submit(self, req: Request) -> Request:
        """Queue a request; returns it (wait on req.done)."""
        req.submit_time = time.monotonic()
        p = len(req.prompt)
        if p == 0:
            return self._reject(req, "empty prompt")
        if req.max_new_tokens < 1:
            return self._reject(req, "max_new_tokens must be >= 1")
        if p + req.max_new_tokens > self.max_seq_len:
            return self._reject(
                req, f"prompt ({p}) + max_new_tokens ({req.max_new_tokens}) "
                     f"exceeds engine max_seq_len {self.max_seq_len}")
        ids = np.asarray(req.prompt)
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            return self._reject(
                req, f"prompt token ids must be in [0, "
                     f"{self.cfg.vocab_size}) (the embedding table)")
        with self._cv:
            self._queue.append(req)
            self._m_queue.set(len(self._queue))
            self._cv.notify_all()
        return req

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _clear_slot(self, i: int):
        """Reset every per-slot host mirror, sampling knobs included."""
        self.slots[i] = None
        self.lengths[i] = 0
        self.last_tok[i] = 0
        self.temps[i] = 0.0
        self.top_ks[i] = 0
        self.top_ps[i] = 0.0
        self.generators[i] = None

    def _retire(self, i: int):
        req = self.slots[i]
        self._clear_slot(i)
        self.stats["retired"] += 1
        self._m_retired.inc()
        self._m_active.set(self.num_active)
        if req.first_token_time is not None and len(req.generated) > 1:
            # steady-state decode latency: the prefill-produced first
            # token is what TTFT measures
            self._m_per_token.observe(
                (time.monotonic() - req.first_token_time)
                / (len(req.generated) - 1))
        req._finish()

    def _admit(self) -> int:
        """Move queued requests into free slots; prefill each. Returns the
        number admitted."""
        n = 0
        for i in range(self.num_slots):
            if self.slots[i] is not None:
                continue
            with self._cv:
                req = self._queue.popleft() if self._queue else None
                if req is not None:
                    self._admitting += 1
            if req is None:
                break
            try:
                n += self._admit_one(i, req)
            finally:
                with self._cv:
                    self._admitting -= 1
                self.last_progress_time = time.monotonic()
        return n

    def _admit_one(self, i: int, req: Request) -> int:
        """Prefill `req` into free slot `i`; returns 1 if admitted."""
        gen = None
        if req.temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(req.seed))
        self.generators[i] = gen
        t_prefill = time.monotonic()
        try:
            tok, lp, plp = self._prefill(i, req)
        except Exception as e:  # noqa: BLE001 - a failing prefill must
            # fail THIS request, not strand it or kill the step loop
            self.generators[i] = None
            self._reject(req, f"prefill failed: {e}")
            return 0
        p = len(req.prompt)
        self.slots[i] = req
        self.lengths[i] = p
        self.last_tok[i] = tok
        self.temps[i] = req.temperature
        self.top_ks[i] = req.top_k
        self.top_ps[i] = req.top_p
        req.generated.append(tok)
        req.logprobs.append(lp)
        req.prompt_logprobs = plp
        self.stats["admitted"] += 1
        now = time.monotonic()
        self._m_prefill.observe(now - t_prefill)
        req.first_token_time = now
        if req.submit_time is not None:
            self._m_ttft.observe(now - req.submit_time)
        self._m_admitted.inc()
        self._m_tokens.inc()
        self._m_active.set(self.num_active)
        with self._cv:
            self._m_queue.set(len(self._queue))
        if self._req_finished(req):
            self._retire(i)
        return 1

    def _req_finished(self, req: Request) -> bool:
        return (len(req.generated) >= req.max_new_tokens
                or (req.eod is not None and req.generated
                    and req.generated[-1] == req.eod))

    def step(self) -> int:
        """One engine tick: admit into free slots, then one batched decode
        for every active slot. Returns the number of active slots served
        (0 = idle)."""
        self._admit()
        return self._decode_tick()

    def _decode_tick(self) -> int:
        """One batched decode for every active slot; returns how many were
        served (0 = nothing to decode)."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        t_tick = time.monotonic()
        try:
            toks, lps = self._decode_step()
        except Exception as e:
            for i in active:
                req = self.slots[i]
                self._clear_slot(i)
                req._finish(f"decode step failed: {e}")
            self._m_active.set(self.num_active)
            raise
        self.stats["ticks"] += 1
        self._m_ticks.inc()
        self._m_tick.observe(time.monotonic() - t_tick)
        self._m_tokens.inc(len(active))
        for i in active:
            req = self.slots[i]
            # the fed token is now in the cache; the sampled one is next up
            self.lengths[i] += 1
            tok = int(toks[i])
            self.last_tok[i] = tok
            req.generated.append(tok)
            req.logprobs.append(float(lps[i]))
            if self._req_finished(req):
                self._retire(i)
        self.last_progress_time = time.monotonic()
        return len(active)

    def stalled(self, threshold_s: float) -> bool:
        """True when the engine has pending work but made no progress for
        `threshold_s` (an idle engine is never stalled)."""
        with self._cv:
            busy = (self.num_active > 0 or bool(self._queue)
                    or self._admitting > 0)
        return (busy and
                time.monotonic() - self.last_progress_time > threshold_s)

    # ----- driving ---------------------------------------------------------

    def run_until_idle(self) -> None:
        """Step until the queue and every slot drain (single-thread use)."""
        while True:
            served = self.step()
            with self._cv:
                if served == 0 and not self._queue:
                    return

    def generate(self, prompts: np.ndarray, lengths: np.ndarray,
                 max_new_tokens: int, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 eod: Optional[int] = None,
                 seed: int = 0) -> GenerationOutput:
        """Submit one request per row, drain, and repack
        [B, maxp + max_new] like the JAX engine: shorter prompts get
        maxp - p extra generated tokens (the one-shot path's row layout)."""
        B, maxp = prompts.shape
        reqs = []
        for b in range(B):
            p = int(lengths[b])
            reqs.append(self.submit(Request(
                prompt=np.asarray(prompts[b, :p], np.int32),
                max_new_tokens=maxp - p + max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p, eod=eod,
                seed=seed + b)))
        if self._thread is None:
            self.run_until_idle()
        for r in reqs:
            r.done.wait()
        errs = [r.error for r in reqs if r.error]
        if errs:
            raise ValueError(errs[0])
        total = maxp + max_new_tokens
        pad = 0 if eod is None else eod
        tokens = np.full((B, total), pad, np.int32)
        ends = np.zeros(B, np.int64)
        lp = np.zeros((B, total - 1), np.float32)
        for b, r in enumerate(reqs):
            t = r.tokens
            tokens[b, :len(t)] = t
            ends[b] = len(t)
            lp[b, :len(r.prompt_logprobs)] = r.prompt_logprobs
            gen0 = int(lengths[b]) - 1  # logprob row index of first token
            lp[b, gen0:gen0 + len(r.logprobs)] = r.logprobs
        return GenerationOutput(tokens=tokens, lengths=ends, logprobs=lp)

    # ----- background thread (HTTP serving) --------------------------------

    def start(self) -> None:
        """Spawn the step-loop thread: concurrent submitters share each
        decode tick."""
        if self._thread is not None:
            return
        self._stop = False

        def loop():
            while True:
                with self._cv:
                    while (not self._stop and self.num_active == 0
                           and not self._queue):
                        self._cv.wait()
                    if self._stop:
                        return
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 - step() has failed
                    # the affected requests; the loop must survive
                    import traceback

                    print(f"inference-engine step error: {e}",
                          file=sys.stderr)
                    traceback.print_exc()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="inference-engine")
        self._thread.start()

    def stop(self) -> None:
        """Stop the step-loop thread and fail whatever it leaves behind
        (waiters block on done.wait() with no timeout)."""
        if self._thread is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError(
                "inference-engine step loop did not stop within 30s")
        self._thread = None
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
        for i in range(self.num_slots):
            req = self.slots[i]
            if req is not None:
                self._clear_slot(i)
                req._finish("engine stopped")
        for req in leftovers:
            req._finish("engine stopped")
        self._m_active.set(0)
        self._m_queue.set(0)
