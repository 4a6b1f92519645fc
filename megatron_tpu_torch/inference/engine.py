"""Continuous-batching decode engine with a persistent slot-based KV cache
(counterpart of megatron_tpu/inference/engine.py).

The engine owns ONE long-lived cache [L, num_slots, S, nkv, D] and runs
a step loop: every tick it admits queued requests into free slots (a
bucketed prefill writes the slot's rows) and then runs ONE batched
single-token decode over all slots. Sequences of different ages share
the batch because attention masks each slot to its own valid prefix
(ops/attention.py kv_lengths -> the flash_decode kernel on CUDA).

The decode tick (the JAX engine's one jitted step, _build_decode_step):
one step body over static device buffers, the carry. last_tok, lengths,
the decode-row mask, the per-request speculation mask and (n-gram) the
drafts live on the device and are refreshed in place with copy_ from the
host mirrors only after an admission, a retire or a preemption changed
them (the JAX engine's _init_carry); between those the carry advances on
the device. On CUDA the body is captured as one CUDA graph at engine
start (inference/cuda_graph.py) and replayed every tick; it covers all N
slots, since every tick runs every slot. The graph ends at the logits
and, for greedy rows, their argmax and log-softmax (and the speculative
accept count); sampled rows draw after the replay, eagerly, from each
request's generator. On the CPU the same body runs directly on the same
buffers. engine_decode_recompiles_total counts captures beyond the
warm-up one (0 in steady state); a failed step fails the requests in
flight, rebuilds the caches and captures again (counted). A capture that
fails raises: the engine never goes on eagerly by itself.
cuda_graph=False (a constructor argument, for A/B measurements and card
tests) runs the body eagerly on CUDA.

Speculative decoding (speculative=SpecConfig, inference/speculative.py)
swaps the tick for the JAX engine's _decode_tick_spec: k drafts per slot
(host n-gram lookup, or a draft model run k times inside the captured
step over a second cache tree that the admission prefill also fills),
one [N, k+1] target verify forward (the decode kernel's Sq = k+1 form),
the exact accept/reject, then 1 .. k+1 tokens emitted per slot, cut at
eod or max_new_tokens. Rejected drafts roll back by the slot's length
alone. A speculating engine admits prompt + max_new_tokens only up to
max_seq_len - k (the tick writes k positions past the last). Request.spec
= False keeps a request to one token a tick on a speculating engine.

Differences from the JAX engine, by design:
  * PyTorch runs eagerly outside the graph: the cache is updated in
    place; the prefill writes straight into the slot's rows of the big
    cache (a [1, P] view), which is what the JAX engine's small-cache
    prefill + paste computes. The prefill stays eager.
  * The RoPE table is built once per engine at the cache length.
  * Each request samples from its own torch.Generator seeded with the
    request's seed, so its tokens never depend on the other slots.
    Greedy requests draw nothing; greedy output matches the JAX engine.
  * Prompt token ids outside the embedding table are rejected at submit
    (an out-of-range index faults the CUDA device; jax clamps it).

The paged engine (inference/paging/engine.py) subclasses this one and
overrides the cache and shape hooks (_kernel_seq_multiple,
_fresh_caches, _fresh_draft_caches, _decode_rows, _decode_extra_args,
_refresh_carry). Admission resumes a preempted request by recompute:
prompt + generated is teacher-forced and the next token is sampled with
the generator state saved at preemption (Request.resume_key).

The request lifecycle is the JAX engine's. max_queue bounds admission:
a submit past it fails at once with Request.overloaded
(EngineOverloadedError from generate, HTTP 503 upstream). A request's
deadline_s (seconds after submit) fails it with Request.timed_out
(RequestTimeoutError, HTTP 504) whether it is still queued or already
decoding; a slot cleared mid-decode marks the carry stale, so the next
replay does not decode the dead row. update_params stages a weight swap
that the step loop applies between ticks (_pre_tick): the new tensors
are copied INTO the existing parameter tensors, because the captured
graph has their addresses baked in (rebinding self.params would leave
it reading the old weights without any error). A swap therefore costs
no capture. wait_idle is the drain step of a rolling update.

kv_cache_int8=True stores the slot caches (or the paged engine's pools)
as int8 with fp32 scales (ops/kv_quant.py): the attention block
quantizes on write and dequantizes the whole cache for attention, as the
JAX package does. The model drafter's caches stay in the model dtype.

Tensor parallelism (mesh: a tensor-parallel MeshRuntime, with a
parallel/distributed.ServingChannel): every rank holds its slices of the
params and caches of its kv heads [L, N, S, nkv/tp, D] (the JAX
engine's _kv_sharding), and the logits are gathered over the tensor
group. Rank 0 owns the queue, the scheduler and the step thread; before
each tick it broadcasts one control record: the slots it cleared since
the last record (retired, timed out, failed, stopped) and its
admissions (slot, prompt ids, knobs, seed), then runs the tick under
the channel's lock. The other ranks run follow(record): the same
clears, the same prefills and the same decode tick. Tokens (the
prefill's first one and each tick's) are chosen on rank 0 and
broadcast with the decode-row mask, which a follower holds against its
own: a decision the record missed fails loudly instead of hanging the
collectives. Retirement needs no record: every rank sees the same
tokens. Any failure inside an announced tick is a fault of the group
(parallel/distributed.ServingChannel): a follower's process ends, and
rank 0 stops its step loop and fails every request it holds. A gloo
collective cannot be captured in a CUDA graph, so at tp > 1 the engine
refuses cuda_graph=True (a captured tick over NCCL waits for a
multi-card machine, ROADMAP.md queue A item 7b); speculation and weight
swaps are refused there, as on the JAX server's mesh. The paged engine
(inference/paging/engine.py) has its own record.

compress_collectives (--serve_compress_collectives, with a comm_policy of
sites) routes the forward's row-parallel reductions and logits gather
through quant/collectives.py's int8/fp8 collectives (a TpComm built once,
as the JAX engine builds it; refused with speculation). The engine
counts the static wire price of each prefill and decode tick in
engine_comm_{dense,compressed}_bytes_total and journals one comm_policy
record at build.

The serving faults of MEGATRON_TPU_FAULT are injected between ticks
(_pre_tick, the JAX engine's hooks). KV migration and on-demand
profiling are not ported yet (inference/server.py).
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
from megatron_tpu_torch.inference.cuda_graph import CapturedStep
from megatron_tpu_torch.inference.generation import (
    GenerationOutput, _init_caches, _rope, check_positions, from_rank0,
)
from megatron_tpu_torch.inference.sampling import (
    _mask_vocab, sample_logits_batched,
)
from megatron_tpu_torch.inference.speculative import (
    SpecConfig, greedy_verify, ngram_propose,
    speculative_accept, validate_spec,
)
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.ops.flash.flash_template import DECODE_BLOCK
from megatron_tpu_torch.quant.collectives import (
    forward_comm_bytes, make_tp_comm,
)
from megatron_tpu_torch.telemetry.metrics import (
    MetricsRegistry, default_registry,
)
from megatron_tpu_torch.training import resilience
from megatron_tpu_torch.training.optimizer import leaf_paths


#: prompts are padded up to a multiple of this many tokens for prefill
PREFILL_BUCKET = 64


def _check_tensor_parallel(speculative, cuda_graph, channel) -> None:
    """What the engines do not do above one rank (tensor or context
    parallelism) yet."""
    what = None
    if speculative is not None:
        what = ("speculative decoding (single-rank serving only, as on the "
                "JAX server: the spec step is not threaded through the "
                "sharded forward)")
    elif cuda_graph:
        what = ("cuda_graph=True: the tick's gloo collectives cannot be "
                "captured in a CUDA graph (a captured tick over NCCL waits "
                "for a multi-card run, ROADMAP.md queue A item 7b); pass "
                "cuda_graph=False")
    elif channel is None:
        what = ("no ServingChannel: rank 0 drives the other ranks through "
                "one (parallel/distributed.py)")
    if what:
        raise ValueError(f"tensor-parallel serving: {what}")


class EngineOverloadedError(RuntimeError):
    """The engine's admission queue is at max_queue: the request was
    rejected, not queued. HTTP serving maps this to 503 + Retry-After."""


class RequestTimeoutError(RuntimeError):
    """A request's deadline expired while it was queued or mid-decode.
    HTTP serving maps this to 504 Gateway Timeout."""


def _uncapturable(cfgs) -> Optional[str]:
    """Why a decode tick over these models cannot be one CUDA graph, or
    None. Dropless MoE splits rows per expert: torch._grouped_mm takes the
    spans on the device, a per-expert loop reads them on the host (a sync
    a capture cannot hold). Dropless is never swapped for the capacity
    path, which is another function."""
    for c in cfgs:
        if c.num_experts is None or c.moe_dispatch != "dropless":
            continue
        if c.dtype != torch.bfloat16 or not hasattr(torch, "_grouped_mm"):
            return (f"moe_dispatch='dropless' in {c.dtype} on torch "
                    f"{torch.__version__}: the per-expert products split "
                    "on host-side row counts (no bf16 torch._grouped_mm), "
                    "which a CUDA graph cannot capture")
    return None


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
    # per-request speculative-decoding knob: False keeps this request to
    # one token a tick on a speculating engine (its greedy output is the
    # same either way); a no-op on an engine built without speculative=
    spec: bool = True
    # relative deadline: seconds after submit() by which the request must
    # complete; a queued or mid-decode request past it fails with
    # timed_out=True (HTTP 504). None = no deadline.
    deadline_s: Optional[float] = None
    # engine-filled
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # teacher-forced logprobs of prompt[1:] from the admission prefill
    prompt_logprobs: List[float] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    error: Optional[str] = None
    submit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    # preemption/resume (paged engine): the state of the request's
    # torch.Generator at preemption (torch.Generator.get_state()), so a
    # recompute-resumed request samples the exact tokens it would have
    # sampled without the preemption (the JAX package saves its PRNG key)
    resume_key: Optional[torch.Tensor] = None
    # rejected at submit because the queue was at max_queue
    overloaded: bool = False
    # failed on an expired deadline (error carries the detail)
    timed_out: bool = False
    # absolute monotonic deadline, stamped at submit
    _deadline: Optional[float] = None

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

    #: whether the engine serves a mesh with a context axis (only the
    #: context-parallel engine's pools hold a rank's stripe of a sequence)
    serves_context = False

    def __init__(self, cfg: ModelConfig, params: Any, num_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, device="cuda",
                 speculative: Optional[SpecConfig] = None,
                 cuda_graph: bool = True, kv_cache_int8: bool = False,
                 max_queue: Optional[int] = None, mesh=None,
                 channel=None, compress_collectives: str = "none",
                 comm_policy=None, comm_chunk: int = 32):
        """speculative: a SpecConfig turns on speculative decoding.
        cuda_graph: on CUDA, capture the decode tick as one CUDA graph at
        construction and replay it (False runs the same step eagerly, for
        A/B measurements); ignored on the CPU, which has no graphs.
        kv_cache_int8: int8 slot caches (the paged engine: pools).
        max_queue: at most this many requests wait for a slot; a submit
        beyond it is rejected as overloaded (None: unbounded).
        mesh, channel: tensor-parallel serving (the module docstring);
        params are then this rank's slices.
        compress_collectives ("none" | "dense" | "int8" | "fp8"),
        comm_policy, comm_chunk: the compressed tensor-parallel
        collectives of the forward (quant/collectives.make_tp_comm; a
        no-op at tp 1), refused with speculation as in the JAX engine."""
        self.mesh = mesh
        self.channel = channel
        self.tp = 1 if mesh is None else mesh.tp
        #: ranks the engine's forward spans (tensor x context); above one,
        #: rank 0 drives the others through the channel
        self.ranks = 1 if mesh is None else mesh.tp * mesh.cp
        self.leads = mesh is None or mesh.rank == 0
        if mesh is not None and mesh.pp > 1:
            raise ValueError(
                "the continuous-batching engine runs the single-stage "
                "forward only — serve pp>1 models with engine_slots=0")
        if mesh is not None and mesh.cp > 1 and not self.serves_context:
            raise ValueError(
                "a mesh with a context axis is served by the "
                "context-parallel engine (inference/context_parallel/, "
                "--serve_context_parallel), whose pools hold a rank's "
                "stripe of each sequence")
        if self.ranks > 1:
            _check_tensor_parallel(speculative, cuda_graph, channel)
        # compressed TP collectives (quant/collectives.py): fixed at
        # build; None when off or at tp 1 (the dense path unchanged)
        self.tp_comm = make_tp_comm(mesh, compress_collectives, cfg=cfg,
                                    policy=comm_policy, chunk=comm_chunk)
        if self.tp_comm is not None and speculative is not None:
            raise ValueError(
                "compress_collectives with speculative decoding is not "
                "supported (the spec step is not threaded through the "
                "explicit TP collectives) — drop one of the two")
        # the static wire prices of the counters: one decode tick's, and
        # one prefill's a bucket (dense = what the dense path moves)
        self._comm_tick_bytes = forward_comm_bytes(cfg, self.tp_comm,
                                                   num_slots, 1)
        self._comm_prefill_bytes = {}
        # slots cleared since the last control record (rank 0, tp > 1)
        self._cleared: List[int] = []
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        self.kv_cache_int8 = bool(kv_cache_int8)
        self.max_queue = max_queue
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.num_slots = num_slots
        self.spec = speculative
        if speculative is not None:
            validate_spec(cfg, speculative)
        self.max_seq_len = self._round_seq_len(
            int(max_seq_len or cfg.seq_length))
        check_positions(cfg, self.max_seq_len, "max_seq_len")
        if self._has_draft_model():
            check_positions(speculative.draft_cfg, self.max_seq_len,
                            "max_seq_len")
        self.vocab_size = vocab_size
        self.caches = self._fresh_caches()
        self.rope = _rope(cfg, self.max_seq_len, self.device)
        # the model drafter's second cache tree and its RoPE table
        self.draft_params = self.draft_caches = self.draft_rope = None
        if self._has_draft_model():
            dcfg = speculative.draft_cfg
            self.draft_params = speculative.draft_params
            self.draft_caches = self._fresh_draft_caches()
            self.draft_rope = _rope(dcfg, self.max_seq_len, self.device)

        N = num_slots
        self.slots: List[Optional[Request]] = [None] * N
        self.lengths = np.zeros(N, np.int64)     # valid context per slot
        self.last_tok = np.zeros(N, np.int64)    # sampled, not yet in cache
        self.temps = np.zeros(N, np.float32)
        self.top_ks = np.zeros(N, np.int64)
        self.top_ps = np.zeros(N, np.float32)
        self.generators: List[Optional[torch.Generator]] = [None] * N
        self.spec_on = np.ones(N, bool)          # per-request knob mirror

        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # admissions popped from the queue but not yet in a slot
        self._admitting = 0
        # hot weight reload: (params, version, applied event) staged by
        # update_params, copied in between ticks by the step loop
        self._pending_params: Optional[tuple] = None
        self.params_version: Any = None
        self.last_progress_time = time.monotonic()
        self._preempt_signalled = False  # preempt_replica fires once
        # decode_recompiles counts captures of the decode step beyond the
        # warm-up one: the JAX engine's zero-recompiles invariant
        self.stats = {"admitted": 0, "retired": 0, "ticks": 0,
                      "rejected": 0, "decode_recompiles": 0,
                      "timeouts": 0, "weight_reloads": 0}
        if self.spec is not None:
            # spec_emitted / ticks = tokens per target forward
            self.stats.update({"spec_proposed": 0, "spec_accepted": 0,
                               "spec_emitted": 0})

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
                                     "failed prefill/queue full)")
        self._m_timeouts = m.counter(
            "engine_requests_timeout_total",
            "requests failed on an expired deadline (queued or mid-decode)")
        self._m_reloads = m.counter(
            "engine_weight_reloads_total",
            "hot weight swaps applied between decode ticks")
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
        self._m_recompiles = m.counter(
            "engine_decode_recompiles_total",
            "CUDA graph captures of the decode step beyond the warm-up one")
        self._m_spec_proposed = m.counter(
            "engine_spec_proposed_total",
            "draft tokens proposed to the speculative verify step")
        self._m_spec_accepted = m.counter(
            "engine_spec_accepted_total",
            "draft tokens accepted by the exact accept/reject")
        self._m_spec_len = m.histogram(
            "engine_spec_accept_length",
            "accepted drafts per slot per tick (0..k)",
            buckets=(0.5, 1.5, 2.5, 3.5, 4.5, 6.5, 8.5, 12.5, 16.5))
        # compressed-collective accounting (quant/): dense = the bytes the
        # dense path would have moved for the same work, compressed =
        # what this mode moves; their ratio is the live compression
        self._m_comm_dense = m.counter(
            "engine_comm_dense_bytes_total",
            "TP-collective wire bytes the dense path would have moved")
        self._m_comm_compressed = m.counter(
            "engine_comm_compressed_bytes_total",
            "TP-collective wire bytes actually moved by this mode")
        if self.tp_comm is not None:
            self.stats.update({"comm_dense_bytes": 0,
                               "comm_compressed_bytes": 0})
            self._journal_comm_policy()
        self._m_slots.set(num_slots)

        # the decode carry: static device buffers the step body reads
        # (and a captured graph has baked in), refreshed from the host
        # mirrors by copy_ when _carry_dirty, advanced on the device
        # after every tick otherwise
        dev, k = self.device, (self.spec.k if self.spec else 0)
        self._carry = {
            "last_tok": torch.zeros(N, dtype=torch.long, device=dev),
            "lengths": torch.zeros(N, dtype=torch.long, device=dev),
            "active": torch.zeros(N, dtype=torch.long, device=dev),
            "spec_rows": torch.ones(N, dtype=torch.bool, device=dev),
            "drafts": torch.zeros((N, k), dtype=torch.long, device=dev),
        }
        self._carry_dirty = True
        self._init_static()
        self.cuda_graph = bool(cuda_graph) and self.device.type == "cuda"
        #: why the tick runs eagerly on CUDA although a graph was asked
        #: for (None: it is captured, or was not asked for)
        self.eager_reason = None
        if self.cuda_graph:
            self.eager_reason = _uncapturable(
                [cfg] + ([speculative.draft_cfg]
                         if self._has_draft_model() else []))
            if self.eager_reason:
                self.cuda_graph = False
                warnings.warn(f"decode tick runs eagerly: "
                              f"{self.eager_reason}", stacklevel=2)
        self._step = None
        self.capture_seconds = None
        self._build_step(warmup=True)

    # ----- cache + shape policy -------------------------------------------

    def _kernel_seq_multiple(self) -> int:
        """Cache-length multiple the engine rounds max_seq_len up to: on
        the CUDA kernel path the decode kernel's kv tile, so no tile of
        the cache is ragged; 1 (no constraint) elsewhere. The paged
        engine overrides it with its page size."""
        if self.cfg.attention_impl == "pallas" and self.device.type == "cuda":
            return DECODE_BLOCK
        return 1

    def _round_seq_len(self, n: int) -> int:
        m = self._kernel_seq_multiple()
        if m <= 1 or n % m == 0:
            return n
        rounded = -(-n // m) * m
        warnings.warn(
            f"engine max_seq_len {n} is not a multiple of {m}; rounding up "
            f"to {rounded} (the decode kernel's kv tile or the page size)",
            stacklevel=3)
        return rounded

    def _fresh_caches(self):
        """Zeroed KV storage: [L, num_slots, max_seq_len, nkv, D] x2, or
        the int8 4-tuple with kv_cache_int8 (the paged engine builds page
        pools instead)."""
        return _init_caches(self.cfg, self.num_slots, self.max_seq_len,
                            device=self.device, int8=self.kv_cache_int8,
                            tp=self.tp)

    def _fresh_draft_caches(self):
        """The draft model's cache tree: the target's slots and length,
        the draft config's own layers and heads, always in the model
        dtype, as in JAX (the paged engine builds draft pools over the
        target's tables instead)."""
        return _init_caches(self.spec.draft_cfg, self.num_slots,
                            self.max_seq_len, device=self.device)

    def _has_draft_model(self) -> bool:
        return self.spec is not None and self.spec.drafter == "model"

    def _capacity_margin(self) -> int:
        """Sequence headroom a speculating engine reserves: a tick writes
        K/V at positions length .. length + k, so the last tick of a
        request must still fit k more positions. 0 without speculation."""
        return self.spec.k if self.spec is not None else 0

    def _bucket(self, p: int) -> int:
        b = PREFILL_BUCKET
        return min(self.max_seq_len - 1, max(1, -(-p // b) * b))

    # ----- device steps ----------------------------------------------------

    @torch.no_grad()
    def _prefill(self, i: int, req: Request, prompt: np.ndarray):
        """Bucketed prefill of `prompt` (req's prompt, or prompt +
        generated on a resume) into slot i, and into the draft cache tree
        for the model drafter, then sample the next token. Returns
        (token, logprob, prompt logprobs)."""
        prompt = np.asarray(prompt, np.int64)
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
                               cache_index=0, rope=self.rope, mesh=self.mesh,
                               tp_comm=self.tp_comm)
        if self._has_draft_model():
            # mirror the prompt into the draft tree so the first
            # speculative tick proposes with the full context
            lm_forward(self.spec.draft_cfg, self.draft_params, tokens,
                       positions=positions,
                       kv_caches=tuple(c[:, i:i + 1, :P]
                                       for c in self.draft_caches),
                       cache_index=0, rope=self.draft_rope,
                       return_hidden=True)
        last = logits[:, p - 1]
        if self.leads:
            tok = sample_logits_batched(
                last, [self.generators[i]],
                torch.tensor([req.temperature]), torch.tensor([req.top_k]),
                torch.tensor([req.top_p]), self.vocab_size)
        else:
            tok = torch.zeros(1, dtype=torch.long, device=self.device)
        if self.ranks > 1:
            tok = from_rank0(tok.to(self.device), self.mesh)
        lp = float(torch.log_softmax(last.float(), dim=-1)[0, tok[0]])
        plp: List[float] = []
        if p > 1:
            lsm = torch.log_softmax(logits[0, :p - 1].float(), dim=-1)
            plp = torch.gather(lsm, 1, tokens[0, 1:p, None])[:, 0] \
                .cpu().tolist()
        return int(tok[0]), lp, plp

    def _init_static(self) -> None:
        """Allocate the static device buffers the step body reads besides
        the carry (the paged engine's page table), before the capture."""

    @torch.no_grad()
    def _step_body(self):
        """The tick's device work on the static buffers, with no host
        sync: what the CUDA graph captures and the CPU calls directly.

        Plain: one [N, 1] forward; returns the logits and, for greedy
        rows, their argmax and its logprob. Speculative: the model
        drafter's k greedy single-token forwards and one write-only
        forward (or the n-gram drafts buffer), the [N, k+1] verify
        forward, and greedy_verify's tokens, logprobs and accept
        counts."""
        c, extra = self._carry, self._decode_extra_args()
        last, lens = c["last_tok"], c["lengths"]
        if self.spec is None:
            logits, _ = lm_forward(self.cfg, self.params, last[:, None],
                                   kv_caches=self.caches, cache_index=lens,
                                   rope=self.rope, mesh=self.mesh,
                                   tp_comm=self.tp_comm, **extra)
            logits = logits[:, 0].float()
            toks = torch.argmax(_mask_vocab(logits, self.vocab_size), dim=-1)
            lps = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                               toks[:, None])[:, 0]
            return {"logits": logits, "toks": toks, "lps": lps}
        drafts = c["drafts"]
        if self._has_draft_model():
            dcfg, tok, ln, proposed = self.spec.draft_cfg, last, lens, []
            for _ in range(self.spec.k):
                lg, _ = lm_forward(dcfg, self.draft_params, tok[:, None],
                                   kv_caches=self.draft_caches,
                                   cache_index=ln, rope=self.draft_rope,
                                   **extra)
                tok = torch.argmax(
                    _mask_vocab(lg[:, 0].float(), self.vocab_size), dim=-1)
                proposed.append(tok)
                ln = ln + 1
            # position lens + k holds draft k's K/V, so a fully accepted
            # tick leaves the draft cache complete for the next proposal
            lm_forward(dcfg, self.draft_params, tok[:, None],
                       kv_caches=self.draft_caches, cache_index=ln,
                       rope=self.draft_rope, return_hidden=True, **extra)
            drafts = torch.stack(proposed, dim=1)
        logits, _ = lm_forward(self.cfg, self.params,
                               torch.cat([last[:, None], drafts], dim=1),
                               kv_caches=self.caches, cache_index=lens,
                               rope=self.rope, **extra)
        toks, lps, accepts = greedy_verify(logits, drafts, self.vocab_size,
                                           c["spec_rows"])
        return {"logits": logits, "drafts": drafts, "toks": toks,
                "lps": lps, "accepts": accepts}

    def _build_step(self, warmup: bool = False) -> None:
        """Set up the tick's step: on CUDA (cuda_graph) capture the body
        as a CUDA graph, else call it directly. A capture past the
        warm-up one counts in engine_decode_recompiles_total; a capture
        that fails raises."""
        self._step = None
        if not self.cuda_graph:
            self._step = self._step_body
            return
        step = CapturedStep(self._step_body, self.device)
        self._step = step
        self.capture_seconds = step.capture_seconds
        if not warmup:
            self.stats["decode_recompiles"] += 1
            self._m_recompiles.inc()

    def _refresh_carry(self, rows: List[int]) -> None:
        """Copy the host mirrors into the static device buffers after an
        admission, retire or preemption changed them (_carry_dirty), and
        the n-gram drafts every tick."""
        c = self._carry
        if self._carry_dirty:
            active = np.zeros(self.num_slots, np.int64)
            active[rows] = 1
            c["last_tok"].copy_(torch.from_numpy(self.last_tok))
            c["lengths"].copy_(torch.from_numpy(self.lengths))
            c["active"].copy_(torch.from_numpy(active))
            c["spec_rows"].copy_(torch.from_numpy(self.spec_on))
            self._carry_dirty = False
        if self.spec is not None and self.spec.drafter == "ngram":
            c["drafts"].copy_(torch.from_numpy(self._propose_ngram(rows)))

    def _propose_ngram(self, rows: List[int]) -> np.ndarray:
        """Host prompt-lookup proposals [N, k] for the decode rows with
        speculation on; zeros elsewhere (their acceptance is forced to
        0 or their tokens are not read)."""
        k, n = self.spec.k, self.spec.ngram
        drafts = np.zeros((self.num_slots, k), np.int64)
        for i in rows:
            if self.spec_on[i]:
                drafts[i] = ngram_propose(self.slots[i].tokens, k, n)
        return drafts

    @torch.no_grad()
    def _decode_step(self, rows: List[int]):
        """One tick for every slot: refresh the carry, replay (or run)
        the step, sample the sampled rows, advance the device carry.
        Returns host (tokens [N, j], logprobs [N, j], accepts [N]) with
        j = 1 plain, k + 1 speculative (accepts 0 plain)."""
        self._refresh_carry(rows)
        out = self._step()
        c = self._carry
        if self.spec is None:
            toks, lps = out["toks"], out["lps"]
            if (self.temps > 0).any() and self.leads:
                toks = sample_logits_batched(
                    out["logits"], self.generators,
                    torch.from_numpy(self.temps),
                    torch.from_numpy(self.top_ks),
                    torch.from_numpy(self.top_ps), self.vocab_size)
                lps = torch.gather(torch.log_softmax(out["logits"], dim=-1),
                                   1, toks[:, None])[:, 0]
            if self.ranks > 1:
                toks = self._agreed_tokens(toks, c["active"])
            c["lengths"].add_(c["active"])
            c["last_tok"].copy_(torch.where(c["active"].bool(), toks,
                                            c["last_tok"]))
            return (toks[:, None].cpu().numpy(), lps[:, None].cpu().numpy(),
                    np.zeros(self.num_slots, np.int64))
        toks, lps, accepts = speculative_accept(
            out["logits"], out["drafts"], self.temps, self.top_ks,
            self.top_ps, self.generators, self.vocab_size, c["spec_rows"],
            greedy=(out["toks"], out["lps"], out["accepts"]))
        c["lengths"].add_((accepts + 1) * c["active"])
        nxt = torch.gather(toks, 1, accepts[:, None])[:, 0]
        c["last_tok"].copy_(torch.where(c["active"].bool(), nxt,
                                        c["last_tok"]))
        return toks.cpu().numpy(), lps.cpu().numpy(), accepts.cpu().numpy()

    def _agreed_tokens(self, toks: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
        """Rank 0's tokens on every rank, with its decode-row mask, which
        a follower holds against its own."""
        agreed = from_rank0(torch.stack([toks.long(), active.long()]),
                            self.mesh)
        if not torch.equal(agreed[1], active.long()):
            raise RuntimeError(
                "tensor-parallel ranks disagree on the decode rows (rank 0 "
                f"{agreed[1].tolist()}, rank {self.mesh.rank} "
                f"{active.tolist()}): a scheduling decision missed the "
                "control record")
        return agreed[0]

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
        margin = self._capacity_margin()
        if p + req.max_new_tokens > self.max_seq_len - margin:
            return self._reject(
                req, f"prompt ({p}) + max_new_tokens ({req.max_new_tokens}) "
                     f"exceeds engine max_seq_len {self.max_seq_len}"
                     + (f" minus the speculative headroom {margin}"
                        if margin else ""))
        ids = np.asarray(req.prompt)
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            return self._reject(
                req, f"prompt token ids must be in [0, "
                     f"{self.cfg.vocab_size}) (the embedding table)")
        if req.deadline_s is not None:
            if not req.deadline_s > 0:      # NaN too
                return self._reject(
                    req, "deadline_s must be > 0 (or None: no deadline)")
            req._deadline = req.submit_time + req.deadline_s
        if resilience.fault_armed("reject_admission"):
            # injected overload: every admission answers queue-full while
            # armed (the router's retry-on-503 path)
            req.overloaded = True
            return self._reject(
                req, "engine queue full (injected: reject_admission); "
                     "retry later")
        with self._cv:
            if self.channel is not None and self.channel.fault is not None:
                return self._reject(req, "the tensor-parallel group "
                                         f"failed: {self.channel.fault}")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                # bounded admission: overload is a fast rejection (HTTP
                # 503 upstream), not unbounded queue latency
                req.overloaded = True
                return self._reject(
                    req, f"engine queue full ({self.max_queue} waiting); "
                         + self._overload_detail() + "retry later")
            self._queue.append(req)
            self._m_queue.set(len(self._queue))
            self._cv.notify_all()
        return req

    def _overload_detail(self) -> str:
        """Extra cause text of a queue-full rejection: an engine with a
        richer admission model (the context-parallel engine's striped
        pools) names what blocks, so the 503 detail tells resource
        exhaustion from queue depth."""
        return ""

    def _journal_comm_policy(self) -> None:
        """One comm_policy record an engine build: which collectives run
        compressed and the static per-tick wire prices (the journal side
        of the engine_comm_*_bytes_total counters)."""
        from megatron_tpu_torch.telemetry import journal

        j = journal.get_global_journal()
        if j is None or self.tp_comm is None:
            return
        t = self._comm_tick_bytes
        j.emit("comm_policy", mode=self.tp_comm.mode,
               sites=sorted(self.tp_comm.sites), chunk=self.tp_comm.chunk,
               tp=self.tp_comm.tp,
               dense_bytes_per_tick=t["dense"],
               compressed_bytes_per_tick=t["compressed"],
               ratio=round(t["dense"] / max(t["compressed"], 1), 3))

    def _count_comm(self, bytes_pair) -> None:
        """Advance the compressed-collective byte counters by one
        forward's static wire price ({"dense", "compressed"})."""
        if self.tp_comm is None:
            return
        self.stats["comm_dense_bytes"] += bytes_pair["dense"]
        self.stats["comm_compressed_bytes"] += bytes_pair["compressed"]
        self._m_comm_dense.inc(bytes_pair["dense"])
        self._m_comm_compressed.inc(bytes_pair["compressed"])

    def _count_prefill(self, P: int) -> None:
        """A prefill's wire price at bucket length P (computed once a
        bucket)."""
        if self.tp_comm is None:
            return
        pair = self._comm_prefill_bytes.get(P)
        if pair is None:
            pair = forward_comm_bytes(self.cfg, self.tp_comm, 1, P)
            self._comm_prefill_bytes[P] = pair
        self._count_comm(pair)

    def _count_tick(self) -> None:
        """A decode tick's wire price."""
        self._count_comm(self._comm_tick_bytes)

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _clear_slot(self, i: int):
        """Reset every per-slot host mirror, sampling knobs and the
        speculation knob included, and mark the device carry stale."""
        self.slots[i] = None
        self.lengths[i] = 0
        self.last_tok[i] = 0
        self.temps[i] = 0.0
        self.top_ks[i] = 0
        self.top_ps[i] = 0.0
        self.generators[i] = None
        self.spec_on[i] = True
        self._carry_dirty = True
        if self.ranks > 1 and self.leads:
            self._cleared.append(i)

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

    def _generator(self, req: Request) -> Optional[torch.Generator]:
        """A sampled request's generator: seeded with its seed, or
        restored to the state saved at its preemption. None for a greedy
        request (it draws nothing)."""
        if req.temperature <= 0:
            return None
        gen = torch.Generator(device=self.device)
        if req.resume_key is not None:
            gen.set_state(req.resume_key)
        else:
            gen.manual_seed(int(req.seed))
        return gen

    def _admit_one(self, i: int, req: Request) -> int:
        """Prefill `req` into free slot `i`; returns 1 if admitted.

        A resumed request (already-generated tokens and/or a saved
        generator state: recompute-resume after preemption) teacher-forces
        prompt + generated in one prefill and samples the NEXT token at
        the final position with the saved generator: the token the
        interrupted decode tick would have sampled, greedy or not."""
        resumed = req.resume_key is not None or bool(req.generated)
        full = (req.tokens if resumed
                else np.asarray(req.prompt, np.int32))
        self.generators[i] = self._generator(req)
        t_prefill = time.monotonic()
        try:
            tok, lp, plp = self._prefill(i, req, full)
        except Exception as e:  # noqa: BLE001 - a failing prefill must
            # fail THIS request, not strand it or kill the step loop;
            # at tp > 1 the ranks' collectives are out of step: a fault
            if self.ranks > 1:
                raise
            self.generators[i] = None
            self._reject(req, f"prefill failed: {e}")
            return 0
        self._count_prefill(self._bucket(len(full)))
        p = len(full)
        self.slots[i] = req
        self.lengths[i] = p
        self.last_tok[i] = tok
        self.temps[i] = req.temperature
        self.top_ks[i] = req.top_k
        self.top_ps[i] = req.top_p
        self.spec_on[i] = bool(req.spec)
        self._carry_dirty = True
        req.generated.append(tok)
        req.logprobs.append(lp)
        if not resumed:
            req.prompt_logprobs = plp
        self.stats["admitted"] += 1
        now = time.monotonic()
        self._m_prefill.observe(now - t_prefill)
        if not resumed:
            # TTFT is first-admission only: a resume's clock restarted
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
        (0 = idle). At tp > 1 (rank 0) the tick's control record goes to
        the other ranks first."""
        if self.ranks > 1:
            return self._step_tensor_parallel()
        self._pre_tick()
        self._admit()
        return self._decode_tick()

    def _step_tensor_parallel(self) -> int:
        with self.channel.lock:
            self._pre_tick()
            plan = []
            with self._cv:
                for i in range(self.num_slots):
                    if self.slots[i] is None and self._queue:
                        plan.append((i, self._queue.popleft()))
                        self._admitting += 1
            record = {"clear": sorted(set(self._cleared)), "admit": [
                (i, dict(prompt=np.asarray(r.prompt).tolist(),
                         max_new_tokens=r.max_new_tokens,
                         temperature=r.temperature, top_k=r.top_k,
                         top_p=r.top_p, eod=r.eod, seed=r.seed))
                for i, r in plan]}
            self._cleared = []
            try:
                with self.channel.announce("tick", record):
                    for i, req in plan:
                        try:
                            self._admit_one(i, req)
                        finally:
                            with self._cv:
                                self._admitting -= 1
                            self.last_progress_time = time.monotonic()
                    return self._decode_tick()
            except BaseException as e:
                self._abandon([r for _, r in plan], e)
                raise

    def _abandon(self, plan: List[Request], e: BaseException) -> None:
        """Rank 0 after a fault of the tensor-parallel group: stop the
        step loop and fail every request it holds (the waiters unblock);
        submit() refuses from now on."""
        with self._cv:
            self._stop = True
            self._admitting = 0
            reqs = plan + list(self._queue)
            self._queue.clear()
        for i, req in enumerate(self.slots):
            if req is not None:
                self.slots[i] = None
                reqs.append(req)
        for req in reqs:
            if not req.done.is_set():
                req._finish(f"the tensor-parallel group failed: {e}")
        self._m_active.set(0)
        self._m_queue.set(0)

    def follow(self, record: dict) -> int:
        """A follower's tick (rank > 0 at tp > 1): rank 0's clears and
        admissions, then the same decode tick."""
        for i in record["clear"]:
            if self.slots[i] is not None:
                self._clear_slot(i)
        for i, kw in record["admit"]:
            kw = dict(kw)
            prompt = np.asarray(kw.pop("prompt"), np.int32)
            self._admit_one(i, Request(prompt=prompt, **kw))
        return self._decode_tick()

    def _pre_tick(self) -> None:
        """Control-plane work between ticks, shared by every engine (the
        paged engine's step() calls it first too): the serving faults of
        MEGATRON_TPU_FAULT at a deterministic decode tick (training/
        resilience.py: kill_replica, preempt_replica, hang_replica,
        slow_tick), a staged weight swap, then deadline expiry."""
        tick = self.stats["ticks"]
        resilience.maybe_kill("kill_replica", tick)
        if (not self._preempt_signalled
                and resilience.fault_active("preempt_replica", tick)):
            # once per process: ticks advance only on decode, and a
            # second SIGTERM would take the server's immediate-exit path
            self._preempt_signalled = True
            resilience.maybe_signal("preempt_replica", tick)
        resilience.maybe_hang("hang_replica", tick)
        resilience.maybe_sleep("slow_tick", journal_once=True)
        self._apply_pending_params()
        self._expire_deadlines()

    # ----- hot weight reload ----------------------------------------------

    def update_params(self, params: Any, version: Any = None
                      ) -> threading.Event:
        """Stage a weight swap; the step loop applies it between decode
        ticks, so slots in flight keep decoding (their cached prefixes
        came from the old weights; a drained rolling update keeps every
        request on one version).

        The new tree must match the old one leaf for leaf in name, shape
        and dtype (ValueError otherwise). The swap copies each new leaf
        INTO the engine's existing tensor: the captured decode graph has
        those tensors' addresses baked in, so the swap needs no capture
        and engine_decode_recompiles_total stays 0. A draft model made of
        views of the target's first layers (the server's default draft)
        changes with them; a draft loaded from its own checkpoint keeps
        its weights. Returns an Event set once the swap is applied.
        Refused at tp > 1, as the JAX server refuses a reload on a mesh."""
        if self.ranks > 1:
            raise ValueError(
                "a weight swap under tensor parallelism is not supported "
                "(as on the JAX server's mesh): restart the replicas with "
                "the new checkpoint")
        old, new = leaf_paths(self.params), leaf_paths(params)
        if [n for n, _ in old] != [n for n, _ in new]:
            raise ValueError("update_params: the new tree's leaves differ "
                             "from the served tree's")
        for (name, a), (_, b) in zip(old, new):
            if (tuple(a.shape), a.dtype) != (tuple(b.shape), b.dtype):
                raise ValueError(
                    f"update_params shape/dtype mismatch at {name}: "
                    f"{tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/"
                    f"{b.dtype}")
        applied = threading.Event()
        with self._cv:
            if self._pending_params is not None:
                # a staged swap not yet applied is superseded; its waiter
                # unblocks too (the newer weights subsume it)
                self._pending_params[2].set()
            self._pending_params = (new, version, applied)
            self._cv.notify_all()
        return applied

    @torch.no_grad()
    def _apply_pending_params(self) -> bool:
        """Swap in the weights update_params staged, if any (True then)."""
        with self._cv:
            pending = self._pending_params
            self._pending_params = None
        if pending is None:
            return False
        new, version, applied = pending
        for (_, dst), (_, src) in zip(leaf_paths(self.params), new):
            dst.copy_(src)
        self.params_version = version
        self.stats["weight_reloads"] += 1
        self._m_reloads.inc()
        applied.set()
        return True

    # ----- deadlines -------------------------------------------------------

    def _expire_deadlines(self) -> None:
        """Fail queued and mid-decode requests past their deadline: their
        waiters unblock within one tick of expiry. A cleared slot marks
        the carry stale (_clear_slot), so the next replay does not decode
        its row."""
        now = time.monotonic()
        with self._cv:
            expired = [r for r in self._queue
                       if r._deadline is not None and now > r._deadline]
            for req in expired:
                self._queue.remove(req)
            if expired:
                self._m_queue.set(len(self._queue))
        for req in expired:
            self._fail_timeout(req, "queued")
        for i in range(self.num_slots):
            req = self.slots[i]
            if (req is not None and req._deadline is not None
                    and now > req._deadline):
                self._clear_slot(i)
                self._m_active.set(self.num_active)
                self._fail_timeout(req, "mid-decode")

    def _fail_timeout(self, req: Request, where: str) -> None:
        req.timed_out = True
        self.stats["timeouts"] += 1
        self._m_timeouts.inc()
        req._finish(
            f"deadline exceeded while {where} (deadline_s="
            f"{req.deadline_s}, generated {len(req.generated)} of "
            f"{req.max_new_tokens} tokens)")

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no request is queued, mid-admission or decoding and
        no weight swap is pending (the drain step of a rolling update).
        False if `timeout` seconds pass first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cv:
                if (not self._queue and self._admitting == 0
                        and self.num_active == 0
                        and self._pending_params is None):
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.01)

    def _decode_rows(self) -> List[int]:
        """Slot indices the batched decode serves this tick (the paged
        engine excludes slots still mid-chunked-prefill)."""
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _decode_extra_args(self) -> dict:
        """Extra lm_forward keyword arguments of the decode step (the
        paged engine passes its static device page table)."""
        return {}

    def _decode_write_span(self) -> int:
        """Cache positions one decode tick writes per slot: 1 plain,
        k + 1 speculative (the paged engine sizes page allocation off
        this)."""
        return 1 + self._capacity_margin()

    def _fail_decode(self, e: Exception) -> None:
        """A failed step: fail every request in flight (their waiters
        must unblock), rebuild the caches (the step may have left them
        half written) and capture the step again over the new ones."""
        for i, req in enumerate(self.slots):
            if req is not None:
                self._clear_slot(i)
                req._finish(f"decode step failed: {e}")
        self._m_active.set(self.num_active)
        self._rebuild_caches()
        self._build_step()

    def _rebuild_caches(self) -> None:
        """Fresh cache trees (target, and the draft's for the model
        drafter), the old ones dropped first."""
        self._step = None
        self.caches = None
        self.draft_caches = None
        self.caches = self._fresh_caches()
        if self._has_draft_model():
            self.draft_caches = self._fresh_draft_caches()
        self._carry_dirty = True

    def _decode_tick(self) -> int:
        """One batched decode for every decodable slot; returns how many
        were served (0 = nothing to decode)."""
        active = self._decode_rows()
        if not active:
            return 0
        t_tick = time.monotonic()
        try:
            # the tick's marker in a profiled window (the decode
            # contracts count comm.* calls per tick between its ends)
            with torch.profiler.record_function("decode_tick"):
                toks, lps, accepts = self._decode_step(active)
        except Exception as e:
            self._fail_decode(e)
            raise
        self.stats["ticks"] += 1
        self._m_ticks.inc()
        self._m_tick.observe(time.monotonic() - t_tick)
        self._count_tick()
        emitted = 0
        for i in active:
            req = self.slots[i]
            a = int(accepts[i])
            # the fed token and a accepted drafts are now in the cache;
            # toks[i, a] is next up
            self.lengths[i] += a + 1
            self.last_tok[i] = int(toks[i, a])
            if self.spec is not None and self.spec_on[i]:
                self.stats["spec_proposed"] += self.spec.k
                self.stats["spec_accepted"] += a
                self._m_spec_proposed.inc(self.spec.k)
                self._m_spec_accepted.inc(a)
                self._m_spec_len.observe(a)
            for j in range(a + 1):
                req.generated.append(int(toks[i, j]))
                req.logprobs.append(float(lps[i, j]))
                emitted += 1
                if self._req_finished(req):
                    # eod or max_new_tokens in the middle of a
                    # speculation: the later accepted tokens come "after
                    # the end", which plain decode never produces
                    break
            if self._req_finished(req):
                self._retire(i)
        if self.spec is not None:
            self.stats["spec_emitted"] += emitted
        self._m_tokens.inc(emitted)
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
                 eod: Optional[int] = None, seed: int = 0,
                 deadline_s: Optional[float] = None,
                 spec: bool = True) -> GenerationOutput:
        """Submit one request per row, drain, and repack
        [B, maxp + max_new] like the JAX engine: shorter prompts get
        maxp - p extra generated tokens (the one-shot path's row layout).
        Raises EngineOverloadedError when the queue cannot take all B
        rows (nothing is submitted then), RequestTimeoutError when a
        row's deadline expired, ValueError for any other failure."""
        B, maxp = prompts.shape
        reqs = []
        # the capacity check and the B submits under one acquisition of
        # the (reentrant) lock: a batch that cannot queue whole is
        # rejected before any row runs
        with self._cv:
            if (self.max_queue is not None
                    and len(self._queue) + B > self.max_queue):
                self.stats["rejected"] += B
                self._m_rejected.inc(B)
                raise EngineOverloadedError(
                    f"engine queue cannot take {B} more requests "
                    f"(max_queue={self.max_queue}); retry later")
            for b in range(B):
                p = int(lengths[b])
                reqs.append(self.submit(Request(
                    prompt=np.asarray(prompts[b, :p], np.int32),
                    max_new_tokens=maxp - p + max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    eod=eod, seed=seed + b, deadline_s=deadline_s,
                    spec=spec)))
        if self._thread is None:
            self.run_until_idle()
        for r in reqs:
            r.done.wait()
        if any(r.overloaded for r in reqs):
            raise EngineOverloadedError(
                next(r.error for r in reqs if r.overloaded))
        if any(r.timed_out for r in reqs):
            raise RequestTimeoutError(
                next(r.error for r in reqs if r.timed_out))
        errs = [r.error for r in reqs if r.error]
        if errs and self.channel is not None and self.channel.fault:
            raise RuntimeError(errs[0])     # the server's fault, not a 400
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
                           and not self._queue
                           and self._pending_params is None):
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
        with self._cv:
            if self._pending_params is not None:
                # unblock a reload waiter: the swap will never be applied
                self._pending_params[2].set()
                self._pending_params = None
        self._m_active.set(0)
        self._m_queue.set(0)
