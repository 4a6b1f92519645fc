"""One-shot generation, scoring and beam search (counterpart of
megatron_tpu/inference/generation.py).

generate_tokens is the JAX package's jitted while-loop as a plain torch
loop on the params' device: one cache [L, B, total_len, nkv, D] per
call, one bucketed prefill of the prompt region, then one single-token
forward per position. Prompts of different lengths are handled the
reference's way: decode starts at the shortest prompt and a row's
prompt tokens override its samples until the row's prompt is used up.
The loop ends early once every row has emitted eod. Sampled rows draw
from a torch.Generator per row, seeded with seed + row, and only at
positions where the row really samples: a row's tokens are those its
request would get from the engine with the same seed (the engine's
generate seeds row b with seed + b too). Greedy rows draw nothing.

The routing is the JAX package's: the prefill's q (prefill_len rows) is
shorter than the cache (total_len), and a decode step attends one query
over the whole cache with no kv_lengths, so both take the dense
attention path (ops/attention.py) and launch no kernel. score_tokens is
one full-sequence causal forward with no cache, the flash_fwd kernel on
CUDA. beam_search_tokens prefills once at batch 1, repeats the caches
across the beams and reorders them by parent every step.

A cache is (k, v), or with int8=True the 4-tuple (k_q, v_q, k_scale,
v_scale) of ops/kv_quant.py: every path here takes either.

Tensor parallelism (a MeshRuntime as `mesh`, serving): every rank of the
tensor group runs the same call on its slices of the params (rank 0
broadcast the request: inference/server.py), with caches of its own kv
heads [L, B, total_len, nkv/tp, D] (scales included), and reads the
logits gathered over the group. Pipeline parallelism (a mesh with
pp > 1; the JAX package passes the same forward as forward_fn):
generate_tokens and score_tokens run the pipelined forward
(inference/pipelined.py), each stage with caches of its own layers and
the logits whole on every rank (beam_search_tokens too, though the
server refuses beam search there, as the JAX server does); int8 caches
are refused there, as in the JAX package. Tokens are
chosen once, on rank 0 of the serving world (its samples, its argmax,
beam search's choices), and broadcast, so no rank can diverge from it.

One difference by design: a right-padded batch's pad positions enter
the model as id 0 (generate_tokens) and ids outside the embedding table
score 0.0 (score_tokens). The null tokenizer's pad id is the vocab size,
which jnp.take turns into a NaN embedding in the JAX package and which
would be an out-of-range index on the card. No real position changes:
attention is causal and a pad's cache row is rewritten before any query
reads it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.pipelined import PipelinedForward
from megatron_tpu_torch.inference.sampling import (
    _mask_vocab, sample_logits_batched,
)
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.ops.kv_quant import kv_buffers
from megatron_tpu_torch.ops.rotary import precompute_rope
from megatron_tpu_torch.parallel.mappings import all_gather, broadcast

#: the one-shot prefill length is the longest prompt rounded up to this
PREFILL_BUCKET = 64


@dataclasses.dataclass
class GenerationOutput:
    tokens: np.ndarray       # [B, total_len] int32 (prompt + generated)
    lengths: np.ndarray      # [B] generated sequence end (index past last)
    logprobs: np.ndarray     # [B, total_len-1] logprob of each emitted token


def _init_caches(cfg: ModelConfig, batch: int, total_len: int,
                 device="cuda", int8: bool = False, tp: int = 1,
                 pp: int = 1):
    """Zeroed caches [L/pp, batch, total_len, nkv/tp, D]: (k, v) in
    the model dtype, or with int8 the 4-tuple of ops/kv_quant.kv_buffers
    (half the bytes of bf16, plus 4/D). tp: a tensor-parallel rank holds
    its kv heads only; pp: a pipeline stage its own layers."""
    shape = (cfg.num_layers // pp, batch, total_len, cfg.n_kv_heads // tp,
             cfg.head_dim)
    return kv_buffers(shape, cfg.dtype, int8, device)


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def _pp(mesh) -> int:
    return 1 if mesh is None else mesh.pp


def _shared(mesh) -> bool:
    """Whether more than one rank serves (a tensor- or pipeline-parallel
    serving world)."""
    return mesh is not None and mesh.world_size > 1


def _leads(mesh) -> bool:
    """Whether this rank chooses the tokens (rank 0 of the serving
    world; the only rank without a mesh)."""
    return not _shared(mesh) or mesh.rank == 0


def from_rank0(t: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's t on every rank of the serving world."""
    if not _shared(mesh):
        return t
    return broadcast(t, dist.group.WORLD)


def pipelined(mesh, kv_cache_int8: bool = False) -> bool:
    """Whether `mesh` serves through the pipelined forward (pp > 1).
    int8 caches are refused there, as in the JAX package."""
    if mesh is None or mesh.pp == 1:
        return False
    if kv_cache_int8:
        raise ValueError(
            "kv_cache_int8 is not supported with pipeline-parallel (pp>1) "
            "serving: the pipelined forward threads bf16 cache pairs")
    return True


def _forward(cfg: ModelConfig, mesh, kv_cache_int8: bool = False):
    """The model's cached and uncached forward: lm_forward, or at
    pp > 1 the pipelined forward, whose logits are whole on every
    rank."""
    if pipelined(mesh, kv_cache_int8):
        return PipelinedForward(cfg, mesh)
    return functools.partial(lm_forward, cfg)


def _device(params: Any) -> torch.device:
    # a norm scale: never weight-quantized, in every model
    return params["layers"]["ln1"]["scale"].device


def _rope(cfg: ModelConfig, n: int, device):
    """The (cos, sin) table of n positions for a rotary model; None for
    absolute position embeddings, which the embedding adds at the
    positions of each forward."""
    if cfg.position_embedding_type != "rotary":
        return None
    return precompute_rope(cfg.head_dim, n, cfg.rope_theta,
                           cfg.rope_scaling_factor, device=device)


def check_positions(cfg: ModelConfig, n: int, what: str) -> None:
    """A model with absolute position embeddings reaches n positions only
    if its table has them: the JAX package refuses the rest rather than
    clamp them to the table's last row."""
    if (cfg.position_embedding_type == "absolute"
            and n > (cfg.max_position_embeddings or 0)):
        raise ValueError(
            f"{what} {n} exceeds max_position_embeddings "
            f"{cfg.max_position_embeddings}: absolute position embeddings "
            "would silently clamp")


def check_one_shot(name: str, cfg: ModelConfig, **kw) -> None:
    """The checks the one-shot token function `name` makes on its
    arguments before its first collective. A tensor-parallel rank 0
    makes them before it announces the call (inference/server.py), so a
    refused request never reaches the other ranks."""
    if name == "score_tokens":
        check_positions(cfg, np.shape(kw["tokens"])[1] - 1, "scored length")
        return
    if name == "beam_search_tokens":
        if kw["beam_size"] < 1:
            raise ValueError("beam_size must be >= 1")
        n = len(kw["prompt"])
    else:
        n = np.shape(kw["prompts"])[1]
    check_positions(cfg, n + kw["max_new_tokens"],
                    "prompt + tokens_to_generate =")


@torch.no_grad()
def generate_tokens(
    cfg: ModelConfig,
    params: Any,
    prompts: np.ndarray,     # [B, max_prompt_len] int32, right-padded
    lengths: np.ndarray,     # [B]
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    vocab_size: Optional[int] = None,
    eod: Optional[int] = None,
    seed: int = 0,
    want_logprobs: bool = True,
    kv_cache_int8: bool = False,
    mesh=None,
) -> GenerationOutput:
    """Every row runs to max_prompt_len + max_new_tokens (or its eod):
    a shorter prompt gets the difference as extra generated tokens.
    mesh: parallel serving (the module docstring)."""
    fwd = _forward(cfg, mesh, kv_cache_int8)
    dev = _device(params)
    B, max_prompt = prompts.shape
    total_len = max_prompt + max_new_tokens
    check_one_shot("generate_tokens", cfg, prompts=prompts,
                   max_new_tokens=max_new_tokens)
    lengths = np.asarray(lengths, np.int64)
    real = np.arange(max_prompt)[None, :] < lengths[:, None]
    tokens = torch.zeros((B, total_len), dtype=torch.long, device=dev)
    tokens[:, :max_prompt] = torch.from_numpy(
        np.where(real, prompts, 0).astype(np.int64)).to(dev)
    # bucketed prefill length: covers the longest prompt, rounded up so a
    # 5-token prompt with 2000 new tokens does not pay a 2000-position
    # prefill; decode rewrites the positions it re-runs
    prefill_len = min(total_len - 1,
                      max(1, -(-max_prompt // PREFILL_BUCKET)
                          * PREFILL_BUCKET))
    caches = _init_caches(cfg, B, total_len, device=dev, int8=kv_cache_int8,
                          tp=_tp(mesh), pp=_pp(mesh))
    rope = _rope(cfg, total_len, dev)
    positions = torch.arange(total_len, device=dev)[None, :]
    logits_all, _ = fwd(params, tokens[:, :prefill_len],
                        positions=positions[:, :prefill_len],
                        kv_caches=caches, cache_index=0, rope=rope,
                        mesh=mesh)

    lp = torch.zeros((B, total_len - 1), dtype=torch.float32, device=dev)
    if want_logprobs:
        # teacher-forced logprobs of the prompt region
        lsm = torch.log_softmax(logits_all.float(), dim=-1)
        prompt_lp = torch.gather(
            lsm, 2, tokens[:, 1:prefill_len + 1, None])[..., 0]
        valid = (torch.arange(1, prefill_len + 1, device=dev)[None, :]
                 < torch.from_numpy(lengths).to(dev)[:, None])
        lp[:, :prefill_len] = torch.where(valid, prompt_lp, 0.0)
        del lsm

    sampled = temperature > 0
    lead = _leads(mesh)
    gens = [torch.Generator(device=dev).manual_seed(int(seed) + b)
            if sampled and lead else None for b in range(B)]
    temps = torch.full((B,), float(temperature))
    top_ks = torch.full((B,), int(top_k), dtype=torch.long)
    top_ps = torch.full((B,), float(top_p))
    done = np.zeros(B, bool)
    t = int(lengths.min())
    # the loop starts at the shortest prompt with the prefill's logits at
    # position t - 1
    last = logits_all[:, max(t - 1, 0)].float()
    del logits_all
    while t < total_len and not done.all():
        in_prompt = t < lengths
        forced = in_prompt | done
        if not lead:
            nxt = torch.zeros(B, dtype=torch.long, device=dev)
        elif sampled:
            # draw only where the row samples (its generator advances
            # exactly as its engine request's would)
            nxt = sample_logits_batched(
                last, [None if forced[b] else gens[b] for b in range(B)],
                torch.where(torch.from_numpy(forced), 0.0, temps), top_ks,
                top_ps, vocab_size)
        else:
            nxt = torch.argmax(_mask_vocab(last, vocab_size), dim=-1)
        nxt = from_rank0(nxt, mesh)
        forced_t = torch.from_numpy(forced).to(dev)
        nxt = torch.where(forced_t, tokens[:, t], nxt)
        if eod is not None:
            nxt = torch.where(torch.from_numpy(done).to(dev), eod, nxt)
        tokens[:, t] = nxt
        step_lp = torch.gather(torch.log_softmax(last, dim=-1), 1,
                               nxt[:, None])[:, 0]
        lp[:, t - 1] = torch.where(torch.from_numpy(done).to(dev), 0.0,
                                   step_lp)
        if eod is not None:
            done |= (nxt == eod).cpu().numpy() & ~in_prompt
        logits, _ = fwd(params, nxt[:, None],
                        positions=positions[:, t:t + 1],
                        kv_caches=caches, cache_index=t, rope=rope,
                        mesh=mesh)
        last = logits[:, 0].float()
        t += 1

    toks = tokens.cpu().numpy().astype(np.int32)
    if eod is not None:
        after = np.arange(total_len)[None, :] >= lengths[:, None]
        hit = (toks == eod) & after
        ends = np.where(hit.any(1), hit.argmax(1) + 1, total_len)
    else:
        ends = np.full(B, total_len)
    return GenerationOutput(tokens=toks, lengths=ends.astype(np.int64),
                            logprobs=lp.cpu().numpy())


@torch.no_grad()
def score_tokens(cfg: ModelConfig, params: Any,
                 tokens: np.ndarray, mesh=None) -> np.ndarray:
    """Teacher-forced per-token logprobs [B, S-1]: one causal forward
    over tokens[:, :-1] with no cache (flash_fwd on CUDA), its logits
    gathered over the tensor group under a mesh (the pipelined forward
    gives them whole). Ids outside the embedding table are padding:
    they enter as 0 and score 0.0."""
    check_one_shot("score_tokens", cfg, tokens=tokens)
    t = torch.from_numpy(np.asarray(tokens, np.int64)).to(_device(params))
    pad = (t < 0) | (t >= cfg.vocab_size)
    t = torch.where(pad, 0, t)
    logits = _forward(cfg, mesh)(params, t[:, :-1], mesh=mesh)
    if not pipelined(mesh) and _tp(mesh) > 1:
        logits = all_gather(logits, mesh.group("tensor"), dim=-1)
    lsm = torch.log_softmax(logits.float(), dim=-1)
    lp = torch.gather(lsm, 2, t[:, 1:, None])[..., 0]
    return torch.where(pad[:, 1:], 0.0, lp).cpu().numpy()


@torch.no_grad()
def beam_search_tokens(
    cfg: ModelConfig,
    params: Any,
    prompt: np.ndarray,       # [prompt_len] one prompt
    max_new_tokens: int,
    beam_size: int,
    eod: int,
    length_penalty: float = 1.0,
    kv_cache_int8: bool = False,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Beam search for one prompt: (beams [beam_size, total + 1], scores
    [beam_size]), best first. The hypothesis bookkeeping (2 x beam
    candidates a step, eod-terminated hypotheses scored with the length
    penalty, the early stop) runs on the host in float64, as in the JAX
    package; the device prefills once at batch 1, repeats the caches
    across the beams and runs one single-token forward per step over the
    caches reordered by parent (index_select on the batch axis, for
    (k, v) and int8 caches alike). Under a mesh rank 0's choice of
    parents, tokens and the early stop is broadcast every step."""
    fwd = _forward(cfg, mesh, kv_cache_int8)
    dev = _device(params)
    prompt = np.asarray(prompt, np.int32)
    plen = len(prompt)
    total = plen + max_new_tokens
    check_one_shot("beam_search_tokens", cfg, prompt=prompt,
                   max_new_tokens=max_new_tokens, beam_size=beam_size)

    caches = _init_caches(cfg, 1, total, device=dev, int8=kv_cache_int8,
                          tp=_tp(mesh), pp=_pp(mesh))
    rope = _rope(cfg, total, dev)
    prefill_logits, _ = fwd(
        params, torch.from_numpy(prompt.astype(np.int64))[None].to(dev),
        positions=torch.arange(plen, device=dev)[None, :], kv_caches=caches,
        cache_index=0, rope=rope, mesh=mesh)
    caches = tuple(c.repeat_interleave(beam_size, dim=1) for c in caches)
    step_logits_dev = prefill_logits[:, -1].repeat_interleave(beam_size, 0)

    def decode_step(caches, parents, toks, t):
        idx = torch.tensor(parents, dtype=torch.long, device=dev)
        caches = tuple(torch.index_select(c, 1, idx) for c in caches)
        pos = torch.full((beam_size, 1), t, dtype=torch.long, device=dev)
        logits, _ = fwd(
            params, torch.tensor(toks, dtype=torch.long,
                                 device=dev)[:, None],
            positions=pos, kv_caches=caches, cache_index=t, rope=rope,
            mesh=mesh)
        return logits[:, 0], caches

    beams = np.tile(prompt[None, :], (beam_size, 1))
    scores = np.full((beam_size,), -1e9, np.float64)
    scores[0] = 0.0
    finished = []  # (score_with_penalty, tokens)

    for t in range(plen, total):
        logits = step_logits_dev.double().cpu().numpy()
        logprobs = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True))
                                   .sum(-1, keepdims=True)) - logits.max(-1, keepdims=True)
        cand = scores[:, None] + logprobs  # [beams, V]
        flat = cand.reshape(-1)
        top = np.argpartition(-flat, 2 * beam_size)[: 2 * beam_size]
        top = top[np.argsort(-flat[top])]
        new_beams, new_scores, parents, new_toks = [], [], [], []
        for idx in top:
            b, v = divmod(int(idx), logits.shape[-1])
            seq = np.concatenate([beams[b], [v]])
            if v == eod:
                penalty = ((len(seq) - plen) ** length_penalty)
                finished.append((flat[idx] / penalty, seq))
            else:
                new_beams.append(seq)
                new_scores.append(flat[idx])
                parents.append(b)
                new_toks.append(v)
            if len(new_beams) == beam_size:
                break
        beams = np.stack([np.pad(s, (0, total - len(s))) for s in new_beams])[:, :t + 1]
        scores = np.asarray(new_scores)
        stop = False
        if len(finished) >= beam_size:
            best_possible = scores.max() / (max(1, t + 1 - plen) ** length_penalty)
            worst_kept = sorted(finished, key=lambda x: -x[0])[beam_size - 1][0]
            stop = bool(worst_kept >= best_possible)
        if _shared(mesh):
            choice = from_rank0(torch.tensor(
                parents + new_toks + [int(stop)], device=dev), mesh).tolist()
            n = len(parents)
            parents, new_toks = choice[:n], choice[n:2 * n]
            stop = bool(choice[-1])
        if stop:
            break
        if t + 1 < total:
            step_logits_dev, caches = decode_step(caches, parents, new_toks,
                                                  t)

    for s, b in zip(scores, beams):
        penalty = (max(1, beams.shape[1] - plen) ** length_penalty)
        finished.append((s / penalty, np.concatenate([b, [eod]])))
    finished.sort(key=lambda x: -x[0])
    finished = finished[:beam_size]
    out_tokens = np.stack([np.pad(f[1], (0, total + 1 - len(f[1])),
                                  constant_values=eod) for f in finished])
    out_scores = np.asarray([f[0] for f in finished])
    return out_tokens, out_scores
