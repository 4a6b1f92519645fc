"""Speculative decoding inside the engines' decode tick (counterpart of
megatron_tpu/inference/speculative.py).

Classic speculative sampling (Leviathan et al., arXiv 2211.17192): a
cheap drafter proposes ``k`` tokens per slot, ONE batched target forward
of ``[N, k+1]`` query rows scores them all, and an exact accept/reject
keeps or replaces each draft, so the emitted tokens follow the target
model's distribution. A tick that accepts ``a`` drafts emits ``a+1``
tokens for one target forward; a tick that rejects everything still
emits one.

Two drafters, as in the JAX package:

  * ``"ngram"``: prompt lookup on the host (ngram_propose, numpy over
    the request's own history). Its ``[N, k]`` proposals are copied into
    the engine's static drafts buffer before the tick.
  * ``"model"``: a draft network with its own cache tree (or page pools
    over the target's page tables). Inside the tick it runs k greedy
    single-token forwards, each feeding its argmax to the next, plus one
    write-only forward so a fully accepted tick leaves the draft cache
    complete (the JAX package's in-step scan).

The engine's tick is split in two (inference/engine.py): the device part
(the draft loop, the verify forward, and for greedy rows the argmax,
their log-softmax and the accept count: greedy_verify) is one captured
CUDA graph on the card; the sampled rows (speculative_accept) run after
the graph's replay, eagerly, because they draw from each request's own
torch.Generator. Exactness, as in the JAX package:

  * greedy rows: draft j is accepted iff it equals the target's argmax
    at j-1, and every emitted token is that argmax: token for token the
    output of plain greedy decode, for any drafter.
  * sampled rows: a point-mass draft is accepted with probability
    p_j(draft) under the temperature/top-k/top-p filtered target
    distribution; a rejected position emits a sample from the residual
    (p with the draft removed), the bonus position a full sample.
  * rows whose spec_rows is False accept nothing and emit one token,
    drawn from the full distribution.

Differences from the JAX package, by design: randomness comes from the
request's torch.Generator (deterministic for a seed, not drawn one for
one like JAX's positional PRNG, which the port does not reproduce), and
an all-greedy tick draws nothing and sorts nothing because the sampled
branch is skipped on the host (JAX keeps it dead under lax.cond).
Rejected drafts roll back by the slot's length alone, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.sampling import (
    _NEG, _mask_vocab, filter_top_k_top_p,
)
from megatron_tpu_torch.ops.flash.flash_template import DECODE_MAX_ROWS

#: drafter registry: "ngram" is host-side prompt lookup, "model" a draft
#: network sharing the engine's cache machinery
DRAFTERS = ("ngram", "model")


@dataclasses.dataclass
class SpecConfig:
    """Engine-level speculative decoding configuration.

    k: drafted tokens per slot per tick (the verify forward takes
       [N, k+1] query rows); a tick emits 1 .. k+1 tokens per slot.
    drafter: "ngram" (zero-weight prompt lookup) or "model".
    ngram: trailing n-gram length the lookup matches (it falls back to
       shorter suffixes down to 1).
    draft_cfg/draft_params: the draft model ("model" only). It must
       share the target's vocab; its layers and heads are free.
    """

    k: int = 4
    drafter: str = "ngram"
    ngram: int = 2
    draft_cfg: Optional[ModelConfig] = None
    draft_params: Any = None


def validate_spec(cfg: ModelConfig, spec: SpecConfig) -> None:
    if spec.k < 1:
        raise ValueError(f"spec k must be >= 1, got {spec.k}")
    if spec.drafter not in DRAFTERS:
        raise ValueError(
            f"unknown drafter {spec.drafter!r} (choose from {DRAFTERS})")
    if spec.drafter == "ngram" and spec.ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {spec.ngram}")
    if spec.drafter == "model":
        if spec.draft_cfg is None or spec.draft_params is None:
            raise ValueError(
                "drafter='model' needs draft_cfg and draft_params "
                "(use drafter='ngram' for the zero-weight drafter)")
        if spec.draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {spec.draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: verify compares token ids directly")


def check_verify_rows(cfg: ModelConfig, spec: SpecConfig) -> None:
    """The decode kernel's limit for the verify form: (k+1) * G query
    rows per kv head fit one block (DECODE_MAX_ROWS). Engines call this
    at construction when the kernel will run, so the error comes there
    and not at the first tick."""
    rows = (spec.k + 1) * (cfg.num_attention_heads // cfg.n_kv_heads)
    if rows > DECODE_MAX_ROWS:
        raise ValueError(
            f"speculative k={spec.k}: the verify pass has (k+1) * G = "
            f"{rows} query rows per kv head, more than the decode "
            f"kernel's {DECODE_MAX_ROWS}; use k <= "
            f"{DECODE_MAX_ROWS // (cfg.num_attention_heads // cfg.n_kv_heads) - 1}")


# ---------------------------------------------------------------------------
# n-gram / prompt-lookup drafter (host side)
# ---------------------------------------------------------------------------


def ngram_propose(history: np.ndarray, k: int, n: int) -> np.ndarray:
    """Propose k continuation tokens by prompt lookup: find the most
    recent EARLIER occurrence of the trailing n-gram of ``history`` and
    return the k tokens that followed it (falling back to shorter
    suffixes down to 1). When nothing matches, repeat the last token — a
    cheap guess the verifier will usually reject at no cost (the tick
    still emits its guaranteed token)."""
    history = np.asarray(history, np.int32)
    ln = len(history)
    out = np.full(k, history[-1] if ln else 0, np.int32)
    for nn in range(min(n, ln - 1), 0, -1):
        suffix = history[ln - nn:]
        # all windows history[i:i+nn] for i < ln-nn at once: match[i]
        # is True when the window equals the trailing n-gram
        windows = np.lib.stride_tricks.sliding_window_view(
            history[:ln - 1], nn)                     # [ln-nn, nn]
        match = (windows == suffix).all(axis=1)
        if not match.any():
            continue
        i = int(len(match) - 1 - np.argmax(match[::-1]))  # newest match
        cont = history[i + nn:i + nn + k]
        out[:len(cont)] = cont
        if 0 < len(cont) < k:
            out[len(cont):] = cont[-1]
        return out
    return out


# ---------------------------------------------------------------------------
# exact accept/reject
# ---------------------------------------------------------------------------


def greedy_verify(logits: torch.Tensor, drafts: torch.Tensor,
                  vocab_size: Optional[int] = None,
                  spec_rows: Optional[torch.Tensor] = None):
    """The greedy part of the accept/reject, on the device with no host
    sync (it ends the captured tick). logits [N, k+1, V], drafts [N, k].
    Returns (toks [N, k+1] the argmax at every position, lps [N, k+1]
    their fp32 log-softmax of the raw logits, accepts [N] the drafts
    accepted until the first mismatch; 0 on rows whose spec_rows is
    False)."""
    raw32 = logits.float()
    k = drafts.shape[1]
    toks = torch.argmax(_mask_vocab(raw32, vocab_size), dim=-1)
    lps = torch.gather(torch.log_softmax(raw32, dim=-1), -1,
                       toks[..., None])[..., 0]
    match = drafts.to(toks.dtype) == toks[:, :k]
    if spec_rows is not None:
        match &= spec_rows[:, None]
    accepts = torch.cumprod(match.long(), dim=1).sum(dim=1)
    return toks, lps, accepts


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel noise: argmax(logits + noise) is a categorical draw."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(
        u.clamp(torch.finfo(torch.float32).tiny, 1.0)))


def speculative_accept(
    logits: torch.Tensor,              # [N, k+1, V] target logits
    drafts: torch.Tensor,              # [N, k] proposed tokens
    temps: Sequence[float],            # [N] host; 0 = greedy
    top_ks: Sequence[int],             # [N] host
    top_ps: Sequence[float],           # [N] host
    generators: Sequence[Optional[torch.Generator]],
    vocab_size: Optional[int] = None,
    spec_rows: Optional[torch.Tensor] = None,   # [N] bool; False = no spec
    greedy=None,
):
    """The exact accept/reject. Returns (toks [N, k+1], lps [N, k+1],
    accepts [N]); the caller emits toks[i, :accepts[i] + 1].

    Position j is the query fed token j (j = 0 the slot's last sampled
    token, j >= 1 draft j). Greedy rows are greedy_verify's (pass its
    result as `greedy` when it was already computed, as the engine's
    captured tick does). Sampled rows draw from generators[i]: k
    uniforms for the accept tests, then Gumbel noise for the k residual
    samples and the bonus sample. The knobs are host sequences, so an
    all-greedy tick makes no host sync, draws nothing and sorts nothing.
    Positions past the first rejection are garbage by construction."""
    if greedy is None:
        greedy = greedy_verify(logits, drafts, vocab_size, spec_rows)
    sampled = [i for i in range(len(temps)) if temps[i] > 0]
    if not sampled:
        return greedy
    toks, lps, accepts = (t.clone() for t in greedy)
    dev = logits.device
    k = drafts.shape[1]
    K1, V = logits.shape[1], logits.shape[2]
    rows = torch.tensor(sampled, device=dev)
    raw32 = logits[rows].float()                          # [n, K1, V]
    t = torch.tensor([float(temps[i]) for i in sampled], device=dev)
    scaled = _mask_vocab(raw32, vocab_size) / t[:, None, None]
    tk = [int(top_ks[i]) for i in sampled]
    tp = [float(top_ps[i]) for i in sampled]
    if any(x > 0 for x in tk) or any(x > 0 for x in tp):
        # the batched sampler's filter, the k+1 positions flattened into
        # the batch axis with each row's knobs repeated per position
        flat = filter_top_k_top_p(
            scaled.reshape(-1, V),
            torch.tensor(tk, device=dev).repeat_interleave(K1),
            torch.tensor(tp, device=dev).repeat_interleave(K1))
        scaled = flat.reshape(len(sampled), K1, V)
    d = drafts[rows].to(torch.long)                       # [n, k]
    srow = (torch.ones(len(sampled), dtype=torch.bool, device=dev)
            if spec_rows is None else spec_rows[rows].bool())
    p_draft = torch.gather(torch.softmax(scaled[:, :k], dim=-1), -1,
                           d[..., None])[..., 0]          # [n, k]
    u = torch.stack([torch.rand(k, generator=generators[i], device=dev)
                     for i in sampled])
    noise = torch.stack([_gumbel((K1, V), generators[i], dev)
                         for i in sampled])
    # spec-off rows never run the accept test, so they sample the FULL
    # distribution (no column removed)
    accept = (u < p_draft) & srow[:, None]
    drop = torch.zeros_like(scaled[:, :k], dtype=torch.bool).scatter_(
        -1, d[..., None], True) & srow[:, None, None]
    resid = torch.where(drop, _NEG, scaled[:, :k])
    rej = torch.argmax(resid + noise[:, :k], dim=-1)
    bonus = torch.argmax(scaled[:, k] + noise[:, k], dim=-1)
    out = torch.cat([torch.where(accept, d, rej), bonus[:, None]], dim=1)
    toks[rows] = out.to(toks.dtype)
    accepts[rows] = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    lps[rows] = torch.gather(torch.log_softmax(raw32, dim=-1), -1,
                             out[..., None])[..., 0]
    return toks, lps, accepts
