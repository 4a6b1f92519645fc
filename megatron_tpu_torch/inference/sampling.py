"""Token sampling: greedy / temperature / top-k / top-p
(counterpart of megatron_tpu/inference/sampling.py).

Filtering works on sorted logits so top-k and top-p compose, with the
JAX package's semantics. The noise differs: jax.random keys become
torch.Generators (one per request in the engine, so a request's tokens
never depend on which other slots are active). Sampling draws Gumbel
noise from the row's generator and takes argmax(logits + noise), which
is a categorical draw, as jax.random.categorical does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG = torch.finfo(torch.float32).min


def _mask_vocab(logits: torch.Tensor, vocab_size: Optional[int]):
    V = logits.shape[-1]
    if vocab_size is not None and vocab_size < V:
        keep = torch.arange(V, device=logits.device) < vocab_size
        logits = torch.where(keep, logits, _NEG)
    return logits


def _gumbel_argmax(logits: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of [B, V] logits, all rows from one
    generator."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp(torch.finfo(torch.float32).tiny, 1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator],
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0,
                  vocab_size: Optional[int] = None) -> torch.Tensor:
    """Sampled token ids [B] from [B, V] logits. top_k=0 / top_p=0
    disable the filters; temperature 0 (or no generator) is greedy."""
    logits = _mask_vocab(logits.float(), vocab_size)
    if generator is None or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, _NEG, logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, _NEG, logits)
    return _gumbel_argmax(logits, generator)


def filter_top_k_top_p(scaled: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k then top-p on [B, V] temperature-scaled logits;
    rows with top_k <= 0 / top_p <= 0 keep all mass for that filter and
    each row's top token always survives (one sort serves both)."""
    V = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (top_k[:, None] - 1).clamp(0, V - 1))
    use_k = top_k[:, None] > 0
    scaled = torch.where(use_k & (scaled < kth), _NEG, scaled)
    desc = torch.where(use_k & (desc < kth), _NEG, desc)
    cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(desc, -1, cutoff_idx.clamp(max=V - 1))
    return torch.where((top_p[:, None] > 0) & (scaled < cutoff), _NEG,
                       scaled)


def sample_logits_batched(logits: torch.Tensor,
                          generators: Sequence[Optional[torch.Generator]],
                          temperature: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor,
                          vocab_size: Optional[int] = None) -> torch.Tensor:
    """Per-row sampling for the continuous-batching engine: row i uses
    temperature[i] / top_k[i] / top_p[i] and draws its noise from
    generators[i]. Greedy rows (temperature 0) take the argmax and draw
    nothing; the filter sort runs only when some sampled row asks for
    it."""
    logits = _mask_vocab(logits.float(), vocab_size)
    toks = torch.argmax(logits, dim=-1)
    temps = temperature.to(logits.device, torch.float32)
    sampled = (temps > 0).nonzero().flatten().tolist()
    if not sampled:
        return toks
    rows = torch.tensor(sampled, device=logits.device)
    scaled = logits[rows] / temps[rows][:, None]
    tk = top_k.to(logits.device)[rows]
    tp = top_p.to(logits.device, torch.float32)[rows]
    if bool(((tk > 0) | (tp > 0)).any()):
        scaled = filter_top_k_top_p(scaled, tk, tp)
    for n, i in enumerate(sampled):
        toks[i] = _gumbel_argmax(scaled[n:n + 1], generators[i])[0]
    return toks
