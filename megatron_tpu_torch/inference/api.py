"""Text-level generation API (counterpart of megatron_tpu/inference/api.py).

Tokenize and pad a prompt batch, run it, detokenize. Three paths, as in
the JAX package: tokens_to_generate == 0 scores the prompts
(teacher-forced logprobs, generation.score_tokens); with an engine the
request goes through its continuous batching (engine.generate); without
one through the one-shot loop (generation.generate_tokens). Beam search
is its own entry point (one prompt).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.generation import (
    beam_search_tokens, generate_tokens, score_tokens,
)


def tokenize_prompts(tokenizer, prompts: Sequence[str],
                     add_bos: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Right-padded prompt batch + lengths."""
    ids = []
    for p in prompts:
        t = list(tokenizer.tokenize(p))
        if add_bos and tokenizer.bos is not None:
            t = [tokenizer.bos] + t
        if not t:
            raise ValueError("empty prompt after tokenization")
        ids.append(t)
    lengths = np.asarray([len(t) for t in ids], np.int32)
    batch = np.full((len(ids), int(lengths.max())), tokenizer.pad, np.int32)
    for i, t in enumerate(ids):
        batch[i, :len(t)] = t
    return batch, lengths


def _check_ids(cfg: ModelConfig, tokens: np.ndarray,
               lengths: np.ndarray) -> None:
    """The one-shot paths' prompt check (the engine does its own at
    submit): an id outside the embedding table would be an out-of-range
    index on the card."""
    real = np.arange(tokens.shape[1])[None, :] < lengths[:, None]
    if ((tokens < 0) | (tokens >= cfg.vocab_size))[real].any():
        raise ValueError(f"prompt token ids must be in [0, "
                         f"{cfg.vocab_size}) (the embedding table)")


def generate_and_post_process(cfg: ModelConfig, params: Any, tokenizer,
                              prompts: Sequence[str],
                              tokens_to_generate: int = 64,
                              temperature: float = 1.0,
                              top_k_sampling: int = 0,
                              top_p_sampling: float = 0.0,
                              add_BOS: bool = False,
                              return_output_log_probs: bool = False,
                              random_seed: int = 0,
                              kv_cache_int8: bool = False, engine=None,
                              deadline_s=None, spec: bool = True):
    """(texts, segments, logprobs, tokens), like the JAX package's.

    tokens_to_generate == 0 is scoring: (texts, None, logprobs [B, S-1],
    prompt tokens). engine routes the request through a continuous-
    batching engine (whose cache mode must equal kv_cache_int8); None
    runs the one-shot loop. deadline_s (engine path only) bounds each
    request's wall time: past it the engine raises RequestTimeoutError.
    spec=False keeps these requests to one token a tick on a speculating
    engine."""
    if tokens_to_generate < 0:
        raise ValueError("tokens_to_generate must be >= 0")
    prompt_tokens, lengths = tokenize_prompts(tokenizer, prompts,
                                              add_bos=add_BOS)
    if engine is None or tokens_to_generate == 0:
        _check_ids(cfg, prompt_tokens, lengths)
    if tokens_to_generate == 0:
        lp = score_tokens(cfg, params, prompt_tokens)
        texts = [tokenizer.detokenize(t[:n])
                 for t, n in zip(prompt_tokens, lengths)]
        return texts, None, lp, prompt_tokens
    if engine is not None:
        # the cache mode is fixed when the engine is built: a conflicting
        # request fails loudly instead of being served the other way
        if bool(kv_cache_int8) != bool(engine.kv_cache_int8):
            raise ValueError(
                f"kv_cache_int8={kv_cache_int8} conflicts with the "
                f"engine's kv_cache_int8={engine.kv_cache_int8}")
        out = engine.generate(
            prompt_tokens, lengths, max_new_tokens=tokens_to_generate,
            temperature=temperature, top_k=top_k_sampling,
            top_p=top_p_sampling, eod=tokenizer.eod, seed=random_seed,
            deadline_s=deadline_s, spec=spec)
    else:
        out = generate_tokens(
            cfg, params, prompt_tokens, lengths,
            max_new_tokens=tokens_to_generate, temperature=temperature,
            top_k=top_k_sampling, top_p=top_p_sampling,
            vocab_size=tokenizer.vocab_size, eod=tokenizer.eod,
            seed=random_seed, want_logprobs=return_output_log_probs,
            kv_cache_int8=kv_cache_int8)
    texts, segments = [], []
    for row, end in zip(out.tokens, out.lengths):
        toks = row[: int(end)]
        texts.append(tokenizer.detokenize(toks))
        segments.append([tokenizer.detokenize([t]) for t in toks])
    logprobs = out.logprobs if return_output_log_probs else None
    return texts, segments, logprobs, out.tokens


def beam_search_and_post_process(cfg: ModelConfig, params: Any, tokenizer,
                                 prompts: Sequence[str],
                                 tokens_to_generate: int = 64,
                                 beam_size: int = 4, add_BOS: bool = False,
                                 length_penalty: float = 1.0,
                                 kv_cache_int8: bool = False):
    """(texts, segments, scores) for ONE prompt's beams, best first."""
    if len(prompts) != 1:
        raise ValueError("beam search supports a single prompt (as in the "
                         "reference)")
    prompt_tokens, lengths = tokenize_prompts(tokenizer, prompts,
                                              add_bos=add_BOS)
    _check_ids(cfg, prompt_tokens, lengths)
    beams, scores = beam_search_tokens(
        cfg, params, prompt_tokens[0, :int(lengths[0])],
        max_new_tokens=tokens_to_generate, beam_size=beam_size,
        eod=tokenizer.eod, length_penalty=length_penalty,
        kv_cache_int8=kv_cache_int8)
    texts = [tokenizer.detokenize(b) for b in beams]
    segments = [[tokenizer.detokenize([t]) for t in b] for b in beams]
    return texts, segments, scores
