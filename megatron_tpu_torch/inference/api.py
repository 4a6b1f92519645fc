"""Text-level generation API (counterpart of megatron_tpu/inference/api.py).

Tokenize and pad a prompt batch, run it through the continuous-batching
engine, detokenize. The JAX package's one-shot path, scoring mode
(tokens_to_generate == 0) and beam search are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


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


def generate_and_post_process(engine, tokenizer, prompts: Sequence[str],
                              tokens_to_generate: int = 64,
                              temperature: float = 1.0,
                              top_k_sampling: int = 0,
                              top_p_sampling: float = 0.0,
                              add_BOS: bool = False,
                              return_output_log_probs: bool = False,
                              random_seed: int = 0):
    """(texts, segments, logprobs, tokens), like the JAX package's
    generate_and_post_process on its engine path."""
    if tokens_to_generate < 1:
        raise ValueError("tokens_to_generate must be >= 1 (scoring mode is "
                         "not ported yet)")
    prompt_tokens, lengths = tokenize_prompts(tokenizer, prompts,
                                              add_bos=add_BOS)
    out = engine.generate(
        prompt_tokens, lengths, max_new_tokens=tokens_to_generate,
        temperature=temperature, top_k=top_k_sampling,
        top_p=top_p_sampling, eod=tokenizer.eod, seed=random_seed)
    texts, segments = [], []
    for row, end in zip(out.tokens, out.lengths):
        toks = row[: int(end)]
        texts.append(tokenizer.detokenize(toks))
        segments.append([tokenizer.detokenize([t]) for t in toks])
    logprobs = out.logprobs if return_output_log_probs else None
    return texts, segments, logprobs, out.tokens
