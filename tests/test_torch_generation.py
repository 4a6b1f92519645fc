"""megatron_tpu_torch's one-shot generation, scoring and beam search
against the JAX package's (inference/generation.py, inference/api.py).

Both run one weight set (a JAX init_params tree converted through numpy)
on the CPU in fp32 at tiny width (2 layers, hidden 64, 4 heads over 2 KV
heads): greedy tokens and ends identical and logprobs within 1e-4, the
scores of score_tokens within 1e-4, beam search's beams identical and
scores within 1e-4, each also with int8 caches. The JAX tests that pin
these paths are tests/test_inference.py (teacher forcing, forced prompt
tokens, eod, scoring, beams) and tests/test_kv_quant.py. Sampled output
cannot match jax.random's noise: it is checked for determinism under one
seed, and against the engine's sampled output for the same seed.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.inference import generation as jg
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu_torch.inference import generation as tg
from megatron_tpu_torch.inference.api import (
    beam_search_and_post_process, generate_and_post_process,
)
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.tokenizer import NullTokenizer

KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = j_presets.tiny(**KW), presets.tiny(**KW)
    assert (tcfg.num_layers, tcfg.hidden_size, tcfg.n_kv_heads) == (2, 64, 2)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _ragged():
    prompts = np.zeros((3, 11), np.int32)
    lengths = np.array([11, 3, 6], np.int32)
    rng = np.random.default_rng(0)
    for b, p in enumerate(lengths):
        prompts[b, :p] = rng.integers(0, 64, size=p)
    return prompts, lengths


def _same_output(got, want):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("with_eod", [False, True])
def test_generate_tokens_greedy_matches_jax(weights, with_eod, int8):
    """A ragged batch: decode starts at the shortest prompt with forced
    prompt tokens; with an eod the rows that emit it stop (padding with
    eod) and `ends` marks them; tokens, ends and logprobs equal JAX's."""
    jcfg, jparams, tcfg, tparams = weights
    prompts, lengths = _ragged()
    kw = dict(max_new_tokens=9, temperature=0.0, vocab_size=65,
              kv_cache_int8=int8)
    eod = None
    if with_eod:
        # the token row 1 emits second: that row ends early
        free = jg.generate_tokens(jcfg, jparams, prompts, lengths, **kw)
        eod = int(free.tokens[1, lengths[1] + 1])
    want = jg.generate_tokens(jcfg, jparams, prompts, lengths, eod=eod, **kw)
    got = tg.generate_tokens(tcfg, tparams, prompts, lengths, eod=eod, **kw)
    _same_output(got, want)
    if with_eod:
        assert got.lengths[1] < prompts.shape[1] + 9


def test_generate_tokens_matches_teacher_forcing(weights):
    """Greedy incremental decode equals repeated full forwards
    (tests/test_inference.py:61)."""
    _, _, tcfg, tparams = weights
    prompts = np.asarray([[3, 7, 11, 2]], np.int32)
    out = tg.generate_tokens(tcfg, tparams, prompts, np.asarray([4]),
                             max_new_tokens=6, temperature=0.0)
    toks = prompts[0].tolist()
    with torch.no_grad():
        for _ in range(6):
            logits = lm_forward(tcfg, tparams, torch.tensor([toks]))
            toks.append(int(torch.argmax(logits[0, -1])))
    np.testing.assert_array_equal(out.tokens[0], np.asarray(toks))


def test_sampled_generation_is_deterministic_and_the_engines(weights):
    """Sampled rows draw from a generator seeded with seed + row, only
    where they sample: the same seed gives the same tokens, another seed
    others, and a one-row batch gives the tokens the engine gives the
    same request."""
    _, _, tcfg, tparams = weights
    prompts, lengths = _ragged()

    def run(seed, p=prompts, n=lengths):
        return tg.generate_tokens(tcfg, tparams, p, n, max_new_tokens=10,
                                  temperature=1.0, top_k=20, seed=seed,
                                  vocab_size=65).tokens

    a = run(5)
    np.testing.assert_array_equal(a, run(5))
    assert not np.array_equal(a, run(6))
    solo = run(7, prompts[1:2, :3], lengths[1:2])
    eng = InferenceEngine(tcfg, tparams, num_slots=1, max_seq_len=64,
                          vocab_size=65, device="cpu",
                          metrics=MetricsRegistry())
    req = eng.submit(Request(prompt=prompts[1, :3], max_new_tokens=10,
                             temperature=1.0, top_k=20, seed=7))
    eng.run_until_idle()
    assert req.generated == solo[0, 3:].tolist()


def test_score_tokens_matches_jax(weights):
    jcfg, jparams, tcfg, tparams = weights
    toks = np.random.default_rng(2).integers(0, 64, (3, 12)).astype(np.int32)
    want = jg.score_tokens(jcfg, jparams, toks)
    got = tg.score_tokens(tcfg, tparams, toks)
    assert got.shape == (3, 11) and (got <= 0).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # ids outside the table are padding: they score 0 and leave the real
    # positions before them unchanged
    padded = toks.copy()
    padded[0, 8:] = 64
    lp = tg.score_tokens(tcfg, tparams, padded)
    np.testing.assert_allclose(lp[0, :7], want[0, :7], atol=1e-4)
    assert (lp[0, 7:] == 0).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("length_penalty", [1.0, 0.5])
def test_beam_search_matches_jax(weights, int8, length_penalty):
    """One prompt, 3 beams: the same beams best first, scores within
    1e-4; eod 63 is in the vocabulary, so hypotheses can end early."""
    jcfg, jparams, tcfg, tparams = weights
    prompt = np.asarray([5, 9, 12, 44, 3], np.int32)
    kw = dict(max_new_tokens=6, beam_size=3, eod=63,
              length_penalty=length_penalty, kv_cache_int8=int8)
    jb, js = jg.beam_search_tokens(jcfg, jparams, prompt, **kw)
    tb, ts = tg.beam_search_tokens(tcfg, tparams, prompt, **kw)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(ts, js, atol=1e-4)
    assert (ts[:-1] >= ts[1:]).all()
    np.testing.assert_array_equal(tb[0, :5], prompt)


def test_api_scoring_one_shot_and_engine_paths(weights):
    """generate_and_post_process: tokens_to_generate 0 scores; with and
    without an engine the greedy text is the same (a server can switch
    mode without changing a response); the engine's cache mode must be
    the request's; an id outside the table is a client error; beam
    search takes one prompt."""
    _, _, tcfg, tparams = weights
    tok = NullTokenizer(64)          # eod 64 is outside the 64-row table
    texts, segments, lp, tokens = generate_and_post_process(
        tcfg, tparams, tok, ["3 7 11", "4 5"], tokens_to_generate=0)
    assert texts == ["3 7 11", "4 5"] and segments is None
    assert lp.shape == (2, 2) and lp[1, 1] == 0.0
    np.testing.assert_allclose(
        lp[0], tg.score_tokens(tcfg, tparams, np.array([[3, 7, 11]]))[0],
        atol=1e-6)
    kw = dict(tokens_to_generate=5, temperature=0.0,
              return_output_log_probs=True)
    one = generate_and_post_process(tcfg, tparams, tok, ["3 7 11", "4 5"],
                                    **kw)
    eng = InferenceEngine(tcfg, tparams, num_slots=2, max_seq_len=64,
                          vocab_size=tok.vocab_size, device="cpu",
                          metrics=MetricsRegistry())
    via = generate_and_post_process(tcfg, tparams, tok, ["3 7 11", "4 5"],
                                    engine=eng, **kw)
    assert one[0] == via[0]
    np.testing.assert_allclose(one[2], via[2], atol=1e-4)
    with pytest.raises(ValueError, match="kv_cache_int8"):
        generate_and_post_process(tcfg, tparams, tok, ["3"], engine=eng,
                                  kv_cache_int8=True)
    with pytest.raises(ValueError, match="embedding table"):
        generate_and_post_process(tcfg, tparams, tok, ["3 64"], **kw)
    with pytest.raises(ValueError, match="single prompt"):
        beam_search_and_post_process(tcfg, tparams, tok, ["1", "2"])
    texts, segments, scores = beam_search_and_post_process(
        tcfg, tparams, tok, ["3 7"], tokens_to_generate=4, beam_size=2)
    assert len(texts) == 2 and len(segments[0]) == 2 + 4 + 1
    assert scores[0] >= scores[1]
