"""Pipelined (pp > 1) one-shot serving and the paged engine under tensor
parallelism, on gloo ranks (the CPU), against the port's one-process
path and the JAX package.

Two spawns for the file, started at once (tests/_torch_pp_serving_worker.py):
two ranks run the pp2 jobs and then the paged engine at tp2, four ranks
the tp2 x pp2 one-shot calls. Held:

  * pp2 generate_tokens through the pipelined forward equals the JAX
    make_pipelined_lm_forward output on tests/test_inference.py's case
    (its tiny config, prompts [[5, 11, 3], [9, 2, 0]], lengths [3, 2],
    6 tokens, top_k 1) token for token;
  * at pp2 and tp2 x pp2, greedy tokens of a ragged batch and beam
    search's beams equal the one-process path's, logprobs, scores and
    beam scores within 1e-5;
  * an HTTP PUT to rank 0 of a pp2 server answers the one-process text
    and scores, and beam search is a 400 with the JAX server's message;
  * the paged engine at tp2, over a pool that preempts and a request
    that hits the prefix cache, equals the one-process paged engine
    token for token (logprobs within 1e-5), with model-dtype and int8
    pools, and the same prefix, preemption and chunk counts;
  * Falcon-40B's parallel block (one reduce of both branches) and the
    post-LN block served at tp2, one-shot and on the dense engine, equal
    the one-process path's greedy tokens, logprobs within 1e-5;
  * what stays refused at pp > 1 names the JAX server's rule: the
    engine, int8 KV caches, beam search.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import numpy as np
import pytest

import _torch_parallel_worker as W
import _torch_pp_serving_worker as P
import _torch_tp_serving_worker as S
from megatron_tpu.config import ParallelConfig as JParallel
from megatron_tpu.inference import generation as jg
from megatron_tpu.inference.pipelined import make_pipelined_lm_forward
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.models.params import param_specs as j_param_specs
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.parallel.sharding import shard_tree
from megatron_tpu_torch.config import ParallelConfig
from megatron_tpu_torch.inference import generation as tg
from megatron_tpu_torch.inference.api import generate_and_post_process
from megatron_tpu_torch.inference.engine import InferenceEngine
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.server import GenerationService
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.tokenizer import NullTokenizer
from megatron_tpu_torch.tools import run_text_generation_server as srv


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX test's tiny weights (pp jobs) and tests/test_torch_tp_
    serving.py's (the paged engine, pallas route), as .npz files."""
    tmp = tmp_path_factory.mktemp("pp")
    out = {}
    for name, kw in (("pp", P.KW), ("paged", S.KW)):
        jcfg = j_presets.tiny(**kw)
        jparams = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(0)))
        path = str(tmp / f"{name}.npz")
        np.savez(path, **_flat(jparams))
        tcfg = presets.tiny(**kw)
        out[name] = (path, jcfg, jparams, tcfg,
                     params_from_numpy(jparams, tcfg, device="cpu"))
    return out


def _jax_pipelined(jcfg, jparams):
    """tests/test_inference.py's pipelined generation on the fake mesh."""
    rt = j_build_mesh(JParallel(pipeline_parallel=2))
    sharded = shard_tree(rt, jparams, j_param_specs(jcfg))
    fwd = make_pipelined_lm_forward(jcfg, rt.mesh, num_stages=2)
    with jax.sharding.set_mesh(rt.mesh):
        return jg.generate_tokens(jcfg, sharded, P.JAX_PROMPTS,
                                  P.JAX_LENGTHS, forward_fn=fwd, **P.JAX_CASE)


@pytest.fixture(scope="module")
def runs(weights):
    pp_path, paged_path = weights["pp"][0], weights["paged"][0]
    two = W.World(2, [
        ("pp", "call", ("_torch_pp_serving_worker:pp_job",
                        {"weights": pp_path})),
        ("paged", "call", ("_torch_pp_serving_worker:paged_job",
                           {"weights": paged_path})),
        ("families", "call", ("_torch_pp_serving_worker:families_job",
                              {}))])
    four = W.World(4, [
        ("tp2_pp2", "call", ("_torch_pp_serving_worker:tp2_pp2_job",
                             {"weights": pp_path}))])
    jax_out = _jax_pipelined(*weights["pp"][1:3])    # while the ranks run
    return {**two.results(), **four.results()}, jax_out


def test_pp2_generation_equals_jax_pipelined_forward(runs, weights):
    got, want = runs[0]["pp"]["jax_case"], runs[1]
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_array_equal(got["lengths"], want.lengths)
    tcfg, tparams = weights["pp"][3:]
    base = tg.generate_tokens(tcfg, tparams, P.JAX_PROMPTS, P.JAX_LENGTHS,
                              **P.JAX_CASE)
    np.testing.assert_array_equal(got["tokens"], base.tokens)


@pytest.mark.parametrize("layout", ["pp", "tp2_pp2"])
def test_pipelined_one_shot_equals_one_process(runs, weights, layout):
    got = runs[0][layout]
    tcfg, tparams = weights["pp"][3:]
    assert got["ranks_agree"]
    want = tg.generate_tokens(tcfg, tparams, S.PROMPTS, S.LENGTHS, S.NEW,
                              temperature=0.0, vocab_size=S.VOCAB)
    np.testing.assert_array_equal(got["greedy"]["tokens"], want.tokens)
    np.testing.assert_array_equal(got["greedy"]["lengths"], want.lengths)
    np.testing.assert_allclose(got["greedy"]["logprobs"], want.logprobs,
                               atol=1e-5)
    np.testing.assert_allclose(got["score"],
                               tg.score_tokens(tcfg, tparams, P.SCORED),
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["pp", "tp2_pp2"])
def test_pipelined_beam_search_equals_one_process(runs, weights, layout):
    """beam_search_tokens takes the pipelined forward from its mesh too
    (the server still refuses beam search at pp > 1, as JAX's does)."""
    got = runs[0][layout]["beam"]
    tcfg, tparams = weights["pp"][3:]
    beams, scores = tg.beam_search_tokens(
        tcfg, tparams, S.PROMPTS[0, :S.LENGTHS[0]], **S.BEAM)
    np.testing.assert_array_equal(got["beams"], beams)
    np.testing.assert_allclose(got["scores"], scores, atol=1e-5)


def test_pp2_http_answers_the_one_process_text(runs, weights):
    got = runs[0]["pp"]["http"]
    tcfg, tparams = weights["pp"][3:]
    tok = NullTokenizer(S.VOCAB - 1)
    prompt = " ".join(str(t) for t in S.PROMPTS[0, :S.LENGTHS[0]])
    texts, _, logprobs, _ = generate_and_post_process(
        tcfg, tparams, tok, [prompt], tokens_to_generate=S.NEW,
        temperature=0.0, return_output_log_probs=True)
    status, body = got["generate"]
    assert status == 200 and body["text"] == texts
    np.testing.assert_allclose(body["logprobs"], logprobs, atol=1e-5)
    _, _, scored, _ = generate_and_post_process(
        tcfg, tparams, tok, [prompt], tokens_to_generate=0)
    status, body = got["score"]
    assert status == 200
    np.testing.assert_allclose(body["logprobs"], scored, atol=1e-5)
    status, body = got["beam"]
    assert status == 400
    assert "beam search is not supported on pipelined" in body["message"]


def _paged_one_process(tcfg, tparams, int8):
    eng = PagedInferenceEngine(tcfg, tparams, vocab_size=S.VOCAB,
                               device="cpu", metrics=MetricsRegistry(),
                               kv_cache_int8=int8, **P.PAGED)
    pair = eng.generate(*P.PAIR, P.PAIR_NEW)
    hit = eng.generate(*P.HIT, 8, temperature=1.0, top_k=4, seed=11)
    return pair, hit, eng.stats


@pytest.mark.parametrize("int8", [False, True])
def test_paged_engine_at_tp2_equals_one_process(runs, weights, int8):
    got = runs[0]["paged"]
    pair, hit, stats = _paged_one_process(*weights["paged"][3:], int8)
    for key, want in (("pair", pair), ("hit", hit)):
        np.testing.assert_array_equal(got[f"{key}_{int8}"]["tokens"],
                                      want.tokens)
        np.testing.assert_allclose(got[f"{key}_{int8}"]["logprobs"],
                                   want.logprobs, atol=1e-5)
    seen = got[f"stats_{int8}"]
    assert seen["preemptions"] >= 1 and seen["prefix_hits"] >= 1
    for k in ("preemptions", "prefix_hits", "prefix_tokens_saved",
              "prefill_chunks", "admitted", "retired"):
        assert seen[k] == stats[k], k


@pytest.mark.parametrize("form", list(P.FAMILIES))
def test_families_served_at_tp2_equal_one_process(runs, form):
    cfg, params = P.family_params(form)
    got = runs[0]["families"]
    want = tg.generate_tokens(cfg, params, S.PROMPTS, S.LENGTHS, S.NEW,
                              temperature=0.0, vocab_size=S.VOCAB)
    eng = InferenceEngine(cfg, params, num_slots=2, max_seq_len=64,
                          vocab_size=S.VOCAB, device="cpu",
                          metrics=MetricsRegistry())
    for key, w in (("generate", want),
                   ("engine", eng.generate(S.PROMPTS, S.LENGTHS, S.NEW))):
        np.testing.assert_array_equal(got[f"{form}_{key}"]["tokens"],
                                      w.tokens)
        np.testing.assert_allclose(got[f"{form}_{key}"]["logprobs"],
                                   w.logprobs, atol=1e-5)


def test_pipelined_serving_keeps_the_jax_refusals(weights):
    """At pp > 1: the engine (built by the service or alone), int8 KV
    caches (the service at construction, generate_tokens and the CLI),
    as the JAX server refuses them; --serve_num_slots is dropped with
    its note."""
    tcfg, tparams = weights["pp"][3:]
    tok = NullTokenizer(S.VOCAB - 1)
    mesh = build_mesh(ParallelConfig(pipeline_parallel=2), world_size=2,
                      rank=0)
    with pytest.raises(ValueError, match="continuous-batching engine runs "
                                         "the single-stage forward only"):
        GenerationService(tcfg, tparams, tok, engine_slots=2, device="cpu",
                          metrics=MetricsRegistry(), mesh=mesh)
    int8 = "kv_cache_int8 is not supported with pipeline-parallel"
    with pytest.raises(ValueError, match=int8):
        GenerationService(tcfg, tparams, tok, engine_slots=0, device="cpu",
                          kv_cache_int8=True, metrics=MetricsRegistry(),
                          mesh=mesh)
    with pytest.raises(ValueError, match=int8):
        tg.generate_tokens(tcfg, tparams, S.PROMPTS, S.LENGTHS, 2,
                           kv_cache_int8=True, mesh=mesh)
    with pytest.raises(ValueError, match="single-stage forward only"):
        InferenceEngine(tcfg, tparams, device="cpu", mesh=mesh,
                        metrics=MetricsRegistry())
    with pytest.raises(SystemExit, match="--kv_cache_int8 is not supported "
                                         "with pipeline-parallel"):
        srv.main(["--model_name", "tiny", "--device", "cpu",
                  "--pipeline_model_parallel_size", "2",
                  "--kv_cache_int8"])
    args = srv.parse_args(["--pipeline_model_parallel_size", "2",
                           "--serve_num_slots", "8"])
    srv.check_parallel_flags(args)
    assert args.serve_num_slots == 0
