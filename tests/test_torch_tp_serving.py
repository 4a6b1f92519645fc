"""Tensor-parallel serving at tp2 on the CPU, against the port's
one-process path and the JAX package on a tp2 mesh.

One spawn of 2 gloo ranks for the file (tests/_torch_tp_serving_worker.py)
serves one weight set (a JAX init_params tree, tiny preset in fp32: 2
layers, hidden 64, 4 heads over 2 kv heads) as each rank's slices:
generate_tokens, score_tokens and beam_search_tokens called on both
ranks, the dense engine driven by rank 0 through the serving channel
(three concurrent requests of 11, 3 and 6 tokens over two slots), and
the HTTP server on rank 0 with rank 1 in the follower loop; each with
model-dtype and int8 caches, greedy and seeded top-k. Held:

  * tokens equal to the port's one-process path, logprobs within 1e-5;
  * greedy tokens equal to the JAX generate_tokens and InferenceEngine
    under jax.sharding.set_mesh of a ParallelConfig(tensor_parallel=2)
    mesh on the fake CPU devices, logprobs within 1e-5 (sampled tokens
    cannot match jax.random's draws: tests/test_torch_generation.py);
  * the server's load_model gives each rank its slices, from a
    checkpoint (--load) and from the seed;
  * an HTTP PUT to rank 0 answers the one-process text, and every
    combination this slice does not serve under tensor parallelism is
    refused by name;
  * a fault of the group ends every rank non-zero, well inside the
    process group's timeout: a control record that misses a clear (two
    more gloo ranks running the server's CLI), a rank 0 that dies (two
    more), and a paged engine's follower that fails a prefill chunk
    (two more).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_parallel_worker as W
import _torch_tp_serving_worker as S
from megatron_tpu.config import ParallelConfig as JParallel
from megatron_tpu.inference import generation as jg
from megatron_tpu.inference.engine import InferenceEngine as JEngine
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.models.params import param_specs as j_param_specs
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.parallel.sharding import shard_tree
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.config import (
    OptimizerConfig, ParallelConfig, RunConfig,
)
from megatron_tpu_torch.inference import generation as tg
from megatron_tpu_torch.inference.api import (
    beam_search_and_post_process, generate_and_post_process,
)
from megatron_tpu_torch.inference.engine import InferenceEngine
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import params_from_numpy, shard_params
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.tokenizer import NullTokenizer
from megatron_tpu_torch.tools import run_text_generation_server as srv
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.optimizer import (
    init_train_state, leaf_paths,
)

CACHES = [False, True]          # int8 KV


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, tcfg = j_presets.tiny(**S.KW), presets.tiny(**S.KW)
    jparams = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(0)))
    tmp = tmp_path_factory.mktemp("tp")
    path = str(tmp / "weights.npz")
    np.savez(path, **_flat(jparams))
    tparams = params_from_numpy(jparams, tcfg, device="cpu")
    # a world-1 checkpoint of the same weights, for the server's --load
    ckpt.save_checkpoint(str(tmp / "ckpt"), init_train_state(
        OptimizerConfig(), tparams), 1,
        config=RunConfig(model=tcfg).to_dict())
    return path, jcfg, jparams, tcfg, tparams, str(tmp / "ckpt")


@pytest.fixture(scope="module")
def qweights(tmp_path_factory):
    """The compressed-collective cases' weights: the JAX test's tiny_cfg
    (tests/test_quant_comm.py) at PRNGKey(0), as an .npz."""
    from megatron_tpu.config import ModelConfig as JModelConfig

    jcfg = JModelConfig(**S.QCFG).validate()
    jparams = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("tpq") / "weights.npz")
    np.savez(path, **_flat(jparams))
    return path, jcfg, jparams


def _jax_on_mesh(jcfg, jparams):
    """The JAX package's greedy outputs on a tp2 mesh."""
    rt = j_build_mesh(JParallel(tensor_parallel=2))
    sharded = shard_tree(rt, jparams, j_param_specs(jcfg))
    out = {}
    with jax.sharding.set_mesh(rt.mesh):
        for int8 in CACHES:
            out[f"generate_{int8}"] = jg.generate_tokens(
                jcfg, sharded, S.PROMPTS, S.LENGTHS, S.NEW, temperature=0.0,
                vocab_size=S.VOCAB, kv_cache_int8=int8)
            eng = JEngine(jcfg, sharded, num_slots=2, max_seq_len=64,
                          vocab_size=S.VOCAB, mesh=rt.mesh,
                          metrics=JRegistry(), kv_cache_int8=int8)
            out[f"engine_{int8}"] = eng.generate(S.PROMPTS, S.LENGTHS, S.NEW)
    return out


FAULTS = ["missed_clear", "rank0_dies", "paged_chunk_fails"]


class _Faults:
    """Every fault scenario's ranks (S.fault_rank), started at once;
    result(fault) joins one and returns ([exit code per rank], [what
    each rank wrote])."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory()
        self._procs = {}
        for fault in FAULTS:
            out = os.path.join(self._dir.name, fault)
            os.makedirs(out)
            port = W.free_port()
            self._procs[fault] = (out, [
                ctx.Process(target=S.fault_rank,
                            args=(rank, port, fault, out))
                for rank in range(2)])
            for p in self._procs[fault][1]:
                p.start()

    def result(self, fault):
        out, procs = self._procs[fault]
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.kill()
        seen = []
        for rank in range(2):
            path = os.path.join(out, f"rank{rank}.json")
            seen.append(json.load(open(path)) if os.path.exists(path)
                        else None)
        return [p.exitcode for p in procs], seen


@pytest.fixture(scope="module")
def faults():
    f = _Faults()
    yield f
    for fault in FAULTS:
        f.result(fault)
    f._dir.cleanup()


@pytest.fixture(scope="module")
def runs(weights, qweights, faults):
    # `faults` only to start its ranks alongside these
    path = weights[0]
    world = W.World(2, [
        (job, "call", (f"_torch_tp_serving_worker:{job}_job",
                       {"weights": path}))
        for job in ("oneshot", "engine", "http")] + [
        ("load", "call", ("_torch_tp_serving_worker:load_job",
                          {"weights": path, "load": weights[5]})),
        ("compress", "call", ("_torch_tp_serving_worker:compress_job",
                              {"weights": qweights[0]}))])
    jax_out = _jax_on_mesh(weights[1], weights[2])   # while the ranks run
    return world.results(), jax_out


def _one_process_generate(tcfg, tparams, name, int8):
    temp, k, seed = S.SAMPLING[name]
    return tg.generate_tokens(tcfg, tparams, S.PROMPTS, S.LENGTHS, S.NEW,
                              temperature=temp, top_k=k, vocab_size=S.VOCAB,
                              seed=seed, kv_cache_int8=int8)


def _one_process_engine(tcfg, tparams, name, int8):
    temp, k, seed = S.SAMPLING[name]
    eng = InferenceEngine(tcfg, tparams, num_slots=2, max_seq_len=64,
                          vocab_size=S.VOCAB, device="cpu",
                          metrics=MetricsRegistry(), kv_cache_int8=int8)
    return eng.generate(S.PROMPTS, S.LENGTHS, S.NEW, temperature=temp,
                        top_k=k, seed=seed)


def _same(got: dict, want, atol=1e-5):
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_array_equal(got["lengths"], want.lengths)
    np.testing.assert_allclose(got["logprobs"], want.logprobs, atol=atol)


@pytest.mark.parametrize("int8", CACHES)
@pytest.mark.parametrize("name", list(S.SAMPLING))
def test_tp2_generate_tokens_equals_one_process(runs, weights, name, int8):
    got = runs[0]["oneshot"][f"generate_{name}_int8_{int8}"]
    _same(got, _one_process_generate(weights[3], weights[4], name, int8))


@pytest.mark.parametrize("int8", CACHES)
@pytest.mark.parametrize("name", list(S.SAMPLING))
def test_tp2_engine_equals_one_process(runs, weights, name, int8):
    got = runs[0]["engine"][f"engine_{name}_int8_{int8}"]
    _same(got, _one_process_engine(weights[3], weights[4], name, int8))
    stats = runs[0]["engine"][f"stats_int8_{int8}"]
    assert stats["admitted"] == stats["retired"] == 6   # 2 x 3 requests


@pytest.mark.parametrize("int8", CACHES)
def test_tp2_greedy_equals_jax_on_a_tp2_mesh(runs, int8):
    _same(runs[0]["oneshot"][f"generate_greedy_int8_{int8}"],
          runs[1][f"generate_{int8}"])
    _same(runs[0]["engine"][f"engine_greedy_int8_{int8}"],
          runs[1][f"engine_{int8}"])


def test_tp2_scoring_and_beams_equal_one_process(runs, weights):
    tcfg, tparams = weights[3], weights[4]
    got = runs[0]["oneshot"]
    assert got["ranks_agree"]
    padded = np.where(np.arange(S.PROMPTS.shape[1])[None]
                      < S.LENGTHS[:, None], S.PROMPTS, S.VOCAB - 1)
    np.testing.assert_allclose(got["score"],
                               tg.score_tokens(tcfg, tparams, padded),
                               atol=1e-5)
    for int8 in CACHES:
        beams, scores = tg.beam_search_tokens(
            tcfg, tparams, S.PROMPTS[0, :S.LENGTHS[0]], kv_cache_int8=int8,
            **S.BEAM)
        np.testing.assert_array_equal(got[f"beam_int8_{int8}"]["beams"],
                                      beams)
        np.testing.assert_allclose(got[f"beam_int8_{int8}"]["scores"],
                                   scores, atol=1e-5)


@pytest.mark.parametrize("source", ["load", "seed"])
def test_the_server_loads_each_ranks_slices(runs, source):
    """--load of a world-1 checkpoint at tp2, and the seed's init without
    one, give each rank exactly its cut of the whole tree."""
    assert runs[0]["load"][source] and runs[0]["load"]["ranks_agree"]


@pytest.mark.parametrize("slots", [2, 0])
def test_http_put_to_rank_0_answers_the_one_process_text(runs, weights,
                                                         slots):
    tcfg, tparams = weights[3], weights[4]
    got = runs[0]["http"]
    tok = NullTokenizer(S.VOCAB - 1)
    prompt = " ".join(str(t) for t in S.PROMPTS[0, :S.LENGTHS[0]])
    texts, _, logprobs, _ = generate_and_post_process(
        tcfg, tparams, tok, [prompt], tokens_to_generate=S.NEW,
        temperature=0.0, return_output_log_probs=True)
    status, body = got[f"generate_{slots}"]
    assert status == 200 and body["text"] == texts
    np.testing.assert_allclose(body["logprobs"], logprobs, atol=1e-5)
    _, _, scored, _ = generate_and_post_process(
        tcfg, tparams, tok, [prompt], tokens_to_generate=0)
    status, body = got[f"score_{slots}"]
    assert status == 200
    np.testing.assert_allclose(body["logprobs"], scored, atol=1e-5)
    beams, _, _ = beam_search_and_post_process(
        tcfg, tparams, tok, [prompt], tokens_to_generate=5, beam_size=3)
    status, body = got[f"beam_{slots}"]
    assert status == 200 and body["text"] == beams
    status, body = got[f"reload_{slots}"]
    assert status == 400 and "tensor parallelism" in body["message"]


def _mesh():
    return build_mesh(ParallelConfig(tensor_parallel=2), world_size=2,
                      rank=0)


@pytest.mark.parametrize("flags,match", [
    (["--weight_int8"], "--weight_int8 at --tensor_model_parallel_size 2"),
    (["--weight_fp8"], "--weight_fp8 at --tensor_model_parallel_size 2"),
    (["--serve_speculative", "ngram"], "--serve_speculative at"),
    (["--pipeline_model_parallel_size", "2", "--kv_cache_int8"],
     "--kv_cache_int8 is not supported with pipeline-parallel serving"),
    ([], "needs one process per rank"),
])
def test_the_server_cli_refuses_what_tp_serving_does_not_cover(flags,
                                                               match):
    with pytest.raises(SystemExit, match=match):
        srv.main(["--model_name", "tiny", "--device", "cpu",
                  "--tensor_model_parallel_size", "2", *flags])


def test_pipelined_serving_is_refused():
    """What stays refused of pipelined serving is the JAX server's:
    --kv_cache_int8 (the pipelined forward threads bf16 caches), and
    --serve_speculative above one rank; the rest serves
    (tests/test_torch_pp_serving.py)."""
    with pytest.raises(SystemExit, match="pipeline-parallel serving"):
        srv.main(["--model_name", "tiny", "--device", "cpu",
                  "--pipeline_model_parallel_size", "2", "--kv_cache_int8"])
    with pytest.raises(SystemExit, match="--serve_speculative at"):
        srv.main(["--model_name", "tiny", "--device", "cpu",
                  "--pipeline_model_parallel_size", "2",
                  "--serve_speculative", "ngram"])


def test_the_engines_refuse_what_tp_serving_does_not_cover(weights):
    tcfg, tparams = weights[3], weights[4]
    kw = dict(device="cpu", metrics=MetricsRegistry(), mesh=_mesh())
    with pytest.raises(ValueError, match="cuda_graph=True"):
        InferenceEngine(tcfg, tparams, channel=object(), **kw)
    with pytest.raises(ValueError, match="speculative decoding"):
        InferenceEngine(tcfg, tparams, cuda_graph=False, channel=object(),
                        speculative=SpecConfig(k=2, drafter="ngram"), **kw)
    with pytest.raises(ValueError, match="ServingChannel"):
        InferenceEngine(tcfg, tparams, cuda_graph=False, **kw)
    # the paged engine serves at tp2 (tests/test_torch_pp_serving.py) on
    # the slot engine's terms: an eager tick, no speculation
    with pytest.raises(ValueError, match="cuda_graph=True"):
        PagedInferenceEngine(tcfg, tparams, channel=object(), **kw)
    with pytest.raises(ValueError, match="speculative decoding"):
        PagedInferenceEngine(tcfg, tparams, cuda_graph=False,
                             channel=object(),
                             speculative=SpecConfig(k=2, drafter="ngram"),
                             **kw)


@pytest.mark.parametrize("family", ["falcon", "post_ln"])
def test_falcon_and_post_ln_under_tp_name_the_roadmap_item(family):
    """Both blocks shard at tp2 now (their parity:
    tests/test_torch_parallel_families.py); what stays refused is the
    JAX package's kv-head rule (Falcon-7B's one kv head at tp2). A MoE
    FFN shards at tp2 too: each expert's GLU input cut per half, its
    output projection by rows (its serving parity:
    tests/test_torch_moe_parallel.py)."""
    cfg = presets.tiny(**S.KW, **({"parallel_attn": True}
                                  if family == "falcon"
                                  else {"use_post_ln": True}))
    flat = dict(leaf_paths(tg_params(cfg)))
    local = shard_params(flat, cfg, _mesh())
    assert local["layers/attn/wk"].shape[-1] == flat[
        "layers/attn/wk"].shape[-1] // 2
    with pytest.raises(ValueError, match="kv heads"):
        shard_params(flat, dataclasses.replace(cfg, num_kv_heads=1),
                     _mesh())
    moe = dataclasses.replace(cfg, num_experts=4, moe_top_k=2).validate()
    full = dict(leaf_paths(tg_params(moe)))
    local = shard_params(full, moe, _mesh())
    w_in, half = full["layers/moe/w_in"], full["layers/moe/w_in"].shape[-1] // 2
    r = _mesh().tp_rank
    torch.testing.assert_close(local["layers/moe/w_in"], torch.cat(
        [w_in[..., :half].chunk(2, -1)[r], w_in[..., half:].chunk(2, -1)[r]],
        -1))
    assert local["layers/moe/w_out"].shape[-2] == full[
        "layers/moe/w_out"].shape[-2] // 2


def tg_params(cfg):
    from megatron_tpu_torch.models.params import init_params

    return init_params(cfg, 0, device="cpu")


# far inside the process group's 600 s timeout (parallel/distributed.py)
FAULT_SECONDS = 30


def test_a_record_that_misses_a_clear_fails_both_ranks(faults):
    codes, (rank0, rank1) = faults.result("missed_clear")
    assert codes[1] != 0 and "disagree on the decode rows" in rank1["error"]
    assert codes[0] != 0
    assert "tensor-parallel group failed" in rank0["error"]
    assert "tensor-parallel group failed" in rank0["request"]
    assert rank0["seconds"] < FAULT_SECONDS
    assert rank1["seconds"] < FAULT_SECONDS


def test_a_follower_fails_when_rank_0_dies(faults):
    codes, (_, rank1) = faults.result("rank0_dies")
    assert codes == [9, 1]
    assert rank1["error"] is not None and rank1["seconds"] < FAULT_SECONDS


def test_a_paged_followers_failed_chunk_fails_both_ranks(faults):
    """The paged engine at tp2: a follower that fails the chunk rank 0
    announced ends non-zero; rank 0's next collective fails, it stops
    serving, fails the request it holds and ends non-zero too."""
    codes, (rank0, rank1) = faults.result("paged_chunk_fails")
    assert codes[1] != 0 and "injected" in rank1["error"]
    assert codes[0] != 0
    assert "tensor-parallel group failed" in rank0["error"]
    assert "tensor-parallel group failed" in rank0["request"]
    assert rank0["seconds"] < FAULT_SECONDS
    assert rank1["seconds"] < FAULT_SECONDS


# ---------------------------------------------------------------------------
# compressed collectives at tp2 (quant/), against the JAX package's


@pytest.fixture(scope="module")
def jax_compressed(qweights):
    """The JAX package's lm_forward logits on S.QTOKENS at tp2: the
    plain forward and the int8 and fp8 TpComm (the setup of
    tests/test_quant_comm.py::test_teacher_forced_parity_gate)."""
    from megatron_tpu.models.language_model import lm_forward as j_forward
    from megatron_tpu.quant.collectives import make_tp_comm as j_tp_comm

    _, jcfg, jparams = qweights
    rt = j_build_mesh(JParallel(tensor_parallel=2),
                      devices=jax.devices()[:2])
    sharded = shard_tree(rt, jparams, j_param_specs(jcfg))
    toks = jax.numpy.asarray(S.QTOKENS)
    out = {}
    with jax.sharding.set_mesh(rt.mesh):
        for mode in ("none", "int8", "fp8"):
            tpc = None if mode == "none" else j_tp_comm(rt.mesh, mode,
                                                        cfg=jcfg)
            out[mode] = np.asarray(jax.jit(
                lambda p, t, tpc=tpc: j_forward(jcfg, p, t, tp_comm=tpc))(
                    sharded, toks))
    return out


# logits of one fp32 forward on two frameworks: summation order only
DENSE_ATOL = 1e-5
# int8/fp8: where a partial sum rounds to the other side of a
# quantization level in one framework, that element moves by one level
# (int8: its chunk's amax / 127, ~1e-3 for these partial sums; fp8: a
# 2^-3 relative step) through the rest of the forward. fp8 takes the JAX
# gate's max-logit-error budget (tests/test_quant_comm.py: 0.06).
# Measured: int8 2.3e-5, fp8 0.017, every argmax equal
COMPRESSED_ATOL = {"int8": 1e-3, "fp8": 0.06}


@pytest.mark.parametrize("mode", ["none", "dense", "int8", "fp8"])
def test_tp2_compressed_lm_forward_equals_jax(runs, jax_compressed, mode):
    """The port's lm_forward at tp2 with a TpComm (none: the
    vocab-parallel logits gathered densely) against the JAX package's
    logits on the same weights and tokens: dense within 1e-5, int8 and
    fp8 within COMPRESSED_ATOL; the argmax equals JAX's wherever JAX's
    top two logits are more than twice the tolerance apart, and at >= 99%
    of all positions."""
    got = runs[0]["compress"][f"logits_{mode}"]
    want = jax_compressed["none" if mode == "dense" else mode]
    atol = COMPRESSED_ATOL.get(mode, DENSE_ATOL)
    assert got.shape == want.shape == (8, 32, 128)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * atol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_tp2_compressed_engine_counts_its_bytes(runs):
    """The tp2 engine with int8 collectives: greedy traffic drains, the
    first token equals the dense engine's (the same prefill context),
    the counters equal the byte model's tick price x ticks plus a
    prefill's price x prefills, and compress >= 3x (the JAX gate)."""
    got = runs[0]["compress"]
    dense, comp = got["engine_none"], got["engine_int8"]
    assert "comm_dense_bytes" not in got["stats_none"]
    np.testing.assert_array_equal(np.asarray(dense["tokens"])[:, 8],
                                  np.asarray(comp["tokens"])[:, 8])
    stats = got["stats_int8"]
    tick, pre = got["tick_bytes_int8"], got["prefill_bytes_int8"]
    for kind in ("dense", "compressed"):
        assert stats[f"comm_{kind}_bytes"] == (
            stats["ticks"] * tick[kind] + stats["admitted"] * pre[kind])
    assert stats["ticks"] > 0 and stats["admitted"] == 4
    assert stats["comm_dense_bytes"] >= 3 * stats["comm_compressed_bytes"]
