"""The Falcon and GPT-2 families in megatron_tpu_torch, against the JAX
package and against HuggingFace, on the CPU in fp32.

  * configs and presets: the new fields' validation rules, the presets'
    parameter trees and counts (falcon 7B/40B, gpt2 124M/1.3B,
    codellama) equal to the JAX package's, the recompute policy forms;
  * models: lm_forward logits of tiny Falcon-like (parallel attention
    over one kv head; parallel layernorm with GQA), GPT-2-like (absolute
    positions, biases, tied) and post-LN configs within 1e-4 of the JAX
    package's (a JAX init_params tree converted through numpy), lm_loss
    and every gradient leaf within 1e-5, and block:1, block:2, uniform:2
    recompute giving the none policy's loss and gradients bitwise;
  * HF interop: random-init FalconForCausalLM (the multi-query layout and
    new_decoder_architecture) and GPT2LMHeadModel, built in code, give
    HF's logits within rtol = atol = 2e-3 (the JAX package's
    tests/test_hf_parity.py gate), a config.json of only the differences
    from HF's defaults gives the same config, and native -> HF -> native
    is an identity;
  * decode past one block's 64 query rows: the plain dense and paged
    decode at R = Sq * G = 71 (Falcon-7B's G) and 72 (G 8, Sq 9) against
    the JAX decode kernels in interpret mode and the JAX dense decode
    path; the kernel's launch plan (row tiles, workspace) at 71 / 72 /
    355 rows; speculative verify at (k + 1) * G = 72 giving the plain
    engine's greedy tokens;
  * engines: the dense and paged engines serve the tiny Falcon-like and
    GPT-2-like models token for token with the JAX engines, with fp32
    and with int8 caches (a prefix hit and a preemption on the paged
    one), and refuse a max_seq_len past an absolute model's position
    table as the JAX engine does;
  * the CLI: the architecture and recompute flags map onto the run
    config, and pretrain_gpt trains a tiny GPT-2-like model under
    block:1 recompute.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.inference.engine import InferenceEngine as JEngine
from megatron_tpu.inference.engine import Request as JRequest
from megatron_tpu.inference.paging import PagedInferenceEngine as JPaged
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_forward as j_lm_forward
from megatron_tpu.models.language_model import lm_loss as j_lm_loss
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.models.params import num_params as j_num_params
from megatron_tpu.models.params import param_shapes as j_param_shapes
from megatron_tpu.ops.attention import attention as j_attention
from megatron_tpu.ops.pallas import flash_template as jft
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.arguments import args_to_run_config, parse_args
from megatron_tpu_torch.config import ModelConfig, parse_recompute
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.generation import generate_tokens
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.interop.hf import (
    config_from_hf, hf_config_from_native, hf_state_dict_to_params,
    params_to_hf_state_dict,
)
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_forward, lm_loss
from megatron_tpu_torch.models.params import num_params, params_from_numpy
from megatron_tpu_torch.ops.flash import flash_template as tft
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.training.optimizer import leaf_paths, tree_map

ATOL = 1e-4
HF_TOL = dict(rtol=2e-3, atol=2e-3)
VOCAB = 96
#: tiny members of each family: (tiny preset overrides)
FAMILIES = {
    "falcon_mqa": dict(normalization="layernorm", activation="gelu",
                       parallel_attn=True, num_kv_heads=1,
                       tie_embed_logits=True),
    "falcon_gqa_parallel_ln": dict(
        normalization="layernorm", activation="gelu", parallel_attn=True,
        parallel_layernorm=True, num_kv_heads=2, tie_embed_logits=True),
    "gpt2": dict(normalization="layernorm", activation="gelu",
                 position_embedding_type="absolute",
                 max_position_embeddings=64, use_bias_linear=True,
                 use_bias_qkv=True, tie_embed_logits=True,
                 num_kv_heads=None),
    "post_ln": dict(normalization="layernorm", activation="gelu_tanh",
                    use_post_ln=True, apply_residual_post_ln=True,
                    use_bias_linear=True),
}


def _pair(family, **kw):
    """(JAX config, JAX params, port config, port params): one JAX
    init_params tree converted through numpy."""
    kw = dict(vocab_size=VOCAB, seq_length=64, **FAMILIES[family], **kw)
    jcfg = j_presets.tiny(**kw)
    tcfg = presets.tiny(attention_impl="pallas", **kw)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams),
                                                  tcfg, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    return {f: _pair(f) for f in FAMILIES}


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape)


# ---------------------------------------------------------------------------
# configs and presets
# ---------------------------------------------------------------------------


def test_config_rules_match_jax():
    base = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                vocab_size=VOCAB, seq_length=32)
    for bad, match in ((dict(position_embedding_type="absolute"),
                        "max_position_embeddings"),
                       (dict(parallel_layernorm=True), "parallel_attn"),
                       (dict(use_post_ln=True, parallel_attn=True),
                        "post_ln")):
        with pytest.raises(ValueError, match=match):
            ModelConfig(**base, **bad).validate()
    assert parse_recompute("block:0") == ("block", 0)
    assert parse_recompute("uniform:3") == ("uniform", 3)
    assert parse_recompute("selective") == ("selective", None)
    for bad in ("uniform:0", "block:-1", "block:", "uniform:x", "all"):
        with pytest.raises(ValueError, match="recompute"):
            parse_recompute(bad)


@pytest.mark.parametrize("name", ["falcon-7B", "falcon-40B", "gpt2-124M",
                                  "gpt2-1.3B", "codellama-7B",
                                  "codellama-34B"])
def test_presets_match_jax(name):
    family, size = name.split("-", 1)
    jcfg = j_presets.PRESETS[family](size=size)
    tcfg = presets.from_model_name(name)
    assert num_params(tcfg) == j_num_params(jcfg)
    for f in ("hidden_size", "num_layers", "num_attention_heads",
              "n_kv_heads", "head_dim", "ffn_size", "vocab_size",
              "seq_length", "max_position_embeddings",
              "position_embedding_type", "normalization", "activation",
              "parallel_attn", "parallel_layernorm", "use_post_ln",
              "use_bias_linear", "use_bias_qkv", "tie_embed_logits",
              "rope_theta", "layernorm_epsilon"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    jshapes = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                jshapes[path] = tuple(v.shape)

    walk(j_param_shapes(jcfg))
    from megatron_tpu_torch.models.params import param_shapes
    assert {k: tuple(v) for k, v in param_shapes(tcfg).items()} == jshapes


def test_family_preset_widths():
    f = presets.from_model_name("falcon-7B")
    assert (f.hidden_size, f.num_layers, f.num_attention_heads,
            f.n_kv_heads, f.head_dim, f.ffn_size, f.vocab_size,
            f.seq_length) == (4544, 32, 71, 1, 64, 18176, 65024, 2048)
    assert round(num_params(f) / 1e9, 2) == 6.92
    g = presets.from_model_name("gpt2-1.3B")
    assert (g.hidden_size, g.num_layers, g.num_attention_heads, g.head_dim,
            g.max_position_embeddings) == (2048, 24, 32, 64, 1024)
    assert round(num_params(g) / 1e9, 2) == 1.31
    m = presets.from_model_name("mixtral-8x7B")
    assert (m.hidden_size, m.num_layers, m.n_kv_heads, m.ffn_size,
            m.num_experts, m.moe_top_k, m.rope_theta) == \
        (4096, 32, 8, 14336, 8, 2, 1e6)
    assert round(num_params(m) / 1e9, 1) == 46.7


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lm_forward_matches_jax(pairs, family):
    """Logits without caches, then a prefill into caches and a per-slot
    decode step (rows at their own depths: absolute positions from the
    cache index)."""
    jcfg, jparams, tcfg, tparams = pairs[family]
    toks = _tokens(1, (2, 12))
    want = np.asarray(j_lm_forward(jcfg, jparams, jnp.asarray(toks)))
    got = lm_forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)
    from megatron_tpu.inference.generation import _init_caches as j_init
    from megatron_tpu_torch.inference.generation import _init_caches
    jc = j_init(jcfg, 2, 32)
    tc = _init_caches(tcfg, 2, 32, device="cpu")
    jl, jc = j_lm_forward(jcfg, jparams, jnp.asarray(toks), kv_caches=jc,
                          cache_index=0)
    tl, tc = lm_forward(tcfg, tparams, torch.from_numpy(toks),
                        kv_caches=tc, cache_index=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=1e-4)
    step = _tokens(2, (2, 1))
    idx = np.asarray([12, 7], np.int32)
    jl, _ = j_lm_forward(jcfg, jparams, jnp.asarray(step), kv_caches=jc,
                         cache_index=jnp.asarray(idx))
    tl, _ = lm_forward(tcfg, tparams, torch.from_numpy(step), kv_caches=tc,
                       cache_index=torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=1e-4)


def _batch(seed, b=2, s=32):
    r = np.random.default_rng(seed)
    text = r.integers(0, VOCAB, size=(b, s + 1))
    mask = (r.random((b, s)) > 0.2).astype(np.float32)
    return {"tokens": text[:, :-1], "labels": text[:, 1:], "loss_mask": mask}


def _grad_params(pair):
    jcfg, jparams, tcfg, _ = pair
    p = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    for _, leaf in leaf_paths(p):
        leaf.requires_grad_(True)
    return p


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lm_loss_and_every_gradient_leaf_match_jax(pairs, family):
    jcfg, jparams, tcfg, _ = pairs[family]
    batch = _batch(3)
    (jl, _), jg = jax.value_and_grad(
        lambda p: j_lm_loss(jcfg, p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(jparams)
    params = _grad_params(pairs[family])
    tl, _ = lm_loss(tcfg, params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=ATOL)
    want = dict(leaf_paths(jax.device_get(jg)))
    got = dict(leaf_paths(tree_map(lambda p: p.grad, params)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("family", ["falcon_mqa", "gpt2"])
def test_block_and_uniform_recompute_match_none(pairs, family):
    """block:1, block:2 and uniform:2 run the none policy's arithmetic:
    the same loss and gradients, bitwise (JAX: tests/test_model.py)."""
    tcfg = pairs[family][2]
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    out = {}
    for policy in ("none", "block:1", "block:2", "uniform:2"):
        params = _grad_params(pairs[family])
        loss, _ = lm_loss(tcfg, params, batch, recompute=policy)
        loss.backward()
        out[policy] = (float(loss), [g.grad for _, g in leaf_paths(params)])
    for policy in ("block:1", "block:2", "uniform:2"):
        assert out[policy][0] == out["none"][0], policy
        for a, b in zip(out[policy][1], out["none"][1]):
            assert torch.equal(a, b), policy
    with pytest.raises(ValueError, match="divisible"):
        lm_loss(tcfg, _grad_params(pairs[family]), batch,
                recompute="uniform:3")


# ---------------------------------------------------------------------------
# HuggingFace interop
# ---------------------------------------------------------------------------


def _hf_model(arch):
    """(random-init HF model, model_type, vocab) of one architecture."""
    from transformers import (FalconConfig, FalconForCausalLM, GPT2Config,
                              GPT2LMHeadModel)

    torch.manual_seed(0)
    if arch == "gpt2":
        return GPT2LMHeadModel(GPT2Config(
            vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            attn_implementation="eager", resid_pdrop=0.0, embd_pdrop=0.0,
            attn_pdrop=0.0)), "gpt2", 96
    layout = (dict(new_decoder_architecture=True, num_kv_heads=2)
              if arch == "falcon_new_decoder"
              else dict(new_decoder_architecture=False, multi_query=True))
    return FalconForCausalLM(FalconConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, layer_norm_epsilon=1e-5, bias=False,
        parallel_attn=True, alibi=False, attn_implementation="eager",
        **layout)), "falcon", 128


@pytest.mark.parametrize("arch", ["falcon_multi_query", "falcon_new_decoder",
                                  "gpt2"])
def test_hf_logits_and_round_trip(arch):
    model, model_type, vocab = _hf_model(arch)
    model.eval()
    cfg = dataclasses.replace(config_from_hf(model.config),
                              params_dtype="float32")
    # a config.json written by save_pretrained holds only what differs
    # from HF's defaults
    assert dataclasses.replace(config_from_hf(model.config.to_diff_dict()),
                               params_dtype="float32") == cfg
    assert cfg.parallel_layernorm == (arch == "falcon_new_decoder")
    sd = model.state_dict()
    params = hf_state_dict_to_params(sd, cfg, model_type)
    toks = torch.from_numpy(_tokens(5, (2, 12)) % vocab)
    with torch.no_grad():
        want = model(toks).logits
    got = lm_forward(cfg, params, toks)[..., :want.shape[-1]]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **HF_TOL)
    back = params_to_hf_state_dict(params, cfg, model_type)
    for name, t in back.items():
        assert torch.equal(t, sd[name]), name
    again = hf_state_dict_to_params(back, cfg, model_type)
    for (pa, a), (pb, b) in zip(leaf_paths(params), leaf_paths(again)):
        assert pa == pb and torch.equal(a, b), pa
    exported = hf_config_from_native(cfg, model_type)
    assert config_from_hf(exported) == dataclasses.replace(
        cfg, params_dtype="bfloat16")


# ---------------------------------------------------------------------------
# decode past 64 query rows per kv head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,hq,hkv", [(1, 71, 1), (9, 16, 2)])
def test_decode_past_64_rows_matches_jax(sq, hq, hkv):
    """R = Sq * G = 71 (Falcon-7B's decode) and 72 (G 8, Sq 9): the plain
    dense and paged decode against the JAX kernels in interpret mode and
    the JAX dense decode path."""
    r = np.random.default_rng(6)
    B, S, D, ps = 2, 128, 8, 8
    q = r.standard_normal((B, sq, hq, D)).astype(np.float32)
    k, v = (r.standard_normal((B, S, hkv, D)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray([3, 120 - sq], np.int32)
    fn = jft.flash_decode if sq == 1 else jft.flash_decode_mq
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lens), block_k=128))
    dense = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   kv_lengths=jnp.asarray(lens)))
    got = tft.flash_decode(*(torch.from_numpy(x) for x in (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), dense, atol=2e-6)
    # the same context through a scrambled page table
    P = 1 + B * S // ps
    perm = r.permutation(P - 1) + 1
    table = perm.reshape(B, S // ps).astype(np.int32)
    kp = np.zeros((P, ps, hkv, D), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        kp[table[b]] = k[b].reshape(S // ps, ps, hkv, D)
        vp[table[b]] = v[b].reshape(S // ps, ps, hkv, D)
    pfn = jft.paged_flash_decode if sq == 1 else jft.paged_flash_decode_mq
    jp = np.asarray(pfn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(table), jnp.asarray(lens)))
    tfn = tft.paged_flash_decode if sq == 1 else tft.paged_flash_decode_mq
    tp = tfn(*(torch.from_numpy(x) for x in (q, kp, vp, table, lens)))
    np.testing.assert_allclose(tp.numpy(), jp, atol=2e-6)
    np.testing.assert_allclose(tp.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("rows,row_tiles,tile_rows", [
    (64, 1, 64), (71, 2, 64), (72, 2, 64), (355, 6, 64), (20, 1, 20)])
def test_decode_plan_cuts_rows_into_tiles(rows, row_tiles, tile_rows):
    """The kernel's launch: ceil(R / 64) row tiles of at most 64 rows on
    the grid's x axis, each padded to 4 m16 tiles past 32 rows, and the
    split plan per (slot, kv head) whatever R is (Falcon-7B: 8 slots x
    2048 positions over 1 kv head)."""
    plan = tft.decode_plan(2048, 8, 1, rows)
    assert plan["row_tiles"] == row_tiles
    assert plan["tile_rows"] == tile_rows
    assert plan["grid"] == (row_tiles, 8, plan["splits"])
    assert plan["m_tiles"] == (4 if tile_rows > 32 else 2)
    base = tft.decode_plan(2048, 8, 1, 1)
    assert (plan["split_tiles"], plan["splits"]) == (base["split_tiles"],
                                                     base["splits"])


def test_split_schedule_at_71_rows_equals_the_plain_decode():
    """The kernel's split-K schedule in plain fp32 at Falcon-7B's G 71
    over one kv head equals the plain decode."""
    r = np.random.default_rng(7)
    q = torch.from_numpy(r.standard_normal((2, 1, 71, 8)).astype(np.float32))
    k, v = (torch.from_numpy(r.standard_normal((2, 256, 1, 8)).astype(
        np.float32)) for _ in range(2))
    lens = torch.tensor([70, 250], dtype=torch.int32)
    want = tft.flash_decode_reference(q, k, v, lens)
    for split_tiles in (1, 2):
        got = tft.flash_decode_split_reference(q, k, v, lens,
                                               split_tiles=split_tiles)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


PROMPTS = ([3, 7, 11, 2], [5, 9, 1, 5, 9, 1, 5, 9], [1, 2, 3],
           [4, 4, 4, 4, 4, 4])


def _serve(eng, prompts, n=10, req=Request):
    reqs = [eng.submit(req(prompt=np.asarray(p, np.int32), max_new_tokens=n))
            for p in prompts]
    eng.run_until_idle()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return reqs


@pytest.mark.parametrize("paged", [False, True])
def test_verify_past_64_rows_serves_the_plain_tokens(paged):
    """(k + 1) * G = 72 query rows per kv head (G 8, k 8), on a tiny GQA
    model: the greedy speculative tokens equal plain decode's."""
    kw = dict(hidden_size=64, num_attention_heads=16, num_kv_heads=2,
              vocab_size=64, seq_length=64, attention_impl="pallas")
    cfg = presets.tiny(**kw)
    jcfg = j_presets.tiny(**{k: v for k, v in kw.items()
                             if k != "attention_impl"})
    params = params_from_numpy(
        jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(0))), cfg,
        device="cpu")
    assert (8 + 1) * cfg.num_attention_heads // cfg.n_kv_heads == 72
    E = PagedInferenceEngine if paged else InferenceEngine
    extra = dict(page_size=8, prefill_chunk=8) if paged else {}
    plain = _serve(E(cfg, params, num_slots=4, max_seq_len=64, device="cpu",
                     vocab_size=65, metrics=MetricsRegistry(), **extra),
                   PROMPTS, n=16)
    eng = E(cfg, params, num_slots=4, max_seq_len=64, device="cpu",
            vocab_size=65, metrics=MetricsRegistry(),
            speculative=SpecConfig(k=8), **extra)
    fast = _serve(eng, PROMPTS, n=16)
    assert eng.stats["spec_proposed"] > 0
    assert [r.generated for r in fast] == [r.generated for r in plain]


# ---------------------------------------------------------------------------
# engines against the JAX engines
# ---------------------------------------------------------------------------


def _engines(pair, paged, **kw):
    jcfg, jparams, tcfg, tparams = pair
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 64)
    if paged:
        kw.setdefault("page_size", 8)
        kw.setdefault("prefill_chunk", 8)
    J, T = (JPaged, PagedInferenceEngine) if paged else (JEngine,
                                                        InferenceEngine)
    return (J(jcfg, jparams, vocab_size=VOCAB + 1, metrics=JRegistry(), **kw),
            T(tcfg, tparams, vocab_size=VOCAB + 1, metrics=MetricsRegistry(),
              device="cpu", **kw))


def _same(jreqs, treqs):
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, atol=1e-4)
        np.testing.assert_allclose(tr.prompt_logprobs, jr.prompt_logprobs,
                                   atol=1e-4)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("family", ["falcon_mqa", "gpt2"])
def test_engines_serve_token_for_token_with_jax(pairs, family, paged, int8):
    """Greedy tokens and logprobs of both engines against the JAX ones, with
    fp32 caches and with int8 caches (one fp32 scale per head vector,
    quantized on write, as in JAX)."""
    jeng, teng = _engines(pairs[family], paged, kv_cache_int8=int8)
    _same(_serve(jeng, PROMPTS, req=JRequest), _serve(teng, PROMPTS))


@pytest.mark.parametrize("family", ["falcon_mqa", "gpt2"])
def test_paged_prefix_hit_matches_jax(pairs, family):
    """A request sharing a 16-token prefix: one hit, and the recomputed
    chunk's absolute positions offset by the cached span."""
    jeng, teng = _engines(pairs[family], True)
    shared = list(np.random.default_rng(3).integers(1, 60, 16))
    for suffix in ([7, 3], [9, 5, 2]):
        _same(_serve(jeng, [shared + suffix], n=6, req=JRequest),
              _serve(teng, [shared + suffix], n=6))
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 1


@pytest.mark.parametrize("family", ["falcon_mqa", "gpt2"])
def test_paged_preemption_matches_jax(pairs, family):
    """Two 22-token sequences in a 10-page pool of 4-token pages: a
    preemption and a recompute resume."""
    jeng, teng = _engines(pairs[family], True, num_slots=2, max_seq_len=32,
                          page_size=4, num_pages=10)
    prompts = ([3, 7, 11, 2, 9, 4], [5, 8, 1, 6, 2, 7])
    _same(_serve(jeng, prompts, n=16, req=JRequest),
          _serve(teng, prompts, n=16))
    assert teng.stats["preemptions"] == jeng.stats["preemptions"] >= 1


def test_absolute_models_refuse_positions_past_the_table(pairs):
    """max_seq_len past max_position_embeddings (64) is refused by both
    engines, as by the JAX engine, and one-shot generation refuses a
    prompt + tokens_to_generate past it."""
    jcfg, jparams, tcfg, tparams = pairs["gpt2"]
    with pytest.raises(ValueError, match="max_position_embeddings"):
        JEngine(jcfg, jparams, max_seq_len=128)
    for E in (InferenceEngine, PagedInferenceEngine):
        with pytest.raises(ValueError, match="max_position_embeddings"):
            E(tcfg, tparams, max_seq_len=128, device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate_tokens(tcfg, tparams, np.ones((1, 40), np.int32),
                        np.asarray([40]), max_new_tokens=30)
    # the rotary families have no table to outgrow
    InferenceEngine(pairs["falcon_mqa"][2], pairs["falcon_mqa"][3],
                    max_seq_len=128, device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_flags_map_onto_the_run_config():
    cfg = args_to_run_config(parse_args([
        "--model_name", "gpt2-1.3B", "--seq_length", "1024",
        "--attention_impl", "pallas", "--recompute_granularity", "full",
        "--recompute_method", "block", "--recompute_num_layers", "2"]))
    assert cfg.model.position_embedding_type == "absolute"
    assert cfg.model.max_position_embeddings == 1024
    assert cfg.training.recompute_granularity == "block:2"
    cfg = args_to_run_config(parse_args([
        "--model_name", "tiny", "--recompute_granularity", "full",
        "--recompute_num_layers", "2", "--position_embedding_type",
        "absolute", "--max_position_embeddings", "128", "--parallel_attn",
        "--use_bias", "--no_tie_embed_logits"]))
    m = cfg.model
    assert (m.position_embedding_type, m.max_position_embeddings,
            m.parallel_attn, m.use_bias_linear, m.use_bias_qkv,
            m.tie_embed_logits) == ("absolute", 128, True, True, True, False)
    assert cfg.training.recompute_granularity == "uniform:2"
    assert args_to_run_config(parse_args(
        ["--model_name", "falcon-7B"])).model.parallel_attn
    with pytest.raises(ValueError, match="recompute_granularity full"):
        args_to_run_config(parse_args([
            "--model_name", "tiny", "--recompute_method", "block"]))


def test_pretrain_gpt_trains_a_gpt2_like_model_with_block_recompute(
        tmp_path):
    from megatron_tpu_torch.data.indexed_dataset import (
        MMapIndexedDatasetBuilder,
    )
    from megatron_tpu_torch.tools import pretrain_gpt

    prefix = str(tmp_path / "corpus")
    builder = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    r = np.random.default_rng(0)
    for _ in range(16):
        builder.add_item(r.integers(0, 90, 60).astype(np.int64))
        builder.end_document()
    builder.finalize(prefix + ".idx")
    logs = []
    pretrain_gpt.main([
        "--model_name", "tiny", "--fp32", "--seq_length", "32",
        "--position_embedding_type", "absolute",
        "--max_position_embeddings", "32", "--use_bias",
        "--micro_batch_size", "2", "--global_batch_size", "4",
        "--train_iters", "3", "--log_interval", "1", "--eval_interval", "3",
        "--eval_iters", "1", "--attention_impl", "pallas",
        "--recompute_granularity", "full", "--recompute_method", "block",
        "--recompute_num_layers", "1", "--data_path", prefix,
        "--split", "90,10,0", "--device", "cpu"], log=logs.append)
    losses = [float(re.search(r"lm loss: ([0-9.]+)", line).group(1))
              for line in logs if line.startswith("iteration")]
    assert len(losses) == 3 and all(np.isfinite(losses))
