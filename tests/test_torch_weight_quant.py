"""The port's int8 / fp8 weight-only serving (ops/weight_quant.py, the
deq / take_rows use sites, the server's --weight_int8 / --weight_fp8) vs
the JAX package, on the CPU.

The 7 cases of tests/test_weight_quant.py, each on the port: the
per-channel error bound, the tree's scope and structure, the quantized
forward against full precision (the JAX gates: relative error < 0.1,
argmax agreement >= 0.85), generation with int8 weights and an int8 KV
cache, the tied-embedding logits, the fp8 error bound and forward, and
fp8 generation. Beside each, the JAX quantized tree itself crosses into
the port through params_from_numpy (int8 payloads, the ml_dtypes fp8
payload as its bytes, fp32 scales) and must equal the port's own
quantization bitwise, and the port's quantized forward and greedy tokens
must equal the JAX quantized forward's (logits atol 1e-4 through two
fp32 layers). The server's flags and a quantized reload close the file.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.inference.generation import (
    generate_tokens as j_generate_tokens,
)
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_forward as j_lm_forward
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.ops import weight_quant as jwq
from megatron_tpu_torch.inference.generation import generate_tokens
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.models.params import init_params, params_from_numpy
from megatron_tpu_torch.ops.weight_quant import (
    deq, is_quantized, quantize_linear, quantize_linear_fp8,
    quantize_params_for_serving, quantize_rows, take_rows,
)
from megatron_tpu_torch.training.optimizer import leaf_paths

KW = dict(vocab_size=128, seq_length=48, params_dtype="float32")
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = j_presets.tiny(**KW)
    tcfg = presets.tiny(**KW, attention_impl="pallas")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _toks(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _j_quantized(jparams, mode):
    return jwq.quantize_params_for_serving(jax.device_get(jparams),
                                           mode=mode)


def _bytes(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_jax_quantized_tree_crosses_bitwise(models, mode):
    """The JAX tree's {q8|f8, s} leaves load 1:1 (fp8 through its bytes)
    and equal the port's own quantization of the same weights."""
    jcfg, jparams, tcfg, tparams = models
    crossed = params_from_numpy(_j_quantized(jparams, mode), tcfg,
                                device="cpu")
    ours = quantize_params_for_serving(tparams, mode)
    a, b = dict(leaf_paths(crossed)), dict(leaf_paths(ours))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(_bytes(a[k]), _bytes(b[k])), k
    kind = "q8" if mode == "int8" else "f8"
    assert f"layers/attn/wq/{kind}" in a and "embed/tokens/s" in a


def test_quantize_linear_per_output_channel():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.02, (2, 64, 32)).astype(np.float32))
    qd = quantize_linear(w)
    assert qd["q8"].dtype == torch.int8 and qd["s"].shape == (2, 1, 32)
    err = (deq(qd, torch.float32) - w).abs()
    assert (err <= qd["s"] / 2 + 1e-8).all()
    j = jwq.quantize_linear(w.numpy())
    np.testing.assert_array_equal(qd["q8"].numpy(), j["q8"])
    np.testing.assert_array_equal(qd["s"].numpy(), j["s"])


def test_quantize_params_scopes_and_structure(models):
    _, _, tcfg, tparams = models
    q = quantize_params_for_serving(tparams)
    layers = q["layers"]
    for name in ("wq", "wk", "wv", "wo"):
        assert is_quantized(layers["attn"][name])
    for name in ("w_in", "w_out"):
        assert is_quantized(layers["mlp"][name])
    assert is_quantized(q["embed"]["tokens"]) and is_quantized(
        q["lm_head"]["w"])
    assert q["embed"]["tokens"]["s"].shape == (tcfg.vocab_size, 1)
    assert not is_quantized(q["final_ln"])
    assert q["final_ln"]["scale"] is tparams["final_ln"]["scale"]
    orig = tparams["layers"]["attn"]["wq"]
    quant = layers["attn"]["wq"]["q8"]
    assert quant.numel() * quant.element_size() == \
        orig.numel() * orig.element_size() // 4
    # MoE experts and the router stay in the model dtype (v1 scope)
    moe_cfg = presets.tiny(**KW, num_experts=4, hidden_size=32,
                           num_attention_heads=4, ffn_hidden_size=48)
    qm = quantize_params_for_serving(init_params(moe_cfg, 0, device="cpu"))
    assert not any(is_quantized(v) for v in qm["layers"]["moe"].values())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_forward_tracks_full_precision_and_jax(models, mode):
    """The JAX gates against full precision, and the port's quantized
    forward against the JAX quantized forward (atol 1e-4)."""
    jcfg, jparams, tcfg, tparams = models
    toks = _toks(1, (2, 16))
    with torch.no_grad():
        ref = lm_forward(tcfg, tparams, torch.from_numpy(toks)).numpy()
        got = lm_forward(tcfg, quantize_params_for_serving(tparams, mode),
                         torch.from_numpy(toks)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.1
    assert (ref.argmax(-1) == got.argmax(-1)).mean() >= 0.85
    want = np.asarray(j_lm_forward(jcfg, _j_quantized(jparams, mode),
                                   jnp.asarray(toks)), np.float32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("mode,kv_int8", [("int8", True), ("fp8", False)])
def test_quantized_generation_matches_jax(models, mode, kv_int8):
    """Quantized weights (with an int8 KV cache for int8, the full
    serving memory configuration) generate end to end, greedy tokens
    equal to the JAX package's on its own quantized tree."""
    jcfg, jparams, tcfg, tparams = models
    prompts = np.random.default_rng(2).integers(1, 128, (2, 6)).astype(
        np.int32)
    lengths = np.array([6, 5], np.int32)
    kw = dict(max_new_tokens=6, temperature=0.0, top_k=1, seed=0)
    out = generate_tokens(tcfg, quantize_params_for_serving(tparams, mode),
                          prompts, lengths, kv_cache_int8=kv_int8, **kw)
    assert out.tokens.shape == (2, 12)
    np.testing.assert_array_equal(out.tokens[0, :6], prompts[0])
    want = j_generate_tokens(jcfg, _j_quantized(jparams, mode), prompts,
                             lengths, want_logprobs=False,
                             kv_cache_int8=kv_int8, **kw)
    np.testing.assert_array_equal(np.asarray(out.tokens),
                                  np.asarray(want.tokens))


def test_tied_embedding_quantized_logits():
    jcfg = j_presets.tiny(vocab_size=64, seq_length=24,
                          tie_embed_logits=True, params_dtype="float32")
    tcfg = presets.tiny(vocab_size=64, seq_length=24, tie_embed_logits=True,
                        params_dtype="float32", attention_impl="pallas")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    toks = _toks(3, (1, 8), 64)
    with torch.no_grad():
        ref = lm_forward(tcfg, tparams, torch.from_numpy(toks)).numpy()
        got = lm_forward(tcfg, quantize_params_for_serving(tparams),
                         torch.from_numpy(toks)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.1
    want = np.asarray(j_lm_forward(jcfg, _j_quantized(jparams, "int8"),
                                   jnp.asarray(toks)), np.float32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


def test_fp8_quantize_error_bound_and_leaf():
    """e4m3: relative error <= 2^-3 per weight plus the scale floor (the
    JAX test's bound), one byte a weight, the same bytes as the JAX
    ml_dtypes payload; take_rows gathers fp8 rows."""
    w = torch.from_numpy(np.random.default_rng(5).normal(
        0, 0.02, (2, 64, 32)).astype(np.float32))
    qd = quantize_linear_fp8(w)
    assert qd["f8"].dtype == torch.float8_e4m3fn
    assert qd["s"].shape == (2, 1, 32)
    assert qd["f8"].element_size() == 1
    back = deq(qd, torch.float32)
    tol = w.abs() * 2.0 ** -3 + qd["s"] * 2.0 ** -6
    assert ((back - w).abs() <= tol + 1e-8).all()
    j = jwq.quantize_linear_fp8(w.numpy())
    np.testing.assert_array_equal(qd["f8"].view(torch.uint8).numpy(),
                                  np.asarray(j["f8"]).view(np.uint8))
    rows = jwq.quantize_rows_fp8(w[0].numpy())
    ids = torch.tensor([[3, 0, 63]])
    t = {"f8": torch.from_numpy(np.asarray(rows["f8"]).view(np.uint8)).view(
        torch.float8_e4m3fn), "s": torch.from_numpy(rows["s"])}
    np.testing.assert_array_equal(
        take_rows(t, ids, torch.float32).numpy(),
        np.asarray(jwq.take_rows(rows, jnp.asarray(ids.numpy()),
                                 jnp.float32)))


def test_quantized_rows_gather(models):
    _, jparams, tcfg, tparams = models
    q = quantize_rows(tparams["embed"]["tokens"])
    ids = torch.from_numpy(_toks(4, (2, 5)))
    got = take_rows(q, ids, torch.float32)
    j = jwq.quantize_rows(np.asarray(jparams["embed"]["tokens"]))
    want = jwq.take_rows(j, jnp.asarray(ids.numpy()), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_quantized_engines_match_generate_tokens(models, paged):
    """Both engines serve a quantized tree with the one-shot path's greedy
    tokens (the decode tick dequantizes each layer where it multiplies)."""
    from megatron_tpu_torch.inference.engine import InferenceEngine
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    _, _, tcfg, tparams = models
    q = quantize_params_for_serving(tparams, "fp8" if paged else "int8")
    prompts = np.random.default_rng(6).integers(1, 128, (2, 6)).astype(
        np.int32)
    lengths = np.array([6, 6], np.int32)
    want = generate_tokens(tcfg, q, prompts, lengths, max_new_tokens=5,
                           temperature=0.0, top_k=1, seed=0)
    # a registry of its own: the process-wide one is read by other
    # files' servers (test_torch_engine.py counts retirements there)
    kw = dict(num_slots=2, max_seq_len=32, vocab_size=128, device="cpu",
              metrics=MetricsRegistry())
    eng = (PagedInferenceEngine(tcfg, q, page_size=8, prefill_chunk=4, **kw)
           if paged else InferenceEngine(tcfg, q, **kw))
    got = eng.generate(prompts, lengths, max_new_tokens=5, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(want.tokens))


def test_server_flags_refusals():
    from megatron_tpu_torch.tools import run_text_generation_server as srv

    def mode(argv, cfg):
        return srv.weight_quant_mode(srv.parse_args(argv), cfg)

    dense = presets.tiny(**KW)
    assert mode([], dense) is None
    assert mode(["--weight_int8"], dense) == "int8"
    assert mode(["--weight_fp8"], dense) == "fp8"
    with pytest.raises(SystemExit, match="exclusive"):
        mode(["--weight_int8", "--weight_fp8"], dense)
    with pytest.raises(SystemExit, match="MoE"):
        mode(["--weight_int8"], presets.tiny(**KW, num_experts=4))
    os.environ["WORLD_SIZE"] = "2"
    try:
        with pytest.raises(SystemExit, match="single-card"):
            mode(["--weight_fp8"], dense)
    finally:
        del os.environ["WORLD_SIZE"]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_reload_quantizes_into_the_served_tensors(tmp_path, mode):
    """A quantized server's reload reads the checkpoint on the host,
    quantizes it and copies it INTO the served tensors (same storage):
    they then equal the new weights' quantization."""
    from megatron_tpu_torch.inference.fleet.reload import (
        save_params_checkpoint,
    )
    from megatron_tpu_torch.inference.server import GenerationService
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = presets.tiny(vocab_size=64, seq_length=64, attention_impl="pallas")
    new = init_params(cfg, 1, device="cpu")
    save_params_checkpoint(str(tmp_path), 1, new)
    served = quantize_params_for_serving(init_params(cfg, 0, device="cpu"),
                                         mode)
    ptrs = {k: v.data_ptr() for k, v in leaf_paths(served)}
    svc = GenerationService(cfg, served, NullTokenizer(64), engine_slots=2,
                            engine_max_seq_len=64, device="cpu",
                            metrics=MetricsRegistry(),
                            reload_dir=str(tmp_path))
    assert svc.weight_quant == mode
    try:
        assert svc.reload(iteration=1) == 1
    finally:
        svc.shutdown()
    want = dict(leaf_paths(quantize_params_for_serving(new, mode)))
    for k, v in leaf_paths(svc.engine.params):
        assert v.data_ptr() == ptrs[k], k
        assert torch.equal(_bytes(v), _bytes(want[k])), k
