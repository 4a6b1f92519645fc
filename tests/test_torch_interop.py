"""The port's HF interop (megatron_tpu_torch/interop/hf.py and the
hf_to_native / native_to_hf tools), on the CPU.

Oracles are random-init transformers models built in code (no weights
are downloaded): a tiny Llama, a tiny Mistral whose sliding window (8) is
shorter than the sequence (32), and a tied-embedding Llama with a
CodeLlama-style rope_theta. hf_state_dict_to_params gives the JAX
package's tree; the port's lm_forward gives transformers' logits within
LOGITS_ATOL in fp32 (measured worst 2.4e-7 on these models, with the
dense attention and with the kernels' plain versions alike); HF ->
native -> HF through the tools is bitwise, from pytorch_model.bin and
from safetensors, in fp32 and bf16; the exported directory loads in
from_pretrained with the same logits; a tiny Mixtral (4 experts, top-2)
takes every one of those checks too, and falcon and gpt2 convert
(tests/test_torch_families.py holds them against HF).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from transformers import (AutoModelForCausalLM, FalconConfig, GPT2Config,
                          LlamaConfig, LlamaForCausalLM, MistralConfig,
                          MistralForCausalLM, MixtralConfig,
                          MixtralForCausalLM)

from megatron_tpu.interop import hf as jhf
from megatron_tpu_torch.interop import hf
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.tools import hf_to_native, native_to_hf
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.optimizer import leaf_paths

LOGITS_ATOL = 1e-5
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            rms_norm_eps=1e-5, tie_word_embeddings=False,
            attn_implementation="eager")
MODELS = {
    "llama": (LlamaConfig, LlamaForCausalLM, {}),
    "mistral": (MistralConfig, MistralForCausalLM, {"sliding_window": 8}),
    "llama_tied": (LlamaConfig, LlamaForCausalLM,
                   {"tie_word_embeddings": True, "rope_theta": 1e6}),
    "mixtral": (MixtralConfig, MixtralForCausalLM,
                {"num_local_experts": 4, "rope_theta": 1e6}),
}


def _hf_model(name, dtype=torch.float32):
    ccls, mcls, extra = MODELS[name]
    torch.manual_seed(0)
    return mcls(ccls(**{**TINY, **extra})).eval().to(dtype)


def _tokens():
    return torch.from_numpy(
        np.random.default_rng(0).integers(0, 128, size=(2, 32)))


def _cfg(model):
    return dataclasses.replace(
        hf.config_from_hf(model.config.to_dict(), seq_length=32),
        params_dtype="float32")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_to_params_matches_jax(name):
    model = _hf_model(name)
    sd = model.state_dict()
    cfg = _cfg(model)
    got = dict(leaf_paths(hf.hf_state_dict_to_params(
        sd, cfg, model.config.model_type)))
    jcfg = jhf.config_from_hf(model.config, seq_length=32)
    want = dict(leaf_paths(jhf.hf_state_dict_to_params(
        sd, jcfg, model.config.model_type)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for f in dataclasses.fields(cfg):
        if hasattr(jcfg, f.name) and f.name != "params_dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lm_forward_matches_transformers(name, impl):
    model = _hf_model(name)
    cfg = dataclasses.replace(_cfg(model), attention_impl=impl)
    params = hf.hf_state_dict_to_params(model.state_dict(), cfg,
                                        model.config.model_type)
    tokens = _tokens()
    with torch.no_grad():
        want = model(tokens).logits
        got = lm_forward(cfg, params, tokens)
        if name == "mistral":       # the window is live at this length
            model.config.sliding_window = None
            assert (model(tokens).logits - want).abs().max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGITS_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("dtype,safe", [(torch.float32, False),
                                        (torch.bfloat16, True),
                                        (torch.bfloat16, False)])
def test_hf_native_hf_round_trip_is_bitwise(tmp_path, name, dtype, safe):
    model = _hf_model(name, dtype)
    src = str(tmp_path / "hf")
    model.save_pretrained(src, safe_serialization=safe)
    dtype_name = str(dtype).split(".")[1]
    native = str(tmp_path / "native")
    hf_to_native.main(["--model", src, "--output", native, "--dtype",
                       dtype_name, "--device", "cpu"])
    assert ckpt.read_tracker(native) == 0
    saved = ckpt.saved_run_config(native)
    assert saved["hf_model_type"] == model.config.model_type
    out = str(tmp_path / "out")
    native_to_hf.main(["--load", native, "--output", out, "--dtype",
                       dtype_name, "--device", "cpu"])
    got = torch.load(os.path.join(out, "pytorch_model.bin"),
                     weights_only=True)
    want = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == dtype and torch.equal(got[k], want[k]), k

    # both directories loaded alike (a model cast with .to(bf16) also
    # casts its rotary inv_freq buffer; from_pretrained keeps it fp32)
    reloaded, original = (AutoModelForCausalLM.from_pretrained(
        d, attn_implementation="eager", dtype="auto").eval()
        for d in (out, src))
    assert type(reloaded) is type(model) and reloaded.dtype == dtype
    with torch.no_grad():
        assert torch.equal(reloaded(_tokens()).logits,
                           original(_tokens()).logits)


@pytest.mark.parametrize("config", [
    FalconConfig(hidden_size=64, num_attention_heads=4, num_hidden_layers=2,
                 vocab_size=128),
    GPT2Config(n_embd=64, n_head=4, n_layer=2, vocab_size=128),
    MixtralConfig(**{k: v for k, v in TINY.items()
                     if k != "attn_implementation"}, num_local_experts=4),
], ids=["falcon", "gpt2", "mixtral"])
def test_unported_model_types_raise(config):
    """falcon, gpt2 and mixtral are all ported now: their configs convert,
    a Llama model has no falcon, gpt2 or mixtral export target, and a
    MoE model none but mixtral."""
    assert hf.config_from_hf(config.to_dict()).num_layers == 2
    llama = hf.config_from_hf(LlamaConfig(**TINY).to_dict())
    with pytest.raises(ValueError, match="export"):
        hf.hf_config_from_native(llama, config.model_type)
    if config.model_type == "mixtral":
        moe = hf.config_from_hf(config.to_dict())
        assert (moe.num_experts, moe.moe_capacity_factor) == (4, 4.0)
        with pytest.raises(ValueError, match="export"):
            hf.hf_config_from_native(moe, "llama")
    with pytest.raises(ValueError, match="unsupported"):
        hf.config_from_hf({"model_type": "qwen2"})


def test_safetensors_without_the_package_raises(tmp_path, monkeypatch):
    model = _hf_model("llama")
    src = str(tmp_path / "hf")
    model.save_pretrained(src, safe_serialization=True)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(RuntimeError, match="safetensors package"):
        hf_to_native.read_hf_checkpoint(src)
