"""megatron_tpu_torch model vs the JAX package, on the CPU in fp32.

One JAX init_params(tiny) tree converts through numpy
(params_from_numpy); lm_forward then runs on both packages with the
same tokens: without caches, a prefill into caches, a per-slot decode
step (every row at its own depth) and a scalar-index decode step.
Logits and caches agree to atol 1e-4 (fp32 through two layers; the two
frameworks sum in different orders).

The port's config uses attention_impl="pallas", so on the CPU its
attention runs the flash kernels' plain versions; the JAX package runs
its dense path (its kernels dispatch on the CPU only when forced).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.inference.generation import _init_caches as j_init_caches
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_forward as j_lm_forward
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.models.params import num_params as j_num_params
from megatron_tpu_torch.inference.generation import _init_caches
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_forward
from megatron_tpu_torch.models.params import (
    init_params, num_params, param_shapes, params_from_numpy,
)

ATOL = 1e-4
KW = dict(vocab_size=96, seq_length=32, attention_impl="pallas")


@pytest.fixture(scope="module")
def models():
    jcfg = j_presets.tiny(**KW)
    tcfg = presets.tiny(**KW)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["tiny", "llama2", "mistral"])
def test_param_tree_and_count_match_jax(name):
    jcfg = {"tiny": j_presets.tiny, "llama2": j_presets.PRESETS["llama2"],
            "mistral": j_presets.mistral}[name]()
    tcfg = presets.PRESETS[name]()
    assert num_params(tcfg) == j_num_params(jcfg)
    for f in ("head_dim", "n_kv_heads", "ffn_size", "num_layers",
              "vocab_size", "sliding_window_size", "layernorm_epsilon"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    jshapes = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                jshapes[path] = tuple(v.shape)

    from megatron_tpu.models.params import param_shapes as j_param_shapes
    walk(j_param_shapes(jcfg))
    assert {k: tuple(v) for k, v in param_shapes(tcfg).items()} == jshapes


def test_llama2_7b_preset_widths():
    cfg = presets.from_model_name("llama2-7B")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_attention_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.ffn_size, cfg.vocab_size) == \
        (4096, 32, 32, 32, 128, 11008, 32000)
    assert cfg.dtype == torch.bfloat16 and cfg.attention_impl == "pallas"
    assert num_params(cfg) == 6_738_415_616


def test_params_from_numpy_checks_the_tree(models):
    jcfg, jparams, tcfg, _ = models
    tree = jax.device_get(jparams)
    del tree["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.device_get(jparams)
    tree["final_ln"]["scale"] = np.ones((3,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_init_params_is_seeded_per_path():
    cfg = presets.tiny(**KW)
    a = init_params(cfg, 7, device="cpu")
    b = init_params(cfg, 7, device="cpu")
    c = init_params(cfg, 8, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"],
                           c["layers"]["attn"]["wq"])
    assert torch.all(a["layers"]["ln1"]["scale"] == 1)
    assert abs(float(a["embed"]["tokens"].std()) - 0.02) < 0.005


def test_lm_forward_matches_jax_without_caches(models):
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(0).integers(0, 96, size=(2, 20))
    want = j_lm_forward(jcfg, jparams, jnp.asarray(toks, jnp.int32))
    got = lm_forward(tcfg, tparams, torch.from_numpy(toks))
    _close(got, want)


def test_lm_forward_matches_jax_with_caches(models):
    """Prefill 9 tokens into a 24-long cache, then a per-slot decode step
    (rows at depths 9 and 5) and a scalar-index step."""
    jcfg, jparams, tcfg, tparams = models
    r = np.random.default_rng(1)
    prompt = r.integers(0, 96, size=(2, 9))
    jc = j_init_caches(jcfg, 2, 24)
    tc = _init_caches(tcfg, 2, 24, device="cpu")

    jl, jc = j_lm_forward(jcfg, jparams, jnp.asarray(prompt, jnp.int32),
                          kv_caches=jc, cache_index=0)
    tl, tc = lm_forward(tcfg, tparams, torch.from_numpy(prompt),
                        kv_caches=tc, cache_index=0)
    _close(tl, jl)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])

    step = r.integers(0, 96, size=(2, 1))
    depth = np.array([9, 5], np.int32)
    jl, jc = j_lm_forward(jcfg, jparams, jnp.asarray(step, jnp.int32),
                          kv_caches=jc, cache_index=jnp.asarray(depth))
    tl, tc = lm_forward(tcfg, tparams, torch.from_numpy(step),
                        kv_caches=tc, cache_index=torch.from_numpy(depth))
    _close(tl, jl)
    _close(tc[0], jc[0])

    jl, jc = j_lm_forward(jcfg, jparams, jnp.asarray(step, jnp.int32),
                          kv_caches=jc, cache_index=10)
    tl, tc = lm_forward(tcfg, tparams, torch.from_numpy(step),
                        kv_caches=tc, cache_index=10)
    _close(tl, jl)
    _close(tc[1], jc[1])


def test_lm_forward_window_gqa_matches_jax():
    """A Mistral-style sliding window narrower than the sequence, GQA."""
    kw = dict(KW, sliding_window_size=5, num_kv_heads=1)
    jcfg, tcfg = j_presets.tiny(**kw), presets.tiny(**kw)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, 96, size=(1, 17))
    _close(lm_forward(tcfg, tparams, torch.from_numpy(toks)),
           j_lm_forward(jcfg, jparams, jnp.asarray(toks, jnp.int32)))
