"""megatron_tpu_torch ops vs the JAX package, on the CPU in fp32.

The same inputs, made from a numpy seed, go through each JAX function and
its PyTorch counterpart: normalization, RoPE (incl. the per-row positions
gather), the activations, and attention()'s dense path over every
masking mode the serving slice uses. Tolerance: atol 1e-5 (fp32, the
two frameworks sum in different orders).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops import activations as j_act
from megatron_tpu.ops import normalization as j_norm
from megatron_tpu.ops import rotary as j_rot
from megatron_tpu.ops.attention import attention as j_attention
from megatron_tpu_torch.ops import activations as t_act
from megatron_tpu_torch.ops import attention as t_attn
from megatron_tpu_torch.ops import normalization as t_norm
from megatron_tpu_torch.ops import rotary as t_rot

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_forward_matches_jax(kind):
    r = _rng(0)
    x = r.normal(size=(2, 5, 32)).astype(np.float32) * 3
    scale = r.normal(size=(32,)).astype(np.float32)
    bias = r.normal(size=(32,)).astype(np.float32)
    tb = torch.from_numpy(bias) if kind == "layernorm" else None
    jb = jnp.asarray(bias) if kind == "layernorm" else None
    got = t_norm.norm_forward(kind, torch.from_numpy(x),
                              torch.from_numpy(scale), tb, 1e-5)
    want = j_norm.norm_forward(kind, jnp.asarray(x), jnp.asarray(scale), jb,
                               1e-5)
    _close(got, want)


def test_norm_forward_rejects_unknown_kind():
    with pytest.raises(ValueError):
        t_norm.norm_forward("batchnorm", torch.zeros(1, 4), torch.ones(4))


@pytest.mark.parametrize("scaling", [1.0, 4.0])
def test_precompute_rope_matches_jax(scaling):
    tc, ts = t_rot.precompute_rope(16, 50, 10000.0, scaling, device="cpu")
    jc, js = j_rot.precompute_rope(16, 50, 10000.0, scaling)
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rotary_emb_matches_jax(per_row):
    r = _rng(1)
    q = r.normal(size=(3, 4, 2, 16)).astype(np.float32)
    k = r.normal(size=(3, 4, 1, 16)).astype(np.float32)
    # per-row positions: every slot at its own depth (engine decode)
    pos = (r.integers(0, 40, size=(3, 1)) + np.arange(4)[None]
           if per_row else None)
    tc, ts = t_rot.precompute_rope(16, 64, device="cpu")
    jc, js = j_rot.precompute_rope(16, 64)
    tq, tk = t_rot.apply_rotary_emb(
        torch.from_numpy(q), torch.from_numpy(k), tc, ts,
        None if pos is None else torch.from_numpy(pos))
    jq, jk = j_rot.apply_rotary_emb(
        jnp.asarray(q), jnp.asarray(k), jc, js,
        None if pos is None else jnp.asarray(pos))
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "relu", "squared_relu",
                                  "swiglu", "geglu", "reglu", "liglu"])
def test_apply_activation_matches_jax(name):
    x = _rng(2).normal(size=(2, 3, 16)).astype(np.float32) * 2
    _close(t_act.apply_activation(name, torch.from_numpy(x)),
           j_act.apply_activation(name, jnp.asarray(x)))
    assert (t_act.mlp_input_width_factor(name)
            == j_act.mlp_input_width_factor(name))


def _qkv(seed, b=2, sq=7, skv=7, hq=4, hkv=2, d=8):
    r = _rng(seed)
    return (r.normal(size=(b, sq, hq, d)).astype(np.float32),
            r.normal(size=(b, skv, hkv, d)).astype(np.float32),
            r.normal(size=(b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("mask_type,window,q_offset,sq", [
    ("causal", None, 0, 7),
    ("causal", 3, 0, 7),
    ("causal", None, 4, 3),      # a chunk into cached context
    ("causal", 2, 5, 2),
    ("bidirectional", None, 0, 7),
    ("bidirectional", 3, 0, 7),
])
def test_attention_dense_matches_jax(mask_type, window, q_offset, sq):
    q, k, v = _qkv(3, sq=sq, skv=7 if q_offset == 0 else q_offset + sq)
    got = t_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mask_type=mask_type,
                           sliding_window=window, q_offset=q_offset)
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask_type=mask_type, sliding_window=window,
                       q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("sq", [1, 3])
def test_attention_kv_lengths_matches_jax(sq, window):
    """The per-row valid-prefix rule k_pos < kv_lengths + j, dense path."""
    q, k, v = _qkv(4, b=3, sq=sq, skv=12)
    lens = np.array([1, 6, 12 - sq + 1], np.int32)
    got = t_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sliding_window=window,
                           kv_lengths=torch.from_numpy(lens))
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       sliding_window=window,
                       kv_lengths=jnp.asarray(lens))
    _close(got, want)


def test_attention_padding_mask_matches_jax_and_warns_on_kernel_route():
    q, k, v = _qkv(5)
    pad = np.ones((2, 7), bool)
    pad[1, 5:] = False
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask_type="bidirectional",
                       padding_mask=jnp.asarray(pad))
    got = t_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mask_type="bidirectional",
                           padding_mask=torch.from_numpy(pad))
    _close(got, want)
    # causal + padding under the kernel route: no kernel covers padding,
    # so the dense fallback must be loud
    with pytest.warns(UserWarning, match="padding masks"):
        t_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), impl="pallas",
                         padding_mask=torch.from_numpy(pad))


def test_attention_kv_lengths_rejects_dropout_and_padding():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, sq=1))
    lens = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="serving-decode"):
        t_attn.attention(q, k, v, kv_lengths=lens, dropout=0.1)
    with pytest.raises(ValueError, match="serving-decode"):
        t_attn.attention(q, k, v, kv_lengths=lens,
                         padding_mask=torch.ones(2, 7, dtype=torch.bool))
