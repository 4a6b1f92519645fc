"""The port's flash backward vs the JAX Pallas backward, on the CPU.

flash_bwd_reference (megatron_tpu_torch ops/flash/flash_template.py) is
the plain version of the flash_bwd_dq and flash_bwd_dkv CUDA kernels,
which the card holds them against. Here it is held against jax.grad
through the Pallas flash_mha — its custom_vjp runs _bwd, i.e. the
_dq_kernel and _dkv_kernel themselves in interpret mode at block 64, as
tests/test_pallas_attention.py runs them — on the same numpy inputs and
cotangent, fp32, atol 1e-5. Also: the port's autograd Function on CPU
tensors (plain forward, plain backward: the structure the card runs with
the kernels) against autograd of the dense attention at ragged lengths,
the CPU wrappers, and the --no_flash_bwd escape hatch.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops.pallas import flash_template as jft
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.ops.flash import flash_template as tft

ATOL = 1e-5


def _arr(r, *shape):
    return r.normal(size=shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=1e-5)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal,window", [
    (True, None), (True, 48), (False, 48)])
def test_flash_bwd_reference_matches_pallas_bwd(causal, window, hq, hkv):
    """dq, dk, dv of jax.grad through the Pallas flash_mha (custom_vjp ->
    _bwd -> _dq_kernel and _dkv_kernel in interpret mode, block 64, GQA
    through its jnp.repeat) against flash_bwd_reference fed the port's
    plain forward (o, lse) and the same cotangent. fp32, atol 1e-5."""
    r = np.random.default_rng(20)
    b, s, d = 1, 128, 16
    q, k, v = _arr(r, b, s, hq, d), _arr(r, b, s, hkv, d), \
        _arr(r, b, s, hkv, d)
    do = _arr(r, b, s, hq, d)

    def f(q, k, v):
        o = jft.flash_mha(q, k, v, sliding_window=window, causal=causal,
                          block_q=64, block_k=64)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tft.flash_fwd_reference(tq, tk, tv, causal=causal,
                                     sliding_window=window)
    got = tft.flash_bwd_reference(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  causal=causal, sliding_window=window)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("s,hq,hkv,window", [
    (37, 4, 2, None), (70, 4, 1, 9), (100, 2, 2, None), (5, 2, 2, None)])
def test_flash_mha_autograd_matches_dense_autograd(s, hq, hkv, window):
    """The port's _FlashAttention on CPU tensors (plain forward, plain
    backward — the structure the card runs with the kernels) against
    torch autograd of the dense attention(impl="xla"), at sequence
    lengths that are not a multiple of the 64-row tile."""
    r = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(_arr(r, 2, s, h, 16)).requires_grad_()
               for h in (hq, hkv, hkv))
    w = torch.from_numpy(_arr(r, 2, s, hq, 16))
    (tft.flash_mha(q, k, v, sliding_window=window) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (attention(q, k, v, sliding_window=window, impl="xla") * w).sum() \
        .backward()
    for g, t in zip(got, (q, k, v)):
        _close(g, t.grad.numpy())


def test_bwd_wrappers_on_cpu_are_the_plain_backward():
    """flash_bwd_dq / flash_bwd_dkv on CPU tensors return the plain
    backward's parts and launch nothing; flash_bwd is their composition."""
    r = np.random.default_rng(22)
    q, do = (torch.from_numpy(_arr(r, 1, 20, 4, 16)) for _ in range(2))
    k, v = (torch.from_numpy(_arr(r, 1, 20, 2, 16)) for _ in range(2))
    o, lse = tft.flash_fwd_reference(q, k, v, sliding_window=6)
    want = tft.flash_bwd_reference(q, k, v, o, lse, do, sliding_window=6)
    before = (tft.flash_bwd_dq.launches, tft.flash_bwd_dkv.launches)
    dsum = tft._bwd_dsum(o, do)
    dq = tft.flash_bwd_dq(q, k, v, do, lse, dsum, sliding_window=6)
    dk, dv = tft.flash_bwd_dkv(q, k, v, do, lse, dsum, sliding_window=6)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    for g, w in zip(tft.flash_bwd(q, k, v, o, lse, do, sliding_window=6),
                    want):
        assert torch.equal(g, w)
    assert (tft.flash_bwd_dq.launches, tft.flash_bwd_dkv.launches) == before


def test_no_flash_bwd_takes_the_dense_path_loudly():
    """flash_bwd=False (--no_flash_bwd): the dense path, with a warning,
    and the same values."""
    r = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(_arr(r, 1, 12, 2, 16)) for _ in range(3))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = attention(q, k, v, impl="pallas", flash_bwd=False)
    assert any("flash_bwd disabled" in str(w.message) for w in caught)
    _close(got, tft.flash_mha(q, k, v).numpy())
