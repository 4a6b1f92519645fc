"""Card-only checks of the port's CUDA kernels (marker `cuda`).

The kernels have no CPU mode, so every test here skips without a CUDA
device. They import torch and megatron_tpu_torch only; tests/conftest.py
imports the JAX package, which a machine with the card need not have, so
on the card run them without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each forward kernel is held against its plain version on the same bf16
inputs (computed in fp32) with |kernel - plain| <= 2e-2 + 2e-2 * |plain|,
at small shapes that hit the ragged edges: sequence lengths that are not
a multiple of the 64-row tile, GQA, sliding windows, the q-vs-k offset
and ragged per-slot prefixes. The backward kernels (dq, dk/dv) are held
against the plain fp32 backward of the same bf16 inputs and the same
o/lse, relative to each tensor's largest plain magnitude M:
|kernel - plain| <= 2e-3 * M + 2e-2 * |plain| (the tolerance of the JAX
package's own backward test, tests/test_pallas_attention.py; the kernels
round p and ds to bf16 for the tensor cores).
"""

import dataclasses

import pytest
import torch

from megatron_tpu_torch.ops.flash import flash_template as ft

pytestmark = pytest.mark.cuda
ATOL = RTOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _assert_close(got, want):
    err = (got.float() - want.float()).abs()
    assert bool((err <= ATOL + RTOL * want.float().abs()).all()), \
        float(err.max())


@pytest.mark.parametrize("s,hq,hkv,d,window,delta", [
    (1, 4, 4, 128, None, 0), (63, 4, 2, 128, None, 0),
    (130, 8, 2, 64, None, 0), (130, 4, 1, 128, 17, 0),
    (100, 4, 4, 128, None, 30), (70, 2, 2, 64, 9, -5),
])
def test_flash_fwd_kernel_matches_plain(gen, s, hq, hkv, d, window, delta):
    q = _randn(gen, 2, s, hq, d)
    k, v = _randn(gen, 2, s, hkv, d), _randn(gen, 2, s, hkv, d)
    before = ft.flash_fwd.launches
    o, lse = ft.flash_fwd(q, k, v, sliding_window=window, delta=delta)
    torch.cuda.synchronize()
    assert ft.flash_fwd.launches == before + 1
    o_ref, lse_ref = ft.flash_fwd_reference(
        q.float(), k.float(), v.float(), sliding_window=window, delta=delta)
    _assert_close(o, o_ref)
    _assert_close(lse, lse_ref)


@pytest.mark.parametrize("sq,hq,hkv,window", [
    (1, 4, 4, None), (1, 8, 2, None), (3, 8, 2, None), (1, 4, 4, 50),
    (4, 4, 1, 33),
])
def test_flash_decode_kernel_matches_plain(gen, sq, hq, hkv, window):
    S = 200
    q = _randn(gen, 4, sq, hq, 128)
    k, v = _randn(gen, 4, S, hkv, 128), _randn(gen, 4, S, hkv, 128)
    lens = torch.tensor([1, 64, 130, S - sq + 1], dtype=torch.int32,
                        device="cuda")
    before = ft.flash_decode.launches
    o = ft.flash_decode(q, k, v, lens, sliding_window=window)
    torch.cuda.synchronize()
    assert ft.flash_decode.launches == before + 1
    _assert_close(o, ft.flash_decode_reference(q.float(), k.float(),
                                               v.float(), lens, window))


def test_flash_decode_reads_a_strided_cache(gen):
    """The engine hands the kernel per-layer views of the stacked cache."""
    cache = _randn(gen, 3, 4, 256, 2, 128)       # [L, B, S, Hkv, D]
    q = _randn(gen, 4, 1, 4, 128)
    lens = torch.tensor([5, 100, 256, 1], dtype=torch.int32, device="cuda")
    k, v = cache[1], cache[2]
    _assert_close(ft.flash_decode(q, k, v, lens),
                  ft.flash_decode_reference(q.float(), k.float(),
                                            v.float(), lens))


def _assert_close_rel(got, want, name):
    want = want.float()
    m = float(want.abs().max())
    err = (got.float() - want).abs()
    assert bool((err <= 2e-3 * m + 2e-2 * want.abs()).all()), \
        (name, float(err.max()), m)


@pytest.mark.parametrize("s,hq,hkv,d,causal,window,delta", [
    (3, 4, 4, 128, True, None, 0), (63, 4, 2, 128, True, None, 0),
    (130, 8, 2, 64, True, None, 0), (130, 4, 1, 128, True, 17, 0),
    (100, 4, 4, 128, True, None, 30), (70, 2, 2, 64, True, 9, -5),
    (96, 4, 2, 128, False, None, 0), (200, 4, 4, 64, False, 33, 0),
])
def test_flash_bwd_kernels_match_plain(gen, s, hq, hkv, d, causal, window,
                                       delta):
    # (S = 1 is left out: there dq is 0 in exact arithmetic and both sides
    # hold only rounding noise, which a relative tolerance cannot judge)
    q = _randn(gen, 2, s, hq, d)
    k, v = _randn(gen, 2, s, hkv, d), _randn(gen, 2, s, hkv, d)
    do = _randn(gen, 2, s, hq, d)
    o, lse = ft.flash_fwd(q, k, v, causal=causal, sliding_window=window,
                          delta=delta)
    before = (ft.flash_bwd_dq.launches, ft.flash_bwd_dkv.launches)
    got = ft.flash_bwd(q, k, v, o, lse, do, causal=causal,
                       sliding_window=window, delta=delta)
    torch.cuda.synchronize()
    assert (ft.flash_bwd_dq.launches, ft.flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want = ft.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                  do, causal=causal, sliding_window=window,
                                  delta=delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _assert_close_rel(a, b, name)


def test_flash_mha_autograd_runs_the_backward_kernels(gen):
    """flash_mha on CUDA tensors that require a gradient: one forward and
    one dq + one dk/dv launch, gradients equal to the plain backward."""
    q = _randn(gen, 1, 150, 4, 128).requires_grad_()
    k = _randn(gen, 1, 150, 2, 128).requires_grad_()
    v = _randn(gen, 1, 150, 2, 128).requires_grad_()
    do = _randn(gen, 1, 150, 4, 128)
    before = (ft.flash_fwd.launches, ft.flash_bwd_dq.launches,
              ft.flash_bwd_dkv.launches)
    o = ft.flash_mha(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert (ft.flash_fwd.launches, ft.flash_bwd_dq.launches,
            ft.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    with torch.no_grad():
        o2, lse = ft.flash_fwd(q, k, v)
    want = ft.flash_bwd_reference(q.detach().float(), k.detach().float(),
                                  v.detach().float(), o2, lse, do)
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        _assert_close_rel(t.grad, w, name)


def test_kernels_refuse_what_they_do_not_cover(gen):
    q = _randn(gen, 1, 8, 2, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        ft.flash_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head_dim"):
        x = _randn(gen, 1, 8, 2, 96)
        ft.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="backward"):
        ft.flash_fwd(q.clone().requires_grad_(), q, q)
    with pytest.raises(ValueError, match="int32"):
        ft.flash_decode(q[:, :1], q, q, torch.tensor([3], device="cuda"))


def test_lm_forward_kernel_route_matches_dense_route(gen):
    """A 2-layer bf16 model: the kernel route and the dense route give
    logits within bf16 noise of each other, with and without caches."""
    from megatron_tpu_torch.inference.generation import _init_caches
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.models.params import init_params

    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, params_dtype="bfloat16",
                       attention_impl="pallas")
    dense = dataclasses.replace(cfg, attention_impl="xla")
    params = init_params(cfg, 0)
    toks = torch.randint(0, 128, (2, 70), generator=gen, device="cuda")
    with torch.no_grad():
        _assert_close(lm_forward(cfg, params, toks),
                      lm_forward(dense, params, toks).float())
        ck, cd = _init_caches(cfg, 2, 128), _init_caches(cfg, 2, 128)
        lk, _ = lm_forward(cfg, params, toks, kv_caches=ck, cache_index=0)
        ld, _ = lm_forward(dense, params, toks, kv_caches=cd, cache_index=0)
        _assert_close(lk, ld.float())
        depth = torch.tensor([70, 40], device="cuda")
        step = toks[:, :1]
        lk, _ = lm_forward(cfg, params, step, kv_caches=ck, cache_index=depth)
        ld, _ = lm_forward(dense, params, step, kv_caches=cd,
                           cache_index=depth)
        _assert_close(lk, ld.float())


def test_train_step_runs_the_attention_kernels(gen):
    """make_train_step on a 2-layer bf16 model (D 128, GQA 4/2, ragged S
    200), 2 microbatches, selective recompute: every step launches
    flash_fwd twice per layer and microbatch (forward + recompute) and
    the dq and dk/dv kernels once, and its losses track the same steps
    taken through the dense attention with autograd within 3e-2 (bf16
    weights; both runs round differently, and three Adam steps carry
    the differences along)."""
    from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.training.optimizer import (init_train_state,
                                                       leaf_paths)
    from megatron_tpu_torch.training.train_step import make_train_step

    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, seq_length=200,
                       params_dtype="bfloat16", attention_impl="pallas")
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    tc = TrainingConfig(micro_batch_size=1, global_batch_size=2,
                        train_iters=3, recompute_granularity="selective")
    toks = torch.randint(0, 128, (3, 2, 201), generator=gen, device="cuda")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    losses, launched = {}, {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        params = init_params(c, 0)
        for _, p in leaf_paths(params):
            p.requires_grad_(True)
        state = init_train_state(opt, params)
        step = make_train_step(c, opt, tc, 2)
        before = [getattr(ft, n).launches for n in names]
        losses[impl] = []
        for i in range(3):
            state, m = step(state, {"tokens": toks[i, :, :-1],
                                    "labels": toks[i, :, 1:]})
            assert float(m["skipped"]) == 0.0
            losses[impl].append(float(m["loss"]))
        torch.cuda.synchronize()
        launched[impl] = [getattr(ft, n).launches - b
                          for n, b in zip(names, before)]
    assert launched["pallas"] == [2 * 2 * 2 * 3, 2 * 2 * 3, 2 * 2 * 3]
    assert launched["xla"] == [0, 0, 0]
    for a, b in zip(losses["pallas"], losses["xla"]):
        assert abs(a - b) <= 3e-2, (losses["pallas"], losses["xla"])
