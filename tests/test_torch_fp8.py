"""The port's fp8 training products (megatron_tpu_torch/ops/fp8.py) held
against the JAX package's (megatron_tpu/ops/fp8.py) on the CPU.

On the CPU both run the plain version: cast to the fp8 dtype, upcast to
fp32, matmul, the scale epilogue. Inputs come from a numpy seed; the
tolerances are stated per test. The card holds torch._scaled_mm's route
against the same plain version (tests/test_torch_cuda.py, chip_smoke.py
phase 4c).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_loss as j_lm_loss
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.ops import fp8 as jfp8
from megatron_tpu.training import optimizer as jopt
from megatron_tpu_torch import arguments, config as tconfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_loss
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.ops import fp8 as tfp8
from megatron_tpu_torch.training import optimizer as topt


def _pair(r, *shape, scale=1.0):
    a = (r.standard_normal(shape) * scale).astype(np.float32)
    return a, torch.from_numpy(a.copy())


@pytest.mark.parametrize("fmt", ["hybrid", "e4m3"])
@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("wgrad", [True, False])
def test_fp8_matmul_values_and_grads_match_jax(fmt, margin, wgrad):
    """out, dx and dw of the port's autograd Function against jax.grad
    through the JAX custom_vjp on the same x [4, 8, 48], w [48, 32] and
    cotangent: the same quantized operands, so only fp32 summation order
    differs (rtol 1e-5, atol 1e-5 of values of order 10)."""
    r = np.random.default_rng(0)
    x, tx = _pair(r, 4, 8, 48)
    w, tw = _pair(r, 48, 32, scale=0.1)
    g = r.standard_normal((4, 8, 32)).astype(np.float32)

    def f(x, w):
        out = jfp8.fp8_matmul(x, w, fmt=fmt, margin=margin, fp8_wgrad=wgrad)
        return jnp.sum(out * g), out

    (_, jout), (jdx, jdw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    out = tfp8.fp8_matmul(tx, tw, fmt=fmt, margin=margin, fp8_wgrad=wgrad)
    out.backward(torch.from_numpy(g))
    for got, want in ((out, jout), (tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_fp8_inf_amax_degrades_to_unit_scale_as_jax():
    """An inf poisons only its own row: amax inf -> scale 1, the inf
    becomes e4m3fn's NaN (ml_dtypes), the other row stays finite and
    equal to JAX's."""
    x = np.array([[1.0, np.inf], [2.0, 3.0]], np.float32)
    w = np.eye(2, dtype=np.float32)
    want = np.asarray(jfp8.fp8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tfp8.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert np.isfinite(got[1]).all() and not np.isfinite(got[0]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("fmt,dt", [("e4m3", ml_dtypes.float8_e4m3fn),
                                    ("e5m2", ml_dtypes.float8_e5m2)])
def test_fp8_cast_rule_matches_ml_dtypes(fmt, dt):
    """The quantize step element for element against ml_dtypes' cast
    (the JAX package's dtypes): the amax element lands on the format's
    max, the overflow band past it (464 in e4m3fn: NaN there, where
    torch's own cast saturates), +-inf, NaN, subnormals; exact."""
    tdt = tfp8.E4M3 if fmt == "e4m3" else tfp8.E5M2
    fmax = tfp8._FMAX[tdt]
    vals = np.array([1.0, -1.0, 0.5, 1e-9, 0.0, 448.0, 449.0, 463.9, 464.0,
                     465.0, 500.0, 57344.0, 61440.0, 1e6, np.inf, -np.inf,
                     np.nan, 3.3e-3], np.float32)
    amax = np.float32(np.nanmax(np.abs(vals[:4])))
    s = np.float32(fmax) / amax
    scaled = vals * s
    scaled[5:] = vals[5:]                   # the edge values as they are
    want = scaled.astype(dt).astype(np.float32)
    got = tfp8._q(torch.from_numpy(scaled), torch.tensor(1.0),
                  tdt).float().numpy()
    np.testing.assert_array_equal(got, want)
    # x * s at |x| = amax lands exactly on the format's max
    t = torch.from_numpy(vals[:4])
    sc = tfp8._scale(tfp8._amax(t, ()), fmax, 0)
    assert float(tfp8._q(t, sc, tdt).float().abs().max()) == fmax


def test_fp8_flags_map_as_the_jax_cli():
    """--fp8_hybrid / --fp8_e4m3 / --fp8_margin / --no_fp8_wgrad reach
    the model config; both formats together is the JAX CLI's error."""
    base = ["--model_name", "tiny", "--fp32"]
    cfg = arguments.args_to_run_config(arguments.parse_args(
        base + ["--fp8_hybrid", "--fp8_margin", "2", "--no_fp8_wgrad"]))
    assert (cfg.model.fp8_format, cfg.model.fp8_margin,
            cfg.model.fp8_wgrad) == ("hybrid", 2, False)
    cfg = arguments.args_to_run_config(arguments.parse_args(
        base + ["--fp8_e4m3"]))
    assert (cfg.model.fp8_format, cfg.model.fp8_margin,
            cfg.model.fp8_wgrad) == ("e4m3", 0, True)
    with pytest.raises(ValueError, match="both fp8 e4m3 and hybrid"):
        arguments.args_to_run_config(arguments.parse_args(
            base + ["--fp8_e4m3", "--fp8_hybrid"]))
    with pytest.raises(ValueError, match="fp8_format"):
        tconfig.ModelConfig(num_layers=1, hidden_size=16,
                            num_attention_heads=2, vocab_size=32,
                            seq_length=8, fp8_format="e5m2").validate()


KW = dict(vocab_size=128, seq_length=32, hidden_size=64, num_layers=2,
          num_attention_heads=4, ffn_hidden_size=128,
          params_dtype="float32")
STEPS = 10


def _jax_losses(jcfg, jparams, batch):
    opt = jconfig.OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    state = jopt.init_train_state(opt, jparams)
    step_fn = jopt.make_optimizer_step(opt, train_iters=STEPS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def one(state):
        loss, grads = jax.value_and_grad(
            lambda p: j_lm_loss(jcfg, p, jb)[0])(state.params)
        state, _ = step_fn(state, grads)
        return state, loss

    out = []
    for _ in range(STEPS):
        state, loss = one(state)
        out.append(float(loss))
    return out


def _torch_losses(tcfg, jparams, batch):
    opt = tconfig.OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    params = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    for _, leaf in topt.leaf_paths(params):
        leaf.requires_grad_(True)
    state = topt.init_train_state(opt, params)
    step = topt.make_optimizer_step(opt, STEPS)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for _ in range(STEPS):
        loss, _ = lm_loss(tcfg, state.params, tb)
        loss.backward()
        grads = topt.tree_map(lambda p: p.grad.detach().clone(),
                              state.params)
        for _, p in topt.leaf_paths(state.params):
            p.grad = None
        state, _ = step(state, grads)
        out.append(float(loss.detach()))
    return out


def test_ten_fp8_steps_track_jax_and_stay_within_5pct_of_bf16():
    """The JAX fp8 test's tiny llama (2 layers, h 64, S 32, fp32 params,
    Adam lr 1e-3) for ten steps from JAX's init on one seeded batch:
    the port's hybrid and e4m3 losses against JAX's fp8 losses (rtol
    3e-4; 9.7e-5 measured: a product's operand an fp32 ulp apart can
    round to the other side of an fp8 step), every fp8 loss within a
    relative 5% of the plain run's (the JAX test's contract), finite, and
    falling."""
    jbase = j_presets.tiny(**KW)
    jparams = j_init_params(jbase, jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    batch = {"tokens": r.integers(0, 128, (4, 32)).astype(np.int64),
             "labels": r.integers(0, 128, (4, 32)).astype(np.int64),
             "loss_mask": np.ones((4, 32), np.float32)}
    plain = _torch_losses(presets.tiny(**KW), jparams, batch)
    for fmt in ("hybrid", "e4m3"):
        got = _torch_losses(presets.tiny(**KW, fp8_format=fmt), jparams,
                            batch)
        want = _jax_losses(dataclasses.replace(jbase, fp8_format=fmt),
                           jparams, batch)
        np.testing.assert_allclose(got, want, rtol=3e-4, err_msg=fmt)
        assert all(np.isfinite(got)) and got[-1] < got[0], (fmt, got)
        for a, b in zip(got, plain):
            assert abs(a - b) / b < 0.05, (fmt, a, b)
