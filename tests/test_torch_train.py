"""The port's training path vs the JAX package, on the CPU in fp32.

Same numpy inputs (and one JAX init_params tree, converted with
params_from_numpy) go through both packages: cross_entropy_loss (mask,
label smoothing, z_loss) value and gradient; lm_loss, plain and chunked,
value and every gradient leaf; the LR / weight-decay schedules; one
optimizer step on the same gradients (weight-decay mask by path name,
clipping, the fp16 loss scaler, a skipped non-finite step); and 5 steps
of make_train_step with 2 microbatches, whose losses and final params
agree within 1e-4 (the gate of tests/test_interop_loop.py's parity
runs: fp32 through two layers, the frameworks sum in different orders).
The port's attention runs attention_impl="pallas", i.e. on the CPU its
flash autograd Function with the kernels' plain forward and backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_loss as j_lm_loss
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.ops.cross_entropy import cross_entropy_loss as j_ce
from megatron_tpu.ops.cross_entropy import vocab_argmax as j_argmax
from megatron_tpu.training import optimizer as jopt
from megatron_tpu.training import scheduler as jsched
from megatron_tpu.training.train_step import make_train_step as j_make_step
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_loss
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.ops.cross_entropy import (cross_entropy_loss,
                                                  vocab_argmax)
from megatron_tpu_torch.training import optimizer as topt
from megatron_tpu_torch.training import scheduler as tsched
from megatron_tpu_torch.training.train_step import make_train_step

ATOL = 1e-4
KW = dict(vocab_size=96, seq_length=32)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.detach().float() if isinstance(tree, torch.Tensor)
                      else jnp.asarray(tree, jnp.float32))


def _assert_tree_close(t, j, atol=ATOL, rtol=1e-4):
    tf, jf = dict(topt.leaf_paths(_np_tree(t))), dict(
        topt.leaf_paths(_np_tree(jax.device_get(j))))
    assert tf.keys() == jf.keys()
    for k in tf:
        np.testing.assert_allclose(tf[k], jf[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_presets.tiny(**KW)
    tcfg = presets.tiny(**KW, attention_impl="pallas")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams


def _tparams(tcfg, jparams, dtype=None):
    p = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu",
                          dtype=dtype)
    for _, leaf in topt.leaf_paths(p):
        leaf.requires_grad_(True)
    return p


def _batch(r, b, s, vocab):
    text = r.integers(0, vocab, size=(b, s + 1))
    mask = (r.random((b, s)) > 0.2).astype(np.float32)
    return {"tokens": text[:, :-1], "labels": text[:, 1:], "loss_mask": mask}


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing,z_loss,masked", [
    (0.0, 0.0, False), (0.0, 0.0, True), (0.1, 0.0, True), (0.1, 1e-3, True),
])
def test_cross_entropy_value_and_grad_match_jax(smoothing, z_loss, masked):
    r = np.random.default_rng(0)
    logits = (3 * r.normal(size=(2, 5, 11))).astype(np.float32)
    targets = r.integers(0, 11, size=(2, 5))
    mask = (r.random((2, 5)) > 0.3).astype(np.float32) if masked else None

    def jf(x):
        return j_ce(x, jnp.asarray(targets),
                    None if mask is None else jnp.asarray(mask),
                    label_smoothing=smoothing, z_loss=z_loss)

    jmean, jper = jf(jnp.asarray(logits))
    jgrad = jax.grad(lambda x: jf(x)[0])(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tmean, tper = cross_entropy_loss(
        x, torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask),
        label_smoothing=smoothing, z_loss=z_loss)
    tmean.backward()
    np.testing.assert_allclose(float(tmean), float(jmean), atol=1e-5)
    np.testing.assert_allclose(tper.detach().numpy(), np.asarray(jper),
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    np.testing.assert_array_equal(vocab_argmax(x).numpy(),
                                  np.asarray(j_argmax(jnp.asarray(logits))))


# ---------------------------------------------------------------------------
# lm_loss and recompute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_lm_loss_and_every_gradient_leaf_match_jax(tiny, ce_chunk):
    jcfg, tcfg, jparams = tiny
    jcfg = dataclasses.replace(jcfg, ce_chunk_size=ce_chunk)
    tcfg = dataclasses.replace(tcfg, ce_chunk_size=ce_chunk)
    batch = _batch(np.random.default_rng(1), 2, 32, 96)
    (jl, _), jg = jax.value_and_grad(
        lambda p: j_lm_loss(jcfg, p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(jparams)
    params = _tparams(tcfg, jparams)
    tl, aux = lm_loss(tcfg, params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    assert float(aux["ntokens"]) == float(batch["loss_mask"].sum())
    _assert_tree_close(topt.tree_map(lambda p: p.grad, params), jg,
                       atol=1e-5)


def test_recompute_policies_give_identical_grads(tiny):
    """none / selective / full recompute run the same arithmetic, so the
    gradients are bitwise equal on the CPU."""
    jcfg, tcfg, jparams = tiny
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(np.random.default_rng(2), 2, 32, 96).items()}
    grads = {}
    for policy in ("none", "selective", "full"):
        params = _tparams(tcfg, jparams)
        loss, _ = lm_loss(tcfg, params, batch, recompute=policy)
        loss.backward()
        grads[policy] = (float(loss), [g.grad.clone() for _, g in
                                       topt.leaf_paths(params)])
    for policy in ("selective", "full"):
        assert grads[policy][0] == grads["none"][0]
        for a, b in zip(grads[policy][1], grads["none"][1]):
            assert torch.equal(a, b), policy
    with pytest.raises(ValueError, match="recompute"):
        lm_loss(tcfg, _tparams(tcfg, jparams), batch, recompute="block:1")


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("style", ["constant", "linear", "cosine",
                                   "inverse-square-root"])
@pytest.mark.parametrize("warmup", [dict(lr_warmup_iters=3),
                                    dict(lr_warmup_fraction=0.25)])
def test_lr_schedule_matches_jax(style, warmup):
    kw = dict(lr=1e-3, min_lr=1e-5, lr_decay_style=style, lr_decay_iters=16,
              **warmup)
    jc, tc = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    for step in range(0, 25):
        np.testing.assert_allclose(
            float(tsched.lr_at_step(tc, step, 20)),
            float(jsched.lr_at_step(jc, step, 20)), rtol=1e-6, atol=1e-12)
    steps = torch.arange(5, dtype=torch.int32)
    assert tsched.lr_at_step(tc, steps, 20).dtype == torch.float32


@pytest.mark.parametrize("style", ["constant", "linear", "cosine"])
def test_wd_schedule_matches_jax(style):
    kw = dict(weight_decay=0.05, start_weight_decay=0.01,
              end_weight_decay=0.1, weight_decay_incr_style=style)
    jc, tc = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    for step in range(0, 14, 3):
        np.testing.assert_allclose(
            float(tsched.wd_at_step(tc, step, 10)),
            float(jsched.wd_at_step(jc, step, 10)), rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _grads_like(tree, r, scale=1.0, poison=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _grads_like(v, r, scale, poison)
        else:
            g = (scale * 0.1 * r.normal(size=np.shape(v))).astype(np.float32)
            if poison and k == "wq":
                g.flat[0] = np.inf
            out[k] = g
    return out


def _state_close(ts, js, atol=1e-6):
    _assert_tree_close(ts.params, js.params, atol=atol, rtol=1e-5)
    _assert_tree_close(ts.mu, js.mu, atol=atol, rtol=1e-5)
    _assert_tree_close(ts.nu, js.nu, atol=atol, rtol=1e-5)
    if js.master is not None:
        _assert_tree_close(ts.master, js.master, atol=atol, rtol=1e-5)
    assert int(ts.step) == int(js.step)
    assert int(ts.nonfinite_streak) == int(js.nonfinite_streak)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_steps_match_jax(tiny, optimizer):
    """Two steps (bias correction at t = 1 and 2) with decoupled weight
    decay — which by path name skips the stacked [L, h] norm scales —
    and a clip that binds."""
    jcfg, tcfg, jparams = tiny
    kw = dict(optimizer=optimizer, lr=1e-2, weight_decay=0.1, clip_grad=0.5,
              lr_warmup_iters=1, lr_decay_style="linear")
    japply = jopt.make_optimizer_step(jconfig.OptimizerConfig(**kw), 10)
    tapply = topt.make_optimizer_step(tconfig.OptimizerConfig(**kw), 10)
    js = jopt.init_train_state(jconfig.OptimizerConfig(**kw), jparams)
    ts = topt.init_train_state(tconfig.OptimizerConfig(**kw),
                               _tparams(tcfg, jparams))
    r = np.random.default_rng(3)
    for _ in range(2):
        g = _grads_like(jax.device_get(jparams), r)
        js, jm = japply(js, jax.tree.map(jnp.asarray, g))
        ts, tm = tapply(ts, topt.tree_map(torch.from_numpy, g))
        _state_close(ts, js)
        for k in ("grad_norm", "lr", "skipped", "skip_streak"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)
    assert not topt._wd_mask("layers/ln1/scale",
                             ts.params["layers"]["ln1"]["scale"])
    assert topt._wd_mask("layers/attn/wq", ts.params["layers"]["attn"]["wq"])


def test_fp16_scaler_and_skipped_step_match_jax(tiny):
    """fp16 params with fp32 masters and the dynamic loss scaler: a good
    step, a non-finite step (skipped on the device: state kept, streak
    and hysteresis advance), then a second non-finite step that backs the
    scale off, then a good step."""
    jcfg, tcfg, jparams = tiny
    kw = dict(lr=1e-3, initial_loss_scale=1024.0, hysteresis=2,
              loss_scale_window=2)
    j16 = jax.tree.map(lambda x: x.astype(jnp.float16), jparams)
    japply = jopt.make_optimizer_step(jconfig.OptimizerConfig(**kw), 10)
    tapply = topt.make_optimizer_step(tconfig.OptimizerConfig(**kw), 10)
    js = jopt.init_train_state(jconfig.OptimizerConfig(**kw), j16,
                               use_fp16_scaler=True)
    ts = topt.init_train_state(
        tconfig.OptimizerConfig(**kw),
        _tparams(tcfg, jparams, dtype=torch.float16), use_fp16_scaler=True)
    r = np.random.default_rng(4)
    for poison in (False, True, True, False):
        g = _grads_like(jax.device_get(jparams), r, scale=float(
            js.scaler.scale), poison=poison)
        js, jm = japply(js, jax.tree.map(jnp.asarray, g))
        ts, tm = tapply(ts, topt.tree_map(torch.from_numpy, g))
        _state_close(ts, js, atol=1e-3)
        assert float(tm["skipped"]) == float(jm["skipped"]) == float(poison)
        assert float(tm["loss_scale"]) == float(jm["loss_scale"])
        assert int(ts.scaler.hysteresis) == int(js.scaler.hysteresis)
        assert int(ts.scaler.growth_tracker) == int(js.scaler.growth_tracker)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_five_train_steps_with_two_microbatches_match_jax(tiny):
    jcfg, tcfg, jparams = tiny
    okw = dict(lr=3e-3, lr_warmup_iters=2, lr_decay_style="cosine",
               weight_decay=0.1, clip_grad=1.0)
    tkw = dict(micro_batch_size=2, global_batch_size=4, train_iters=5,
               recompute_granularity="selective")
    jstep = jax.jit(j_make_step(jcfg, jconfig.OptimizerConfig(**okw),
                                jconfig.TrainingConfig(**tkw), 2))
    tstep = make_train_step(tcfg, tconfig.OptimizerConfig(**okw),
                            tconfig.TrainingConfig(**tkw), 2)
    js = jopt.init_train_state(jconfig.OptimizerConfig(**okw), jparams)
    ts = topt.init_train_state(tconfig.OptimizerConfig(**okw),
                               _tparams(tcfg, jparams))
    r = np.random.default_rng(5)
    for _ in range(5):
        batch = _batch(r, 4, 32, 96)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=ATOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(ts.step) == 5
    _assert_tree_close(ts.params, js.params)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_training_config_fields_and_flops_match_jax():
    """The ported OptimizerConfig / TrainingConfig fields carry the JAX
    package's names and defaults, flops_per_token_fwd its formula, and
    dropout (not ported) is refused loudly."""
    for tcls, jcls in ((tconfig.OptimizerConfig, jconfig.OptimizerConfig),
                       (tconfig.TrainingConfig, jconfig.TrainingConfig)):
        t, j = tcls(), jcls()
        for f in dataclasses.fields(tcls):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for t, j in ((presets.llama2("7B"), j_presets.llama("7B", version=2)),
                 (presets.mistral(), j_presets.mistral()),
                 (presets.tiny(**KW), j_presets.tiny(**KW))):
        assert t.flops_per_token_fwd() == j.flops_per_token_fwd() > 0
        assert t.flops_per_token_fwd(1000) == j.flops_per_token_fwd(1000)
    tiny = presets.tiny(**KW)
    for field in ("hidden_dropout", "attention_dropout"):
        with pytest.raises(ValueError, match="dropout"):
            dataclasses.replace(tiny, **{field: 0.1}).validate()
    with pytest.raises(ValueError, match="ce_chunk_size"):
        dataclasses.replace(tiny, ce_chunk_size=5).validate()
    with pytest.raises(ValueError, match="recompute"):
        tconfig.TrainingConfig(recompute_granularity="block:2").validate()
