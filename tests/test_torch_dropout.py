"""Dropout in the port (parallel/random.py and its sites) against the
JAX package, on the CPU at tiny widths (the decoder: 2 layers, h 64, 4
heads over 2 kv heads, vocab 96, S 32; the encoders: 2 layers, h 32,
fp32), the same weights on both sides through params_from_numpy.

The JAX side draws its masks with its own keys; the port gets the
masks of the JAX package along its key paths (_torch_jax_masks.py), so
the two compute the same function. Tolerances are the matching
no-dropout parity tests': logits 1e-4 absolute; losses 1e-4 absolute
(the decoder, test_torch_train.py) or 1e-5 relative (the encoders);
gradients 1e-5 absolute + 1e-4 relative a leaf (the decoder) or 1e-4 of
each leaf's norm (the encoders, _torch_encoder_helpers); the TrainLoop's
logged losses 1e-5 relative. The default mask source is held to its
sampling error (4 sigma) and to its determinism."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.arguments import build_parser as j_build_parser
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import biencoder as jbi
from megatron_tpu.models import classification as jcls
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models import t5 as jt5
from megatron_tpu.models.language_model import (
    _layer_dropout_rates as j_rates, lm_forward as j_lm_forward,
    lm_loss as j_lm_loss,
)
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.training.pretrain import TrainLoop as JTrainLoop
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.arguments import (
    args_to_run_config, encoder_model_kwargs, parse_args,
)
from megatron_tpu_torch.models import bert, biencoder as bi
from megatron_tpu_torch.models import classification as cls
from megatron_tpu_torch.models import presets, t5
from megatron_tpu_torch.models.language_model import (
    _layer_dropout_rates, lm_forward, lm_loss,
)
from megatron_tpu_torch.models.params import init_params, params_from_numpy
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.parallel.random import (
    RngStreams, default_mask_source, keep_mask,
)
from megatron_tpu_torch.training import optimizer as topt
from megatron_tpu_torch.training.pretrain import TrainLoop

from _torch_encoder_helpers import (
    assert_aux_close, assert_grads_close, grads, jax_batch, jax_reference,
    torch_batch,
)
from _torch_jax_masks import jax_key, jax_mask_source

KW = dict(vocab_size=96, seq_length=32)
DROP = dict(hidden_dropout=0.1, attention_dropout=0.1)
ENC = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
           vocab_size=96, seq_length=24, params_dtype="float32")


def _key(seed=7, step=3, micro=1, source=jax_mask_source):
    """A microbatch's key path, as the train step derives it."""
    return RngStreams(seed, mask_source=source).dropout(step).fold_in(micro)


def _lm_batch(seed=1, b=2, s=32, v=96):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, v, (b, s)).astype(np.int32),
            "labels": rng.integers(0, v, (b, s)).astype(np.int32),
            "loss_mask": (rng.random((b, s)) < 0.8).astype(np.float32)}


def _tparams(tcfg, jparams):
    p = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    for _, leaf in topt.leaf_paths(p):
        leaf.requires_grad_(True)
    return p


def _assert_tree_close(tgrads, jgrads, atol=1e-5, rtol=1e-4):
    tf = dict(topt.leaf_paths(tgrads))
    jf = dict(topt.leaf_paths(jax.device_get(jgrads)))
    assert tf.keys() == jf.keys()
    for k in tf:
        np.testing.assert_allclose(tf[k].detach().numpy(), np.asarray(jf[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("hd,lima,L", [(0.3, True, 4), (0.1, False, 3),
                                       (0.1, True, 1), (0.25, True, 5)])
def test_layer_dropout_rates_equal_jax(hd, lima, L):
    """The LIMA ramp hidden_dropout * l / (L - 1) in float32, bit for
    bit (the first case is the JAX package's own test_model.py one)."""
    t = _layer_dropout_rates(presets.tiny(hidden_dropout=hd,
                                          lima_dropout=lima, num_layers=L))
    j = np.asarray(j_rates(j_presets.tiny(hidden_dropout=hd,
                                          lima_dropout=lima, num_layers=L)))
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    if lima and L == 4:
        np.testing.assert_allclose(t, [0.0, 0.1, 0.2, 0.3], atol=1e-6)


@pytest.mark.parametrize("lima", [False, True], ids=["flat", "lima"])
def test_lm_forward_and_loss_with_dropout_equal_jax(lima):
    """lm_forward's logits and lm_loss with every gradient, hidden and
    attention dropout 0.1, with and without the LIMA ramp."""
    jcfg = j_presets.tiny(**KW, **DROP, lima_dropout=lima)
    tcfg = presets.tiny(**KW, **DROP, lima_dropout=lima)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    batch = _lm_batch()
    key = _key()
    jk = jax_key(key)
    jlogits, (jl, _), jg = jax_reference(
        lambda p, b: j_lm_forward(jcfg, p, b["tokens"], dropout_key=jk),
        lambda p, b: j_lm_loss(jcfg, p, b, dropout_key=jk), jparams,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = _tparams(tcfg, jparams)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tlogits = lm_forward(tcfg, params, tb["tokens"], dropout_key=key)
        plain = lm_forward(tcfg, params, tb["tokens"])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    assert float((tlogits - plain).abs().max()) > 1e-2   # masks applied

    tl, _ = lm_loss(tcfg, params, tb, dropout_key=key)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-4)
    _assert_tree_close(topt.tree_map(lambda p: p.grad, params), jg)


def _bert_batch(seed=0, b=4, s=24, v=96):
    rng = np.random.default_rng(seed)
    pad = np.ones((b, s), np.float32)
    pad[1, 15:] = 0.0
    pad[3, 9:] = 0.0
    return {"tokens": rng.integers(0, v, (b, s)).astype(np.int64),
            "padding_mask": pad,
            "tokentype_ids": (np.arange(s)[None] >= rng.integers(
                4, s - 4, (b, 1))).astype(np.int64),
            "labels": rng.integers(0, v, (b, s)).astype(np.int64),
            "loss_mask": (rng.random((b, s)) < 0.3).astype(np.float32) * pad,
            "is_random": rng.integers(0, 2, (b,)).astype(np.int64)}


def test_bert_loss_and_grads_at_the_default_dropout_equal_jax():
    """BERT at both packages' default config (hidden and attention
    dropout 0.1): the MLM + SOP loss, its aux and every gradient."""
    jc, tc = jbert.bert_config(**ENC), bert.bert_config(**ENC)
    assert (tc.hidden_dropout, tc.attention_dropout) == (
        jc.hidden_dropout, jc.attention_dropout) == (0.1, 0.1)
    jparams = j_init_params(jc, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.device_get(jparams), tc, device="cpu")
    b = _bert_batch()
    key = _key(step=0, micro=0)
    jk = jax_key(key)
    _, (_, jaux), jgrads = jax_reference(
        lambda p, b: jbert.bert_loss(jc, p, b, dropout_key=jk)[0],
        lambda p, b: jbert.bert_loss(jc, p, b, dropout_key=jk), jparams,
        jax_batch(b))
    _, taux, tgrads = grads(
        lambda p: bert.bert_loss(tc, p, torch_batch(b), dropout_key=key),
        tparams)
    assert_aux_close(taux, jaux)
    assert_grads_close(tgrads, jgrads)
    plain, _ = bert.bert_loss(tc, tparams, torch_batch(b))
    assert abs(float(plain) - float(jaux["loss"])) > 1e-4


def _cls_batch(seed, shape):
    rng = np.random.default_rng(seed)
    mask = (np.arange(24) < rng.integers(8, 25, shape)[..., None]).astype(
        np.float32)
    return {"tokens": rng.integers(5, 96, shape + (24,)).astype(np.int64),
            "padding_mask": mask,
            "tokentype_ids": (np.arange(24) >= rng.integers(
                3, 12, shape)[..., None]).astype(np.int64),
            "label": rng.integers(0, 3 if len(shape) == 1 else 4,
                                  shape[:1]).astype(np.int64)}


@pytest.mark.parametrize("num_classes,shape", [(3, (4,)), (1, (2, 4))],
                         ids=["classification", "multichoice"])
def test_classification_losses_with_dropout_equal_jax(num_classes, shape):
    """classification_loss (the pooled state's dropout under
    fold_in(0xC1A55) on top of the encoder's), on a classification and
    a multiple-choice batch."""
    jc = jcls.classification_config(**ENC)
    tc = cls.classification_config(**ENC)
    jparams = jcls.cls_init_params(jc, jax.random.PRNGKey(num_classes),
                                   num_classes=num_classes)
    tparams = cls.cls_params_from_numpy(jax.device_get(jparams), tc,
                                        device="cpu")
    b = _cls_batch(num_classes, shape)
    key = _key(step=2, micro=0)
    jk = jax_key(key)
    _, (_, jaux), jgrads = jax_reference(
        lambda p, b: jcls.classification_logits(jc, p, b, dropout_key=jk),
        lambda p, b: jcls.classification_loss(jc, p, b, dropout_key=jk),
        jparams, jax_batch(b))
    _, taux, tgrads = grads(
        lambda p: cls.classification_loss(tc, p, torch_batch(b),
                                          dropout_key=key), tparams)
    assert_aux_close(taux, jaux)
    assert_grads_close(tgrads, jgrads)


def test_biencoder_loss_with_dropout_equals_jax():
    """The ICT towers, each under its half of the key's split."""
    kw = dict(ENC, seq_length=32)
    jc, tc = jbi.biencoder_config(**kw), bi.biencoder_config(**kw)
    jparams = jbi.biencoder_init_params(jc, jax.random.PRNGKey(2),
                                        ict_head_size=16, shared=False)
    tparams = bi.biencoder_params_from_numpy(jax.device_get(jparams), tc,
                                             device="cpu")
    rng = np.random.default_rng(4)
    b = {"query_tokens": rng.integers(0, 96, (6, 32)).astype(np.int64),
         "query_pad_mask": (np.arange(32)[None] < rng.integers(
             6, 16, (6, 1))).astype(np.float32),
         "context_tokens": rng.integers(0, 96, (6, 32)).astype(np.int64),
         "context_pad_mask": (np.arange(32)[None] < rng.integers(
             16, 33, (6, 1))).astype(np.float32)}
    key = _key(step=1, micro=0)
    jk = jax_key(key)
    _, (_, jaux), jgrads = jax_reference(
        lambda p, b: jbi.biencoder_loss(jc, p, b, dropout_key=jk)[0],
        lambda p, b: jbi.biencoder_loss(jc, p, b, dropout_key=jk,
                                        score_scaling=True, topk=(1, 3)),
        jparams, jax_batch(b))
    _, taux, tgrads = grads(
        lambda p: bi.biencoder_loss(tc, p, torch_batch(b), score_scaling=True,
                                    topk=(1, 3), dropout_key=key), tparams)
    assert_aux_close(taux, jaux)
    assert_grads_close(tgrads, jgrads)


def _losses(logs):
    return [float(m.group(1)) for m in
            (re.search(r"lm loss: ([0-9.e+-]+)", line) for line in logs)
            if m]


def test_five_trainloop_steps_with_dropout_equal_the_jax_trainloop():
    """Five TrainLoop steps of the tiny decoder at hidden and attention
    dropout 0.1 with the LIMA ramp, two microbatches a step: the JAX
    loop (micro-batch 1 over its 8 fake devices) and the port's (micro-
    batch 8) draw the same masks for step s, microbatch i; the logged
    losses within 1e-5 relative and the final params within the
    five-step parity's 1e-4."""
    model = dict(KW, **DROP, lima_dropout=True)
    train = dict(global_batch_size=16, train_iters=5, log_interval=1, seed=5)
    opt = dict(lr=1e-3, lr_decay_style="constant")
    jcfg = jconfig.RunConfig(
        model=j_presets.tiny(**model), optimizer=jconfig.OptimizerConfig(
            **opt), training=jconfig.TrainingConfig(micro_batch_size=1,
                                                    **train))
    tcfg = tconfig.RunConfig(
        model=presets.tiny(**model), optimizer=tconfig.OptimizerConfig(
            **opt), training=tconfig.TrainingConfig(micro_batch_size=8,
                                                    **train))
    batches = [_lm_batch(seed=s, b=16) for s in range(5)]

    def factory(consumed, gbs):
        return iter(batches[consumed // gbs:])

    jlogs, tlogs = [], []
    jloop = JTrainLoop(jcfg, log=jlogs.append)
    jinit = jax.device_get(jloop.state.params)
    jloop.train(factory)
    tloop = TrainLoop(
        tcfg, log=tlogs.append, device="cpu",
        init_params_fn=lambda mc, seed, dev: params_from_numpy(
            jinit, mc, device=dev),
        mask_source=jax_mask_source)
    tloop.train(lambda c, g: iter([{k: v.astype(np.int64)
                                    if v.dtype == np.int32 else v
                                    for k, v in b.items()}
                                   for b in batches[c // g:]]))
    jl, tl = _losses(jlogs), _losses(tlogs)
    assert len(jl) == len(tl) == 5
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_tree_close(tloop.state.params, jloop.state.params, atol=1e-4)


@pytest.mark.parametrize("policy", ["selective", "full", "uniform:2"])
def test_recompute_draws_the_same_masks(policy):
    """Activation recompute replays each forward under the same key
    paths: with the default mask source the loss and every gradient
    are bitwise those of the run without recompute."""
    tcfg = presets.tiny(**KW, **DROP, lima_dropout=True)
    params0 = init_params(tcfg, 0, device="cpu")
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in _lm_batch(2).items()}
    key = _key(source=None)
    out = {}
    for p in ("none", policy):
        params = topt.tree_map(lambda x: x.detach().clone()
                               .requires_grad_(True), params0)
        loss, _ = lm_loss(tcfg, params, tb, recompute=p, dropout_key=key)
        loss.backward()
        out[p] = (float(loss), [g.grad for _, g in topt.leaf_paths(params)])
    assert out[policy][0] == out["none"][0]
    for a, b in zip(out[policy][1], out["none"][1]):
        assert torch.equal(a, b)


def test_t5_with_dropout_set_equals_the_jax_t5():
    """T5 applies no dropout in either package, whatever the config:
    the port's loss with a key and dropout 0.1 equals the JAX T5's and
    its own without a key, bit for bit."""
    kw = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
              vocab_size=96, seq_length=24, decoder_seq_length=12,
              params_dtype="float32", **DROP)
    jc, tc = jt5.t5_config(**kw), t5.t5_config(**kw)
    jparams = jt5.t5_init_params(jc, jax.random.PRNGKey(1))
    tparams = t5.t5_params_from_numpy(jax.device_get(jparams), tc,
                                      device="cpu")
    rng = np.random.default_rng(0)
    b = {"enc_tokens": rng.integers(0, 96, (3, 24)).astype(np.int64),
         "enc_padding_mask": np.ones((3, 24), np.float32),
         "dec_tokens": rng.integers(0, 96, (3, 12)).astype(np.int64),
         "labels": rng.integers(0, 96, (3, 12)).astype(np.int64),
         "loss_mask": np.ones((3, 12), np.float32)}
    jl, _ = jax.jit(lambda p, b: jt5.t5_loss(jc, p, b))(jparams, jax_batch(b))
    with torch.no_grad():
        tl, _ = t5.t5_loss(tc, tparams, torch_batch(b), dropout_key=_key())
        plain, _ = t5.t5_loss(tc, tparams, torch_batch(b))
    assert float(tl) == float(plain)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_attention_dropout_under_context_parallelism_raises():
    """The JAX package warns and runs its dense path over the gathered
    sequence; the port refuses (ROADMAP.md, deliberate departures)."""
    q = torch.zeros(1, 8, 4, 16)
    ctx = types.SimpleNamespace(cp=2, cp_rank=0)
    for impl in ("xla", "pallas", "ring", "ulysses"):
        with pytest.raises(ValueError, match="context parallelism"):
            attention(q, q, q, dropout=0.1, dropout_key=_key(source=None),
                      impl=impl, context=ctx)
    with pytest.raises(ValueError, match="requires a key"):
        attention(q, q, q, dropout=0.1)


def test_default_source_keep_rate_and_determinism():
    """The generator source keeps 1 - rate of the positions within 4
    sigma, draws the same mask for the same path (a fresh generator
    each time), another for another path, and a rank's block of the
    logical mask under a mesh."""
    key = _key(source=None)
    n, rate = (64, 4096), 0.1
    m = default_mask_source(key, n, rate, torch.device("cpu"))
    size = n[0] * n[1]
    sigma = math.sqrt(rate * (1 - rate) / size)
    assert abs(float(m.float().mean()) - (1 - rate)) < 4 * sigma
    assert torch.equal(m, default_mask_source(key, n, rate,
                                              torch.device("cpu")))
    for other in (key.fold_in(0), key.split(2)[1],
                  dataclasses.replace(key, step=key.step + 1)):
        assert not torch.equal(m, default_mask_source(
            other, n, rate, torch.device("cpu")))
    assert key.split(3)[0] == key.split(3)[0]
    assert bool(default_mask_source(key, (4, 8), 0.0, "cpu").all())
    # a data rank's rows, a sequence-parallel rank's piece, a tensor
    # rank's kv heads of the logical mask
    mesh = types.SimpleNamespace(world_size=4, dp=2, dp_rank=1, cp=1,
                                 cp_rank=0, tp=2, tp_rank=1,
                                 sequence_parallel=True)
    full = key.draw((4, 8, 6), rate, "cpu")
    np.testing.assert_array_equal(
        keep_mask(key, (2, 4, 6), rate, "cpu", mesh), full[2:4, 4:8])
    probs = key.draw((4, 4, 2, 8, 8), rate, "cpu")
    np.testing.assert_array_equal(
        keep_mask(key, (2, 2, 2, 8, 8), rate, "cpu", mesh, "probs"),
        probs[2:4, 2:4])
    np.testing.assert_array_equal(
        keep_mask(key, (2, 6), rate, "cpu", mesh, "rows"),
        key.draw((4, 6), rate, "cpu")[2:4])


def test_dropout_flags_carry_the_jax_defaults_to_every_model_path():
    """--hidden_dropout, --attention_dropout and --lima_dropout: the JAX
    CLI's defaults; a preset and an encoder config take them."""
    jargs = j_build_parser().parse_args([])
    targs = parse_args(["--model_name", "tiny"])
    for flag in ("hidden_dropout", "attention_dropout", "lima_dropout"):
        assert getattr(targs, flag) == getattr(jargs, flag), flag
    targs = parse_args(["--model_name", "tiny", "--hidden_dropout", "0.2",
                        "--attention_dropout", "0.05", "--lima_dropout"])
    model = args_to_run_config(targs).model
    assert (model.hidden_dropout, model.attention_dropout,
            model.lima_dropout) == (0.2, 0.05, True)
    targs = parse_args(["--num_layers", "2", "--hidden_size", "32",
                        "--num_attention_heads", "4", "--vocab_size", "96"])
    assert bert.bert_config(**encoder_model_kwargs(targs)).hidden_dropout \
        == 0.0


def test_a_resumed_dropout_run_equals_the_uninterrupted_one(tmp_path):
    """Checkpoints keep only the seed and the step: a run saved at step 2
    and resumed draws the masks of the uninterrupted run, so its
    losses and final params are bitwise the uninterrupted run's."""
    def run(iters, save=None, load=None):
        cfg = tconfig.RunConfig(
            model=presets.tiny(**KW, **DROP),
            optimizer=tconfig.OptimizerConfig(lr=1e-3,
                                              lr_decay_style="constant"),
            training=tconfig.TrainingConfig(
                micro_batch_size=2, global_batch_size=4, train_iters=iters,
                log_interval=1, seed=9, save=save, load=load,
                save_interval=2 if save else None))
        logs = []
        loop = TrainLoop(cfg, log=logs.append, device="cpu")
        batches = [_lm_batch(seed=s, b=4) for s in range(4)]
        loop.train(lambda c, g: iter([{k: v.astype(np.int64)
                                       if v.dtype == np.int32 else v
                                       for k, v in b.items()}
                                      for b in batches[c // g:]]))
        return _losses(logs), loop

    whole, a = run(4)
    run(2, save=str(tmp_path / "ck"))
    tail, b = run(4, load=str(tmp_path / "ck"))
    assert tail == whole[2:]
    for (k, x), (_, y) in zip(topt.leaf_paths(a.state.params),
                              topt.leaf_paths(b.state.params)):
        assert torch.equal(x, y), k
