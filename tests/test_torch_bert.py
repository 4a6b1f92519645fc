"""The port's BERT (models/bert.py, data/bert_dataset.py,
tools/pretrain_bert.py and TrainLoop's loss_fn hook) against the JAX
package's, on the CPU at the JAX tests' tiny size (2 layers, h 32, 4
heads, vocab 128, S 32, fp32), with the JAX init carried across through
params_from_numpy. Tolerances: logits 1e-4 max abs, losses 1e-5
relative, gradients 1e-4 relative to each leaf's norm, dataset items bit
for bit, the TrainLoop's three losses 1e-5 relative."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import re
import types

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.data.bert_dataset import BertDataset as JBertDataset
from megatron_tpu.data.indexed_dataset import make_dataset as j_make_dataset
from megatron_tpu.models import bert as jbert
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.training.pretrain import TrainLoop as JTrainLoop
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.data.bert_dataset import BertDataset
from megatron_tpu_torch.data.indexed_dataset import make_dataset
from megatron_tpu_torch.models import bert
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.training.pretrain import TrainLoop

from _torch_encoder_helpers import (
    assert_aux_close, assert_grads_close, grads, jax_batch, jax_reference,
    sentence_corpus, torch_batch,
)

KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
          vocab_size=128, seq_length=32, params_dtype="float32")


def _jcfg(**kw):
    return jbert.bert_config(**KW, hidden_dropout=0.0, attention_dropout=0.0,
                             **kw)


def _batch(seed=0, b=4, s=32, v=128):
    rng = np.random.default_rng(seed)
    pad = np.ones((b, s), np.float32)
    pad[1, 20:] = 0.0
    pad[3, 9:] = 0.0
    return {
        "tokens": rng.integers(0, v, (b, s)).astype(np.int64),
        "padding_mask": pad,
        "tokentype_ids": (np.arange(s)[None] >= rng.integers(
            4, s - 4, (b, 1))).astype(np.int64),
        "labels": rng.integers(0, v, (b, s)).astype(np.int64),
        "loss_mask": (rng.random((b, s)) < 0.2).astype(np.float32) * pad,
        "is_random": rng.integers(0, 2, (b,)).astype(np.int64),
    }


@pytest.mark.parametrize("binary_head", [True, False])
def test_bert_forward_loss_and_grads_match_jax(binary_head):
    """bert_forward's logits (MLM and binary), bert_loss's losses and
    jax.grad of the same loss, with token types and padded rows; the
    tree is the binary-head config's (the MLM head's leaves live there)
    and the forward's config drops the binary head or not."""
    jc_tree = _jcfg()
    jc = _jcfg(bert_binary_head=binary_head)
    tc = bert.bert_config(**KW, bert_binary_head=binary_head)
    jparams = j_init_params(jc_tree, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.device_get(jparams),
                                bert.bert_config(**KW), device="cpu")
    b = _batch()
    jb, tb = jax_batch(b), torch_batch(b)

    (jl, jbin), (_, jaux), jgrads = jax_reference(
        lambda p, b: jbert.bert_forward(jc, p, b["tokens"],
                                        b["padding_mask"] > 0,
                                        tokentype_ids=b["tokentype_ids"]),
        lambda p, b: jbert.bert_loss(jc, p, b), jparams, jb)
    with torch.no_grad():
        tl, tbin = bert.bert_forward(tc, tparams, tb["tokens"],
                                     tb["padding_mask"] > 0,
                                     tokentype_ids=tb["tokentype_ids"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    if binary_head:
        np.testing.assert_allclose(tbin.numpy(), np.asarray(jbin), rtol=0,
                                   atol=1e-4)
    else:
        assert tbin is None and jbin is None

    _, taux, tgrads = grads(lambda p: bert.bert_loss(tc, p, tb), tparams)
    assert_aux_close(taux, jaux)
    assert_grads_close(tgrads, jgrads)


def test_bert_dataset_items_match_jax_bitwise(tmp_path):
    prefix = str(tmp_path / "sents")
    sentence_corpus(prefix)
    kw = dict(num_samples=24, max_seq_length=64, mask_token=4, cls_token=1,
              sep_token=2, pad_token=0, vocab_size=200, seed=3)
    ours = BertDataset(make_dataset(prefix), **kw)
    theirs = JBertDataset(j_make_dataset(prefix), **kw)
    assert len(ours) == len(theirs) > 0
    np.testing.assert_array_equal(ours.mapping, theirs.mapping)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_trainloop_bert_three_steps_match_jax():
    """Three TrainLoop steps of BERT through loss_fn: the JAX loop (its
    global batch of 8 rows is one microbatch over the 8 fake devices)
    and the port's (one microbatch of 8 rows), the same config, init
    and data; the logged losses within 1e-5 relative."""
    train = dict(global_batch_size=8, train_iters=3, log_interval=1, seed=5)
    opt = dict(lr=1e-3, lr_decay_style="constant")
    jcfg = jconfig.RunConfig(
        model=_jcfg(), optimizer=jconfig.OptimizerConfig(**opt),
        training=jconfig.TrainingConfig(micro_batch_size=1, **train))
    # the JAX loss_fn takes no key, so both sides run without dropout
    tcfg = tconfig.RunConfig(
        model=bert.bert_config(**KW, hidden_dropout=0.0,
                               attention_dropout=0.0),
        optimizer=tconfig.OptimizerConfig(**opt),
        training=tconfig.TrainingConfig(micro_batch_size=8, **train))
    batches = [_batch(seed=s, b=8) for s in range(3)]

    def factory(cast):
        def make(consumed, gbs):
            return iter([cast(b) for b in batches[consumed // gbs:]])
        return make

    jlogs, tlogs = [], []
    jloop = JTrainLoop(
        jcfg, log=jlogs.append,
        loss_fn=lambda mc, p, b, key: jbert.bert_loss(mc, p, b))
    jinit = jax.device_get(jloop.state.params)
    jloop.train(factory(lambda b: {k: v.astype(np.int32)
                                   if v.dtype == np.int64 else v
                                   for k, v in b.items()}))
    tloop = TrainLoop(
        tcfg, log=tlogs.append, device="cpu",
        init_params_fn=lambda mc, seed, dev: params_from_numpy(
            jinit, mc, device=dev),
        loss_fn=bert.bert_loss)
    tloop.train(factory(lambda b: b))

    def losses(logs):
        return [float(m.group(1)) for m in
                (re.search(r"lm loss: ([0-9.e+-]+)", line) for line in logs)
                if m]

    jl, tl = losses(jlogs), losses(tlogs)
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tloop.iteration == 3

    # the eval loss is loss_fn's, without a backward, its aux beside it
    ev = tloop.evaluate(iter([batches[0]]), 1)
    with torch.no_grad():
        want, aux = bert.bert_loss(tcfg.model, tloop.state.params,
                                   torch_batch(batches[0]))
    assert ev["lm_loss"] == pytest.approx(float(want), rel=1e-6)
    assert ev["sop_loss"] == pytest.approx(float(aux["sop_loss"]), rel=1e-6)


def test_pretrain_bert_runs_and_refuses_ranks(tmp_path):
    """tools/pretrain_bert end to end at tiny size on a sentence corpus
    the test writes (finite, logged losses, a saved checkpoint), and the
    refusals that stand: a parallel topology outside a launch of one
    process per rank, --no_binary_head (ROADMAP.md item 11c), and a task
    loss at pp > 1 without a pipeline_loss_factory (the JAX loop's)."""
    from megatron_tpu_torch.tools import pretrain_bert

    prefix = str(tmp_path / "sents")
    sentence_corpus(prefix, n_docs=16, vocab=128)
    argv = ["--num_layers", "2", "--hidden_size", "32",
            "--num_attention_heads", "4", "--vocab_size", "128",
            "--seq_length", "32", "--fp32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", "3",
            "--log_interval", "1", "--lr", "1e-3", "--data_path", prefix,
            "--mask_token_id", "4", "--cls_token_id", "1",
            "--sep_token_id", "2", "--pad_token_id", "0",
            "--save", str(tmp_path / "ck"), "--device", "cpu"]
    logs = []
    loop = pretrain_bert.main(argv, log=logs.append)
    assert loop.iteration == 3
    assert len(loop.history) == 3
    assert all(np.isfinite(h["lm_loss"]) for h in loop.history)
    assert (tmp_path / "ck" / "latest_checkpointed_iteration.txt").exists()

    with pytest.raises(ValueError, match="one process per rank"):
        pretrain_bert.main(argv + ["--tensor_model_parallel_size", "2"])
    with pytest.raises(ValueError, match="binary head.*11c"):
        pretrain_bert.main(argv + ["--no_binary_head"])
    cfg = tconfig.RunConfig(model=bert.bert_config(**KW))
    with pytest.raises(ValueError, match="task losses .* would silently "
                       "train unpipelined"):
        TrainLoop(cfg, device="cpu", mesh=types.SimpleNamespace(
            world_size=2, pp=2, cp=1), loss_fn=bert.bert_loss)
