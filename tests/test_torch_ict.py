"""The port's ICT biencoder (models/biencoder.py, data/ict_dataset.py,
tools/pretrain_ict.py) against the JAX package's, on the CPU at the JAX
tests' tiny size (2 layers, h 32, 4 heads, vocab 96, S 32, fp32),
separate and shared towers, with the JAX tree carried across through
biencoder_params_from_numpy. Tolerances: embeddings 1e-4 max abs, losses
and top-k accuracies 1e-5 relative, gradients 1e-4 relative to each
leaf's norm, dataset items bit for bit."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import numpy as np
import pytest
import torch

from megatron_tpu.data.ict_dataset import ICTDataset as JICTDataset
from megatron_tpu.data.indexed_dataset import make_dataset as j_make_dataset
from megatron_tpu.models import biencoder as jbi
from megatron_tpu_torch.data.ict_dataset import ICTDataset
from megatron_tpu_torch.data.indexed_dataset import make_dataset
from megatron_tpu_torch.models import biencoder as bi

from _torch_encoder_helpers import (
    assert_aux_close, assert_grads_close, grads, jax_batch, jax_reference,
    sentence_corpus, titles_corpus, torch_batch,
)

KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
          vocab_size=96, seq_length=32, params_dtype="float32")


def _batch(seed=0, b=6):
    rng = np.random.default_rng(seed)
    qmask = (np.arange(32)[None] < rng.integers(6, 16, (b, 1))).astype(
        np.float32)
    cmask = (np.arange(32)[None] < rng.integers(16, 33, (b, 1))).astype(
        np.float32)
    return {"query_tokens": rng.integers(0, 96, (b, 32)).astype(np.int64),
            "query_pad_mask": qmask,
            "context_tokens": rng.integers(0, 96, (b, 32)).astype(np.int64),
            "context_pad_mask": cmask}


@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_biencoder_embed_loss_and_grads_match_jax(shared):
    jc = jbi.biencoder_config(**KW, hidden_dropout=0.0,
                              attention_dropout=0.0)
    tc = bi.biencoder_config(**KW)
    jparams = jbi.biencoder_init_params(jc, jax.random.PRNGKey(2),
                                        ict_head_size=16, shared=shared)
    tparams = bi.biencoder_params_from_numpy(jax.device_get(jparams), tc,
                                             device="cpu")
    b = _batch()
    jb, tb = jax_batch(b), torch_batch(b)
    tower = "shared" if shared else "context"

    je, (_, jaux), jgrads = jax_reference(
        lambda p, b: jbi.embed_text(jc, p[tower], b["context_tokens"],
                                    b["context_pad_mask"] > 0),
        lambda p, b: jbi.biencoder_loss(jc, p, b, score_scaling=True,
                                        topk=(1, 3)), jparams, jb)
    with torch.no_grad():
        te = bi.embed_text(tc, tparams[tower], tb["context_tokens"],
                           tb["context_pad_mask"] > 0)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-4)

    _, taux, tgrads = grads(
        lambda p: bi.biencoder_loss(tc, p, tb, score_scaling=True,
                                    topk=(1, 3)), tparams)
    assert_aux_close(taux, jaux)
    assert_grads_close(tgrads, jgrads)


def test_ict_dataset_items_match_jax_bitwise(tmp_path):
    blocks = sentence_corpus(str(tmp_path / "blocks"), vocab=90, lo=4, hi=9)
    titles = titles_corpus(str(tmp_path / "titles"), vocab=90)
    for use_titles in (True, False):
        kw = dict(num_samples=16, max_seq_length=32, cls_token=1,
                  sep_token=2, pad_token=0, seed=3, use_titles=use_titles)
        ours = ICTDataset(make_dataset(blocks), make_dataset(titles), **kw)
        theirs = JICTDataset(j_make_dataset(blocks), j_make_dataset(titles),
                             **kw)
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_pretrain_ict_runs_one_microbatch(tmp_path):
    """tools/pretrain_ict end to end at tiny size with titles and a saved
    checkpoint: each step is one microbatch of the whole global batch
    (fixed_num_microbatches=1), whose in-batch softmax over 4 rows starts
    near ln 4; load_biencoder_params restores the towers bit for bit."""
    from megatron_tpu_torch.tools import pretrain_ict

    blocks = sentence_corpus(str(tmp_path / "blocks"), n_docs=16, vocab=90,
                             lo=4, hi=9)
    titles = titles_corpus(str(tmp_path / "titles"), n_docs=16, vocab=90)
    argv = ["--num_layers", "2", "--hidden_size", "32",
            "--num_attention_heads", "4", "--vocab_size", "96",
            "--make_vocab_size_divisible_by", "32", "--seq_length", "32",
            "--fp32", "--micro_batch_size", "1", "--global_batch_size", "4",
            "--train_iters", "3", "--log_interval", "1", "--lr", "1e-3",
            "--data_path", blocks, "--titles_data_path", titles,
            "--ict_head_size", "16", "--retriever_score_scaling",
            "--cls_token_id", "1", "--sep_token_id", "2",
            "--pad_token_id", "0", "--save", str(tmp_path / "ck"),
            "--device", "cpu"]
    loop = pretrain_ict.main(argv, log=lambda m: None)
    assert loop.iteration == 3 and len(loop.history) == 3
    assert list(loop._step_cache) == [1]
    assert abs(loop.history[0]["lm_loss"] - np.log(4)) < 0.2
    assert all(np.isfinite(h["lm_loss"]) for h in loop.history)

    tc = loop.cfg.model
    got = bi.load_biencoder_params(tc, str(tmp_path / "ck"), 16, False,
                                   device="cpu")
    for (k, a), (_, b) in zip(
            sorted(_flat(got).items()),
            sorted(_flat(loop.state.params).items())):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="one process per rank"):
        pretrain_ict.main(argv + ["--tensor_model_parallel_size", "2"])


def _flat(tree):
    from megatron_tpu_torch.training.optimizer import leaf_paths

    return dict(leaf_paths(tree))
