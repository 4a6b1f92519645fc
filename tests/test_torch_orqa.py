"""The port's retrieval tools (tools/build_retrieval_index.py,
tasks/orqa.py, tasks/qa_utils.py, tasks/orqa_finetune.py) against the
JAX package's, on the CPU at the JAX tests' tiny size (2 layers, h 32, 4
heads, vocab 96, fp32), the towers' JAX init carried across through
biencoder_params_from_numpy. Tolerances: index embeddings 1e-5 max abs
with block_meta equal, the same top-k ids and hit rates, qa_utils case
for case, orqa_loss and its aux 1e-5 relative with gradients 1e-4 of each
leaf's norm, three finetune_orqa losses and the final evaluation 1e-5
relative."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tasks.orqa as j_orqa
import tasks.orqa_finetune as j_ft
import tasks.qa_utils as j_qa
from megatron_tpu import config as jconfig
from megatron_tpu.data.ict_dataset import ICTDataset as JICTDataset
from megatron_tpu.data.indexed_dataset import make_dataset as j_make_dataset
from megatron_tpu.models import biencoder as jbi
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.data.ict_dataset import ICTDataset
from megatron_tpu_torch.data.indexed_dataset import make_dataset
from megatron_tpu_torch.models import biencoder as bi
from megatron_tpu_torch.tasks import orqa, orqa_finetune as ft, qa_utils
from megatron_tpu_torch.tools import build_retrieval_index as bri
from tools import build_retrieval_index as j_bri

from _torch_encoder_helpers import (
    assert_aux_close, assert_grads_close, grads, jax_batch, jax_reference,
    sentence_corpus, titles_corpus, torch_batch,
)

KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
          vocab_size=96, seq_length=32, params_dtype="float32")
FLAGS = ["--num_layers", "2", "--hidden_size", "32",
         "--num_attention_heads", "4", "--seq_length", "32",
         "--vocab_size", "96", "--make_vocab_size_divisible_by", "32",
         "--fp32", "--ict_head_size", "16", "--cls_token_id", "1",
         "--sep_token_id", "2", "--pad_token_id", "0", "--device", "cpu"]


def _tokenize(text):
    return [int(t) for t in text.split()]


def _detokenize(ids):
    return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def towers():
    jc = jbi.biencoder_config(**KW, hidden_dropout=0.0,
                              attention_dropout=0.0)
    tc = bi.biencoder_config(**KW)
    jp = jbi.biencoder_init_params(jc, jax.random.PRNGKey(3),
                                   ict_head_size=16)
    tp = bi.biencoder_params_from_numpy(jax.device_get(jp), tc, device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("blocks")
    blocks = sentence_corpus(str(tmp / "blocks"), n_docs=12, vocab=96)
    titles = titles_corpus(str(tmp / "titles"), n_docs=12, vocab=96)
    kw = dict(num_samples=None, max_seq_length=32, cls_token=1, sep_token=2,
              pad_token=0, query_in_block_prob=1.0, use_titles=True)
    ours = ICTDataset(make_dataset(blocks), make_dataset(titles), **kw)
    theirs = JICTDataset(j_make_dataset(blocks), j_make_dataset(titles), **kw)
    return tmp, blocks, ours, theirs


@pytest.fixture(scope="module")
def indexes(towers, corpus):
    jc, jp, tc, tp = towers
    _, _, ours, theirs = corpus
    j_emb, j_meta = j_bri.build_index(jc, jp["context"], theirs,
                                      batch_size=8, log=lambda m: None)
    t_emb, t_meta = bri.build_index(tc, tp["context"], ours, batch_size=8,
                                    log=lambda m: None)
    return (j_emb, j_meta), (t_emb, t_meta)


def test_build_index_and_search_equal_jax(indexes):
    (j_emb, j_meta), (t_emb, t_meta) = indexes
    assert t_emb.dtype == np.float32 and t_emb.shape == j_emb.shape
    np.testing.assert_allclose(t_emb, j_emb, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_meta, j_meta)
    queries = j_emb[::3] + 0.01
    t_scores, t_ids = bri.search(t_emb, queries, topk=5)
    j_scores, j_ids = j_bri.search(j_emb, queries, topk=5)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_scores, j_scores, atol=1e-5)


def _questions(corpus, meta, n=6):
    _, blocks, _, _ = corpus
    ds = make_dataset(blocks)
    qs, ans = [], []
    for s, _, _, _ in meta[:n]:
        sent = np.asarray(ds[int(s)], np.int64)
        qs.append(_detokenize(sent))
        ans.append([str(int(sent[0])), _detokenize(sent[1:3])])
    return qs, ans


@pytest.mark.parametrize("match", ["token", "string"])
def test_evaluate_retriever_equal_jax(towers, corpus, indexes, match):
    jc, jp, tc, tp = towers
    (j_emb, j_meta), (t_emb, _) = indexes
    ds = make_dataset(corpus[1])

    def block_tokens(bid):
        s, e = int(j_meta[bid][0]), int(j_meta[bid][1])
        return np.concatenate([np.asarray(ds[i], np.int64)
                               for i in range(s, e)])

    qs, ans = _questions(corpus, j_meta)
    kw = dict(max_query_len=32, cls_id=1, sep_id=2, pad_id=0, topk=(1, 3, 5),
              batch_size=4, match=match, detokenize=_detokenize)
    jembed = jax.jit(lambda t, m: jbi.embed_text(jc, jp["query"], t, m > 0))

    @torch.no_grad()
    def tembed(t, m):
        return bi.embed_text(tc, tp["query"], torch.from_numpy(t),
                             torch.from_numpy(m) > 0).numpy()

    want = j_orqa.evaluate_retriever(
        qs, ans, _tokenize, lambda t, m: jembed(jnp.asarray(t),
                                                jnp.asarray(m)),
        j_emb, block_tokens, **kw)
    got = orqa.evaluate_retriever(qs, ans, _tokenize, tembed, t_emb,
                                  block_tokens, **kw)
    assert got == want


def test_index_tool_and_orqa_main_end_to_end(corpus, tmp_path):
    """build_retrieval_index.main writes the index build_index gives the
    flags' towers; tasks.orqa.main reads it and reports hit rates."""
    tmp, blocks, ours, _ = corpus
    flags = FLAGS + ["--data_path", blocks, "--titles_data_path",
                     str(tmp / "titles")]
    emb, meta = bri.main(flags + ["--output", str(tmp_path / "index"),
                                  "--indexer_batch_size", "8"],
                         log=lambda m: None)
    np.testing.assert_array_equal(
        np.load(tmp_path / "index" / "block_index.npy"), emb)
    np.testing.assert_array_equal(
        np.load(tmp_path / "index" / "block_meta.npy"), meta)
    args = types_args(flags)
    _, params = bri.load_towers(args, torch.device("cpu"))
    want, _ = bri.build_index(bri.load_towers(args, "cpu")[0],
                              params["context"], ours, batch_size=8,
                              log=lambda m: None)
    np.testing.assert_array_equal(emb, want)
    qs, ans = _questions(corpus, meta)
    (tmp_path / "nq.tsv").write_text(
        "".join(f"{q}\t{a}\n" for q, a in zip(qs, ans)))
    out = orqa.main(flags + ["--tokenizer_type", "null", "--index_dir",
                             str(tmp_path / "index"), "--questions",
                             str(tmp_path / "nq.tsv"), "--topk", "1", "5"],
                    log=lambda m: None)
    assert set(out) == {"top1", "top5"}
    assert 0.0 <= out["top1"] <= out["top5"] <= 1.0


def types_args(flags):
    from megatron_tpu_torch.arguments import parse_args, retrieval_args

    return parse_args(flags, retrieval_args)


QA_CASES = [
    (["New York"], "I love New York City.", "string"),
    (["New York"], "new-york is here", "string"),
    (["new york"], "NEW YORK", "string"),
    (["café"], "Un café noir", "string"),
    ([""], "anything", "string"),
    ([r"\d{4}"], "in the year 1984", "regex"),
    ([r"[unclosed"], "text", "regex"),
    (["Paris", "Lyon"], "They went to lyon.", "string"),
]


def test_qa_utils_agree_case_for_case():
    for answers, text, mode in QA_CASES:
        assert qa_utils.has_answer(answers, text, mode) == \
            j_qa.has_answer(answers, text, mode), (answers, text, mode)
    for pred, gold in (("The Cat!", "cat"), ("a b", "b a"), ("", ""),
                       ("An apple.", "apple")):
        assert qa_utils.exact_match_score(pred, gold) == \
            j_qa.exact_match_score(pred, gold)
    docs = {0: "the big apple", 1: "nothing here", 2: "apple pie",
            3: "New York"}
    answers = [["apple"], ["new york"], ["zebra"]]
    closest = [[1, 0, 2], [3, 1, 0], [0, 1, 2]]
    assert qa_utils.calculate_matches(docs.get, answers, closest) == \
        j_qa.calculate_matches(docs.get, answers, closest)
    with pytest.raises(ValueError):
        qa_utils.has_answer(["x"], "x", "fuzzy")


def _dpr_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: {"title": "5", "text": f"{s} {s} {int(rng.integers(10, 90))}"}
    return [{"question": f"{10 + i} {10 + i}?", "answers": [str(10 + i)],
             "positive_ctxs": [mk(10 + i)],
             "hard_negative_ctxs": [mk(10 + (i + k + 1) % 40)
                                    for k in range(3)],
             "negative_ctxs": [mk(10 + (i + 9) % 40)]} for i in range(n)]


def _datasets(tmp_path, pkg):
    """The DPR train (2 negatives) and dev sets through `pkg`'s loader
    and dataset."""
    (tmp_path / "train.json").write_text(json.dumps(_dpr_rows(8)))
    (tmp_path / "dev.json").write_text(json.dumps(_dpr_rows(6, 7)))
    kw = dict(cls_id=1, sep_id=2, pad_id=0)
    train = pkg.NQSupervisedDataset(
        pkg.load_dpr_json(str(tmp_path / "train.json")), _tokenize, 24,
        num_neg=2, **kw)
    dev = pkg.NQSupervisedDataset(
        pkg.load_dpr_json(str(tmp_path / "dev.json")), _tokenize, 24,
        evaluate=True, val_hard_neg=2, val_other_neg=1, **kw)
    return train, dev


def test_orqa_loss_and_grads_equal_jax(tmp_path):
    cfg_kw = dict(KW, seq_length=24)
    jc = jbi.biencoder_config(**cfg_kw, hidden_dropout=0.0,
                              attention_dropout=0.0)
    tc = bi.biencoder_config(**cfg_kw)
    jp = jbi.biencoder_init_params(jc, jax.random.PRNGKey(5),
                                   ict_head_size=16)
    tp = bi.biencoder_params_from_numpy(jax.device_get(jp), tc, device="cpu")
    train, _ = _datasets(tmp_path, ft)
    jtrain, _ = _datasets(tmp_path, j_ft)
    for i in range(4):
        for k, v in train[i].items():
            np.testing.assert_array_equal(v, jtrain[i][k])
    b = {k: np.stack([train[i][k] for i in range(4)]) for k in train[0]}
    _, (_, jaux), jgrads = jax_reference(
        lambda p, b: p, lambda p, b: j_ft.orqa_loss(
            jc, p, b, score_scaling=True, topk=(1, 3, 20)), jp, jax_batch(b))
    _, taux, tgrads = grads(lambda p: ft.orqa_loss(
        tc, p, torch_batch(b), score_scaling=True, topk=(1, 3, 20)), tp)
    assert_aux_close(taux, jaux)
    # the context tower's output bias shifts each query's every score
    # alike: its gradient is zero in exact arithmetic, and both packages'
    # rounding noise stays under 1e-6 of the whole gradient's norm
    jgrads = jax.tree.map(np.asarray, jgrads)
    total = float(np.sqrt(sum(np.square(g).sum()
                              for g in jax.tree.leaves(jgrads))))
    noise = (tgrads["context"]["ict_head"].pop("b").numpy(),
             jgrads["context"]["ict_head"].pop("b"))
    assert max(float(np.linalg.norm(g)) for g in noise) <= 1e-6 * total
    assert_grads_close(tgrads, jgrads)


def test_finetune_orqa_three_steps_equal_jax(tmp_path, monkeypatch):
    """finetune_orqa's three logged losses and its final evaluation
    against the JAX harness's, from the JAX loop's own init."""
    cfg_kw = dict(KW, seq_length=24)
    train_kw = dict(micro_batch_size=1, global_batch_size=8, train_iters=3,
                    log_interval=1, seed=11)
    opt_kw = dict(lr=1e-3, lr_decay_style="constant")
    jmodel = jbi.biencoder_config(**cfg_kw, hidden_dropout=0.0,
                                  attention_dropout=0.0)
    jcfg = jconfig.RunConfig(
        model=jmodel, optimizer=jconfig.OptimizerConfig(**opt_kw),
        training=jconfig.TrainingConfig(**train_kw))
    jtrain, jdev = _datasets(tmp_path, j_ft)
    jlogs = []
    _, jstats = j_ft.finetune_orqa(jcfg, jtrain, jdev, ict_head_size=16,
                                   score_scaling=True, topk=(1, 3),
                                   log=jlogs.append)
    jinit = jax.device_get(jbi.biencoder_init_params(
        jmodel, jax.random.fold_in(jax.random.PRNGKey(11), 0),
        ict_head_size=16, shared=False))
    monkeypatch.setattr(
        bi, "biencoder_init_params",
        lambda mc, seed, head, shared, dev: bi.biencoder_params_from_numpy(
            jinit, mc, device=dev))
    tcfg = tconfig.RunConfig(
        model=bi.biencoder_config(**cfg_kw),
        optimizer=tconfig.OptimizerConfig(**opt_kw),
        training=tconfig.TrainingConfig(**train_kw))
    train, dev = _datasets(tmp_path, ft)
    tlogs = []
    loop, stats = ft.finetune_orqa(tcfg, train, dev, ict_head_size=16,
                                   score_scaling=True, topk=(1, 3),
                                   log=tlogs.append, device="cpu")

    def losses(logs):
        import re

        return [float(m.group(1)) for m in
                (re.search(r"lm loss: ([0-9.e+-]+)", line) for line in logs)
                if m]

    assert len(losses(tlogs)) == 3
    np.testing.assert_allclose(losses(tlogs), losses(jlogs), rtol=1e-5)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        assert stats[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
