"""The port's data pipeline vs the JAX package's, on the CPU.

The .bin/.idx files are byte-compatible both ways (each package's
builder read by the other's reader), and one corpus and seed give the
same GPTDataset samples (single corpus and a weighted blend), the same
sampler index order (sequential and epoch-seeded random, with resume and
data-parallel slicing) and the same gpt_collate batches.
"""

import numpy as np
import pytest

from megatron_tpu.data import gpt_dataset as jgpt
from megatron_tpu.data import indexed_dataset as jidx
from megatron_tpu.data import samplers as jsamp
from megatron_tpu.training.pretrain import gpt_collate as j_collate
from megatron_tpu_torch.data import gpt_dataset as tgpt
from megatron_tpu_torch.data import indexed_dataset as tidx
from megatron_tpu_torch.data import samplers as tsamp
from megatron_tpu_torch.training.pretrain import gpt_collate as t_collate

EOD = 0


def _docs(seed, n_docs=40, vocab=200):
    r = np.random.default_rng(seed)
    return [np.append(r.integers(1, vocab, size=int(r.integers(5, 60))), EOD)
            for _ in range(n_docs)]


def _write(builder_mod, prefix, docs, dtype):
    b = builder_mod.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=dtype)
    for d in docs:
        b.add_item(d)
        b.end_document()
    b.finalize(prefix + ".idx")


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
@pytest.mark.parametrize("writer,reader", [(jidx, tidx), (tidx, jidx)])
def test_indexed_files_are_byte_compatible(tmp_path, writer, reader, dtype):
    docs = _docs(0)
    _write(writer, str(tmp_path / "a"), docs, dtype)
    _write(reader, str(tmp_path / "b"), docs, dtype)
    for ext in (".bin", ".idx"):
        assert (tmp_path / ("a" + ext)).read_bytes() == \
            (tmp_path / ("b" + ext)).read_bytes()
    ds = reader.make_dataset(str(tmp_path / "a"))
    assert len(ds) == len(docs)
    np.testing.assert_array_equal(ds.sizes, [len(d) for d in docs])
    np.testing.assert_array_equal(ds.doc_idx, np.arange(len(docs) + 1))
    for i, d in enumerate(docs):
        np.testing.assert_array_equal(ds[i], d)
        assert ds[i].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(ds.get(3, offset=2, length=3), docs[3][2:5])


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    prefixes = []
    for seed in (1, 2):
        p = str(d / f"c{seed}")
        _write(jidx, p, _docs(seed), np.uint16)
        prefixes.append(p)
    return prefixes


def _samples(ds):
    return [ds[i]["text"] for i in range(len(ds))]


@pytest.mark.parametrize("blend", [False, True])
def test_gpt_datasets_give_the_same_samples(corpora, blend):
    prefix = ["0.3", corpora[0], "0.7", corpora[1]] if blend else corpora[:1]
    # 150 train samples of 32 tokens span several epochs of a ~1.3k-token
    # split, so the separate-last-epoch shuffle is exercised too
    args = (prefix, "80,15,5", 32, (150, 20, 5))
    want = jgpt.build_gpt_datasets(*args, seed=7)
    got = tgpt.build_gpt_datasets(*args, seed=7)
    for w, g in zip(want, got):
        assert len(g) == len(w)
        for a, b in zip(_samples(g), _samples(w)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.int64


def _order(sampler):
    return [list(b) for b in sampler]


@pytest.mark.parametrize("consumed", [0, 24, 56])
def test_samplers_give_the_same_order(consumed):
    for rank in (0, 1):
        kw = dict(total_samples=97, consumed_samples=consumed,
                  micro_batch_size=4, data_parallel_rank=rank,
                  data_parallel_size=2)
        assert _order(tsamp.PretrainingSampler(**kw)) == \
            _order(jsamp.PretrainingSampler(**kw))
        assert _order(tsamp.PretrainingRandomSampler(**kw, seed=5)) == \
            _order(jsamp.PretrainingRandomSampler(**kw, seed=5))


@pytest.mark.parametrize("eod_opts", [
    {}, dict(eod_token=EOD, eod_mask_loss=True),
    dict(eod_token=EOD, eod_mask_loss=True, reset_position_ids=True)])
def test_gpt_collate_batches_are_identical(corpora, eod_opts):
    train = tgpt.build_gpt_datasets(corpora[:1], "100,0,0", 32, (24, 0, 0),
                                    seed=3)[0]
    sampler = dict(total_samples=len(train), consumed_samples=4,
                   micro_batch_size=4, data_parallel_rank=0,
                   data_parallel_size=1)
    got = list(tsamp.build_data_loader(
        train, tsamp.PretrainingSampler(**sampler),
        collate_fn=lambda it: t_collate(it, **eod_opts), prefetch=2))
    want = list(jsamp.build_data_loader(
        train, jsamp.PretrainingSampler(**sampler),
        collate_fn=lambda it: j_collate(it, **eod_opts), prefetch=0))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
    if eod_opts.get("eod_mask_loss"):
        assert any((b["loss_mask"] == 0).any() for b in got)
