"""Resume through the port's entry point, on the CPU in fp32.

`megatron_tpu_torch.tools.pretrain_gpt.main` on the tiny preset: 6 steps
in one run equal 3 steps + save + a resumed run of 3 more, bitwise
(float ==, torch.equal) in every logged loss and in the final params,
masters, moments and step, because the state and consumed_samples are
restored exactly and the data iterator is rebuilt from consumed_samples.
A torn newest checkpoint falls back, with a warning, to the previous
one, and the replayed steps are bitwise the same again. The lr is
constant: a decaying schedule is a function of --train_iters, which the
two halves of the interrupted run set differently.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import os

import numpy as np
import pytest
import torch

from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDatasetBuilder
from megatron_tpu_torch.tools import pretrain_gpt
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.optimizer import leaf_paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("corpus") / "corpus")
    r = np.random.default_rng(0)
    b = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(48):
        b.add_item(r.integers(1, 90, size=int(r.integers(10, 70))))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _run(corpus, iters, *extra):
    argv = ["--model_name", "tiny", "--fp32", "--num_layers", "2",
            "--seq_length", "32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", str(iters),
            "--log_interval", "1", "--eval_interval", "100",
            "--eval_iters", "1", "--lr", "1e-3", "--lr_decay_style",
            "constant", "--attention_impl", "pallas", "--data_path", corpus,
            "--split", "90,10,0", "--seed", "5", "--device", "cpu", *extra]
    logs = []
    loop = pretrain_gpt.main(argv, log=logs.append)
    return loop, logs


def _assert_same_state(a, b):
    for field in ("params", "mu", "nu"):
        for (n, x), (_, y) in zip(leaf_paths(getattr(a, field)),
                                  leaf_paths(getattr(b, field))):
            assert torch.equal(x, y), (field, n)
    assert int(a.step) == int(b.step)


@pytest.fixture(scope="module")
def uninterrupted(corpus):
    return _run(corpus, 6)[0]


def test_resume_is_bitwise(corpus, uninterrupted, tmp_path):
    save = str(tmp_path / "ckpt")
    first, logs = _run(corpus, 3, "--save", save, "--save_interval", "2")
    assert ckpt.committed_iterations(save) == [2, 3]
    assert any("saved checkpoint" in m for m in logs)
    assert [s["iteration"] for s in first.saves] == [2, 3]
    resumed, logs = _run(corpus, 6, "--load", save, "--save", save)
    assert "loaded checkpoint at iteration 3 (consumed 12 samples)" in logs
    assert [h["iteration"] for h in resumed.history] == [4, 5, 6]
    assert [h["consumed"] for h in resumed.history] == [16, 20, 24]
    a = [h["lm_loss"] for h in uninterrupted.history]
    assert a[:3] == [h["lm_loss"] for h in first.history]
    assert a[3:] == [h["lm_loss"] for h in resumed.history]
    _assert_same_state(resumed.state, uninterrupted.state)
    assert ckpt.read_tracker(save) == 6


def test_torn_newest_checkpoint_falls_back(corpus, uninterrupted, tmp_path):
    save = str(tmp_path / "ckpt")
    _run(corpus, 4, "--save", save, "--save_interval", "2",
         "--no_async_save")
    state = os.path.join(ckpt.checkpoint_dir(save, 4), "state", "mu.pt")
    with open(state, "r+b") as f:
        f.truncate(os.path.getsize(state) // 2)
    with pytest.warns(UserWarning, match="falling back to iteration 2"):
        resumed, logs = _run(corpus, 6, "--load", save)
    assert "loaded checkpoint at iteration 2 (consumed 8 samples)" in logs
    assert ([h["lm_loss"] for h in resumed.history]
            == [h["lm_loss"] for h in uninterrupted.history][2:])
    _assert_same_state(resumed.state, uninterrupted.state)


def test_load_of_an_empty_dir_starts_fresh(corpus, uninterrupted, tmp_path):
    loop, logs = _run(corpus, 6, "--load", str(tmp_path / "nothing"))
    assert f"no checkpoint found in {tmp_path / 'nothing'}, starting fresh" \
        in logs
    _assert_same_state(loop.state, uninterrupted.state)
