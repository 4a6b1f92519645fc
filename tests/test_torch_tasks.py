"""The port's classification heads and task harness
(models/classification.py, tasks/) against the JAX package's
(megatron_tpu/models/classification.py and the repo's tasks/), on the CPU
at the JAX tests' tiny size (2 layers, h 32, 4 heads, vocab 96, S 24,
fp32), with the JAX cls_init_params tree carried across. Tolerances:
logits 1e-4 max abs, losses 1e-5 relative, gradients 1e-4 relative to
each leaf's norm, GLUE/RACE samples and the epoch stream bit for bit.
tasks/main runs MNLI and RACE end to end from a BERT checkpoint that
tools/pretrain_bert saved."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json

import jax
import numpy as np
import pytest
import torch

from megatron_tpu.models import classification as jcls
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.models import classification as cls
from megatron_tpu_torch.training.checkpointing import load_params_only
from megatron_tpu_torch.training.optimizer import leaf_paths

from _torch_encoder_helpers import (
    assert_aux_close, assert_grads_close, grads, jax_batch, jax_reference,
    sentence_corpus, torch_batch,
)

KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
          vocab_size=96, seq_length=24, params_dtype="float32")


def _batch(seed=0, shape=(4,)):
    rng = np.random.default_rng(seed)
    full = shape + (24,)
    mask = (np.arange(24) < rng.integers(8, 25, shape)[..., None]).astype(
        np.float32)
    return {"tokens": rng.integers(5, 96, full).astype(np.int64),
            "padding_mask": mask,
            "tokentype_ids": (np.arange(24) >= rng.integers(
                3, 12, shape)[..., None]).astype(np.int64),
            "label": rng.integers(0, 3 if len(shape) == 1 else 4,
                                  shape[:1]).astype(np.int64)}


def test_classification_and_multichoice_match_jax():
    """classification_forward and multichoice_forward's logits, and
    classification_loss with jax.grad of it on the multichoice batch."""
    jc = jcls.classification_config(**KW, hidden_dropout=0.0,
                                    attention_dropout=0.0)
    tc = cls.classification_config(**KW)
    for num_classes, shape in ((3, (4,)), (1, (2, 4))):
        jparams = jcls.cls_init_params(jc, jax.random.PRNGKey(num_classes),
                                       num_classes=num_classes)
        tparams = cls.cls_params_from_numpy(jax.device_get(jparams), tc,
                                            device="cpu")
        b = _batch(num_classes, shape)
        jb, tb = jax_batch(b), torch_batch(b)
        if num_classes == 3:
            jl = jax.jit(lambda p, b: jcls.classification_logits(jc, p, b))(
                jparams, jb)
        else:
            jl, (_, jaux), jgrads = jax_reference(
                lambda p, b: jcls.classification_logits(jc, p, b),
                lambda p, b: jcls.classification_loss(jc, p, b), jparams, jb)
        with torch.no_grad():
            tl = cls.classification_logits(tc, tparams, tb)
        assert tl.shape == ((4, 3) if num_classes == 3 else (2, 4))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    _, taux, tgrads = grads(lambda p: cls.classification_loss(tc, p, tb),
                            tparams)
    assert_aux_close(taux, jaux)
    assert_grads_close(tgrads, jgrads)


def _mnli_tsv(path, n, seed):
    rng = np.random.default_rng(seed)
    labels = ["contradiction", "entailment", "neutral"]
    with open(path, "w") as f:
        f.write("\t".join(f"c{i}" for i in range(12)) + "\n")
        for _ in range(n):
            row = [""] * 12
            y = int(rng.integers(0, 3))
            row[8] = " ".join(str(int(x)) for x in np.concatenate(
                [[y + 5], rng.integers(10, 90, 6)]))
            row[9] = " ".join(str(int(x)) for x in np.concatenate(
                [[y + 5], rng.integers(10, 90, 4)]))
            row[11] = labels[y]
            f.write("\t".join(row) + "\n")


def _race_dir(path, n, seed):
    rng = np.random.default_rng(seed)
    path.mkdir()
    with open(path / "docs.txt", "w") as f:
        for _ in range(n):
            y = int(rng.integers(0, 4))
            opts = [" ".join(str(int(x)) for x in rng.integers(10, 80, 3))
                    for _ in range(4)]
            art = " ".join(str(int(x)) for x in rng.integers(10, 80, 10))
            f.write(json.dumps({"article": art,
                                "questions": ["7 _ 8", "9 10"],
                                "options": [opts, opts[::-1]],
                                "answers": [chr(65 + y), chr(68 - y)]})
                    + "\n")


def test_task_samples_and_epoch_stream_match_jax_bitwise(tmp_path):
    from tasks import finetune_utils as jfu
    from tasks import glue as jglue
    from tasks import race as jrace

    from megatron_tpu_torch.tasks import finetune_utils, glue, race

    _mnli_tsv(tmp_path / "m.tsv", 12, 0)
    _race_dir(tmp_path / "race", 4, 1)
    tok = lambda s: [int(t) for t in s.split()]  # noqa: E731
    ids = dict(cls_id=1, sep_id=2, pad_id=0)
    pairs = [
        (glue.GlueDataset(glue.load_mnli(str(tmp_path / "m.tsv")), tok, 24,
                          **ids),
         jglue.GlueDataset(jglue.load_mnli(str(tmp_path / "m.tsv")), tok,
                           24, **ids)),
        (race.RaceDataset(race.load_race(str(tmp_path / "race")), tok, 16,
                          **ids),
         jrace.RaceDataset(jrace.load_race(str(tmp_path / "race")), tok, 16,
                           **ids))]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            assert sorted(ours[i]) == sorted(theirs[i])
            for k in ours[i]:
                np.testing.assert_array_equal(ours[i][k], theirs[i][k])
        a = finetune_utils._epoch_iter(ours, 5, 3, seed=7)
        b = jfu._epoch_iter(theirs, 5, 3, seed=7)
        for _ in range(6):
            x, y = next(a), next(b)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


def test_tasks_main_mnli_and_race_from_a_bert_checkpoint(tmp_path):
    """pretrain_bert saves a tiny BERT; tasks.main finetunes MNLI and RACE
    from it with --head_lr_mult. The finetune loop's encoder leaves equal
    the checkpoint's bit for bit (params and fp32 masters, a bf16 run),
    the heads start fresh, and RET-FINETUNE-NQ goes to the retriever
    finetuning."""
    from megatron_tpu_torch.arguments import HEAD_PATTERN
    from megatron_tpu_torch.tasks import main as tasks_main
    from megatron_tpu_torch.tasks.finetune_utils import ENCODER, finetune_loop
    from megatron_tpu_torch.tools import pretrain_bert

    width = ["--num_layers", "2", "--hidden_size", "32",
             "--num_attention_heads", "4", "--vocab_size", "96",
             "--make_vocab_size_divisible_by", "32", "--device", "cpu",
             "--cls_token_id", "1", "--sep_token_id", "2",
             "--pad_token_id", "0"]
    prefix = sentence_corpus(str(tmp_path / "sents"), n_docs=12, vocab=96)
    ck = str(tmp_path / "bert")
    pretrain_bert.main(width + [
        "--seq_length", "32", "--micro_batch_size", "2",
        "--global_batch_size", "4", "--train_iters", "2", "--lr", "1e-3",
        "--data_path", prefix, "--mask_token_id", "4", "--save", ck],
        log=lambda m: None)

    # the load the harness makes, in a bf16 run
    cfg = tconfig.RunConfig(model=cls.classification_config(
        **dict(KW, params_dtype="bfloat16"), max_position_embeddings=32))
    loop = finetune_loop(cfg, 3, pretrained=ck, log=lambda m: None,
                         device="cpu")
    enc = {k: v for k, v in loop.state.params.items() if k in ENCODER}
    saved = load_params_only(ck, enc)
    for (k, a), (_, b) in zip(leaf_paths(enc), leaf_paths(saved)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), k
    masters = load_params_only(ck, {k: loop.state.master[k] for k in enc})
    for (k, a), (_, b) in zip(leaf_paths(masters),
                              leaf_paths({k: loop.state.master[k]
                                          for k in enc})):
        assert a.dtype == torch.float32 and torch.equal(a, b), k
    head_b = loop.state.params["classification_head"]["b"].detach()
    assert float(head_b.abs().sum()) == 0.0

    _mnli_tsv(tmp_path / "train.tsv", 24, 0)
    _mnli_tsv(tmp_path / "dev.tsv", 8, 1)
    common = width + ["--fp32", "--tokenizer_type", "null",
                      "--micro_batch_size", "2", "--global_batch_size", "4",
                      "--lr", "1e-3", "--lr_decay_style", "constant",
                      "--log_interval", "2", "--head_lr_mult", "10",
                      "--pretrained_checkpoint", ck]
    logs = []
    loop = tasks_main.main(common + [
        "--task", "MNLI", "--train_data", str(tmp_path / "train.tsv"),
        "--valid_data", str(tmp_path / "dev.tsv"), "--epochs", "1",
        "--seq_length", "24"], log=logs.append)
    assert loop.iteration == 6
    assert loop.cfg.optimizer.param_group_mults == ((HEAD_PATTERN, 10.0,
                                                     1.0),)
    assert any("loaded" in m and "encoder leaves" in m for m in logs)
    acc = float(logs[-1].rsplit(":", 1)[1])
    assert logs[-1].startswith("final validation accuracy") and 0 <= acc <= 1

    _race_dir(tmp_path / "rtrain", 4, 2)
    _race_dir(tmp_path / "rdev", 2, 3)
    logs = []
    loop = tasks_main.main(common + [
        "--task", "RACE", "--train_data", str(tmp_path / "rtrain"),
        "--valid_data", str(tmp_path / "rdev"), "--epochs", "1",
        "--seq_length", "32"], log=logs.append)
    assert loop.iteration == 2
    assert loop.state.params["classification_head"]["w"].shape == (32, 1)
    assert all(np.isfinite(h["lm_loss"]) for h in loop.history)
    assert logs[-1].startswith("final validation accuracy")

    # RET-FINETUNE-NQ goes to the retriever finetuning, which reads its
    # DPR JSON (tests/test_torch_orqa.py trains it)
    with pytest.raises(FileNotFoundError, match="'x'"):
        tasks_main.main(common + [
            "--task", "RET-FINETUNE-NQ", "--train_data", "x",
            "--valid_data", "y", "--seq_length", "24"])
