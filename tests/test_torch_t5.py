"""The port's T5 (models/t5.py, data/t5_dataset.py, tools/pretrain_t5.py)
against the JAX package's, on the CPU at the JAX tests' tiny size (h 32,
4 heads, vocab 96, encoder S 24, decoder S 12, fp32), symmetric (2 + 2
layers) and asymmetric (3 + 1), with the JAX t5_init_params tree carried
across through t5_params_from_numpy. Tolerances: logits 1e-4 max abs,
the loss 1e-5 relative, gradients 1e-4 relative to each leaf's norm,
t5_span_corrupt and dataset items bit for bit."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import numpy as np
import pytest
import torch

from megatron_tpu.data.indexed_dataset import make_dataset as j_make_dataset
from megatron_tpu.data.t5_dataset import T5Dataset as JT5Dataset
from megatron_tpu.data.t5_dataset import t5_span_corrupt as j_span_corrupt
from megatron_tpu.models import t5 as jt5
from megatron_tpu_torch.data.indexed_dataset import make_dataset
from megatron_tpu_torch.data.t5_dataset import T5Dataset, t5_span_corrupt
from megatron_tpu_torch.models import t5

from _torch_encoder_helpers import (
    assert_aux_close, assert_grads_close, grads, jax_batch, jax_reference,
    sentence_corpus, torch_batch,
)

KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
          vocab_size=96, seq_length=24, decoder_seq_length=12,
          params_dtype="float32")


def _batch(seed=0, b=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 24), np.float32)
    mask[0, 16:] = 0.0
    mask[2, 7:] = 0.0
    loss_mask = np.ones((b, 12), np.float32)
    loss_mask[1, 9:] = 0.0
    return {"enc_tokens": rng.integers(0, 96, (b, 24)).astype(np.int64),
            "enc_padding_mask": mask,
            "dec_tokens": rng.integers(0, 96, (b, 12)).astype(np.int64),
            "labels": rng.integers(0, 96, (b, 12)).astype(np.int64),
            "loss_mask": loss_mask}


@pytest.mark.parametrize("depths", [(None, None), (3, 1)],
                         ids=["symmetric", "asymmetric"])
def test_t5_forward_loss_and_grads_match_jax(depths):
    enc_l, dec_l = depths
    jc = jt5.t5_config(**KW, encoder_num_layers=enc_l,
                       decoder_num_layers=dec_l)
    tc = t5.t5_config(**KW, encoder_num_layers=enc_l,
                      decoder_num_layers=dec_l)
    assert t5.t5_param_shapes(tc) == jt5.t5_param_shapes(jc)
    assert t5.t5_stack_depths(tc) == ((3, 1) if enc_l else (2, 2))
    jparams = jt5.t5_init_params(jc, jax.random.PRNGKey(1))
    tparams = t5.t5_params_from_numpy(jax.device_get(jparams), tc,
                                      device="cpu")
    b = _batch()
    jb, tb = jax_batch(b), torch_batch(b)

    jl, (_, jaux), jgrads = jax_reference(
        lambda p, b: jt5.t5_forward(jc, p, b["enc_tokens"], b["dec_tokens"],
                                    b["enc_padding_mask"] > 0),
        lambda p, b: jt5.t5_loss(jc, p, b), jparams, jb)
    with torch.no_grad():
        tl = t5.t5_forward(tc, tparams, tb["enc_tokens"], tb["dec_tokens"],
                           tb["enc_padding_mask"] > 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)

    _, taux, tgrads = grads(lambda p: t5.t5_loss(tc, p, tb), tparams)
    assert_aux_close(taux, jaux)
    assert_grads_close(tgrads, jgrads)


def test_t5_init_and_specs_cover_the_tree():
    """The port's own init has the JAX table's paths and shapes, its
    output-facing products at the stack's scaled std, and the specs name
    the same leaves."""
    from megatron_tpu_torch.training.optimizer import leaf_paths

    tc = t5.t5_config(**KW, encoder_num_layers=3, decoder_num_layers=1)
    params = t5.t5_init_params(tc, seed=4, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in leaf_paths(params)}
    assert shapes == t5.t5_param_shapes(tc)
    assert set(t5.t5_param_specs(tc)) == set(shapes)
    assert float(params["encoder"]["ln1"]["scale"].min()) == 1.0
    std = float(params["decoder"]["mlp"]["w_out"].std())
    assert abs(std - 0.02 / np.sqrt(2.0)) < 0.004


def test_span_corrupt_and_dataset_items_match_jax_bitwise(tmp_path):
    sentinels = list(range(86, 96))
    rng_t = np.random.RandomState(11)
    rng_j = np.random.RandomState(11)
    toks = np.arange(10, 60, dtype=np.int64)
    for _ in range(5):
        enc_t, spans_t = t5_span_corrupt(toks, rng_t, 0.15, sentinels)
        enc_j, spans_j = j_span_corrupt(toks, rng_j, 0.15, sentinels)
        np.testing.assert_array_equal(enc_t, enc_j)
        assert spans_t == spans_j

    prefix = sentence_corpus(str(tmp_path / "sents"), vocab=86)
    kw = dict(num_samples=20, max_seq_length=24, max_seq_length_dec=12,
              bos_token=1, eos_token=2, pad_token=0,
              sentinel_tokens=sentinels, seed=3)
    ours = T5Dataset(make_dataset(prefix), **kw)
    theirs = JT5Dataset(j_make_dataset(prefix), **kw)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_pretrain_t5_runs_and_refuses_pipeline(tmp_path):
    """tools/pretrain_t5 end to end at tiny size with asymmetric stacks
    and a saved checkpoint; pp > 1 (T5's pipeline) outside a launch of
    one process per rank, and sequence parallelism (ROADMAP.md item 11c),
    are refused."""
    from megatron_tpu_torch.tools import pretrain_t5

    prefix = sentence_corpus(str(tmp_path / "sents"), n_docs=16, vocab=86)
    argv = ["--num_layers", "2", "--encoder_num_layers", "2",
            "--decoder_num_layers", "1", "--hidden_size", "32",
            "--num_attention_heads", "4", "--vocab_size", "96",
            "--make_vocab_size_divisible_by", "32",
            "--seq_length", "24", "--decoder_seq_length", "12",
            "--vocab_extra_ids", "10", "--fp32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", "3",
            "--log_interval", "1", "--lr", "1e-3", "--data_path", prefix,
            "--bos_token_id", "1", "--eos_token_id", "2",
            "--pad_token_id", "0", "--save", str(tmp_path / "ck"),
            "--device", "cpu"]
    loop = pretrain_t5.main(argv, log=lambda m: None)
    assert loop.iteration == 3 and len(loop.history) == 3
    assert all(np.isfinite(h["lm_loss"]) for h in loop.history)
    assert loop.state.params["decoder"]["attn"]["wq"].shape[0] == 1
    assert (tmp_path / "ck" / "latest_checkpointed_iteration.txt").exists()
    # the T5 tree resumes through --load: the state, the iteration
    resumed = pretrain_t5.main(
        [a if a != "3" else "4" for a in argv] + ["--load",
                                                  str(tmp_path / "ck")],
        log=lambda m: None)
    assert [h["iteration"] for h in resumed.history] == [4]
    with pytest.raises(ValueError, match="one process per rank"):
        pretrain_t5.main(argv + ["--pipeline_model_parallel_size", "2"])
    with pytest.raises(ValueError, match="11c"):
        pretrain_t5.main(argv + ["--tensor_model_parallel_size", "2",
                                 "--sequence_parallel"])
