"""The port's encoder families above one rank, on four gloo processes (one
launch; tests/_torch_encoder_worker.py), held to the JAX package and to
the port's one-process runs, at the JAX tests' tiny sizes (2 layers,
h 32, 4 heads, vocab 96-128, fp32):

  * BERT: the loss and every gradient at tp2 + SP (dp 2) against JAX's
    (1e-5 relative, 1e-4 of each leaf's norm), and three TrainLoop
    steps at tp2 + SP with ZeRO-1 (dp 2) against
    the port's one-process loop and JAX's TrainLoop with bert_loss at
    tp2 + SP on the 8-device CPU mesh (losses 1e-5 relative); the state
    it saves loads bitwise at world size 1 and into the classification
    tree;
  * ICT at dp 4 and at tp2 + SP (dp 2): the loss (1e-5 relative) and
    every gradient (1e-4 of each leaf's norm) of JAX's global-batch
    loss, the witness of the embeddings' gather over the batch ranks;
  * T5 at tp2 (dp 2) against JAX's loss over the same two microbatches,
    and T5's interleaved pp2 ring at tp1 (dp 2), tp2, and with
    asymmetric stacks (4 + 2) under full recompute against JAX's
    unpipelined loss over the whole batch and, at pp2, JAX's
    make_t5_pipeline_loss_fn on the fake mesh (losses 1e-5 relative,
    gradients 1e-4 of each leaf's norm), and the task eval step's
    forward-only ring against the same loss; the ring's constraints
    raise JAX's messages;
  * the entry points' main() on the launch's process group:
    pretrain_bert at tp2 + SP + ZeRO-1, pretrain_t5 at pp2 + ZeRO-1,
    pretrain_ict at dp 4 + ZeRO-1, tasks.main MNLI at dp 4 + ZeRO-1 from
    the BERT state saved at tp2, and RET-FINETUNE-NQ at tp2, each
    against its one-process run at the same global microbatches (losses
    within 1e-5 relative); the T5 state saved at pp2 loads bitwise at
    world size 1.

The JAX references compile while the ranks run.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_encoder_worker as EW
import _torch_parallel_worker as W
from megatron_tpu import config as jconfig
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import biencoder as jbi
from megatron_tpu.models import t5 as jt5
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.parallel.sharding import shard_tree
from megatron_tpu.training.pretrain import TrainLoop as JTrainLoop
from megatron_tpu.training.t5_pipeline import make_t5_pipeline_loss_fn
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.models import t5

from _torch_encoder_helpers import (
    assert_grads_close, jax_batch, sentence_corpus, titles_corpus,
)

T5_CASES = ("t5_tp2", "t5_pp2", "t5_pp2_tp2", "t5_pp2_asym_full")
CLI_CASES = ("bert", "t5", "ict", "mnli", "orqa")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _bert_batch(seed, b=8, s=32, v=128):
    rng = np.random.default_rng(seed)
    pad = np.ones((b, s), np.float32)
    pad[1, 20:] = 0.0
    pad[6, 9:] = 0.0
    return {
        "tokens": rng.integers(0, v, (b, s)).astype(np.int64),
        "padding_mask": pad,
        "tokentype_ids": (np.arange(s)[None] >= rng.integers(
            4, s - 4, (b, 1))).astype(np.int64),
        "labels": rng.integers(0, v, (b, s)).astype(np.int64),
        "loss_mask": (rng.random((b, s)) < 0.2).astype(np.float32) * pad,
        "is_random": rng.integers(0, 2, (b,)).astype(np.int64),
    }


def _ict_batch(b=8, s=32, v=96):
    rng = np.random.default_rng(4)
    qmask = (np.arange(s)[None] < rng.integers(6, 16, (b, 1))).astype(
        np.float32)
    cmask = (np.arange(s)[None] < rng.integers(16, s + 1, (b, 1))).astype(
        np.float32)
    return {"query_tokens": rng.integers(0, v, (b, s)).astype(np.int64),
            "query_pad_mask": qmask,
            "context_tokens": rng.integers(0, v, (b, s)).astype(np.int64),
            "context_pad_mask": cmask}


def _t5_batch(b=8, se=24, sd=12, v=96):
    rng = np.random.default_rng(6)
    mask = (np.arange(se)[None] < rng.integers(8, se + 1, (b, 1))).astype(
        np.float32)
    loss_mask = (np.arange(sd)[None] < rng.integers(3, sd + 1, (b, 1))
                 ).astype(np.float32)
    return {"enc_tokens": rng.integers(0, v, (b, se)).astype(np.int64),
            "enc_padding_mask": mask,
            "dec_tokens": rng.integers(0, v, (b, sd)).astype(np.int64),
            "labels": rng.integers(0, v, (b, sd)).astype(np.int64),
            "loss_mask": loss_mask}


def _mnli_tsv(path, n, seed):
    rng = np.random.default_rng(seed)
    labels = ["contradiction", "entailment", "neutral"]
    with open(path, "w") as f:
        f.write("\t".join(f"c{i}" for i in range(12)) + "\n")
        for _ in range(n):
            row = [""] * 12
            y = int(rng.integers(0, 3))
            row[8] = " ".join(str(int(x)) for x in rng.integers(10, 90, 7))
            row[9] = " ".join(str(int(x)) for x in rng.integers(10, 90, 5))
            row[11] = labels[y]
            f.write("\t".join(row) + "\n")


def _dpr_json(path, n, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: {"title": "5", "text": f"{s} {s} {int(rng.integers(10, 90))}"}
    rows = [{"question": f"{10 + i} {10 + i}?", "answers": [str(10 + i)],
             "positive_ctxs": [mk(10 + i)],
             "hard_negative_ctxs": [mk(10 + (i + k + 1) % 40)
                                    for k in range(2)],
             "negative_ctxs": [mk(10 + (i + 9) % 40)]} for i in range(n)]
    path.write_text(json.dumps(rows))


def _argv(tmp):
    """The entry points' flags, without the topology and the micro-batch
    (the ranks and the one-process run each add theirs)."""
    run = ["--pad_token_id", "0", "--device", "cpu", "--fp32",
           "--log_interval", "1", "--lr", "1e-3", "--lr_decay_style",
           "constant"]
    ids = run + ["--cls_token_id", "1", "--sep_token_id", "2"]
    width = ["--num_layers", "2", "--hidden_size", "32",
             "--num_attention_heads", "4",
             "--make_vocab_size_divisible_by", "32"]
    sents = sentence_corpus(str(tmp / "sents"), n_docs=16, vocab=96)
    blocks = sentence_corpus(str(tmp / "blocks"), n_docs=12, vocab=96,
                             seed=3)
    titles = titles_corpus(str(tmp / "titles"), n_docs=12, vocab=96)
    _mnli_tsv(tmp / "train.tsv", 8, 0)
    _mnli_tsv(tmp / "dev.tsv", 4, 1)
    _dpr_json(tmp / "nq_train.json", 8, 0)
    _dpr_json(tmp / "nq_dev.json", 4, 1)
    return {
        "bert": width + ids + [
            "--vocab_size", "128", "--seq_length", "32",
            "--global_batch_size", "4", "--train_iters", "3",
            "--data_path", sents, "--mask_token_id", "4"],
        "t5": width + run + [
            "--vocab_size", "96",
            "--seq_length", "24", "--decoder_seq_length", "12",
            "--vocab_extra_ids", "10", "--global_batch_size", "4",
            "--train_iters", "3", "--data_path", sents,
            "--bos_token_id", "1", "--eos_token_id", "2"],
        "ict": width + ids + [
            "--vocab_size", "96", "--seq_length", "32",
            "--global_batch_size", "4", "--train_iters", "3",
            "--data_path", blocks, "--titles_data_path", titles,
            "--ict_head_size", "16", "--retriever_score_scaling"],
        "mnli": width + ids + [
            "--vocab_size", "128", "--seq_length", "24",
            "--tokenizer_type", "null", "--global_batch_size", "4",
            "--task", "MNLI", "--train_data", str(tmp / "train.tsv"),
            "--valid_data", str(tmp / "dev.tsv"), "--epochs", "1"],
        "orqa": width + ids + [
            "--vocab_size", "128", "--tokenizer_type", "null",
            "--global_batch_size", "4", "--task", "RET-FINETUNE-NQ",
            "--train_data", str(tmp / "nq_train.json"),
            "--valid_data", str(tmp / "nq_dev.json"), "--epochs", "1",
            "--retriever_seq_length", "16", "--ict_head_size", "16",
            "--train_with_neg", "--train_hard_neg", "2",
            "--val_av_rank_hard_neg", "2", "--val_av_rank_other_neg", "1",
            "--retriever_report_topk_accuracies", "1", "3"],
    }


# (the ranks' micro-batch, the one-process run's: the ranks' global
# microbatch, or T5's ring's whole batch, whose loss weighs every target
# token of the batch alike)
CLI_MICRO = {"bert": (1, 2), "t5": (1, 4), "ict": (1, 4), "mnli": (1, 4),
             "orqa": (2, 4)}


def _jax_bert_loop(batches):
    """JAX's TrainLoop at tp2 + SP on the fake mesh (dp 4, microbatches
    of 4 rows): its init (for the ranks) and its train() to run later."""
    jcfg = jconfig.RunConfig(
        model=jbert.bert_config(**EW.BERT_KW, hidden_dropout=0.0,
                                attention_dropout=0.0),
        optimizer=jconfig.OptimizerConfig(lr=1e-3, lr_decay_style="constant"),
        training=jconfig.TrainingConfig(micro_batch_size=1,
                                        global_batch_size=8, train_iters=3,
                                        log_interval=1, seed=5),
        parallel=jconfig.ParallelConfig(tensor_parallel=2,
                                        sequence_parallel=True))
    logs = []
    loop = JTrainLoop(jcfg, log=logs.append,
                      loss_fn=lambda mc, p, b, key, sharder=None:
                      jbert.bert_loss(mc, p, b, sharder=sharder)
                      if sharder is not None else jbert.bert_loss(mc, p, b))

    def train():
        loop.train(lambda consumed, gbs: iter(
            [{k: v.astype(np.int32) if v.dtype == np.int64 else v
              for k, v in b.items()} for b in batches[consumed // gbs:]]))
        return EW._losses(logs)

    return jax.device_get(loop.state.params), train


def _jax_grads(loss, params, batch):
    f = jax.jit(jax.value_and_grad(loss)).lower(params, batch).compile(
        {"xla_backend_optimization_level": 0})
    value, g = f(params, batch)
    return float(value), jax.device_get(g)


def _jax_t5(tb):
    """JAX's T5 losses and gradients for each rank case: tp2 over the two
    global microbatches, the rings over the whole batch (unpipelined),
    and pp2's make_t5_pipeline_loss_fn on the fake mesh."""
    jb = jax_batch(tb)
    half = [jax_batch({k: v[i * 4:(i + 1) * 4] for k, v in tb.items()})
            for i in range(2)]
    out, trees = {}, {}
    for name, kw in (("sym", EW.T5_KW), ("asym", EW.T5_ASYM)):
        jc = jt5.t5_config(**kw, hidden_dropout=0.0, attention_dropout=0.0)
        params = jt5.t5_init_params(jc, jax.random.PRNGKey(1))
        trees[name] = (jc, params)
        out[name] = _jax_grads(lambda p, b: jt5.t5_loss(jc, p, b)[0],
                               params, jb)
    jc, params = trees["sym"]
    out["halves"] = _jax_grads(
        lambda p, bs: sum(jt5.t5_loss(jc, p, b)[0] for b in bs) / 2,
        params, half)
    rt = j_build_mesh(jconfig.ParallelConfig(pipeline_parallel=2))
    fn = make_t5_pipeline_loss_fn(jc, rt.mesh, num_stages=2,
                                  num_microbatches=2, recompute="none")
    sharded = shard_tree(rt, params, jt5.t5_param_specs(jc))
    with jax.sharding.set_mesh(rt.mesh):
        value, g = jax.jit(jax.value_and_grad(
            lambda p: fn(p, jb, None)[0]))(sharded)
    out["ring"] = (float(value), jax.device_get(g))
    return out, {k: jax.device_get(v[1]) for k, v in trees.items()}


def _one_process_cli(argv):
    """The entry points at world size 1, at the ranks' global
    microbatches (micro-batch x dp rows)."""
    from megatron_tpu_torch.tasks import main as tasks_main
    from megatron_tpu_torch.tools import (
        pretrain_bert, pretrain_ict, pretrain_t5,
    )

    mains = {"bert": pretrain_bert.main, "t5": pretrain_t5.main,
             "ict": pretrain_ict.main, "mnli": tasks_main.main,
             "orqa": tasks_main.main}
    out = {}
    for name, fn in mains.items():
        extra = ["--micro_batch_size", str(CLI_MICRO[name][1])]
        if name == "mnli":
            extra += ["--pretrained_checkpoint", argv["bert_ck"]]
        got = fn(argv[name] + extra, log=lambda m: None)
        loop = got[0] if isinstance(got, tuple) else got
        out[name] = [h["lm_loss"] for h in loop.history]
        if name == "orqa":
            out["orqa_eval"] = got[1]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("encoders")
    out = tmp / "out"
    out.mkdir()
    bert_batches = [_bert_batch(s) for s in range(3)]
    jinit, jax_bert_train = _jax_bert_loop(bert_batches)
    ict_cfg = jbi.biencoder_config(**EW.ICT_KW, hidden_dropout=0.0,
                                   attention_dropout=0.0)
    ict_params = jbi.biencoder_init_params(ict_cfg, jax.random.PRNGKey(2),
                                           ict_head_size=EW.ICT_HEAD,
                                           shared=False)
    tb = _t5_batch()
    npz = {f"bert/{k}": v for k, v in _flat(jinit).items()}
    npz.update({f"ict/{k}": v for k, v in
                _flat(jax.device_get(ict_params)).items()})
    for i, b in enumerate(bert_batches):
        npz.update({f"bbatch{i}/{k}": v for k, v in b.items()})
    npz.update({f"ibatch/{k}": v for k, v in _ict_batch().items()})
    npz.update({f"tbatch/{k}": v for k, v in tb.items()})
    t5_params = {}
    for name, kw in (("t5", EW.T5_KW), ("t5asym", EW.T5_ASYM)):
        jc = jt5.t5_config(**kw)
        t5_params[name] = jax.device_get(
            jt5.t5_init_params(jc, jax.random.PRNGKey(1)))
        npz.update({f"{name}/{k}": v for k, v in
                    _flat(t5_params[name]).items()})
    np.savez(tmp / "data.npz", **npz)
    argv = _argv(tmp)
    cli_argv = {k: v + ["--micro_batch_size", str(CLI_MICRO[k][0])]
                for k, v in argv.items()}
    world = W.World(4, [("cases", "call", ("_torch_encoder_worker:cases", {
        "data": {"npz": str(tmp / "data.npz"), "argv": cli_argv},
        "out": str(out)}))])
    # the references, while the ranks run
    ref = {"jax_bert": jax_bert_train()}
    ref["bert_one"] = EW.bert_loop(
        EW.bert_run_config(4, {}, False), _flat(jinit), bert_batches)
    jbcfg = jbert.bert_config(**EW.BERT_KW, hidden_dropout=0.0,
                              attention_dropout=0.0)
    ref["bert_grads"] = _jax_grads(
        lambda p, b: jbert.bert_loss(jbcfg, p, b)[0], jinit,
        jax_batch(bert_batches[0]))
    ref["ict"] = _jax_grads(
        lambda p, b: jbi.biencoder_loss(ict_cfg, p, b, score_scaling=True,
                                        topk=(1, 3))[0],
        ict_params, jax_batch(_ict_batch()))
    ref["t5"], _ = _jax_t5(tb)
    got = world.results()["cases"]
    argv["bert_ck"] = str(out / "bert_tp2")
    ref["cli"] = _one_process_cli(argv)
    return got, ref, out


def test_bert_tp2_sp_zero1_loop_equals_one_process_and_jax(runs):
    got, ref, _ = runs
    g = got["bert_tp2_sp_zero1"]
    assert len(g["losses"]) == 3
    np.testing.assert_allclose(g["losses"], ref["bert_one"]["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(g["losses"], ref["jax_bert"], rtol=1e-5)
    for path, x in ref["bert_one"]["params"].items():
        np.testing.assert_allclose(g["params"][path], x, atol=1e-5,
                                   err_msg=path)


def test_bert_tp2_state_loads_bitwise_at_world_1_and_into_classification(
        runs):
    """The BERT state the tp2 + SP + ZeRO-1 ranks saved: a world-1
    TrainLoop's --load and tasks.main's classification tree take its
    params bit for bit."""
    from megatron_tpu_torch.models import classification as cls
    from megatron_tpu_torch.tasks.finetune_utils import ENCODER, finetune_loop
    from megatron_tpu_torch.training.optimizer import leaf_paths
    from megatron_tpu_torch.training.pretrain import TrainLoop

    got, _, out = runs
    want = got["bert_tp2_sp_zero1"]["params"]
    loop = TrainLoop(EW.bert_run_config(4, {}, False,
                                        load=str(out / "bert_tp2")),
                     device="cpu", log=lambda m: None)
    assert loop.iteration == 3
    for path, t in leaf_paths(loop.state.params):
        assert np.array_equal(t.detach().numpy(), want[path]), path
    cfg = tconfig.RunConfig(model=cls.classification_config(**EW.BERT_KW))
    loop = finetune_loop(cfg, 3, pretrained=str(out / "bert_tp2"),
                         log=lambda m: None, device="cpu")
    enc = {k: v for k, v in loop.state.params.items() if k in ENCODER}
    for path, t in leaf_paths(enc):
        assert np.array_equal(t.detach().numpy(), want[path]), path


def test_bert_tp2_sp_grads_equal_jax(runs):
    """BERT's MLM + SOP loss and every gradient at tp2 + SP (dp 2): the
    MLM transform's partial sums, the pooler's and the binary head's
    whole gradients, the vocab-parallel decoder and its bias."""
    got, ref, _ = runs
    value, jgrads = ref["bert_grads"]
    np.testing.assert_allclose(got["bert_grads_tp2_sp"]["loss"], value,
                               rtol=1e-5)
    assert_grads_close(EW.nest(got["bert_grads_tp2_sp"]["grads"]), jgrads)


@pytest.mark.parametrize("case", ["ict_dp4", "ict_tp2_sp"])
def test_ict_grads_equal_the_jax_global_batch(runs, case):
    got, ref, _ = runs
    value, jgrads = ref["ict"]
    np.testing.assert_allclose(got[case]["loss"], value, rtol=1e-5)
    assert_grads_close(EW.nest(got[case]["grads"]), jgrads)


@pytest.mark.parametrize("case", T5_CASES)
def test_t5_loss_and_grads_equal_jax(runs, case):
    """tp2 against JAX's mean over the two global microbatches; each ring
    against JAX's unpipelined loss over the whole batch (its own stack
    depths), and pp2 also against make_t5_pipeline_loss_fn."""
    got, ref, _ = runs
    wants = {"t5_tp2": ["halves"], "t5_pp2": ["sym", "ring"],
             "t5_pp2_tp2": ["sym"], "t5_pp2_asym_full": ["asym"]}[case]
    for want in wants:
        value, jgrads = ref["t5"][want]
        np.testing.assert_allclose(got[case]["loss"], value, rtol=1e-5)
        assert_grads_close(EW.nest(got[case]["grads"]), jgrads)
    # the task eval step (the rings' forward-only pass): the whole batch's
    # loss, which tp2's eval takes as one microbatch
    whole = "sym" if case == "t5_tp2" else wants[0]
    np.testing.assert_allclose(got[case]["eval_loss"], ref["t5"][whole][0],
                               rtol=1e-5)


def test_t5_pipeline_constraints_raise_where_jax_raises():
    from megatron_tpu_torch.training.t5_pipeline import T5Pipeline

    mesh = types.SimpleNamespace(vpp=1, sequence_parallel=False, pp=2)
    cfg = t5.t5_config(**dict(EW.T5_KW, encoder_num_layers=3))
    jcfg = jt5.t5_config(**dict(EW.T5_KW, encoder_num_layers=3))
    rt = j_build_mesh(jconfig.ParallelConfig(pipeline_parallel=2))
    for tc, jc, m in ((cfg, jcfg, 2),
                      (t5.t5_config(**EW.T5_KW),
                       jt5.t5_config(**EW.T5_KW), 3)):
        with pytest.raises(ValueError) as want:
            make_t5_pipeline_loss_fn(jc, rt.mesh, 2, m)
        with pytest.raises(ValueError) as have:
            T5Pipeline(tc, mesh, m)
        assert str(have.value) == str(want.value)
    with pytest.raises(ValueError, match="already interleaved"):
        T5Pipeline(cfg, types.SimpleNamespace(vpp=2, sequence_parallel=False,
                                              pp=2), 2)


@pytest.mark.parametrize("name", CLI_CASES)
def test_entry_points_under_ranks_equal_one_process(runs, name):
    got, ref, _ = runs
    have, want = got["cli"][name], ref["cli"][name]
    assert len(have) == len(want) > 0
    np.testing.assert_allclose(have, want, rtol=1e-5)
    if name == "orqa":
        for k, v in ref["cli"]["orqa_eval"].items():
            assert got["cli"]["orqa_eval"][k] == pytest.approx(v, rel=1e-5)


def test_t5_pp2_state_loads_bitwise_at_world_1(runs):
    from megatron_tpu_torch.models.t5 import t5_init_params
    from megatron_tpu_torch.training.checkpointing import load_params_only
    from megatron_tpu_torch.training.optimizer import leaf_paths

    got, _, out = runs
    want = got["cli"]["t5_params"]
    cfg = t5.t5_config(**dict(EW.T5_KW, vocab_size=96))
    params = load_params_only(str(out / "ct5"), t5_init_params(
        cfg, 0, device="cpu"))
    for path, t in leaf_paths(params):
        assert np.array_equal(t.detach().numpy(), want[path]), path
