"""The port's instruction-tuning path vs the JAX package, on the CPU.

The same chats (seeded numpy token ids, as text for the null tokenizer)
go through both packages: the port's preprocess_instruct_data writes the
same bytes as the JAX tool; the port's InstructionDataset and
instruction_collator give the JAX package's arrays exactly, padded to
seq_length and with variable_seq_lengths, at scalar_loss_mask 0 and 0.1;
lm_loss with the instruction mask and 5 finetune steps on shared weights
(params_from_numpy) agree within 1e-4 in fp32 (the gate of
tests/test_torch_train.py: two layers, sums in different orders); and
the finetune CLI trains 4 steps from a checkpoint.
"""

import dataclasses
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.data import instruction_dataset as jid
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_loss as j_lm_loss
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.training import optimizer as jopt
from megatron_tpu.training.train_step import make_train_step as j_make_step
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.data import instruction_dataset as tid
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_loss
from megatron_tpu_torch.models.params import init_params, params_from_numpy
from megatron_tpu_torch.tools import preprocess_instruct_data
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training import optimizer as topt
from megatron_tpu_torch.training.train_step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
VOCAB, SEQ = 96, 32
ROLES = ("system", "user", "assistant", "prompter", "gpt")


def _write_chats(path, n=12, seed=0):
    r = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            turns = [{"role": ROLES[int(r.integers(0, len(ROLES)))],
                      "text": " ".join(map(str, r.integers(
                          1, VOCAB - 1, size=int(r.integers(1, 15)))))}
                     for _ in range(int(r.integers(1, 6)))]
            f.write(json.dumps({"conversation": turns}) + "\n")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_preprocess_instruct_data",
        os.path.join(REPO, "tools", "preprocess_instruct_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("instruct")
    chats = str(d / "chats.jsonl")
    _write_chats(chats)
    common = ["--input", chats, "--tokenizer_type", "null", "--vocab_size",
              str(VOCAB - 1), "--append_eod"]
    assert preprocess_instruct_data.main(
        common + ["--output_prefix", str(d / "port")]) == 12
    _jax_tool().main(common + ["--output_prefix", str(d / "jax")])
    return str(d)


def test_preprocess_writes_the_jax_tools_bytes(data):
    for stream in ("text", "role"):
        for ext in ("bin", "idx"):
            a = os.path.join(data, f"port-{stream}.{ext}")
            b = os.path.join(data, f"jax-{stream}.{ext}")
            assert filecmp.cmp(a, b, shallow=False), (stream, ext)
    # every tokenizer is ported now; a name the JAX build_tokenizer does
    # not know is refused as it refuses it
    with pytest.raises(ValueError, match="unknown tokenizer_type"):
        preprocess_instruct_data.main(["--input", "x", "--output_prefix",
                                       "y", "--tokenizer_type", "GPT2BPE"])


@pytest.mark.parametrize("variable,scalar", [(False, 0.0), (False, 0.1),
                                             (True, 0.0), (True, 0.1)])
def test_dataset_and_collator_match_jax(data, variable, scalar):
    prefix = os.path.join(data, "port")
    tds = tid.InstructionDataset(prefix, num_samples=30, seed=3)
    jds = jid.InstructionDataset(prefix, num_samples=30, seed=3)
    assert len(tds) == len(jds) == 30
    np.testing.assert_array_equal(tds.index, jds.index)
    for start in range(0, 30, 3):
        items = [tds[i] for i in range(start, start + 3)]
        for a, b in zip(items, [jds[i] for i in range(start, start + 3)]):
            for k in ("text", "role"):
                np.testing.assert_array_equal(a[k], b[k])
        kw = dict(seq_length=SEQ, pad_token=0, scalar_loss_mask=scalar,
                  variable_seq_lengths=variable)
        got = tid.instruction_collator(items, **kw)
        want = jid.instruction_collator(items, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        width = got["tokens"].shape[1]
        assert (width + 1) % 16 == 0 or width == SEQ if variable \
            else width == SEQ


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_presets.tiny(vocab_size=VOCAB, seq_length=SEQ)
    tcfg = presets.tiny(vocab_size=VOCAB, seq_length=SEQ,
                        attention_impl="pallas")
    return jcfg, tcfg, j_init_params(jcfg, jax.random.PRNGKey(0))


def _batches(data, n, gbs, scalar):
    ds = tid.InstructionDataset(os.path.join(data, "port"),
                                num_samples=n * gbs, seed=1)
    return [tid.instruction_collator(
        [ds[i] for i in range(s * gbs, (s + 1) * gbs)], seq_length=SEQ,
        pad_token=0, scalar_loss_mask=scalar) for s in range(n)]


def _tparams(tcfg, jparams):
    p = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    for _, leaf in topt.leaf_paths(p):
        leaf.requires_grad_(True)
    return p


def test_masked_lm_loss_and_five_finetune_steps_match_jax(data, tiny):
    jcfg, tcfg, jparams = tiny
    batch = _batches(data, 1, 4, 0.1)[0]
    assert 0 < (batch["loss_mask"] == 0.1).sum() < batch["loss_mask"].size
    jl, _ = j_lm_loss(jcfg, jparams, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    with torch.no_grad():
        tl, _ = lm_loss(tcfg, _tparams(tcfg, jparams),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)

    okw = dict(lr=3e-3, lr_decay_style="constant", weight_decay=0.1,
               clip_grad=1.0)
    tkw = dict(micro_batch_size=2, global_batch_size=4, train_iters=5,
               recompute_granularity="selective", scalar_loss_mask=0.1)
    jstep = jax.jit(j_make_step(jcfg, jconfig.OptimizerConfig(**okw),
                                jconfig.TrainingConfig(**tkw), 2))
    tstep = make_train_step(tcfg, tconfig.OptimizerConfig(**okw),
                            tconfig.TrainingConfig(**tkw), 2)
    js = jopt.init_train_state(jconfig.OptimizerConfig(**okw), jparams)
    ts = topt.init_train_state(tconfig.OptimizerConfig(**okw),
                               _tparams(tcfg, jparams))
    for batch in _batches(data, 5, 4, 0.1):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=ATOL)
    for (n, t), (_, j) in zip(topt.leaf_paths(ts.params), topt.leaf_paths(
            jax.device_get(js.params))):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=ATOL, rtol=1e-4, err_msg=n)


def test_finetune_cli_trains_four_steps_from_a_checkpoint(data, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    model = ["--model_name", "tiny", "--fp32", "--seq_length", str(SEQ)]
    init = str(tmp_path / "init")
    tcfg = presets.tiny(seq_length=SEQ)
    state = topt.init_train_state(tconfig.OptimizerConfig(),
                                  init_params(tcfg, 7, device="cpu"))
    ckpt.save_checkpoint(init, state, 0,
                         config=tconfig.RunConfig(model=tcfg).to_dict())
    proc = subprocess.run(
        [sys.executable, "-m", "megatron_tpu_torch.tools.finetune", *model,
         "--load", init, "--finetune", "--save", str(tmp_path / "out"),
         "--data_path", os.path.join(data, "port"), "--micro_batch_size",
         "2", "--global_batch_size", "4", "--train_iters", "4",
         "--log_interval", "1", "--lr", "1e-3", "--lr_decay_style",
         "constant", "--scalar_loss_mask", "0.1", "--variable_seq_lengths",
         "--attention_impl", "pallas", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert "loaded checkpoint at iteration 0 (consumed 0 samples)" in lines
    steps = [ln for ln in lines if ln.startswith("iteration ")]
    assert [ln.split()[1] for ln in steps] == ["1/4", "2/4", "3/4", "4/4"]
    losses = [float(ln.split("lm loss: ")[1].split()[0]) for ln in steps]
    assert all(np.isfinite(losses))
    assert ckpt.read_tracker(str(tmp_path / "out")) == 4


def test_finetune_data_type_gpt_hands_over_to_pretrain_gpt(tmp_path):
    from megatron_tpu_torch.data.indexed_dataset import (
        MMapIndexedDatasetBuilder,
    )
    from megatron_tpu_torch.tools import finetune

    prefix = str(tmp_path / "corpus")
    r = np.random.default_rng(0)
    b = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(24):
        b.add_item(r.integers(1, 90, size=int(r.integers(10, 70))))
        b.end_document()
    b.finalize(prefix + ".idx")
    logs = []
    loop = finetune.main(
        ["--data_type", "gpt", "--pad_token_id", "0", "--model_name",
         "tiny", "--fp32", "--seq_length", str(SEQ), "--micro_batch_size",
         "2", "--global_batch_size", "2", "--train_iters", "2",
         "--log_interval", "1", "--eval_interval", "100", "--data_path",
         prefix, "--split", "90,10,0", "--device", "cpu"], log=logs.append)
    assert [h["iteration"] for h in loop.history] == [1, 2]
    assert any(m.startswith("iteration 2/2 | consumed samples: 4")
               for m in logs)
