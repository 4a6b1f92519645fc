"""The port's checkpoint tools against what the JAX package's tests assert,
in both of the port's checkpoint layouts (one file per field at world
size 1, and the sharded layout, written here by two tp ranks' slices in
one process through the saver's own steps):

  * tools/checkpoint_util: copy and cast with --params_only
    (tests/test_checkpoint.py:187), verify (--deep, the size-mismatch
    verdict, the preemption tag; test_elastic.py:400) and prune with
    --dry_run (test_checkpoint.py:507); the staging age guard;
  * the restore of a checkpoint that predates a TrainState field
    (test_checkpoint.py:424): the recorded fields load, the missing one
    keeps the template's value with a warning, an unknown field fails;
  * retention keeps the newest preemption checkpoint
    (test_elastic.py:366), and the loud refusal of a global batch the
    new data-parallel degree cannot keep (test_elastic.py:145);
  * tools/verify_correctness against random-init HF Llama and Mistral
    models built in code and saved to disk: the logits check and N
    steps of the port's Adam against torch.optim.AdamW, within the
    tool's fp32 bounds.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from megatron_tpu_torch.config import OptimizerConfig, ParallelConfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import StatePlacement, init_params
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.tools import checkpoint_util, verify_correctness
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.optimizer import init_train_state, leaf_paths

LAYOUTS = ["world1", "sharded"]


def _model(**kw):
    return presets.tiny(**{**dict(vocab_size=64, seq_length=16,
                                  hidden_size=32, num_attention_heads=4,
                                  num_kv_heads=2, ffn_hidden_size=64), **kw})


def _state(seed=0, cfg=None):
    cfg = cfg or _model()
    params = init_params(cfg, seed, device="cpu")
    return cfg, init_train_state(OptimizerConfig(lr=1e-3), params)


def _sharded_save(save, state, cfg, iteration, consumed, config=None,
                  tags=()):
    """The sharded layout of `state` as two tp ranks write it: each
    rank's blocks and vote, then rank 0's layout and commit."""
    import _torch_ckpt_worker as C

    stage = ckpt._staging_dir(save, iteration)
    os.makedirs(stage)
    for r in range(2):
        mesh = build_mesh(ParallelConfig(tensor_parallel=2), world_size=2,
                          rank=r)
        placement = StatePlacement.of(cfg, mesh, False)
        host, fragment = ckpt._sharded_to_host(
            C.slice_state(state, cfg, mesh, False), placement)
        ckpt._write_state(stage, host, f".r{r}")
        ckpt._vote(stage, r, fragment)
    votes = ckpt._await_votes(stage, range(2), 5.0, iteration)
    ckpt._write_layout(stage, votes, placement)
    known = {rel: e for v in votes for rel, e in v["files"].items()}
    return ckpt._finalize(save, stage, iteration, consumed, config, None,
                          tags=tags, known=known)


def _save(layout, save, state, cfg, iteration, consumed=0, config=None):
    if layout == "world1":
        return ckpt.save_checkpoint(save, state, iteration, consumed,
                                    config=config)
    return _sharded_save(save, state, cfg, iteration, consumed, config)


def _truncate_largest_state_file(path):
    d = os.path.join(path, ckpt.STATE_DIR)
    big = max((os.path.join(d, n) for n in os.listdir(d)),
              key=os.path.getsize)
    with open(big, "r+b") as f:
        f.truncate(os.path.getsize(big) // 2)
    return big


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_util_copy_and_cast(tmp_path, layout):
    """Copy a checkpoint, cast the params to bf16, drop the optimizer
    state: the copy loads, matches to bf16 rounding, and records the new
    dtype."""
    cfg, state = _state(3)
    with torch.no_grad():
        for _, m in leaf_paths(state.mu):
            m.fill_(0.5)
    config = {"model": dataclasses.asdict(cfg), "parallel": {},
              "optimizer": {}, "training": {}}
    src = str(tmp_path / "src")
    _save(layout, src, state, cfg, 7, 123, config=config)
    dst = str(tmp_path / "dst")
    checkpoint_util.main(["--load", src, "--save", dst,
                          "--target_params_dtype", "bfloat16",
                          "--params_only"])
    assert ckpt.read_tracker(dst) == 7
    path = ckpt.checkpoint_dir(dst, 7)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["config"]["model"]["params_dtype"] == "bfloat16"
    assert meta["consumed_train_samples"] == 123
    cfg_bf16 = dataclasses.replace(cfg, params_dtype="bfloat16")
    got = ckpt.load_params_only(dst, init_params(cfg_bf16, 0, device="cpu"))
    for (k, a), (_, b) in zip(leaf_paths(got), leaf_paths(state.params)):
        assert a.dtype == torch.bfloat16, k
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=1e-2,
                                   atol=1e-2, err_msg=k)
    fields = ckpt.read_state(path)
    assert all(bool((t == 0).all()) for t in fields["mu"].values())
    assert int(fields["step"]["step"]) == int(state.step)
    assert ckpt.verify_checkpoint(path, deep=True)[0]


def _strip_field(path, field):
    """Make a committed checkpoint look written before `field` existed."""
    d = os.path.join(path, ckpt.STATE_DIR)
    layout = os.path.join(d, ckpt.LAYOUT)
    if os.path.exists(layout):
        with open(layout) as f:
            doc = json.load(f)
        files = {b["file"] for leaf in doc["fields"].pop(field).values()
                 for b in leaf["blocks"]}
        with open(layout, "w") as f:
            json.dump(doc, f)
        for name in files:
            os.remove(os.path.join(d, name))
    else:
        os.remove(os.path.join(d, field + ".pt"))
    ckpt.write_manifest(path, int(os.path.basename(path)[5:]))


def _add_field(path, field, value):
    d = os.path.join(path, ckpt.STATE_DIR)
    layout = os.path.join(d, ckpt.LAYOUT)
    if os.path.exists(layout):
        with open(layout) as f:
            doc = json.load(f)
        doc["fields"][field] = doc["fields"]["step"]
        with open(layout, "w") as f:
            json.dump(doc, f)
    else:
        torch.save({field: value}, os.path.join(d, field + ".pt"))
    ckpt.write_manifest(path, int(os.path.basename(path)[5:]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pre_field_checkpoint_still_loads(tmp_path, layout):
    cfg, state = _state()
    state.nonfinite_streak.fill_(2)  # would show if it were read
    save = str(tmp_path / "old")
    _save(layout, save, state, cfg, 5, 50)
    _strip_field(ckpt.checkpoint_dir(save, 5), "nonfinite_streak")
    assert ckpt.verify_checkpoint(ckpt.checkpoint_dir(save, 5), deep=True)[0]
    _, template = _state(seed=99)
    with pytest.warns(UserWarning, match="predates TrainState fields"):
        restored, it, consumed = ckpt.load_checkpoint(save, template)
    assert (it, consumed) == (5, 50)
    assert int(restored.nonfinite_streak) == 0
    assert int(restored.step) == int(state.step)
    for (k, a), (_, b) in zip(leaf_paths(restored.params),
                              leaf_paths(state.params)):
        assert torch.equal(a, b), k
    # a checkpoint with a field this TrainState does not know fails hard
    _save(layout, save, state, cfg, 7, 70)
    _add_field(ckpt.checkpoint_dir(save, 7), "from_the_future", state.step)
    with pytest.raises(ValueError, match="unknown TrainState fields"):
        ckpt.load_checkpoint(save, template, iteration=7)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_util_verify_and_prune(tmp_path, capsys, layout):
    cfg, state = _state()
    save = str(tmp_path / "run")
    for it in (1, 2, 3):
        _save(layout, save, state, cfg, it, it)
    results = checkpoint_util.main(["verify", "--load", save, "--deep"])
    assert [ok for _, ok in results] == [True, True, True]
    _truncate_largest_state_file(ckpt.checkpoint_dir(save, 2))
    with pytest.raises(SystemExit):
        checkpoint_util.main(["verify", "--load", save])
    out = capsys.readouterr().out
    assert "INVALID" in out and "size mismatch" in out
    pruned = checkpoint_util.main(["prune", "--load", save,
                                   "--keep_latest_k", "1", "--dry_run"])
    assert pruned == [1, 2]
    assert ckpt.committed_iterations(save) == [1, 2, 3]
    pruned = checkpoint_util.main(["prune", "--load", save,
                                   "--keep_latest_k", "1"])
    assert pruned == [1, 2]
    assert ckpt.committed_iterations(save) == [3]
    assert ckpt.read_tracker(save) == 3


def _fake_ckpt(save, it, tags=()):
    path = ckpt.checkpoint_dir(save, it)
    os.makedirs(path)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{}")
    ckpt.write_manifest(path, it, tags=tags)
    with open(os.path.join(save, ckpt.TRACKER), "w") as f:
        f.write(str(it))


def test_preempted_checkpoint_survives_pruning(tmp_path):
    save = str(tmp_path / "ckpt")
    os.makedirs(save)
    _fake_ckpt(save, 1, tags=("preemption",))
    _fake_ckpt(save, 2)
    _fake_ckpt(save, 3, tags=("preemption",))
    _fake_ckpt(save, 4)
    _fake_ckpt(save, 5)
    assert ckpt.checkpoint_tags(ckpt.checkpoint_dir(save, 3)) == (
        "preemption",)
    assert ckpt.prune_checkpoints(save, 1, dry_run=True) == [1, 2, 4]
    assert ckpt.committed_iterations(save) == [1, 2, 3, 4, 5]
    assert ckpt.prune_checkpoints(save, keep_latest_k=1) == [1, 2, 4]
    assert ckpt.committed_iterations(save) == [3, 5]
    assert ckpt.prune_checkpoints(save, 1, dry_run=True) == []


def test_checkpoint_util_verify_prints_preemption_tag(tmp_path, capsys):
    save = str(tmp_path / "ckpt")
    os.makedirs(save)
    _fake_ckpt(save, 7, tags=("preemption",))
    checkpoint_util.main(["verify", "--load", save])
    assert "[tags: preemption]" in capsys.readouterr().out


def test_cleanup_staging_age_guard(tmp_path):
    save = str(tmp_path)
    stage = ckpt.checkpoint_dir(save, 3) + ckpt.STAGING_SUFFIX
    os.makedirs(os.path.join(stage, "state"))
    with open(os.path.join(stage, "state", "d"), "w") as f:
        f.write("x")  # freshly written: a live writer
    assert ckpt.cleanup_staging(save, min_age_seconds=3600) == []
    assert os.path.isdir(stage)
    assert ckpt.cleanup_staging(save) == ["iter_0000003.tmp"]
    assert not os.path.exists(stage)


def test_global_batch_indivisible_by_new_dp_is_loud():
    from megatron_tpu_torch.training.microbatches import MicroBatchCalculator

    with pytest.raises(ValueError) as e:
        MicroBatchCalculator(micro_batch_size=3, target_global_batch=16,
                             data_parallel=2)
    assert "micro_batch_size from [1, 2, 4, 8]" in str(e.value)
    assert "invariant" in str(e.value)
    with pytest.raises(ValueError) as e:
        MicroBatchCalculator(micro_batch_size=1, target_global_batch=16,
                             data_parallel=3)
    assert "data-parallel degree dividing 16" in str(e.value)
    assert "[1, 2, 4, 8, 16]" in str(e.value)
    MicroBatchCalculator(micro_batch_size=2, target_global_batch=16,
                         data_parallel=2)


# -- verify_correctness ------------------------------------------------------

HF_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64,
               rms_norm_eps=1e-5, tie_word_embeddings=False)


@pytest.fixture(scope="module", params=["llama", "mistral"])
def hf_dir(request, tmp_path_factory):
    from transformers import (
        LlamaConfig, LlamaForCausalLM, MistralConfig, MistralForCausalLM,
    )

    torch.manual_seed(0)
    if request.param == "llama":
        model = LlamaForCausalLM(LlamaConfig(**HF_TINY))
    else:
        model = MistralForCausalLM(MistralConfig(**HF_TINY, sliding_window=8))
    out = str(tmp_path_factory.mktemp(request.param))
    model.save_pretrained(out, safe_serialization=False)
    return out


def test_verify_correctness_logits_against_hf(hf_dir):
    lines = []
    got = verify_correctness.main(
        ["--model", hf_dir, "--iters", "2", "--batch", "2", "--seq", "32",
         "--device", "cpu"], log=lines.append)
    assert lines[-1] == "PASS"
    assert got["iters"] == 2 and got["threshold"] == 0.01
    assert got["avg_mean_abs_err"] < 1e-5
    assert got["avg_loss_delta"] < 1e-5


def test_verify_correctness_adamw_parity(hf_dir):
    lines = []
    got = verify_correctness.main(
        ["--model", hf_dir, "--batch", "2", "--seq", "32",
         "--train_iters", "3", "--device", "cpu"], log=lines.append)
    assert lines[-1] == "PASS"
    assert (got["loss_bound"], got["param_bound"]) == (1e-3, 1e-3)
    assert got["worst_loss_delta"] < 1e-5
    assert got["param_delta"] < 1e-5


def test_verify_correctness_reads_only_a_directory(tmp_path):
    with pytest.raises(SystemExit, match="not a directory"):
        verify_correctness.main(["--model", "meta-llama/Llama-2-7b-hf",
                                 "--device", "cpu"])
