"""The port's checkpointing (megatron_tpu_torch/training/checkpointing.py)
on the CPU.

Save -> load is bitwise (torch.equal) for every TrainState leaf, the
iteration and consumed_samples, in fp32, in bf16 with fp32 masters and in
fp16 with a loss scaler; --finetune and --no_load_optim keep fresh
moments; a config mismatch raises naming every key; load_params_only
prefers the masters and a truncated master file raises; the async saver
returns before its commit, waits for the previous save, raises a thread
error again and prunes only committed checkpoints. The commit protocol
is the JAX package's: on a directory the port wrote, the JAX readers
(compute_manifest, read_tracker, verify_checkpoint,
list_valid_checkpoints, resolve_load_iteration) answer as the port's
do, intact, with a torn staging dir, a garbage tracker, a truncated
file and a missing manifest.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import os
import shutil
import threading
import warnings

import numpy as np
import pytest
import torch

from megatron_tpu.training import checkpointing as jckpt
from megatron_tpu_torch.config import OptimizerConfig, RunConfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import init_params
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.optimizer import (
    init_train_state, leaf_paths, tree_map,
)

CFG = presets.tiny(vocab_size=64, seq_length=16)


def _state(seed=0, dtype="float32"):
    """A TrainState whose every leaf holds seeded, distinct values."""
    cfg = dataclasses.replace(CFG, params_dtype=dtype)
    params = init_params(cfg, seed, device="cpu")
    state = init_train_state(OptimizerConfig(), params,
                             use_fp16_scaler=(dtype == "float16"))
    r = np.random.default_rng(seed)

    def fill(t):
        t.copy_(torch.from_numpy(r.normal(size=tuple(t.shape))))
        return t

    with torch.no_grad():
        tree_map(fill, state.mu)
        tree_map(fill, state.nu)
        if state.master is not None:
            tree_map(fill, state.master)
            tree_map(lambda p, m: p.copy_(m), state.params, state.master)
        state.step.fill_(int(r.integers(1, 100)))
        state.nonfinite_streak.fill_(int(r.integers(1, 5)))
        if state.scaler is not None:
            state.scaler.scale.fill_(2.0 ** 10)
            state.scaler.growth_tracker.fill_(3)
    return cfg, state


def _leaves(state):
    return dict(leaf for f, flat in ckpt._state_fields(state).items()
                for leaf in (((f, n), t) for n, t in flat.items()))


def _assert_state_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_save_load_is_bitwise_for_every_leaf(tmp_path, dtype):
    cfg, state = _state(0, dtype)
    save = str(tmp_path / "ckpt")
    config = RunConfig(model=cfg).to_dict()
    path = ckpt.save_checkpoint(save, state, iteration=7,
                                consumed_samples=123, config=config)
    assert ckpt.read_tracker(save) == 7
    files = set(os.listdir(os.path.join(path, "state")))
    want = {"params.pt", "mu.pt", "nu.pt", "step.pt",
            "nonfinite_streak.pt"}
    want |= {"master.pt"} if dtype != "float32" else set()
    want |= {"scaler.pt"} if dtype == "float16" else set()
    assert files == want
    _, template = _state(99, dtype)
    restored, it, consumed = ckpt.load_checkpoint(save, template,
                                                  config=config)
    assert restored is template and (it, consumed) == (7, 123)
    _assert_state_equal(restored, state)


def test_saved_files_hold_no_more_than_their_tensors(tmp_path):
    """torch.save of a view writes its whole storage: every tensor is
    saved as a copy of its own, so a file's size is its tensors' bytes
    plus the pickle's overhead, and the manifest records those sizes."""
    _, state = _state(0, "bfloat16")
    stacked = state.mu["layers"]["attn"]["wq"]
    state.mu["layers"]["attn"]["wq"] = stacked[:, :, :32]  # a strided view
    path = ckpt.save_checkpoint(str(tmp_path / "c"), state, 1)
    man = ckpt.compute_manifest(path, hashes=False)
    for field, flat in ckpt._state_fields(state).items():
        nbytes = sum(t.numel() * t.element_size() for t in flat.values())
        size = man[f"state/{field}.pt"]["size"]
        assert nbytes <= size <= nbytes + 4096 + 1024 * len(flat), field
    loaded = torch.load(os.path.join(path, "state", "mu.pt"))
    assert torch.equal(loaded["layers/attn/wq"], stacked[:, :, :32])


def test_finetune_and_no_load_optim_keep_fresh_moments(tmp_path):
    cfg, state = _state(0, "bfloat16")
    save = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(save, state, iteration=55, consumed_samples=999)
    fresh = init_train_state(OptimizerConfig(),
                             init_params(cfg, 99, device="cpu"))
    zero = lambda tree: all(not t.any() for _, t in leaf_paths(tree))

    _, template = _state(99, "bfloat16")
    template = init_train_state(OptimizerConfig(), template.params)
    restored, it, consumed = ckpt.load_checkpoint(save, template,
                                                  finetune=True)
    assert (it, consumed) == (0, 0) and int(restored.step) == 0
    assert zero(restored.mu) and zero(restored.nu)
    assert int(restored.nonfinite_streak) == 0
    for name in ("params", "master"):   # the weights come from the file
        for (n, a), (_, b) in zip(leaf_paths(getattr(restored, name)),
                                  leaf_paths(getattr(state, name))):
            assert torch.equal(a, b), (name, n)

    template = init_train_state(OptimizerConfig(), fresh.params)
    restored, it, consumed = ckpt.load_checkpoint(save, template,
                                                  no_load_optim=True)
    assert (it, consumed) == (55, 999)
    assert int(restored.step) == int(state.step)
    assert zero(restored.mu) and zero(restored.nu)
    for (n, a), (_, b) in zip(leaf_paths(restored.master),
                              leaf_paths(state.master)):
        assert torch.equal(a, b), n

    # an fp32 checkpoint (no masters) finetuned by a bf16 run: the masters
    # are the loaded params
    _, s32 = _state(1, "float32")
    ckpt.save_checkpoint(str(tmp_path / "f32"), s32, 3)
    template = init_train_state(OptimizerConfig(), init_params(
        dataclasses.replace(cfg, params_dtype="bfloat16"), 5, device="cpu"))
    restored, _, _ = ckpt.load_checkpoint(str(tmp_path / "f32"), template,
                                          finetune=True)
    for (n, m), (_, p) in zip(leaf_paths(restored.master),
                              leaf_paths(restored.params)):
        assert torch.equal(m, p.float()), n
    with pytest.raises(ValueError, match="no fp32 masters"):
        ckpt.load_checkpoint(str(tmp_path / "f32"), template)


def test_config_mismatch_raises_and_lists_every_key(tmp_path):
    cfg, state = _state()
    save = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(save, state, 1,
                         config=RunConfig(model=cfg).to_dict())
    drifted = RunConfig(model=dataclasses.replace(
        cfg, rope_theta=5e5, num_layers=3, layernorm_epsilon=1e-6)).to_dict()
    _, template = _state(9)
    with pytest.raises(ValueError) as e:
        ckpt.load_checkpoint(save, template, config=drifted)
    for key in ("rope_theta", "num_layers", "layernorm_epsilon"):
        assert key in str(e.value)
    # the same check as the JAX package's, key for key
    with pytest.raises(ValueError) as je:
        jckpt.check_config_compatibility(
            {"model": RunConfig(model=cfg).to_dict()["model"]}, drifted)
    assert str(je.value) == str(e.value)
    assert ckpt.SHAPE_KEYS == jckpt.SHAPE_KEYS
    assert ckpt.DRIFT_KEYS == jckpt.DRIFT_KEYS
    # finetune adopts the weights under the drifted config deliberately
    ckpt.load_checkpoint(save, template, config=drifted, finetune=True)


def test_load_params_only_prefers_masters_and_corruption_raises(tmp_path):
    cfg, state = _state(0, "bfloat16")
    with torch.no_grad():   # params that differ from bf16(master)
        tree_map(lambda p: p.add_(1.0), state.params)
    save = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(save, state, 7, 70)
    template = init_params(dataclasses.replace(cfg, params_dtype="float32"),
                           3, device="cpu")
    got = ckpt.load_params_only(save, template, iteration=7)
    for (n, a), (_, m) in zip(leaf_paths(got), leaf_paths(state.master)):
        assert a.dtype == torch.float32 and torch.equal(a, m), n
    master = os.path.join(ckpt.checkpoint_dir(save, 7), "state",
                          "master.pt")
    with open(master, "r+b") as f:
        f.truncate(os.path.getsize(master) // 2)
    with pytest.raises(Exception):
        ckpt.load_params_only(save, template, iteration=7)


def test_async_saver_returns_before_commit_and_waits(tmp_path, monkeypatch):
    _, state = _state()
    save = str(tmp_path / "ckpt")
    gate, entered = threading.Event(), threading.Event()
    real = ckpt.write_manifest

    def held_manifest(*a, **kw):
        entered.set()
        assert gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "write_manifest", held_manifest)
    saver = ckpt.AsyncCheckpointSaver(save)
    saver.save(state, 1, 10)
    assert entered.wait(30)
    # save() has returned while the commit is held: nothing committed yet
    assert ckpt.read_tracker(save) is None
    assert ckpt.committed_iterations(save) == []
    # the snapshot is the state at save(): an in-place update now (the
    # next optimizer step) does not reach the checkpoint
    before = state.mu["embed"]["tokens"].clone()
    with torch.no_grad():
        state.mu["embed"]["tokens"].add_(1.0)
    second = threading.Thread(target=saver.save, args=(state, 2, 20))
    second.start()
    second.join(0.3)
    assert second.is_alive()          # waits for the first commit
    gate.set()
    second.join(30)
    assert not second.is_alive()
    saver.close()
    assert ckpt.list_valid_checkpoints(save) == [1, 2]
    assert ckpt.read_tracker(save) == 2
    assert [h["iteration"] for h in saver.history] == [1, 2]
    assert all(h["stall_s"] <= h["commit_s"] for h in saver.history)
    mu1 = torch.load(os.path.join(ckpt.checkpoint_dir(save, 1), "state",
                                  "mu.pt"))
    assert torch.equal(mu1["embed/tokens"], before)


def test_async_saver_raises_thread_error_again(tmp_path, monkeypatch):
    _, state = _state()

    def broken(*a, **kw):
        raise OSError("disk full")

    real = ckpt.write_manifest
    saver = ckpt.AsyncCheckpointSaver(str(tmp_path / "ckpt"))
    monkeypatch.setattr(ckpt, "write_manifest", broken)
    saver.save(state, 1)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.save(state, 2)
    with pytest.raises(OSError, match="disk full"):
        saver.save(state, 3)       # save 2's error, before save 3 starts
    monkeypatch.setattr(ckpt, "write_manifest", real)
    saver.save(state, 4)
    saver.wait()
    monkeypatch.setattr(ckpt, "write_manifest", broken)
    saver.save(state, 5)
    with pytest.raises(OSError, match="disk full"):
        saver.close()              # save 5's error, at close
    assert ckpt.read_tracker(str(tmp_path / "ckpt")) == 4
    assert ckpt.committed_iterations(str(tmp_path / "ckpt")) == [4]


def test_keep_latest_k_prunes_only_committed(tmp_path):
    _, state = _state()
    save = str(tmp_path / "ckpt")
    stale = ckpt.checkpoint_dir(save, 9) + ckpt.STAGING_SUFFIX
    os.makedirs(stale)
    logs = []
    saver = ckpt.AsyncCheckpointSaver(save, keep_latest_k=2,
                                      log=logs.append)
    assert not os.path.exists(stale)
    # a legacy dir without a manifest is never auto-deleted
    legacy = ckpt.checkpoint_dir(save, 0)
    os.makedirs(os.path.join(legacy, "state"))
    open(os.path.join(legacy, "meta.json"), "w").write("{}")
    for it in (1, 2, 3):
        saver.save(state, it, it * 10)
    # an uncommitted staging dir of a later save is not touched by pruning
    os.makedirs(ckpt.checkpoint_dir(save, 5) + ckpt.STAGING_SUFFIX)
    saver.save(state, 4, 40)
    saver.close()
    assert ckpt.committed_iterations(save) == [0, 3, 4]
    assert os.path.isdir(ckpt.checkpoint_dir(save, 5) + ckpt.STAGING_SUFFIX)
    assert any("pruned" in m for m in logs)
    for it in (3, 4):
        assert ckpt.verify_checkpoint(ckpt.checkpoint_dir(save, it),
                                      deep=True)[0]


# -- the commit protocol against the JAX package's readers -------------------


def _truncate_largest_state_file(path):
    files = [os.path.join(r, f) for r, _, fs in os.walk(
        os.path.join(path, "state")) for f in fs]
    big = max(files, key=os.path.getsize)
    with open(big, "r+b") as f:
        f.truncate(os.path.getsize(big) // 2)


def _intact(save):
    """No damage."""


def _torn_tmp(save):
    stage = ckpt.checkpoint_dir(save, 8) + ckpt.STAGING_SUFFIX
    os.makedirs(os.path.join(stage, "state"))
    with open(os.path.join(stage, "state", "params.pt"), "wb") as f:
        f.write(b"x" * 100)


def _garbage_tracker(save):
    with open(os.path.join(save, ckpt.TRACKER), "w") as f:
        f.write("\x00garbage")


def _truncated(save):
    _truncate_largest_state_file(ckpt.checkpoint_dir(save, 6))


def _no_manifest(save):
    os.remove(os.path.join(ckpt.checkpoint_dir(save, 6), ckpt.MANIFEST))
    os.remove(os.path.join(ckpt.checkpoint_dir(save, 4), ckpt.MANIFEST))
    os.remove(os.path.join(ckpt.checkpoint_dir(save, 4), "meta.json"))


def _answers(mod, save):
    """What one package's readers say about `save`, with the checkpoint
    paths made relative so two copies of one directory compare."""
    out = {"tracker": mod.read_tracker(save),
           "valid": mod.list_valid_checkpoints(save),
           "valid_deep": mod.list_valid_checkpoints(save, deep=True)}
    for it in (2, 4, 6, 8):
        path = mod.checkpoint_dir(save, it)
        out[f"verify_{it}"] = mod.verify_checkpoint(path)
        out[f"verify_deep_{it}"] = mod.verify_checkpoint(path, deep=True)
        if os.path.isdir(path):
            out[f"manifest_{it}"] = mod.compute_manifest(path)
    try:
        it, reason = mod.resolve_load_iteration(save)
        out["resolve"] = (it, reason and reason.replace(save, "SAVE"))
    except FileNotFoundError as e:
        out["resolve"] = str(e).replace(save, "SAVE")
    out["after"] = sorted(os.listdir(save))
    return out


@pytest.mark.parametrize("damage,resolved", [
    (_intact, 6), (_torn_tmp, 6), (_garbage_tracker, 6), (_truncated, 4),
    (_no_manifest, 6)])
def test_commit_protocol_matches_jax_readers(tmp_path, damage, resolved):
    _, state = _state()
    written = str(tmp_path / "port")
    for it in (2, 4, 6):
        ckpt.save_checkpoint(written, state, it, it * 10)
    damage(written)
    copy = str(tmp_path / "copy")
    shutil.copytree(written, copy)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        port = _answers(ckpt, written)
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter("always")
        jax_ = _answers(jckpt, copy)
    port = {k: v.replace(written, "SAVE") if isinstance(v, str) else v
            for k, v in port.items()}
    jax_ = {k: v.replace(copy, "SAVE") if isinstance(v, str) else v
            for k, v in jax_.items()}
    assert port == jax_
    assert ([str(w.message).replace(written, "SAVE") for w in port_w]
            == [str(w.message).replace(copy, "SAVE") for w in jax_w])
    assert port["resolve"][0] == resolved


def test_server_serves_a_checkpoint_and_warns_without_one(tmp_path,
                                                          capsys):
    """run_text_generation_server --load: the saved architecture, the
    masters in the model's dtype, the iteration logged; no --load: the
    preset at random init, loudly warned."""
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    cfg, state = _state(0, "bfloat16")
    save = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(save, state, 4,
                         config=RunConfig(model=cfg).to_dict())
    args = rts.parse_args(["--load", save, "--device", "cpu"])
    got_cfg, params, it = rts.load_model(args)
    assert it == 4 and got_cfg.attention_impl == "pallas"
    assert dataclasses.replace(got_cfg, attention_impl=cfg.attention_impl) \
        == cfg
    for (n, p), (_, m) in zip(leaf_paths(params), leaf_paths(state.master)):
        assert p.dtype == torch.bfloat16 and torch.equal(p, m.bfloat16()), n
    assert f"loaded checkpoint at iteration 4 from {save}" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="num_layers"):
        rts.load_model(rts.parse_args(["--load", save, "--model_name",
                                       "llama2-7B", "--device", "cpu"]))
    _, _, it = rts.load_model(rts.parse_args(["--model_name", "tiny",
                                              "--device", "cpu"]))
    assert it is None
    assert "WARNING: serving randomly initialized weights" in \
        capsys.readouterr().out
