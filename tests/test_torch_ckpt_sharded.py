"""The sharded checkpoint layout: saved at one topology, loaded at any.

One spawn of 8 gloo ranks (tp2 x pp2 x dp2, ZeRO-1) for the file
(tests/_torch_ckpt_worker.py): it saves a TrainState known from one
process (bf16 params, fp32 masters, Adam moments after 2 steps) from its
8 slices, and runs TrainLoop uninterrupted, saved and resumed, preempted
on one rank, and rolled back. Against those:

  * the checkpoint loads at world size 1, tp2, pp2, pp2 x vpp2, dp2 with
    ZeRO-1, cp2, tp2 x cp2, cp2 x dp2 with ZeRO-1 and the saving
    topology, every leaf of params, master, mu and nu (and step) bitwise
    equal to the one-process state cut by the training path's own rules,
    each rank reading exactly its own bytes (the JAX package's
    test_cross_topology_restore, tests/test_checkpoint.py:66, at more
    topologies); the same state saved at cp2 x dp4 with ZeRO-1 (a second
    save in the same spawn) loads bitwise at world size 1, cp2, tp2 x cp2
    and tp2;
  * no block is written twice, every element is covered once, and the
    bytes on disk are a world-1 save's within 1%;
  * a same-topology resume continues bitwise; a SIGTERM on one rank
    stops every rank after the same step with one committed preemption
    checkpoint; a rollback equals skipping the poisoned step; a run
    under --save_interval auto commits;
  * a rank that never votes leaves an uncommitted `.tmp` and the
    previous checkpoint as the newest valid one;
  * tools/finetune, tools/native_to_hf and the server's --load, at world
    size 1, read the 8-rank checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_ckpt_worker as C
import _torch_parallel_worker as W
from megatron_tpu_torch.config import ParallelConfig
from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDatasetBuilder
from megatron_tpu_torch.models.params import StatePlacement
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.optimizer import leaf_paths, nest_paths

# name -> (ParallelConfig kwargs, world size, ZeRO-1)
TOPOLOGIES = {
    "tp2": (dict(tensor_parallel=2), 2, False),
    "pp2": (dict(pipeline_parallel=2), 2, False),
    "pp2_vpp2": (dict(pipeline_parallel=2, virtual_pipeline_parallel=2),
                 2, False),
    "dp2_zero1": ({}, 2, True),
    "tp2_pp2_dp2_zero1": (C.SAVE_PARALLEL, 8, True),
    # the context axis: one more axis every leaf is replicated over
    "cp2": (dict(context_parallel=2), 2, False),
    "tp2_cp2": (dict(tensor_parallel=2, context_parallel=2), 4, False),
    "cp2_dp2_zero1": (dict(context_parallel=2), 4, True),
}
# the second save: cp2 x dp4 with ZeRO-1 on the same 8 ranks
CP_SAVE = dict(context_parallel=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    w = W.World(8, [
        ("save", "call", ("_torch_ckpt_worker:save_job", {"out_dir": out})),
        ("save_cp2", "call", ("_torch_ckpt_worker:save_job",
                              {"out_dir": out, "parallel": CP_SAVE,
                               "name": "sharded_cp2"})),
        ("train", "call", ("_torch_ckpt_worker:train_job",
                           {"out_dir": out}))])
    return out, w.results()


@pytest.fixture(scope="module")
def one_process(world):
    """The saved state, read back from rank 0's one-file-per-field save
    (the world-1 path the other checkpoint tests hold)."""
    out, _ = world
    cfg, template = C.one_process_state(seed=9, steps=0)
    state, it, consumed = ckpt.load_checkpoint(
        os.path.join(out, "world1"), template)
    assert (it, consumed) == (C.SAVE_ITERATION, 16)
    return cfg, state


def _fields(state):
    return ckpt._state_fields(state)


def _assert_bitwise(got, want, where):
    a, b = _fields(got), _fields(want)
    assert set(a) == set(b), where
    for field in a:
        assert set(a[field]) == set(b[field]), (where, field)
        for name, t in a[field].items():
            assert t.dtype == b[field][name].dtype, (where, field, name)
            assert torch.equal(t, b[field][name]), (where, field, name)


def test_world1_load_of_the_sharded_save_is_bitwise(world, one_process):
    out, _ = world
    cfg, want = one_process
    _, template = C.one_process_state(seed=9, steps=0)
    stats = {}
    got, it, consumed = ckpt.load_checkpoint(
        os.path.join(out, "sharded"), template, stats=stats)
    assert (it, consumed) == (C.SAVE_ITERATION, 16)
    _assert_bitwise(got, want, "world 1")
    assert stats["read_bytes"] == sum(
        t.numel() * t.element_size()
        for flat in _fields(want).values() for t in flat.values())


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_sharded_save_loads_bitwise_at_another_topology(world, one_process,
                                                        topology):
    _load_at(world, one_process, topology, "sharded")


@pytest.mark.parametrize("topology", ["cp2", "tp2_cp2", "tp2"])
def test_cp2_save_loads_bitwise_at_world1_and_other_topologies(
        world, one_process, topology):
    """A state saved at cp2 x dp4 with ZeRO-1 (every leaf replicated over
    the context ranks, written once) loads bitwise at world size 1, at
    cp2, at tp2 x cp2 and at tp2."""
    out, _ = world
    _, want = one_process
    _, template = C.one_process_state(seed=9, steps=0)
    got, it, _ = ckpt.load_checkpoint(os.path.join(out, "sharded_cp2"),
                                      template)
    assert it == C.SAVE_ITERATION
    _assert_bitwise(got, want, "world 1 from cp2")
    _load_at(world, one_process, topology, "sharded_cp2")


def _load_at(world, one_process, topology, name):
    out, _ = world
    cfg, full = one_process
    _, fresh = C.one_process_state(seed=9, steps=0)
    kw, size, zero1 = TOPOLOGIES[topology]
    par = ParallelConfig(**kw)
    for r in range(size):
        mesh = build_mesh(par, world_size=size, rank=r)
        want = C.slice_state(full, cfg, mesh, zero1)
        template = C.slice_state(fresh, cfg, mesh, zero1)
        stats = {}
        got, _, _ = ckpt.load_checkpoint(
            os.path.join(out, name), template,
            placement=StatePlacement.of(cfg, mesh, zero1), stats=stats)
        _assert_bitwise(got, want, f"{topology} rank {r}")
        # a rank reads its own share: each of its elements once
        assert stats["read_bytes"] == sum(
            t.numel() * t.element_size()
            for flat in _fields(want).values() for t in flat.values()), r


def _state_bytes(path):
    d = os.path.join(path, ckpt.STATE_DIR)
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
               if n.endswith(".pt"))


def test_no_block_is_written_twice_and_the_bytes_match_world1(world):
    out, results = world
    path = ckpt.checkpoint_dir(os.path.join(out, "sharded"),
                               C.SAVE_ITERATION)
    assert ckpt.verify_checkpoint(path, deep=True)[0]
    assert not os.path.exists(os.path.join(path, ckpt.VOTES_DIR))
    with open(os.path.join(path, ckpt.STATE_DIR, ckpt.LAYOUT)) as f:
        layout = json.load(f)
    assert layout["world_size"] == 8 and layout["zero1"]
    assert set(layout["fields"]) == {"params", "master", "mu", "nu",
                                     "step", "nonfinite_streak"}
    keys = set()
    for field, leaves in layout["fields"].items():
        for name, desc in leaves.items():
            cover = np.zeros(desc["shape"] or [1], np.int64)
            for b in desc["blocks"]:
                assert (b["file"], b["key"]) not in keys
                keys.add((b["file"], b["key"]))
                box = tuple(slice(o, o + n)
                            for o, n in zip(b["offsets"], b["sizes"]))
                cover[box or (slice(None),)] += 1
            assert (cover == 1).all(), (field, name)
    sharded = _state_bytes(path)
    world1 = _state_bytes(ckpt.checkpoint_dir(os.path.join(out, "world1"),
                                              C.SAVE_ITERATION))
    assert abs(sharded - world1) <= 0.01 * world1, (sharded, world1)
    history = results["save"]["history"]
    assert sum(h[0]["bytes"] for h in history) == sharded
    assert history[0][0]["bytes_all_ranks"] == sharded
    assert "commit_s" in history[0][0] and "voted_s" in history[1][0]


def test_same_topology_resume_continues_bitwise(world):
    ranks = world[1]["train"]["ranks"]
    for r in ranks:
        assert r["resume_equal"], r["rank"]
        assert r["resumed_from"] == 3
        assert r["resumed_losses"] == r["straight_losses"][2:]
        assert r["load_read_bytes"] > 0
    assert all(r["straight_losses"] == ranks[0]["straight_losses"]
               for r in ranks)


def test_a_sigterm_on_one_rank_stops_every_rank_after_one_step(world):
    train = world[1]["train"]
    assert [r["preempt_iteration"] for r in train["ranks"]] == [3] * 8
    assert [r["preempt_signal"] for r in train["ranks"]] == (
        [None, "SIGTERM"] + [None] * 6)
    save = train["dirs"]["preempt"]
    assert ckpt.read_tracker(save) == 3
    assert ckpt.committed_iterations(save) == [3]
    assert ckpt.checkpoint_tags(ckpt.checkpoint_dir(save, 3)) == (
        "preemption",)


def test_save_interval_auto_commits_at_world_size_8(world):
    save = world[1]["train"]["dirs"]["auto"]
    assert ckpt.read_tracker(save) == 2
    assert ckpt.verify_checkpoint(ckpt.checkpoint_dir(save, 2), deep=True)[0]


def test_a_rollback_at_world_size_8_equals_skipping_the_step(world):
    train = world[1]["train"]
    for r in train["ranks"]:
        assert r["rollback_iteration"] == 4
        assert r["rollback_equal"], r["rank"]
        assert r["rollback_losses"][-1] == r["skip_losses"][-1]


def test_a_rank_that_never_votes_leaves_the_previous_checkpoint(
        tmp_path, monkeypatch):
    """Two ranks of a tp2 save in one process: rank 1 votes for iteration
    1 and never for iteration 2 (as if killed before its vote)."""
    cfg, full = C.one_process_state(steps=0)
    par = ParallelConfig(tensor_parallel=2)
    meshes = [build_mesh(par, world_size=2, rank=r) for r in range(2)]
    states = [C.slice_state(full, cfg, m, False) for m in meshes]
    save = str(tmp_path / "ckpt")
    savers = [ckpt.AsyncCheckpointSaver(
        save, placement=StatePlacement.of(cfg, m, False)) for m in meshes]
    for saver, state in zip(savers, states):
        saver.save(state, 1)
    assert savers[1].wait() and savers[0].wait()
    assert ckpt.read_tracker(save) == 1
    monkeypatch.setattr(ckpt, "VOTE_TIMEOUT_S", 0.5)
    savers[0].save(states[0], 2)
    with pytest.raises(TimeoutError, match=r"ranks \[1\] did not vote"):
        savers[0].wait()
    assert os.path.isdir(ckpt.checkpoint_dir(save, 2) + ckpt.STAGING_SUFFIX)
    assert not os.path.exists(ckpt.checkpoint_dir(save, 2))
    assert ckpt.read_tracker(save) == 1
    assert ckpt.resolve_load_iteration(save) == (1, None)
    assert ckpt.list_valid_checkpoints(save) == [1]


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


def test_world1_tools_read_the_8_rank_checkpoint(world, corpus, tmp_path):
    from megatron_tpu_torch.interop.hf import params_to_hf_state_dict
    from megatron_tpu_torch.tools import finetune, native_to_hf
    from megatron_tpu_torch.tools import run_text_generation_server as srv

    train = world[1]["train"]
    load = train["dirs"]["resume"]
    want = train["saved_params"]

    cfg, params, it = srv.load_model(srv.parse_args(
        ["--load", load, "--device", "cpu"]))
    assert it == 2
    for name, t in leaf_paths(params):
        assert torch.equal(t, torch.from_numpy(want[name])), name

    out = native_to_hf.main(["--load", load, "--output", str(tmp_path / "hf"),
                             "--model_type", "llama", "--dtype", "float32",
                             "--device", "cpu"])
    sd = torch.load(os.path.join(out, "pytorch_model.bin"))
    ref = params_to_hf_state_dict(
        nest_paths({k: torch.from_numpy(v) for k, v in want.items()}), cfg,
        "llama")
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k

    loop = finetune.main(C.BASE_ARGV + [
        "--train_iters", "1", "--data_type", "gpt", "--data_path", corpus,
        "--split", "90,10,0", "--load", load, "--finetune", "--eval_only",
        "--eval_iters", "1"], log=lambda m: None)
    assert loop.load_s is not None and loop.state.master is None
    for name, t in leaf_paths(loop.state.params):
        assert torch.equal(t.detach(), torch.from_numpy(want[name])), name
