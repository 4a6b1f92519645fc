"""The port's multi-host coordination (training/coordination.py and its
wiring in the train loop and the checkpoint saver) against the JAX
package's tests/test_coordination.py:

  * every protocol unit of the JAX file (:60-461), the same call
    sequence on the port's ClusterCoordinator with the same outcomes,
    over the file backend and over the store backend (an in-process
    TCPStore, the kind of store a process group holds);
  * a JAX ClusterCoordinator as host 0 and the port's as host 1 on one
    directory reach the same topology, exit-iteration, commit, resume
    and broadcast agreements (the record format, not only the logic);
  * the store backend on a real two-process gloo group (the process
    group's own store): the JAX KV-backend drill's sequence;
  * the three two-host drills of the JAX file (:688, :772, :803), two
    `pretrain_gpt --device cpu` processes sharing only a
    --coordination_dir: a SIGTERM on one host drains both into one
    cluster-consistent `preemption` checkpoint (exit 0); a SIGKILLed
    host leaves its peer exiting 76 with one `peer_abort` journaled
    within the timeout; a host killed mid-save leaves no half-commit,
    and both resume from the older checkpoint with the uninterrupted
    run's losses bit for bit.

Every subprocess of the file (the drills, their oracle, the store drill)
starts at once in one fixture; the drills run shorter than JAX's: the
port compiles nothing.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import datetime
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from megatron_tpu.training import coordination as jcoord
from megatron_tpu_torch.telemetry.journal import read_events
from megatron_tpu_torch.tools import preprocess_data
from megatron_tpu_torch.training import checkpointing, coordination, resilience
from megatron_tpu_torch.training.coordination import (
    ClusterCoordinator, CommitAborted, CoordinationError, FileBackend,
    StoreBackend,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ["file", "store"]


# -- backends ------------------------------------------------------------------

_STORES = {}


def _backend(kind, root, num_hosts=2):
    """A backend over the shared medium named by `root`: a directory, or
    one in-process TCPStore per root."""
    if kind == "file":
        return FileBackend(str(root))
    if str(root) not in _STORES:
        _STORES[str(root)] = torch.distributed.TCPStore(
            "127.0.0.1", 0, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=30))
    return StoreBackend(num_hosts, store=_STORES[str(root)])


def _pair(kind, tmp_path, timeout=1.0, poll=0.02):
    d = tmp_path / "coord"
    a = ClusterCoordinator(_backend(kind, d), 0, 2,
                           peer_death_timeout_s=timeout, poll_s=poll)
    b = ClusterCoordinator(_backend(kind, d), 1, 2,
                           peer_death_timeout_s=timeout, poll_s=poll)
    return a, b


def _concurrently(fa, fb):
    out = {}
    t = threading.Thread(target=lambda: out.update(a=fa()))
    t.start()
    out["b"] = fb()
    t.join()
    return out["a"], out["b"]


@pytest.mark.parametrize("kind", BACKENDS)
def test_backend_atomic_records(tmp_path, kind):
    be = _backend(kind, tmp_path / "c")
    assert be.get_all("sig") == {}
    be.put("sig/0", "hello")
    be.put("sig/0", "world")  # overwrite
    be.put("sig/1", "x")
    assert be.get_all("sig") == {"0": "world", "1": "x"}
    be.delete("sig/0")
    be.delete("sig/0")  # idempotent
    assert be.get_all("sig") == {"1": "x"}


@pytest.mark.parametrize("kind", BACKENDS)
def test_topology_barrier_and_mismatch(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    ra, rb = _concurrently(lambda: a.topology_barrier(5),
                           lambda: b.topology_barrier(5))
    assert sorted(ra) == sorted(rb) == [0, 1]
    lone = ClusterCoordinator(_backend(kind, tmp_path / "solo"), 0, 2,
                              peer_death_timeout_s=1, poll_s=0.02)
    with pytest.raises(CoordinationError, match=r"hosts \[1\] missing"):
        lone.topology_barrier(0.3)
    d3 = tmp_path / "mismatch"
    c0 = ClusterCoordinator(_backend(kind, d3), 0, 2, poll_s=0.02)
    c1 = ClusterCoordinator(_backend(kind, d3, 3), 1, 3, poll_s=0.02)
    c1._put("topo/1", num_hosts=3)
    with pytest.raises(CoordinationError, match="disagreement"):
        c0.topology_barrier(5)


@pytest.mark.parametrize("kind", BACKENDS)
def test_signal_agreement_union_and_exit_iteration(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    assert b.cluster_signals() == {} and b.notice_host() is None
    a.publish_signals(["SIGTERM"])
    a.publish_signals(["SIGTERM"])  # idempotent
    assert b.cluster_signals()[0]["signals"] == ["SIGTERM"]
    assert b.notice_host() == 0
    (ta, na), (tb, nb) = _concurrently(
        lambda: a.agree_exit_iteration(5, 5),
        lambda: b.agree_exit_iteration(3, 5))
    assert (ta, na) == (tb, nb) == (5, 0)


@pytest.mark.parametrize("kind", BACKENDS)
def test_completion_ack_resolves_late_notice(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    a.ack_exit(50)
    b.publish_signals(["SIGTERM"])
    assert b.agree_exit_iteration(47, 5) == (50, 1)


@pytest.mark.parametrize("kind", BACKENDS)
def test_commit_reattempt_needs_fresh_votes(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    _concurrently(lambda: a.commit_barrier(7, "a0", 5),
                  lambda: b.commit_barrier(7, "b0", 5))
    _concurrently(lambda: a.commit_barrier(7, "a1", 5),
                  lambda: b.commit_barrier(7, "b1", 5))
    with pytest.raises(CommitAborted, match="attempt 2"):
        a.commit_barrier(7, "a2", 0.4)


@pytest.mark.parametrize("kind", BACKENDS)
def test_two_phase_commit_agreement_and_abort(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    _concurrently(lambda: a.commit_barrier(7, "ca", 5),
                  lambda: b.commit_barrier(7, "cb", 5))
    with pytest.raises(CommitAborted, match="iteration 8"):
        a.commit_barrier(8, "ca", 0.4)
    b.publish_abort("hang", iteration=9)
    t0 = time.monotonic()
    with pytest.raises(CommitAborted, match="hang"):
        a.commit_barrier(9, "ca", 30.0)
    assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("kind", BACKENDS)
def test_peer_abort_and_heartbeat_death(tmp_path, monkeypatch, kind):
    a, b = _pair(kind, tmp_path, timeout=0.3)
    b.heartbeat()
    assert a.check_peers() is None
    deadline = time.monotonic() + 5
    verdict = None
    while verdict is None and time.monotonic() < deadline:
        verdict = a.check_peers()
        time.sleep(0.05)
    assert verdict == {"host": 1, "cause": "peer_death",
                       "detail": verdict["detail"]}
    # a peer that never heartbeat is judged against the startup window
    a2 = ClusterCoordinator(_backend(kind, tmp_path / "n"), 0, 2,
                            peer_death_timeout_s=0.1, poll_s=0.02)
    monkeypatch.setenv(coordination.STARTUP_TIMEOUT_ENV, "0.4")
    t0 = time.monotonic()
    v = None
    while v is None and time.monotonic() < t0 + 5:
        v = a2.dead_peer()
        time.sleep(0.03)
    assert v == 1
    assert time.monotonic() - t0 >= 0.35
    b2 = ClusterCoordinator(a.backend, 1, 2, peer_death_timeout_s=0.3,
                            poll_s=0.02)
    b2.publish_abort("sdc", iteration=4)
    v = a.check_peers()
    assert v["host"] == 1 and v["cause"] == "sdc"
    assert b2.peer_abort() is None


@pytest.mark.parametrize("kind", BACKENDS)
def test_stale_incarnation_records_are_invisible(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    b.publish_abort("hang")
    b.publish_signals(["SIGTERM"])
    assert a.peer_abort() is not None
    ClusterCoordinator(a.backend, 1, 2, poll_s=0.02)
    assert a.peer_abort() is None
    assert a.cluster_signals() == {}


@pytest.mark.parametrize("kind", BACKENDS)
def test_resume_agreement_intersection(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    ra, rb = _concurrently(lambda: a.agree_resume_iteration([2, 4, 6], 5),
                           lambda: b.agree_resume_iteration([2, 4], 5))
    assert ra == rb == 4
    a2, b2 = _pair(kind, tmp_path / "n2")
    ra, rb = _concurrently(lambda: a2.agree_resume_iteration([2], 5),
                           lambda: b2.agree_resume_iteration([], 5))
    assert ra is rb is None


@pytest.mark.parametrize("kind", BACKENDS)
def test_broadcast_and_published_value(tmp_path, kind):
    a, b = _pair(kind, tmp_path)
    got, _ = _concurrently(
        lambda: b.broadcast(None, root=0, key="cfg", timeout_s=5),
        lambda: a.broadcast({"interval": 40}, root=0, key="cfg"))
    assert got == {"interval": 40}
    a.publish_value("cadence", 37)
    assert b.read_value("cadence") == 37
    assert b.read_value("cadence", host=1) is None


@pytest.mark.parametrize("kind", BACKENDS)
def test_sideband_watchdog_fires_on_poison(tmp_path, kind):
    a, b = _pair(kind, tmp_path, timeout=5.0, poll=0.02)
    fired = []
    a.start_watchdog(fired.append)
    try:
        time.sleep(0.1)
        assert not fired
        b.publish_abort("hang", iteration=3)
        deadline = time.monotonic() + 5
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired and fired[0]["cause"] == "hang"
        assert a._fresh("hb").get(0) is not None
    finally:
        a.stop_watchdog()


def test_single_process_gets_no_coordinator(tmp_path, monkeypatch):
    """No host identity: for_training returns None (the single-host
    paths unchanged); MEGATRON_TPU_COORD_* or torch.distributed.run's
    node rank and count make a file-backend coordinator heartbeating
    from construction, on local rank 0 only; a half-set pair is loud."""
    from megatron_tpu_torch.config import TrainingConfig

    for var in (coordination.COORD_HOST_ENV, coordination.COORD_NUM_HOSTS_ENV,
                coordination.NODE_RANK_ENV, coordination.NUM_NODES_ENV,
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    t = TrainingConfig(coordination_dir=str(tmp_path / "c"))
    assert coordination.for_training(t, log=lambda m: None) is None
    monkeypatch.setenv(coordination.COORD_HOST_ENV, "1")
    monkeypatch.setenv(coordination.COORD_NUM_HOSTS_ENV, "2")
    c = coordination.for_training(t, log=lambda m: None)
    assert isinstance(c.backend, FileBackend)
    assert (c.host, c.num_hosts) == (1, 2)
    assert c._fresh("hb").get(1) is not None
    assert c._watchdog is not None
    c.close()
    monkeypatch.delenv(coordination.COORD_NUM_HOSTS_ENV)
    with pytest.raises(ValueError, match="must be set together"):
        coordination.for_training(t, log=lambda m: None)
    # the launcher's node identity; a host's other ranks get none
    monkeypatch.delenv(coordination.COORD_HOST_ENV)
    monkeypatch.setenv(coordination.NODE_RANK_ENV, "1")
    monkeypatch.setenv(coordination.NUM_NODES_ENV, "2")
    assert coordination.resolve_host_identity() == (1, 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert coordination.for_training(t, log=lambda m: None) is None
    # without a directory the store backend needs the process group
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="not initialized"):
        coordination.for_training(TrainingConfig(), log=lambda m: None)


# -- per-host faults, cadence, flags -----------------------------------------


def test_host_faults_parse_and_target_one_host(monkeypatch):
    monkeypatch.setenv(resilience.FAULT_ENV,
                       "kill_host:1:4,preempt_host:0:3")
    assert resilience.host_fault_active("kill_host", 1, 4)
    assert not resilience.host_fault_active("kill_host", 0, 4)
    assert not resilience.host_fault_active("kill_host", 1, 5)
    assert resilience.host_fault_active("preempt_host", 0, 3)
    from megatron_tpu_torch.training.signal_handler import (
        DistributedSignalHandler,
    )

    with DistributedSignalHandler() as h:
        resilience.maybe_signal_host(1, 3)
        assert h.signals_received() == ()
        resilience.maybe_signal_host(0, 3)
        assert h.signals_received() == (signal.SIGTERM,)


def test_cadence_tuner_formula_and_retune():
    t = resilience.CheckpointCadenceTuner(grace_s=100.0, floor_steps=5)
    assert t.interval() is None
    for _ in range(10):
        t.note_step(1.0)
    for _ in range(10):
        t.note_commit(10.0)
    assert t.interval() == 90
    r = t.retune()
    assert r["to_interval"] == 90 and r["from_interval"] is None
    assert t.retune() is None
    for _ in range(50):
        t.note_commit(99.5)
    assert t.interval() == 5
    assert t.retune()["to_interval"] == 5
    t2 = resilience.CheckpointCadenceTuner(grace_s=20.0, floor_steps=2)
    n = t2.seed_from_journal([
        {"kind": "checkpoint_commit", "seconds": 4.0},
        {"kind": "preemption", "save_latency_ms": 6000.0},
        {"kind": "step"},
    ])
    assert n == 2
    t2.note_step(2.0)
    assert t2.interval() == 7
    with pytest.raises(ValueError, match="positive"):
        resilience.CheckpointCadenceTuner(grace_s=0.0)


def test_multi_host_flag_wiring():
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.config import TrainingConfig

    base = ["--model_name", "tiny", "--fp32", "--seq_length", "16",
            "--micro_batch_size", "1", "--global_batch_size", "1",
            "--train_iters", "1"]
    cfg = args_to_run_config(parse_args(
        base + ["--save_interval", "auto", "--save_interval_floor", "7",
                "--coordination_dir", "/tmp/c",
                "--peer_death_timeout_s", "9", "--seed_pipeline_offset",
                "3", "--data_parallel_random_init"]))
    t = cfg.training
    assert t.save_interval is None and t.save_interval_auto
    assert t.save_interval_floor == 7
    assert t.coordination_dir == "/tmp/c"
    assert t.peer_death_timeout_s == 9.0
    assert (t.seed_pipeline_offset, t.data_parallel_random_init) == (3, True)
    d = args_to_run_config(parse_args(base)).training
    assert (d.coordination_dir, d.peer_death_timeout_s,
            d.seed_pipeline_offset, d.data_parallel_random_init) == (
        None, 60.0, 100, False)
    with pytest.raises(SystemExit):
        args_to_run_config(parse_args(base + ["--save_interval",
                                              "sometimes"]))
    with pytest.raises(ValueError, match="peer_death_timeout_s"):
        TrainingConfig(peer_death_timeout_s=-1).validate()


def test_save_interval_auto_refused_on_coordinated_runs(tmp_path,
                                                        monkeypatch):
    from megatron_tpu_torch.config import (
        OptimizerConfig, RunConfig, TrainingConfig,
    )
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.training.pretrain import TrainLoop

    monkeypatch.setenv(coordination.COORD_HOST_ENV, "0")
    monkeypatch.setenv(coordination.COORD_NUM_HOSTS_ENV, "2")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    cfg = RunConfig(
        model=presets.tiny(vocab_size=64, seq_length=16),
        optimizer=OptimizerConfig(lr=1e-3, lr_decay_style="constant"),
        training=TrainingConfig(
            micro_batch_size=1, global_batch_size=8, train_iters=2,
            save=str(tmp_path / "ckpt"), save_interval_auto=True,
            coordination_dir=str(tmp_path / "coord")))
    with pytest.raises(ValueError, match="not supported on coordinated"):
        TrainLoop(cfg, log=lambda m: None, device="cpu")


# -- two-phase commit through the saver ---------------------------------------


class _StubCoordinator:
    """A num_hosts > 1 coordinator double: records votes, optionally
    refuses agreement."""

    def __init__(self, agree=True):
        self.num_hosts = 2
        self.host = 0
        self.votes = []
        self.agree = agree

    def commit_barrier(self, iteration, crc, timeout_s=None):
        self.votes.append((iteration, crc))
        if not self.agree:
            raise CommitAborted(f"stub refused iteration {iteration}")


def _stage_fake_checkpoint(save, iteration):
    stage = checkpointing.checkpoint_dir(str(save), iteration) \
        + checkpointing.STAGING_SUFFIX
    os.makedirs(os.path.join(stage, "state"))
    with open(os.path.join(stage, "state", "blob"), "w") as f:
        f.write("bytes")
    return stage


def test_finalize_two_phase_commit_and_abort(tmp_path):
    save = tmp_path / "ckpt"
    stage = _stage_fake_checkpoint(save, 3)
    coord = _StubCoordinator(agree=True)
    path = checkpointing._finalize(str(save), stage, 3, 30, None, None,
                                   coordinator=coord)
    assert os.path.isdir(path) and checkpointing.read_tracker(str(save)) == 3
    assert len(coord.votes) == 1 and coord.votes[0][0] == 3
    assert len(coord.votes[0][1]) == 8  # crc32 hex of the manifest
    stage = _stage_fake_checkpoint(save, 5)
    with pytest.raises(CommitAborted):
        checkpointing._finalize(str(save), stage, 5, 50, None, None,
                                coordinator=_StubCoordinator(agree=False))
    assert checkpointing.read_tracker(str(save)) == 3
    assert os.path.isdir(stage)
    assert checkpointing.list_valid_checkpoints(str(save)) == [3]


class _Journal:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append({"kind": kind, **fields})

    def flush(self):
        pass


def test_saver_journals_commit_abort(tmp_path):
    from megatron_tpu_torch.config import OptimizerConfig
    from megatron_tpu_torch.training.optimizer import init_train_state

    state = init_train_state(
        OptimizerConfig(lr=1e-3, lr_decay_style="constant"),
        {"w": torch.ones(2)})
    journal = _Journal()
    saver = checkpointing.AsyncCheckpointSaver(
        str(tmp_path / "s"), journal=journal,
        coordinator=_StubCoordinator(agree=False))
    saver.save(state, 1, 10)
    with pytest.raises(CommitAborted):
        saver.wait()
    assert [e["kind"] for e in journal.events] == ["checkpoint_begin",
                                                   "commit_abort"]
    assert journal.events[1]["iteration"] == 1
    assert journal.events[1]["host"] == 0
    assert checkpointing.read_tracker(str(tmp_path / "s")) is None


def test_event_counters_on_metrics_registry(tmp_path):
    from megatron_tpu_torch.config import TrainingConfig
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.telemetry.run import for_training

    reg = MetricsRegistry()
    tcfg = TrainingConfig(telemetry_dir=str(tmp_path / "tele"))
    rt = for_training(tcfg, log=lambda m: None, registry=reg)
    try:
        rt.emit("preemption", iteration=3, notice_host=0)
        rt.emit("peer_abort", host=1, cause="hang")
        rt.emit("peer_abort", host=1, cause="peer_death")
        rt.emit("elastic_resume", from_dp=4, to_dp=2)
        rt.emit("hang_detected", iteration=5)
        rt.emit("sdc_detected", iteration=6)
        rt.journal_sink().emit("commit_abort", iteration=7, reason="x")
        rt.emit("cadence_retune", to_interval=40)
        text = reg.render()
    finally:
        rt.close()
    for needle in ("train_preemptions_total 1",
                   "train_peer_aborts_total 2",
                   "train_elastic_resumes_total 1",
                   "train_hangs_total 1",
                   "train_sdc_total 1",
                   "train_commit_aborts_total 1",
                   "train_cadence_retunes_total 1"):
        assert needle in text, (needle, text)
    evs, _ = read_events(os.path.join(str(tmp_path / "tele"),
                                      "events.jsonl"))
    assert [e for e in evs if e["kind"] == "commit_abort"]


def test_telemetry_report_merges_hosts(tmp_path):
    from megatron_tpu_torch.tools import telemetry_report

    def write(path, events):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")

    j0 = str(tmp_path / "h0" / "events.jsonl")
    j1 = str(tmp_path / "h1" / "events.jsonl")
    write(j0, [
        {"ts": 1, "kind": "run_start", "host": 0, "num_hosts": 2},
        {"ts": 2, "kind": "preemption", "iteration": 4, "notice_host": 1},
        {"ts": 3, "kind": "commit_abort", "iteration": 6, "host": 0},
    ])
    write(j1, [
        {"ts": 1, "kind": "run_start", "host": 1, "num_hosts": 2},
        {"ts": 2, "kind": "preemption", "iteration": 4, "notice_host": 1},
        {"ts": 3, "kind": "peer_abort", "host": 0, "cause": "hang"},
        {"ts": 4, "kind": "cadence_retune", "to_interval": 40},
    ])
    summary = telemetry_report.summarize(
        telemetry_report.load_journals([j0, j1]))
    co = summary["coordination"]
    assert co["hosts"] == [0, 1]
    assert co["preemption_notices_by_host"] == {"host 1": 1}
    assert co["peer_aborts"] == {"host 0: hang": 1}
    assert co["commit_aborts"]["total"] == 1
    assert co["commit_aborts"]["iterations"] == [6]
    assert co["cadence_retunes"]["last_interval"] == 40
    text = telemetry_report.render(summary)
    assert "peer aborts" in text and "host 0: hang: 1" in text
    assert "preemption notices" in text


# -- the record format: a JAX host and a port host on one directory ----------


def test_jax_and_port_hosts_agree_on_one_directory(tmp_path):
    d = str(tmp_path / "mixed")
    j = jcoord.ClusterCoordinator(jcoord.FileBackend(d), 0, 2,
                                  peer_death_timeout_s=5, poll_s=0.02)
    p = ClusterCoordinator(FileBackend(d), 1, 2, peer_death_timeout_s=5,
                           poll_s=0.02)
    rj, rp = _concurrently(lambda: j.topology_barrier(5),
                           lambda: p.topology_barrier(5))
    assert sorted(rj) == sorted(rp) == [0, 1]
    p.publish_signals(["SIGTERM"])
    assert j.cluster_signals()[1]["signals"] == ["SIGTERM"]
    assert j.notice_host() == p.notice_host() == 1
    (tj, nj), (tp, np_) = _concurrently(
        lambda: j.agree_exit_iteration(12, 5),
        lambda: p.agree_exit_iteration(9, 5))
    assert (tj, nj) == (tp, np_) == (12, 1)
    _concurrently(lambda: j.commit_barrier(12, "aaaa0000", 5),
                  lambda: p.commit_barrier(12, "bbbb1111", 5))
    assert {h: r["crc"] for h, r in p._fresh("commit/12/0").items()} == {
        0: "aaaa0000", 1: "bbbb1111"}
    rj, rp = _concurrently(lambda: j.agree_resume_iteration([4, 8, 12], 5),
                           lambda: p.agree_resume_iteration([8, 12], 5))
    assert rj == rp == 12
    got, _ = _concurrently(
        lambda: p.broadcast(None, root=0, key="cfg", timeout_s=5),
        lambda: j.broadcast({"interval": 40}, root=0, key="cfg"))
    assert got == {"interval": 40}
    p.heartbeat()
    assert j.check_peers() is None
    p.publish_abort("hang", iteration=13)
    assert j.check_peers()["cause"] == "hang"
    with pytest.raises(jcoord.CommitAborted, match="hang"):
        j.commit_barrier(13, "x", 5)


# -- subprocesses: the store drill and the two-host CLI drills ----------------


_STORE_DRILL = textwrap.dedent(r"""
    import sys, time
    import torch.distributed as dist
    from megatron_tpu_torch.training.coordination import (
        ClusterCoordinator, CommitAborted, StoreBackend)

    pid, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=pid, world_size=2)
    store = dist.distributed_c10d._get_default_store()
    print(f"P{pid} list_keys {hasattr(store, 'list_keys')}", flush=True)
    c = ClusterCoordinator(StoreBackend(2), pid, 2, peer_death_timeout_s=10,
                           poll_s=0.05)
    c.topology_barrier(60)
    if pid == 0:
        c.publish_signals(["SIGTERM"])
    deadline = time.monotonic() + 30
    while not c.cluster_signals():
        assert time.monotonic() < deadline, "union never arrived"
        time.sleep(0.05)
    assert c.notice_host() == 0
    target, nh = c.agree_exit_iteration(3 + pid, 30)
    assert (target, nh) == (4, 0), (target, nh)
    c.commit_barrier(7, f"crc{pid}", 30)
    print(f"P{pid} commit ok", flush=True)
    if pid == 0:
        try:
            c.commit_barrier(9, "crc0", 1.0)
            print("P0 COMMIT-9-DID-NOT-ABORT", flush=True)
        except CommitAborted:
            print("P0 commit 9 aborted as required", flush=True)
    val = c.broadcast({"interval": 40} if pid == 0 else None, root=0,
                      key="cfg", timeout_s=30)
    assert val == {"interval": 40}, val
    if pid == 1:
        c.publish_abort("hang", iteration=5)
    if pid == 0:
        deadline = time.monotonic() + 30
        v = None
        while v is None and time.monotonic() < deadline:
            v = c.peer_abort()
            time.sleep(0.05)
        assert v and v["cause"] == "hang" and v["host"] == 1, v
        print("P0 poison ok", flush=True)
    c.publish_value("done", True)
    deadline = time.monotonic() + 60
    while c.read_value("done", host=1 - pid) is None:
        assert time.monotonic() < deadline, "peer never finished"
        time.sleep(0.05)
    dist.barrier()
    print(f"P{pid} DRILL-OK", flush=True)
""")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", resilience.FAULT_ENV, "LOCAL_RANK",
                        coordination.COORD_HOST_ENV,
                        coordination.COORD_NUM_HOSTS_ENV,
                        coordination.NODE_RANK_ENV,
                        coordination.NUM_NODES_ENV)}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _host_argv(corpus, base, host, train_iters, save_interval, pdt, coord):
    argv = ["--model_name", "tiny", "--fp32", "--num_layers", "2",
            "--seq_length", "32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", str(train_iters),
            "--log_interval", "1", "--lr", "1e-3",
            "--lr_decay_style", "constant", "--data_path", corpus,
            "--split", "95,5,0", "--eval_interval", "100000",
            "--save", os.path.join(base, f"save{host}"),
            "--load", os.path.join(base, f"save{host}"),
            "--save_interval", str(save_interval),
            "--telemetry_dir", os.path.join(base, f"tele{host}"),
            "--preempt_save_timeout", "120", "--device", "cpu"]
    if coord:
        argv += ["--coordination_dir", coord, "--peer_death_timeout_s",
                 str(pdt)]
    return argv


class _Procs:
    """Subprocesses started at once, both pipes of each drained on a
    thread (a full pipe would block a host in print mid-pass)."""

    def __init__(self):
        self.items = []

    def start(self, name, cmd, env):
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, cwd=REPO)
        box = []
        t = threading.Thread(target=lambda: box.append(p.stdout.read()),
                             daemon=True)
        t.start()
        self.items.append((name, p, box, t, time.monotonic()))

    def wait(self, names=None, timeout=150):
        out = {}
        deadline = time.monotonic() + timeout
        for name, p, box, t, t0 in self.items:
            if names is not None and name not in names:
                continue
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            t.join(timeout=30)
            out[name] = (p.returncode, box[0] if box else "",
                         time.monotonic() - t0)
        return out


def _start_hosts(procs, name, corpus, base, faults, train_iters,
                 save_interval, pdt):
    coord = os.path.join(base, "coord")
    for host in range(2):
        extra = {coordination.COORD_HOST_ENV: str(host),
                 coordination.COORD_NUM_HOSTS_ENV: "2",
                 coordination.STARTUP_TIMEOUT_ENV: "120"}
        if faults.get(host):
            extra[resilience.FAULT_ENV] = faults[host]
        procs.start(f"{name}{host}",
                    [sys.executable, "-m",
                     "megatron_tpu_torch.tools.pretrain_gpt",
                     *_host_argv(corpus, base, host, train_iters,
                                 save_interval, pdt, coord)],
                    _env(**extra))


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drills")
    rng = np.random.default_rng(0)
    jsonl = tmp / "docs.jsonl"
    with open(jsonl, "w") as f:
        for _ in range(150):
            n = int(rng.integers(20, 60))
            f.write(json.dumps({"text": " ".join(
                str(int(x)) for x in rng.integers(0, 97, n))}) + "\n")
    corpus = str(tmp / "corpus")
    preprocess_data.main(["--input", str(jsonl), "--output_prefix", corpus,
                          "--tokenizer_type", "null", "--vocab_size", "97",
                          "--append_eod"])
    bases = {k: str(tmp / k) for k in ("preempt", "kill", "save", "oracle")}
    for b in bases.values():
        os.makedirs(b)
    procs = _Procs()
    from _torch_parallel_worker import free_port

    port = free_port()
    for pid in range(2):
        procs.start(f"store{pid}", [sys.executable, "-c", _STORE_DRILL,
                                    str(pid), str(port)], _env())
    # the notice lands on host 0 only, past the start; train_iters is
    # far beyond reach, so both hosts are mid-run when they drain
    _start_hosts(procs, "preempt", corpus, bases["preempt"],
                 {0: "preempt_host:0:25", 1: "preempt_host:0:25"},
                 3000, 100000, 30)
    _start_hosts(procs, "kill", corpus, bases["kill"],
                 {1: "kill_host:1:4"}, 2000, 100000, 4)
    _start_hosts(procs, "save", corpus, bases["save"],
                 {1: "kill_during_save:4"}, 8, 2, 5)
    # the oracle: one uncoordinated, uninterrupted process
    procs.start("oracle", [sys.executable, "-m",
                           "megatron_tpu_torch.tools.pretrain_gpt",
                           *_host_argv(corpus, bases["oracle"], 0, 8, 2,
                                       None, None)], _env())
    out = procs.wait(names={"save0", "save1"})
    # what the kill during the save left on each host, before the resume
    out["save_state"] = [
        (checkpointing.list_valid_checkpoints(
            os.path.join(bases["save"], f"save{h}")),
         checkpointing.read_tracker(os.path.join(bases["save"], f"save{h}")))
        for h in range(2)]
    # both hosts resume on a fresh coordination directory
    resume = _Procs()
    for host in range(2):
        resume.start(f"resume{host}",
                     [sys.executable, "-m",
                      "megatron_tpu_torch.tools.pretrain_gpt",
                      *_host_argv(corpus, bases["save"], host, 8, 2, 10,
                                  os.path.join(bases["save"], "coord2"))],
                     _env(**{coordination.COORD_HOST_ENV: str(host),
                             coordination.COORD_NUM_HOSTS_ENV: "2",
                             coordination.STARTUP_TIMEOUT_ENV: "120"}))
    out.update(procs.wait())
    out.update(resume.wait())
    return bases, out


def _events(base, host):
    evs, _ = read_events(os.path.join(base, f"tele{host}", "events.jsonl"))
    return evs


def _losses_by_iteration(stdout):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"iteration (\d+)/\d+ \|.*?lm loss: ([0-9.einf-]+)", stdout)}


def test_store_backend_two_process_drill(drills):
    _, out = drills
    for pid in range(2):
        rc, text, _ = out[f"store{pid}"]
        assert rc == 0, text[-3000:]
        assert f"P{pid} DRILL-OK" in text
    text0 = out["store0"][1]
    assert "P0 commit 9 aborted as required" in text0
    assert "COMMIT-9-DID-NOT-ABORT" not in text0
    assert "P0 poison ok" in text0


def test_sigterm_one_host_drains_both(drills):
    bases, out = drills
    base = bases["preempt"]
    for host in range(2):
        rc, text, _ = out[f"preempt{host}"]
        assert rc == 0, (host, text[-4000:])
        assert "preemption notice: expedited synchronous save" in text
    assert "preempt_host firing on host 0" in out["preempt0"][1]
    assert "preempt_host firing" not in out["preempt1"][1]
    trackers = [checkpointing.read_tracker(os.path.join(base, f"save{h}"))
                for h in range(2)]
    assert trackers[0] == trackers[1] and trackers[0] is not None, trackers
    assert 25 <= trackers[0] < 3000
    for h in range(2):
        ckpt = checkpointing.checkpoint_dir(os.path.join(base, f"save{h}"),
                                            trackers[h])
        assert checkpointing.verify_checkpoint(ckpt, deep=True)[0]
        assert "preemption" in checkpointing.checkpoint_tags(ckpt)
        assert checkpointing.committed_iterations(
            os.path.join(base, f"save{h}")) == [trackers[h]]
    pres = []
    for h in range(2):
        evs = _events(base, h)
        pre = [e for e in evs if e["kind"] == "preemption"]
        assert len(pre) == 1, (h, [e["kind"] for e in evs])
        assert pre[0]["notice_host"] == 0 and pre[0]["host"] == h
        pres.append(pre[0])
        run_end = [e for e in evs if e["kind"] == "run_end"][-1]
        assert run_end["received_signal"] == "SIGTERM"
    assert pres[0]["iteration"] == pres[1]["iteration"] == trackers[0]
    # both hosts' journals as one timeline, one process per host
    from megatron_tpu_torch.tools import telemetry_report

    trace = telemetry_report.write_perfetto(
        [os.path.join(base, f"tele{h}", "events.jsonl") for h in range(2)],
        os.path.join(base, "cluster.perfetto.json"))
    assert {e["pid"] for e in trace["traceEvents"]} == {0, 1}
    for pid in (0, 1):
        assert any(e["ph"] == "i" and e["name"] == "preemption"
                   and e["pid"] == pid for e in trace["traceEvents"])


def test_sigkill_one_host_peer_abort_within_timeout(drills):
    bases, out = drills
    rc1, out1, _ = out["kill1"]
    assert rc1 == -signal.SIGKILL, (rc1, out1[-2000:])
    assert "kill_host firing on host 1" in out1
    rc0, out0, wall = out["kill0"]
    assert rc0 == resilience.PEER_ABORT_EXIT_CODE, (rc0, out0[-4000:])
    assert "peer abort: host 1 (peer_death)" in out0
    pa = [e for e in _events(bases["kill"], 0) if e["kind"] == "peer_abort"]
    assert len(pa) == 1
    assert pa[0]["host"] == 1 and pa[0]["cause"] == "peer_death"
    assert pa[0]["observed_by"] == 0
    # bounded: the 4 s window plus start-up, nowhere near the 2000 steps
    assert wall < 100, wall
    assert not re.search(r"iteration 2000/2000", out0)


def test_kill_during_save_never_half_commits(drills):
    bases, out = drills
    base = bases["save"]
    rc1, out1, _ = out["save1"]
    assert rc1 == -signal.SIGKILL, (rc1, out1[-2000:])
    rc0, out0, _ = out["save0"]
    # the sideband's peer-death exit (76) and the commit barrier's own
    # dead-peer CommitAborted race; either way no tracker flipped
    assert rc0 in (resilience.PEER_ABORT_EXIT_CODE, 1), (rc0, out0[-4000:])
    assert ("peer abort: host 1" in out0
            or "commit ABORTED" in out0), out0[-4000:]
    kinds = [e["kind"] for e in _events(base, 0)]
    assert "peer_abort" in kinds or "commit_abort" in kinds
    # no half-commit: iteration 4 is valid on neither host
    assert out["save_state"] == [([2], 2), ([2], 2)]
    rc, oracle, _ = out["oracle"]
    assert rc == 0, oracle[-3000:]
    ref = _losses_by_iteration(oracle)
    assert set(ref) == set(range(1, 9))
    for h in range(2):
        rc, text, _ = out[f"resume{h}"]
        assert rc == 0, (h, text[-4000:])
        assert "loaded checkpoint at iteration 2" in text, (h, text[-3000:])
        losses = _losses_by_iteration(text)
        assert set(losses) == set(range(3, 9)), (h, sorted(losses))
        for it in range(3, 9):
            assert losses[it] == ref[it], (h, it, losses[it], ref[it])
        assert checkpointing.read_tracker(
            os.path.join(base, f"save{h}")) == 8
