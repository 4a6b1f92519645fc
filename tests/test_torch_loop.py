"""The port's train loop in-process on the CPU, against itself and the
JAX package's TrainLoop.

The same tiny model (2 layers, h 32, fp32) and the same seeded batches
(a 48- or 64-sample pool that the factory cycles through, so runs cross
epoch boundaries and rebuild the prefetcher) go through both loops; the
port's state starts from the JAX loop's init params. Checked:

  * the async loop (prefetcher + metrics read one step late) gives the
    synchronous loop's losses bitwise, with one host sync per step;
  * a nan_loss window trips the sentinel into the same rollback in both
    modes and both packages: the same trip and rollback iterations and
    fast-forward, port sync == async bitwise, and the port within 1e-4
    of the JAX losses at every iteration (fp32, different summation
    orders; the gate of tests/test_torch_train.py);
  * the journal: the JAX run's event kinds, step-record fields and
    goodput keys, with warm-up only on the first step;
  * the replay check passes clean and raises SDCError under corrupt_step;
  * --save_interval auto takes a cadence and saves; --skip_iters,
    --exit_interval, --eval_only with --metrics; a --profile window
    writes a Chrome trace.
"""

import json
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.telemetry.journal import read_events as j_read_events
from megatron_tpu.training import resilience as jres
from megatron_tpu.training.pretrain import TrainLoop as JTrainLoop
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.telemetry.journal import read_events
from megatron_tpu_torch.training import resilience
from megatron_tpu_torch.training.optimizer import leaf_paths
from megatron_tpu_torch.training.pretrain import TrainLoop

MODEL = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
             num_kv_heads=2, ffn_hidden_size=64, vocab_size=64,
             seq_length=16, params_dtype="float32")
TRAIN = dict(micro_batch_size=2, global_batch_size=16, log_interval=1,
             seed=7)


def _tcfg(train_iters=9, **kw):
    return tconfig.RunConfig(
        model=tconfig.ModelConfig(**MODEL).validate(),
        optimizer=tconfig.OptimizerConfig(lr=1e-3, lr_decay_style="constant"),
        training=tconfig.TrainingConfig(train_iters=train_iters, **TRAIN,
                                        **kw))


def _jcfg(train_iters=9, **kw):
    # tests/conftest.py's 8-device fake CPU mesh: gbs 16 = mbs 2 x dp 8
    return jconfig.RunConfig(
        model=jconfig.ModelConfig(**MODEL).validate(),
        parallel=jconfig.ParallelConfig(),
        optimizer=jconfig.OptimizerConfig(lr=1e-3,
                                          lr_decay_style="constant"),
        training=jconfig.TrainingConfig(train_iters=train_iters, **TRAIN,
                                        **kw))


def _factory(n_samples=48, seq=16, vocab=64, seed=3):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, vocab, (n_samples, seq + 1))

    def factory(consumed, gbs):
        def gen():
            i = consumed % n_samples
            while i + gbs <= n_samples:
                rows = pool[i:i + gbs]
                yield {"tokens": rows[:, :-1].astype(np.int64),
                       "labels": rows[:, 1:].astype(np.int64),
                       "loss_mask": np.ones((gbs, seq), np.float32)}
                i += gbs
        return gen()

    return factory


def _losses(logs):
    out = {}
    for line in logs:
        m = re.match(r"iteration (\d+)/\d+ \|.*?lm loss: ([0-9.einfa-]+)",
                     line)
        if m:
            out[int(m.group(1))] = m.group(2)
    return out


def _port_loop(cfg, jloop=None, logs=None):
    """A port TrainLoop on the CPU, its params copied from a JAX loop's
    init when one is given."""
    loop = TrainLoop(cfg, log=(logs.append if logs is not None
                               else lambda m: None), device="cpu")
    if jloop is not None:
        src = params_from_numpy(jax.device_get(jloop.state.params),
                                cfg.model, device="cpu")
        with torch.no_grad():
            for (_, dst), (_, s) in zip(leaf_paths(loop.state.params),
                                        leaf_paths(src)):
                dst.copy_(s)
    return loop


def test_async_loop_matches_sync_bitwise():
    factory = _factory()
    curves = {}
    for tag, async_on in (("sync", False), ("async", True)):
        logs = []
        loop = _port_loop(_tcfg(async_loop=async_on), logs=logs)
        loop.train(factory)
        assert loop.iteration == 9 and loop.consumed_samples == 9 * 16
        # one blocking host read per step, none hidden elsewhere
        assert loop.host_sync_points == 9
        curves[tag] = _losses(logs)
    assert set(curves["sync"]) == set(range(1, 10))
    assert curves["sync"] == curves["async"]  # bitwise (string) equal


ROLLBACK = dict(save_interval=4, async_save=False, divergence_patience=2,
                rollback_on_divergence=True)


def _assert_rollback_lines(logs):
    assert any("tripped at iteration 5" in ln and
               "rolled back to checkpoint at iteration 4" in ln
               for ln in logs), logs
    assert any("iteration 5: update skipped (post-rollback "
               "fast-forward)" in ln for ln in logs)


def test_async_rollback_matches_sync_bitwise(tmp_path, monkeypatch):
    """iterations 4, 5 poisoned -> the optimizer skips them -> a streak of
    2 trips at 5; rollback to the iteration-4 checkpoint, fast-forward 5,
    train 6..8 again, in both loops."""
    monkeypatch.setenv(resilience.FAULT_ENV, "nan_loss:4:2")
    curves = {}
    for tag, async_on in (("sync", False), ("async", True)):
        logs = []
        loop = _port_loop(_tcfg(8, save=str(tmp_path / f"ck_{tag}"),
                                async_loop=async_on, **ROLLBACK), logs=logs)
        loop.train(_factory(n_samples=64))
        assert loop.iteration == 8
        _assert_rollback_lines(logs)
        curves[tag] = _losses(logs)
    assert curves["sync"] == curves["async"]
    assert set(curves["async"]) == {1, 2, 3, 4, 6, 7, 8}
    for it in (6, 7, 8):
        assert math.isfinite(float(curves["async"][it]))


def test_rollback_matches_jax(tmp_path, monkeypatch):
    """The same fault through the JAX TrainLoop and the port's async loop
    from the same init: the same trip, rollback and fast-forward, and
    losses within 1e-4 at every iteration."""
    monkeypatch.setenv(resilience.FAULT_ENV, "nan_loss:4:2")
    jlogs, logs = [], []
    jloop = JTrainLoop(_jcfg(8, save=str(tmp_path / "ck_jax"), **ROLLBACK),
                       log=jlogs.append)
    loop = _port_loop(_tcfg(8, save=str(tmp_path / "ck"), **ROLLBACK),
                      jloop, logs)
    loop.train(_factory(n_samples=64))
    jloop.train(_factory(n_samples=64))
    for lines in (logs, jlogs):
        _assert_rollback_lines(lines)
    got, want = _losses(logs), _losses(jlogs)
    assert set(got) == set(want) == {1, 2, 3, 4, 6, 7, 8}
    for it in want:
        if math.isnan(float(want[it])):
            assert math.isnan(float(got[it])), it
        else:
            assert abs(float(got[it]) - float(want[it])) <= 1e-4, (
                it, got[it], want[it])


def test_journal_matches_jax_and_steady_state_sync_freedom(tmp_path):
    from megatron_tpu_torch.telemetry.metrics import default_registry

    before = default_registry().counter(
        "train_host_syncs_total",
        "blocking device->host transfers issued by the train loop").value()
    tele, jtele = str(tmp_path / "tele"), str(tmp_path / "jtele")
    loop = _port_loop(_tcfg(8, telemetry_dir=tele))
    loop.train(_factory())
    assert loop.host_sync_points == 8
    assert loop.telemetry.metrics.get(
        "train_host_syncs_total").value() - before == 8
    evs, torn = read_events(os.path.join(tele, "events.jsonl"))
    assert torn is None
    steps = [e for e in evs if e["kind"] == "step"]
    assert [e["iteration"] for e in steps] == list(range(1, 9))
    # the first step's warm-up is the compile bucket; no compiler runs
    assert steps[0]["compiles"] == 0 and steps[0]["compile_ms"] > 0
    for e in steps[1:]:
        assert "compiles" not in e and "compile_ms" not in e, e
    for e in steps[2:]:
        assert e["data_wait_ms"] < 50.0, e

    JTrainLoop(_jcfg(8, telemetry_dir=jtele), log=lambda m: None).train(
        _factory())
    jevs, _ = j_read_events(os.path.join(jtele, "events.jsonl"))
    # either package's reader reads the other's journal
    assert j_read_events(os.path.join(tele, "events.jsonl"))[0] == evs
    assert read_events(os.path.join(jtele, "events.jsonl"))[0] == jevs
    assert [e["kind"] for e in evs] == [e["kind"] for e in jevs]
    jsteps = [e for e in jevs if e["kind"] == "step"]
    for t, j in zip(steps, jsteps):
        assert set(t) == set(j), (sorted(t), sorted(j))
    goodput = [e for e in evs if e["kind"] == "goodput"]
    jgoodput = [e for e in jevs if e["kind"] == "goodput"]
    assert set(goodput[-1]) == set(jgoodput[-1])
    assert goodput[-1]["compile_s"] > 0 and goodput[-1]["productive_s"] > 0


def test_replay_check_passes_clean_and_catches_corrupt_step(tmp_path,
                                                            monkeypatch):
    tele = str(tmp_path / "tele")
    loop = _port_loop(_tcfg(6, replay_check_interval=2))
    loop.train(_factory())
    assert loop.replay_checks == [2, 4, 6]

    monkeypatch.setenv(resilience.FAULT_ENV, "corrupt_step:4")
    loop = _port_loop(_tcfg(6, replay_check_interval=2, telemetry_dir=tele))
    with pytest.raises(resilience.SDCError, match="iteration 4"):
        loop.train(_factory())
    assert loop.replay_checks == [2]
    evs, _ = read_events(os.path.join(tele, "events.jsonl"))
    sdc = [e for e in evs if e["kind"] == "sdc_detected"]
    assert sdc and sdc[0]["iteration"] == 4
    assert sdc[0]["leaves"][0].startswith("state/params/")


def test_save_interval_auto_takes_a_cadence_and_saves(tmp_path):
    tele = str(tmp_path / "tele")
    cfg = _tcfg(12, save=str(tmp_path / "ck"), save_interval_auto=True,
                save_interval_floor=3, preempt_save_timeout=1e-3,
                telemetry_dir=tele)
    loop = _port_loop(cfg)
    loop.train(_factory())
    saved = [s["iteration"] for s in loop.saves]
    # the grace window is far below one step, so the floor is the cadence
    assert saved == [3, 6, 9, 12], saved
    evs, _ = read_events(os.path.join(tele, "events.jsonl"))
    retunes = [e for e in evs if e["kind"] == "cadence_retune"]
    assert retunes and retunes[0]["to_interval"] == 3
    commits = [e for e in evs if e["kind"] == "checkpoint_commit"]
    assert [e["iteration"] for e in commits] == saved


def test_skip_iters_exit_interval_and_eval_only_with_metrics(tmp_path):
    logs = []
    loop = _port_loop(_tcfg(9, skip_iters=(3,), exit_interval=5,
                            save=str(tmp_path / "ck"), save_interval=100),
                      logs=logs)
    loop.train(_factory())
    assert loop.iteration == 5
    assert "iteration 3: update skipped (--skip_iters)" in logs
    assert set(_losses(logs)) == {1, 2, 4, 5}
    assert [s["iteration"] for s in loop.saves] == [5]

    logs = []
    loop = _port_loop(_tcfg(9, eval_only=True, eval_iters=2,
                            metrics=("perplexity", "accuracy")), logs=logs)
    loop.train(_factory(), lambda: _factory()(0, 16))
    assert loop.iteration == 0 and len(loop.evals) == 1
    ev = loop.evals[0]
    assert set(ev) == {"lm_loss", "ppl", "perplexity", "accuracy",
                       "iteration"}
    assert abs(ev["perplexity"] - math.exp(ev["lm_loss"])) < 1e-3
    assert 0.0 <= ev["accuracy"] <= 1.0
    assert any(ln.startswith("validation | lm loss: ") for ln in logs)


def test_profile_window_writes_a_chrome_trace(tmp_path):
    tele = str(tmp_path / "tele")
    loop = _port_loop(_tcfg(5, profile=True, profile_step_start=2,
                            profile_step_end=4, telemetry_dir=tele))
    loop.train(_factory())
    assert len(loop.profile_traces) == 1
    path = loop.profile_traces[0]
    assert path.startswith(os.path.join(tele, "traces"))
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    evs, _ = read_events(os.path.join(tele, "events.jsonl"))
    begin = [e for e in evs if e["kind"] == "profile_begin"]
    end = [e for e in evs if e["kind"] == "profile_end"]
    assert begin[0]["iteration"] == 2 and begin[0]["until"] == 4
    assert end[0]["path"] == path


def test_fault_env_is_parsed_as_jax_parses_it(monkeypatch):
    for raw in ("kill_during_save:4,nan_loss:3:2", "preempt_at:5",
                "hang_step:4, corrupt_step:2 ,slow_save:500",
                "reject_admission", ""):
        assert resilience.parse_fault_env(raw) == jres.parse_fault_env(raw)
    for bad in ("nan_loss:x", "kill_at:1:y"):
        with pytest.raises(ValueError, match="malformed"):
            resilience.parse_fault_env(bad)
    monkeypatch.setenv(resilience.FAULT_ENV, "nan_loss:3:2,kill_at:7")
    for kind in ("nan_loss", "kill_at", "hang_step"):
        for it in range(10):
            assert resilience.fault_active(kind, it) == \
                jres.fault_active(kind, it)
