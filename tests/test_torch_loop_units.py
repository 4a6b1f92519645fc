"""The port's loop modules unit by unit, against the JAX package's.

The same inputs go through both: the divergence sentinel (streaks, the
device streak override, loss spikes) gives the same verdicts; the
cadence tuner the same intervals; batch_fingerprint the same string;
the bitwise tree comparison the same mismatches (NaN payloads equal,
-0.0 != 0.0) over torch tensors; Timers.log_string the same line;
compute_metrics the same values within 1e-5; the goodput report the
same keys. Also: the step watchdog fires once after the first beat;
the prefetcher keeps strict order, discards in-flight batches on close,
passes consumption iterations to its transform and surfaces errors;
the journal rotates; a preemption-tagged checkpoint survives retention;
the CLI takes the loop's flags and refuses --compilation_cache_dir.
"""

import itertools
import math
import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.telemetry import goodput as jgoodput
from megatron_tpu.training import metrics as jmetrics
from megatron_tpu.training import resilience as jres
from megatron_tpu.training import timers as jtimers
from megatron_tpu_torch.arguments import args_to_run_config, parse_args
from megatron_tpu_torch.config import TrainingConfig
from megatron_tpu_torch.telemetry import goodput
from megatron_tpu_torch.telemetry.journal import EventJournal, read_events
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training import metrics, resilience, timers
from megatron_tpu_torch.training.prefetch import DevicePrefetcher
from megatron_tpu_torch.training.signal_handler import (
    DistributedSignalHandler,
)

LOSSES = [1.0, 1.1, float("nan"), 0.9, float("inf"), None, float("nan"),
          1.0, *([1.0] * 8), 5.0, 5.0, 1.0, 5.0, 5.0, 5.0, 6.0]


@pytest.mark.parametrize("kw", [dict(patience=3, spike_factor=0.0),
                                dict(patience=0, spike_factor=2.0,
                                     spike_patience=3, warmup_steps=5,
                                     ema_alpha=0.5),
                                dict(patience=2, spike_factor=1.5,
                                     spike_patience=2, warmup_steps=3)])
def test_sentinel_verdicts_match_jax(kw):
    t, j = resilience.DivergenceSentinel(**kw), jres.DivergenceSentinel(**kw)
    for i, loss in enumerate(LOSSES):
        skipped = loss is None or (i % 7 == 3)
        streak = 50 if i == 12 else None
        assert t.observe(loss, skipped, streak=streak) == \
            j.observe(loss, skipped, streak=streak), i
        assert (t.nonfinite_streak, t.spike_streak, t.ema) == \
            (j.nonfinite_streak, j.spike_streak, j.ema)
        if i == 9:
            t.reset()
            j.reset()


def test_cadence_tuner_matches_jax():
    t = resilience.CheckpointCadenceTuner(grace_s=30.0, floor_steps=5)
    j = jres.CheckpointCadenceTuner(grace_s=30.0, floor_steps=5)
    events = [{"kind": "checkpoint_commit", "seconds": 2.5},
              {"kind": "preemption", "save_latency_ms": 4000.0},
              {"kind": "step"}]
    assert t.seed_from_journal(events) == j.seed_from_journal(events) == 2
    rng = np.random.default_rng(0)
    for step_s in rng.uniform(0.05, 0.4, 40):
        t.note_step(step_s)
        j.note_step(step_s)
        assert t.retune() == j.retune()
        assert t.interval() == j.interval()
    with pytest.raises(ValueError, match="preempt_save_timeout"):
        resilience.CheckpointCadenceTuner(grace_s=0)


def test_fingerprint_and_bitwise_trees_match_jax():
    rng = np.random.default_rng(0)
    a = {"tokens": rng.integers(0, 9, (2, 4)),
         "labels": rng.integers(0, 9, (2, 4)),
         "loss_mask": np.ones((2, 4), np.float32)}
    b = {k: a[k].copy() for k in ("loss_mask", "labels", "tokens")}
    assert resilience.batch_fingerprint(a) == jres.batch_fingerprint(a) \
        == resilience.batch_fingerprint(b)
    poisoned = resilience.poison_batch(a)
    assert np.isinf(poisoned["loss_mask"].flat[0])
    assert resilience.batch_fingerprint(poisoned) == \
        jres.batch_fingerprint(jres.poison_batch(a))

    x = {"x": np.array([1.0, np.nan], np.float32),
         "y": {"z": np.array([0.0], np.float32)}}
    neg = {"x": x["x"].copy(), "y": {"z": np.array([-0.0], np.float32)}}
    as_torch = lambda t: {k: (as_torch(v) if isinstance(v, dict)  # noqa
                              else torch.from_numpy(v)) for k, v in t.items()}
    assert resilience.tree_bitwise_mismatch(as_torch(x), as_torch(x)) == []
    assert resilience.tree_bitwise_mismatch(as_torch(x), as_torch(neg)) == \
        ["y/z"]
    assert len(jres.tree_bitwise_mismatch(x, neg)) == 1
    params = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    before = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
    resilience.corrupt_params(params, 7)
    assert resilience.tree_bitwise_mismatch(params, before) == ["a"]


def test_timers_log_string_matches_jax():
    t, j = timers.Timers(1), jtimers.Timers(1)
    for tm in (t, j):
        tm.record("forward-backward-optimizer", 0.25)
        tm.record("batch-generator", 0.0125, level=0)
        tm.record("batch-transfer", 0.5, level=1)
        tm.record("hidden", 1.0, level=2)
    line = t.log_string(normalizer=2)
    assert line == j.log_string(normalizer=2) == (
        "time (ms) | batch-generator: 6.25 | batch-transfer: 250.00 | "
        "forward-backward-optimizer: 125.00")
    # the first read reset the windows
    assert t.log_string() == j.log_string()
    assert t.elapsed_ms() == j.elapsed_ms()
    assert t("x", 2).elapsed() == 0.0


def test_compute_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 8, 20)).astype(np.float32)
    labels = rng.integers(0, 20, (2, 8))
    labels[0, :3] = logits[0, :3].argmax(-1)
    mask = rng.choice([0.0, 0.25, 1.0], (2, 8)).astype(np.float32)
    per_token = rng.uniform(0, 5, (2, 8)).astype(np.float32)
    names = tuple(metrics.METRICS)
    got = metrics.compute_metrics(
        names, torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask), torch.from_numpy(per_token))
    want = jmetrics.compute_metrics(
        names, jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
        jnp.asarray(per_token))
    assert set(got) == set(want) == set(jmetrics.METRICS)
    for k in names:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.compute_metrics(("bleu",), *got.values())


def test_goodput_report_keys_match_jax():
    t, j = goodput.GoodputTracker(), jgoodput.GoodputTracker()
    for tr in (t, j):
        tr.attribute("productive", 0.5)
        tr.attribute("compile", 0.25)
        with tr.track("eval"):
            pass
    rt, rj = t.report(), j.report()
    assert set(rt) == set(rj)
    assert rt["productive_s"] == rj["productive_s"] == 0.5
    assert goodput.CATEGORIES == jgoodput.CATEGORIES
    with pytest.raises(ValueError, match="unknown goodput category"):
        t.attribute("naps", 1.0)
    tracker = goodput.RecompileTracker()
    snap = tracker.snapshot()
    tracker.note_warmup(1.5)
    assert tracker.delta(snap) == {"compiles": 0, "compile_seconds": 1.5,
                                   "trace_seconds": 0.0, "cache_hits": 0,
                                   "cache_misses": 0}


def test_step_watchdog_fires_once_after_the_first_beat():
    fired = []
    wd = resilience.StepWatchdog(0.15, fired.append, poll_s=0.02).start()
    try:
        time.sleep(0.3)
        assert not fired          # the clock starts at the first beat
        for _ in range(4):
            wd.beat()
            time.sleep(0.05)
        assert not fired
        wd.pause()
        time.sleep(0.3)
        assert not fired          # paused until the next beat
        wd.beat()
        time.sleep(0.5)
        assert len(fired) == 1 and fired[0] >= 0.15
        time.sleep(0.2)
        assert len(fired) == 1    # one hang, one verdict
    finally:
        wd.stop()


def _host_batches(n):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, 16, (2, 8)),
             "idx": np.full((2,), i, np.int64)} for i in range(n)]


def test_prefetcher_order_close_transform_and_errors():
    pf = DevicePrefetcher(iter(_host_batches(7)), "cpu", depth=2)
    seen = []
    while (b := next(pf, None)) is not None:
        assert isinstance(b["tokens"], torch.Tensor)
        seen.append(int(b["idx"][0]))
    assert seen == list(range(7)) and next(pf, None) is None
    assert pf.batches_put == 7
    pf.close()
    pf.close()

    pulled = []

    def endless():
        for i in itertools.count():
            pulled.append(i)
            yield {"x": np.full((1,), i, np.int64)}

    pf = DevicePrefetcher(endless(), "cpu", depth=2)
    assert int(next(pf)["x"][0]) == 0
    pf.close()
    n = len(pulled)
    time.sleep(0.2)
    assert len(pulled) == n <= 5

    calls = []
    pf = DevicePrefetcher(iter(_host_batches(4)), "cpu", depth=2,
                          first_iteration=11,
                          transform=lambda b, i: calls.append(i) or b)
    assert [next(pf, None) is None for _ in range(5)][-1]
    assert calls == [11, 12, 13, 14]
    pf.close()

    def broken():
        yield {"x": np.zeros((1,), np.int64)}
        raise RuntimeError("disk on fire")

    pf = DevicePrefetcher(broken(), "cpu", depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(pf)
    pf.close()
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter(()), "cpu", depth=0)


def test_signal_handler_records_signals_in_order():
    with DistributedSignalHandler(signals=(signal.SIGUSR1,
                                           signal.SIGUSR2)) as h:
        assert h.signals_received() == () and h.first_signal() is None
        os.kill(os.getpid(), signal.SIGUSR2)
        assert h.signals_received() == (signal.SIGUSR2,)
        assert h.first_signal()[0] == signal.SIGUSR2


def test_journal_rotates_and_keeps_segments(tmp_path):
    j = EventJournal(str(tmp_path), max_bytes=400, keep_segments=2)
    for i in range(40):
        j.emit("step", iteration=i, loss=np.float32(1.5),
               t=torch.tensor(2.0))
    j.close()
    assert len(j.segments()) == 3
    evs = j.events()
    assert [e["iteration"] for e in evs] == list(range(40 - len(evs), 40))
    assert evs[-1]["loss"] == 1.5 and evs[-1]["t"] == 2.0
    assert j.tail(3)[-1]["iteration"] == 39
    with open(j.path, "a") as f:
        f.write('{"ts": 1, "kind": "st')
    _, torn = read_events(j.path)
    assert torn == '{"ts": 1, "kind": "st'


def test_preemption_checkpoint_survives_retention(tmp_path):
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.config import OptimizerConfig
    from megatron_tpu_torch.training.optimizer import init_train_state

    cfg = presets.tiny(vocab_size=32, seq_length=8, num_layers=1,
                       hidden_size=16)
    state = init_train_state(OptimizerConfig(),
                             init_params(cfg, 0, device="cpu"))
    saver = ckpt.AsyncCheckpointSaver(str(tmp_path), keep_latest_k=1,
                                      async_save=False)
    saver.save(state, 2, tags=("preemption",))
    for it in (4, 6):
        saver.save(state, it)
    saver.close()
    assert ckpt.committed_iterations(str(tmp_path)) == [2, 6]
    assert ckpt.checkpoint_tags(ckpt.checkpoint_dir(str(tmp_path), 2)) == \
        ("preemption",)
    assert ckpt.checkpoint_tags(ckpt.checkpoint_dir(str(tmp_path), 6)) == ()
    assert saver.last_commit_seconds is not None


def test_cli_takes_the_loop_flags():
    argv = ["--model_name", "tiny", "--save_interval", "auto",
            "--preempt_save_timeout", "30", "--save_interval_floor", "4",
            "--metrics", "perplexity", "accuracy", "--skip_iters", "3", "5",
            "--no_async_loop", "--prefetch_depth", "3", "--metrics_lag", "2",
            "--rollback_on_divergence", "--divergence_patience", "3",
            "--step_timeout_s", "9", "--replay_check_interval", "2",
            "--telemetry_dir", "tele", "--metrics_port", "0",
            "--flight_recorder", "--profile", "--profile_step_start", "3",
            "--profile_step_end", "4", "--timing_log_level", "2",
            "--log_params_norm", "--log_memory_to_tensorboard",
            "--exit_interval", "7", "--eval_only", "--train_samples", "64"]
    t = args_to_run_config(parse_args(argv)).training
    assert t.save_interval is None and t.save_interval_auto
    assert (t.save_interval_floor, t.preempt_save_timeout) == (4, 30.0)
    assert t.metrics == ("perplexity", "accuracy")
    assert t.skip_iters == (3, 5) and not t.async_loop
    assert (t.prefetch_depth, t.metrics_lag, t.step_timeout_s) == (3, 2, 9.0)
    assert t.rollback_on_divergence and t.divergence_patience == 3
    assert t.metrics_port == 0 and t.flight_recorder and t.profile
    assert t.log_memory and t.log_params_norm and t.timing_log_level == 2
    assert t.exit_interval == 7 and t.eval_only and t.train_samples == 64
    assert args_to_run_config(parse_args(
        ["--model_name", "tiny", "--save_interval", "5"])
    ).training.save_interval == 5
    with pytest.raises(ValueError, match="compiles nothing"):
        args_to_run_config(parse_args(["--model_name", "tiny",
                                       "--compilation_cache_dir", "xc"]))
    with pytest.raises(SystemExit):
        parse_args(["--model_name", "tiny", "--save_interval", "often"])
    for bad in (dict(save_interval_auto=True, save_interval=5),
                dict(save_interval_auto=True, preempt_save_timeout=0.0),
                dict(prefetch_depth=-1), dict(metrics_lag=-1),
                dict(step_timeout_s=-1.0), dict(replay_check_interval=-1),
                dict(flight_recorder=True, flight_recorder_deadline_s=0.0)):
        with pytest.raises(ValueError):
            TrainingConfig(**bad).validate()
    assert math.isclose(TrainingConfig().preempt_save_timeout, 600.0)
