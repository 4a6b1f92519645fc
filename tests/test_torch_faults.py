"""The port's fault paths through its entry point, on the CPU.

`python -m megatron_tpu_torch.tools.pretrain_gpt --device cpu` under the
MEGATRON_TPU_FAULT harness (the JAX package's variable and grammar), as
tests/test_resilience.py drives the JAX entry point:

  * nan_loss:3:3 with --rollback_on_divergence --divergence_patience 3
    rolls back to the iteration-4 checkpoint, fast-forwards and finishes
    at 8, with at most 2 checkpoints kept (keep_latest_k 2);
  * preempt_at:5 with --save_interval 100: the SIGTERM notice forces a
    committed checkpoint tagged "preemption" at 5 and exit 0, journaled
    (`preemption`, run_end received_signal SIGTERM); the resumed run's
    losses and final state equal an uninterrupted run's bitwise;
  * kill_during_save:4 SIGKILLs the run between the state files and the
    commit: iteration 2 stays committed, 4 is an ignorable staging dir,
    and the resume replays 3..8 bitwise;
  * hang_step:3 with --step_timeout_s 2 exits 70 with a flight bundle
    whose stacks show the hung frame, and `hang_detected` journaled;
  * a second SIGTERM during the handled first forces exit 128+15.

Fault runs are subprocesses with timeouts; the reference runs are
in-process.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json
import os
import re
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from megatron_tpu_torch.telemetry.journal import read_events
from megatron_tpu_torch.tools import pretrain_gpt
from megatron_tpu_torch.tools import preprocess_data
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training import resilience
from megatron_tpu_torch.training.optimizer import leaf_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    jsonl = tmp / "docs.jsonl"
    with open(jsonl, "w") as f:
        for _ in range(150):
            n = int(rng.integers(20, 60))
            f.write(json.dumps({"text": " ".join(
                str(int(x)) for x in rng.integers(0, 97, n))}) + "\n")
    prefix = str(tmp / "corpus")
    preprocess_data.main(["--input", str(jsonl), "--output_prefix", prefix,
                          "--tokenizer_type", "null", "--vocab_size", "97",
                          "--append_eod"])
    return prefix


def _argv(corpus, save, train_iters=8, extra=()):
    return ["--model_name", "tiny", "--fp32", "--num_layers", "2",
            "--seq_length", "32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", str(train_iters),
            "--log_interval", "1", "--lr", "1e-3",
            "--lr_decay_style", "constant", "--data_path", corpus,
            "--split", "95,5,0", "--eval_interval", "100",
            "--save", save, "--load", save, "--save_interval", "2",
            "--device", "cpu", *extra]


def _run_cli(corpus, save, fault=None, train_iters=8, extra=(),
             timeout=120):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", resilience.FAULT_ENV)}
    if fault:
        env[resilience.FAULT_ENV] = fault
    return subprocess.run(
        [sys.executable, "-m", "megatron_tpu_torch.tools.pretrain_gpt",
         *_argv(corpus, save, train_iters, extra)],
        env=env, capture_output=True, text=True, cwd=REPO, timeout=timeout)


@pytest.fixture(scope="module")
def whole(corpus, tmp_path_factory):
    """The uninterrupted 8-step run, in-process."""
    save = str(tmp_path_factory.mktemp("whole") / "ck")
    return pretrain_gpt.main(_argv(corpus, save, extra=(
        "--save_interval", "100")), log=lambda m: None)


def _assert_same_state(a, b):
    for field in ("params", "mu", "nu"):
        for (n, x), (_, y) in zip(leaf_paths(getattr(a, field)),
                                  leaf_paths(getattr(b, field))):
            assert torch.equal(x, y), (field, n)


def _losses_by_iteration(stdout):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"iteration (\d+)/\d+ \|.*?lm loss: ([0-9.einf-]+)", stdout)}


def test_nan_window_rollback_and_continue(tmp_path, corpus):
    out = _run_cli(corpus, str(tmp_path / "roll"), fault="nan_loss:3:3",
                   extra=("--divergence_patience", "3",
                          "--rollback_on_divergence", "--keep_latest_k", "2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "rolled back to checkpoint at iteration 4" in out.stdout
    assert "post-rollback fast-forward" in out.stdout
    assert "iteration 8/8" in out.stdout
    losses = _losses_by_iteration(out.stdout)
    for it in (6, 7, 8):
        assert float(losses[it]) == float(losses[it])  # not NaN
    save = str(tmp_path / "roll")
    assert ckpt.read_tracker(save) == 8
    assert len(ckpt.list_valid_checkpoints(save)) <= 2


def test_preemption_notice_checkpoint_and_bitwise_resume(tmp_path, corpus,
                                                         whole):
    save, tele = str(tmp_path / "pre"), str(tmp_path / "tele")
    out = _run_cli(corpus, save, fault="preempt_at:5",
                   extra=("--telemetry_dir", tele,
                          "--preempt_save_timeout", "120",
                          "--save_interval", "100"))
    assert out.returncode == 0, (out.returncode, out.stderr[-3000:])
    assert "preempt_at firing at iteration 5" in out.stderr
    assert "expedited synchronous save" in out.stdout
    assert "preemption checkpoint committed at iteration 5" in out.stdout
    assert set(_losses_by_iteration(out.stdout)) == {1, 2, 3, 4, 5}
    assert ckpt.read_tracker(save) == 5
    path = ckpt.checkpoint_dir(save, 5)
    assert ckpt.verify_checkpoint(path, deep=True)[0]
    assert ckpt.checkpoint_tags(path) == ("preemption",)
    evs, _ = read_events(os.path.join(tele, "events.jsonl"))
    pre = [e for e in evs if e["kind"] == "preemption"]
    assert len(pre) == 1 and pre[0]["iteration"] == 5
    assert pre[0]["signal"] == "SIGTERM"
    assert 0 < pre[0]["notice_to_commit_ms"] < 120 * 1000
    assert [e for e in evs if e["kind"] == "run_end"][-1][
        "received_signal"] == "SIGTERM"

    logs = []
    resumed = pretrain_gpt.main(_argv(corpus, save, extra=(
        "--save_interval", "100")), log=logs.append)
    assert "loaded checkpoint at iteration 5 (consumed 20 samples)" in logs
    first = _losses_by_iteration(out.stdout)
    want = {h["iteration"]: f"{h['lm_loss']:.6f}" for h in whole.history}
    assert first == {it: want[it] for it in range(1, 6)}
    assert [h["lm_loss"] for h in resumed.history] == \
        [h["lm_loss"] for h in whole.history][5:]
    _assert_same_state(resumed.state, whole.state)


def test_kill_during_save_leaves_staging_and_resumes_bitwise(
        tmp_path, corpus, whole):
    save = str(tmp_path / "kill")
    out = _run_cli(corpus, save, fault="kill_during_save:4")
    assert out.returncode == -signal.SIGKILL, out.stderr[-3000:]
    assert "kill_during_save firing at iteration 4" in out.stderr
    assert ckpt.read_tracker(save) == 2
    assert ckpt.committed_iterations(save) == [2]
    assert os.path.isdir(os.path.join(save, "iter_0000004.tmp"))
    logs = []
    resumed = pretrain_gpt.main(_argv(corpus, save), log=logs.append)
    assert any("removed uncommitted checkpoint staging dirs" in m
               for m in logs)
    assert "loaded checkpoint at iteration 2 (consumed 8 samples)" in logs
    assert [h["lm_loss"] for h in resumed.history] == \
        [h["lm_loss"] for h in whole.history][2:]
    _assert_same_state(resumed.state, whole.state)
    assert ckpt.read_tracker(save) == 8


def test_hang_step_watchdog_bundle_and_exit_70(tmp_path, corpus):
    tele = str(tmp_path / "tele")
    out = _run_cli(corpus, str(tmp_path / "hang"), fault="hang_step:3",
                   train_iters=6,
                   extra=("--telemetry_dir", tele, "--step_timeout_s", "2"))
    assert out.returncode == resilience.HANG_EXIT_CODE == 70, (
        out.returncode, out.stderr[-3000:])
    assert "hang_step firing at iteration 3" in out.stderr
    assert "step watchdog" in out.stdout
    bundles = os.listdir(os.path.join(tele, "flight_bundles"))
    assert len(bundles) == 1
    bundle = os.path.join(tele, "flight_bundles", bundles[0])
    assert os.path.exists(os.path.join(bundle, "meta.json"))
    with open(os.path.join(bundle, "stacks.txt")) as f:
        assert "maybe_hang" in f.read()
    evs, _ = read_events(os.path.join(tele, "events.jsonl"))
    hangs = [e for e in evs if e["kind"] == "hang_detected"]
    assert hangs and hangs[0]["iteration"] == 3


def test_signal_handler_second_signal_forces_exit():
    code = textwrap.dedent("""
        import os, signal, sys, time
        from megatron_tpu_torch.training.signal_handler import (
            DistributedSignalHandler)
        with DistributedSignalHandler() as h:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.2)
            print("first", [signal.Signals(s).name
                            for s in h.signals_received()], flush=True)
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(5)
        print("not reached")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 128 + signal.SIGINT
    assert "first ['SIGTERM']" in proc.stdout
    assert "not reached" not in proc.stdout
    assert "forcing exit" in proc.stderr
