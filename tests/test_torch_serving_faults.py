"""The serving fault hooks of both port engines against the JAX engines.

The same MEGATRON_TPU_FAULT value arms the same fault in the JAX dense
and paged engines and in the port's; each engine serves two greedy
requests tick by tick on the CPU. The faults' effects on the process
are observed instead of suffered: os.kill is replaced by a recorder and
a sleep of an hour (maybe_hang's wedge) raises, so every engine's
outcome is the list of (tick, effect) the fault produced:

  kill_replica:2     SIGKILL before decode tick 2
  preempt_replica:1  SIGTERM before decode tick 1, once
  hang_replica:3     the step loop wedges before decode tick 3
  slow_tick:7        a 7 ms sleep before every tick
  reject_admission   every submit is answered overloaded at once
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import os
import time

import jax
import numpy as np
import pytest

from megatron_tpu.inference.engine import InferenceEngine as JEngine
from megatron_tpu.inference.engine import Request as JRequest
from megatron_tpu.inference.paging.engine import (
    PagedInferenceEngine as JPaged,
)
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from megatron_tpu_torch.inference.engine import InferenceEngine, Request
from megatron_tpu_torch.inference.paging.engine import PagedInferenceEngine
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.training import resilience

KW = dict(vocab_size=64, seq_length=64, attention_impl="pallas")
PAGED = dict(page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = j_presets.tiny(**KW), presets.tiny(**KW)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    common = dict(num_slots=2, max_seq_len=64, vocab_size=65)
    return {
        "jax": lambda: (JEngine(jcfg, jparams, metrics=JRegistry(),
                                **common), JRequest),
        "jax_paged": lambda: (JPaged(jcfg, jparams, metrics=JRegistry(),
                                     **common, **PAGED), JRequest),
        "torch": lambda: (InferenceEngine(tcfg, tparams, device="cpu",
                                          metrics=MetricsRegistry(),
                                          **common), Request),
        "torch_paged": lambda: (PagedInferenceEngine(
            tcfg, tparams, device="cpu", metrics=MetricsRegistry(),
            **common, **PAGED), Request),
    }


class _Wedged(Exception):
    pass


def _outcome(monkeypatch, make, fault):
    """(tick, effect) pairs the fault produced while the engine served
    two requests, and each request's (overloaded, error)."""
    monkeypatch.setenv(resilience.FAULT_ENV, fault)
    engine, request = make()
    effects = []
    real_sleep = time.sleep

    def kill(pid, sig):
        assert pid == os.getpid()
        effects.append((engine.stats["ticks"], f"signal {int(sig)}"))

    def sleep(seconds):
        if seconds >= 3600:
            raise _Wedged
        effects.append((engine.stats["ticks"], f"sleep {seconds:g}"))
        real_sleep(0)

    monkeypatch.setattr(os, "kill", kill)
    monkeypatch.setattr(time, "sleep", sleep)
    reqs = [engine.submit(request(prompt=np.array(p, np.int32),
                                  max_new_tokens=4))
            for p in ([3, 9, 4], [7, 1])]
    try:
        for _ in range(20):
            if not engine.step() and not engine.num_active and all(
                    r.done.is_set() for r in reqs):
                break
    except _Wedged:
        effects.append((engine.stats["ticks"], "wedged"))
    finally:
        monkeypatch.undo()
    return effects, [(r.overloaded, r.error) for r in reqs]


@pytest.mark.parametrize("fault", ["kill_replica:2", "preempt_replica:1",
                                   "hang_replica:3", "slow_tick:7",
                                   "reject_admission"])
def test_serving_fault_matches_jax_engines(monkeypatch, engines, fault):
    got = {name: _outcome(monkeypatch, make, fault)
           for name, make in engines.items()}
    # each port engine against its JAX counterpart (the paged engines
    # run more steps: their prefill comes in chunks)
    assert got["torch"] == got["jax"], got
    assert got["torch_paged"] == got["jax_paged"], got
    effects, answers = got["jax"]
    if fault == "reject_admission":
        assert effects == [] and all(o for o, _ in answers)
        assert "reject_admission" in answers[0][1]
    else:
        assert effects and all(not o for o, _ in answers)
    expected = {"kill_replica:2": (2, "signal 9"),
                "preempt_replica:1": (1, "signal 15"),
                "hang_replica:3": (3, "wedged"),
                "slow_tick:7": (0, "sleep 0.007")}
    if fault in expected:
        for name in ("jax", "jax_paged"):
            assert got[name][0][0] == expected[fault], name
        if fault == "preempt_replica:1":
            assert len(effects) == 1  # once per process
