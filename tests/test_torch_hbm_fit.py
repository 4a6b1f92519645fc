"""The port's per-card memory fit (training/aot.py, tools/hbm_check.py)
against the JAX package's: one rank's train step run under fake tensors
with a fake process group, its state bytes held against the JAX AOT
report's argument bytes less the batch's, the live-storage tracker
itself, and the H100 scale proofs."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json

import jax
import pytest
import torch

from megatron_tpu.config import ModelConfig as JModelConfig
from megatron_tpu.config import ParallelConfig as JParallelConfig
from megatron_tpu.training.aot import hbm_fit_report as j_hbm_fit_report
from megatron_tpu_torch.config import ModelConfig, ParallelConfig
from megatron_tpu_torch.training import aot
from megatron_tpu_torch.tools import hbm_check

GEOMETRY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                num_kv_heads=2, ffn_hidden_size=128, vocab_size=256,
                seq_length=64, params_dtype="bfloat16")


@pytest.mark.parametrize("tp,sp,world", [(2, True, 4), (1, False, 4),
                                         (2, False, 2)])
def test_state_bytes_equal_jax_argument_bytes_less_the_batch(tp, sp, world):
    """bf16 params with fp32 masters and ZeRO-1 moments on dp = world /
    tp ranks: this rank's state bytes equal XLA's argument bytes per
    device less the batch (tokens and labels int32, loss mask fp32, 2
    rows x S on each data rank) exactly — tolerance 0 bytes."""
    jrep = j_hbm_fit_report(
        JModelConfig(**GEOMETRY).validate(),
        JParallelConfig(tensor_parallel=tp, sequence_parallel=sp),
        devices=jax.devices()[:world], micro_batch_size=1,
        num_microbatches=2)
    rep = aot.hbm_fit_report(
        ModelConfig(**GEOMETRY).validate(),
        ParallelConfig(tensor_parallel=tp, sequence_parallel=sp),
        micro_batch_size=1, num_microbatches=2, world_size=world)
    j_batch = 2 * GEOMETRY["seq_length"] * (4 + 4 + 4)
    assert rep.state_bytes == jrep.argument_bytes - j_batch
    assert rep.mesh_shape == jrep.mesh_shape
    assert rep.n_params == jrep.n_params
    # the split adds up, and the step needs more than its state
    assert rep.master_bytes == rep.moment_bytes // 2
    assert rep.grad_bytes == 2 * rep.param_bytes
    assert rep.temp_peak_bytes > 0
    assert rep.per_chip_bytes == rep.peak_bytes + aot.WORKSPACE_BYTES
    assert not torch.distributed.is_initialized()


def test_live_bytes_tracker_counts_what_lives():
    from torch._subclasses.fake_tensor import FakeTensorMode

    tracker = aot.LiveBytes()
    with FakeTensorMode(), tracker:
        a = torch.empty(1024, dtype=torch.float32)
        b = a.view(32, 32)              # a view: no new storage
        c = torch.empty(256, dtype=torch.bfloat16)
        assert tracker.current == 4096 + 512
        del a, b
        d = c * 2                       # an op's output
        assert tracker.current == 512 + 512
        del c, d
    assert tracker.current == 0 and tracker.peak == 4096 + 512


def test_scale_proof_7b_fits_an_h100():
    """Llama-2-7B at DP2 x TP4 (the reference's 8-GPU recipe) fits one
    H100 80 GB."""
    rep = aot.run_scale_proof("llama2_7b_dp2tp4")
    assert rep.fits(aot.H100_BYTES)
    assert rep.mesh_shape == {"data": 2, "expert": 1, "pipe": 1,
                              "context": 1, "tensor": 4}
    assert 6.5e9 < rep.n_params < 7.0e9
    # bf16 params (13.5 GB / tp4) + fp32 master + moments over tp4 and
    # the two ZeRO-1 data ranks: ~12.5 GiB of state a card
    assert 10 * aot.GIB < rep.state_bytes < 16 * aot.GIB


def test_hbm_check_cli_json_and_budget(capsys):
    assert hbm_check.main(["--model", "llama2", "--size", "7B",
                           "--num_layers", "2", "--seq_length", "1024",
                           "--tp", "2", "--devices", "2", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fits"] and out["budget_bytes"] == aot.H100_BYTES
    assert out["per_chip_bytes"] == out["peak_bytes"] + aot.WORKSPACE_BYTES
    # a budget below the step is refused
    assert hbm_check.main(["--model", "llama2", "--size", "7B",
                           "--num_layers", "2", "--seq_length", "1024",
                           "--devices", "1", "--budget_gib", "1"]) == 1
    assert "OVER" in capsys.readouterr().out
