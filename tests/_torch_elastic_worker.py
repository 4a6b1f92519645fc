"""Elastic resume on gloo ranks (the JAX package's tests/test_elastic.py
matrix), for the two launches of tests/test_torch_pp_serving.py: four
ranks run each case's uninterrupted oracle and its run preempted at
iteration 4; two ranks then resume each at the smaller topology
(dp4 -> dp2, tp2 x dp2 -> dp2, pp2 x dp2 -> dp2) to iteration 8.

Imports torch and the port only. Every run journals its step records
(--telemetry_dir, --log_data_fingerprint); rank 0's log lines come
back to the test.
"""

from __future__ import annotations

import os
import time

import numpy as np

ARGV = ["--model_name", "tiny", "--fp32", "--num_layers", "2",
        "--seq_length", "32", "--micro_batch_size", "1",
        "--global_batch_size", "8", "--lr", "1e-3",
        "--lr_decay_style", "constant", "--log_interval", "1",
        "--eval_interval", "100", "--save_interval", "100",
        "--preempt_save_timeout", "120", "--log_data_fingerprint",
        "--device", "cpu"]
#: case -> the four ranks' topology flags (the two ranks resume at dp2)
CASES = {"dp4_to_dp2": [],
         "tp2_to_tp1": ["--tensor_model_parallel_size", "2"],
         "pp2_to_pp1": ["--pipeline_model_parallel_size", "2"]}
READY = "elastic_ready"
_MESHES: dict = {}


def _factory(consumed: int, gbs: int):
    """Global batch i of the run drawn from seed 100 + i: a pure function
    of the consumed-samples watermark, the sampler contract an elastic
    resume leans on."""
    def gen():
        i = consumed // gbs
        while True:
            rng = np.random.default_rng(100 + i)
            text = rng.integers(0, 97, (gbs, 33)).astype(np.int64)
            yield {"tokens": text[:, :-1], "labels": text[:, 1:],
                   "loss_mask": np.ones((gbs, 32), np.float32)}
            i += 1
    return gen()


def _run(iters, flags, tele, fault=None, log=None):
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training.pretrain import pretrain

    cfg = args_to_run_config(parse_args(
        ARGV + ["--train_iters", str(iters), "--telemetry_dir", tele,
                *flags]))
    if cfg.parallel not in _MESHES:     # new_group is collective
        _MESHES[cfg.parallel] = build_mesh(cfg.parallel)
    if fault:
        os.environ["MEGATRON_TPU_FAULT"] = fault
    try:
        return pretrain(cfg, _factory, log=log or (lambda m: None),
                        device="cpu", mesh=_MESHES[cfg.parallel])
    finally:
        os.environ.pop("MEGATRON_TPU_FAULT", None)


def train_job(out_dir: str):
    """Four ranks: each case's oracle (8 iterations) and its run
    preempted at 4 (a SIGTERM notice on every rank), then the marker the
    two ranks wait for."""
    import torch.distributed as dist

    for case, flags in CASES.items():
        d = os.path.join(out_dir, case)
        ck = os.path.join(d, "ck")
        _run(8, flags, os.path.join(d, "oracle"))
        _run(8, flags + ["--save", ck, "--load", ck],
             os.path.join(d, "pre"), fault="preempt_at:4")
    dist.barrier()
    if dist.get_rank() == 0:
        open(os.path.join(out_dir, READY), "w").close()
    return {}


def resume_job(out_dir: str, timeout_s: float = 300.0):
    """Two ranks: each case's checkpoint resumed at dp2 to iteration 8.
    Returns rank 0's log lines by case."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(os.path.join(out_dir, READY)):
        if time.monotonic() > deadline:
            raise TimeoutError("the four ranks' elastic runs never finished")
        time.sleep(0.1)
    logs = {}
    for case in CASES:
        d = os.path.join(out_dir, case)
        ck = os.path.join(d, "ck")
        lines: list = []
        _run(8, ["--save", ck, "--load", ck], os.path.join(d, "resumed"),
             log=lines.append)
        logs[case] = lines
    return {"logs": logs}
