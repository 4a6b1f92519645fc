"""The port's training entry point, on the CPU.

`python -m megatron_tpu_torch.tools.pretrain_gpt --device cpu` on a tiny
corpus, in a subprocess: it prints the JAX package's log line
(megatron_tpu/training/pretrain.py, TrainLoop's window line) for every
step and a validation line per evaluation, and its losses equal those of
make_train_step run in this process on the same batches (the same
datasets, sampler and collate, one step per log window), to the 6
decimals the line prints.
"""

import os
import re
import subprocess
import sys

import numpy as np
import torch

from megatron_tpu_torch.arguments import args_to_run_config, parse_args
from megatron_tpu_torch.data.gpt_dataset import build_gpt_datasets
from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDatasetBuilder
from megatron_tpu_torch.data.samplers import (PretrainingSampler,
                                              build_data_loader)
from megatron_tpu_torch.models.params import init_params
from megatron_tpu_torch.training.optimizer import init_train_state, leaf_paths
from megatron_tpu_torch.training.pretrain import gpt_collate
from megatron_tpu_torch.training.train_step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's format string, field by field
LOG_LINE = re.compile(
    r"^iteration (\d+)/(\d+) \| consumed samples: (\d+) \| "
    r"lm loss: (\d+\.\d{6}) \| lr: (\d\.\d{3}e[+-]\d\d) \| "
    r"grad norm: (\d+\.\d{3}) \| skipped: (\d+) \| "
    r"tokens/sec: ([\d,]+) \| model TFLOP/s: (\d+\.\d)$")


def _corpus(prefix):
    r = np.random.default_rng(0)
    b = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(48):
        b.add_item(r.integers(1, 90, size=int(r.integers(10, 70))))
        b.end_document()
    b.finalize(prefix + ".idx")


def test_pretrain_gpt_cli_on_cpu_matches_make_train_step(tmp_path):
    prefix = str(tmp_path / "corpus")
    _corpus(prefix)
    argv = ["--model_name", "tiny", "--fp32", "--num_layers", "2",
            "--seq_length", "32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", "4",
            "--log_interval", "1", "--eval_interval", "2",
            "--eval_iters", "1", "--lr", "1e-3", "--lr_decay_style",
            "constant", "--attention_impl", "pallas",
            "--recompute_granularity", "selective", "--data_path", prefix,
            "--split", "90,10,0", "--seed", "5"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "megatron_tpu_torch.tools.pretrain_gpt",
         *argv, "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    steps = [LOG_LINE.match(ln) for ln in lines if ln.startswith("iteration")]
    assert len(steps) == 4 and all(steps), lines
    assert [int(m.group(1)) for m in steps] == [1, 2, 3, 4]
    assert [int(m.group(3)) for m in steps] == [4, 8, 12, 16]
    assert all(m.group(7) == "0" for m in steps)
    assert sum(ln.startswith("validation | lm loss: ") for ln in lines) == 2
    assert "attention: flash kernels, fused fwd+bwd" in proc.stdout
    cli_losses = [float(m.group(4)) for m in steps]

    # the same run in this process, through make_train_step directly
    cfg = args_to_run_config(parse_args(argv))
    t = cfg.training
    train_ds = build_gpt_datasets([prefix], "90,10,0", 32, (16, 6, 2),
                                  seed=5)[0]
    params = init_params(cfg.model, t.seed, device="cpu")
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(cfg.optimizer, params)
    step = make_train_step(cfg.model, cfg.optimizer, t, 2,
                           train_iters=t.train_iters)
    loader = build_data_loader(
        train_ds, PretrainingSampler(len(train_ds), 0, 4, 0, 1),
        collate_fn=gpt_collate, prefetch=0)
    losses = []
    for _ in range(4):
        batch = {k: torch.from_numpy(v) for k, v in next(loader).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(cli_losses, losses, atol=1.5e-6, rtol=0)
