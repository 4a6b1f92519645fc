"""Where a training step's time goes on the card.

    python -m megatron_tpu_torch.tools.profile_training [--layers 8] [--steps 2]

Builds the training state as chip_smoke.py's training run does
(Llama-2-7B at full width cut to --layers, S 4096, bf16, micro-batch 1,
global batch 2 so 2 microbatches, selective recompute, the flash
kernels, Adam with fp32 masters), feeds it batches of Zipf-distributed
token ids from --seed, runs two warm steps, then times --steps steps
with profile_serving's window: the host wall time of a run without the
profiler (each step ends in a read of its loss, as the log line does),
the device time of each CUDA kernel the profiler saw in a second run,
and the device idle share. A last JSON line sums the device time by
category (GEMMs, each flash kernel, elementwise, reductions, the rest)
per step, with the peak memory. Every line carries the card's name and
power limit. CUDA only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from megatron_tpu_torch.tools.profile_serving import _card, _window

#: (category, substrings of the kernel name), first match wins
CATEGORIES = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "wgmma")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduce", ("reduce",)),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None) -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--seq_length", type=int, default=4096)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from megatron_tpu_torch.config import (OptimizerConfig, RunConfig,
                                           TrainingConfig)
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.training.pretrain import TrainLoop

    card = _card()
    model = dataclasses.replace(presets.llama2("7B"), num_layers=args.layers,
                                seq_length=args.seq_length).validate()
    run = RunConfig(
        model=model,
        optimizer=OptimizerConfig(lr=3e-4, lr_decay_style="constant",
                                  clip_grad=1.0),
        training=TrainingConfig(micro_batch_size=1, global_batch_size=2,
                                train_iters=args.steps + 2,
                                recompute_granularity="selective",
                                seed=args.seed))
    loop = TrainLoop(run, log=lambda msg: None, device="cuda")
    rng = np.random.default_rng(args.seed)
    text = (rng.zipf(1.2, size=(2, args.seq_length + 1)) - 1) % \
        model.vocab_size
    batch = {"tokens": text[:, :-1], "labels": text[:, 1:],
             "loss_mask": np.ones((2, args.seq_length), np.float32)}

    def steps(n):
        for _ in range(n):
            float(loop.train_step(batch)["loss"])
        return n

    torch.cuda.reset_peak_memory_stats()
    steps(2)                           # warm: cuBLAS plans, allocator
    wall_ms, kernels = _window(torch, "train_steps", lambda: steps(
        args.steps), card, top=15)
    by_cat = {}
    for name, (ms, count) in kernels.items():
        cat = by_cat.setdefault(_category(name), [0.0, 0])
        cat[0] += ms / args.steps
        cat[1] += count / args.steps
    device_ms = sum(ms for ms, _ in by_cat.values())
    tokens = 2 * args.seq_length
    step_ms = wall_ms / args.steps
    flops = 3.0 * model.flops_per_token_fwd() * tokens
    print(json.dumps({
        "window": "train_step_by_category", "card": card,
        "layers": args.layers, "seq_length": args.seq_length,
        "step_wall_ms": step_ms, "device_ms_per_step": device_ms,
        "device_idle_share": 1 - device_ms / step_ms if kernels
        else "not measured",
        "tokens_per_s": tokens / (step_ms / 1e3),
        "mfu": flops / (step_ms / 1e3) / 989e12,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2**30,
        "per_step": {c: {"ms": ms, "launches": n,
                         "share_of_device": ms / device_ms if device_ms
                         else None}
                     for c, (ms, n) in sorted(by_cat.items(),
                                              key=lambda kv: -kv[1][0])}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
