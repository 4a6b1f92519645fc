"""Where a serving tick's time goes on the card.

    python -m megatron_tpu_torch.tools.profile_serving [--ticks 10]

Builds the engine as the server does (Llama-2-7B at full width and
depth, random init, bf16, 8 slots x 2048 positions), fills every slot
with a greedy request (prompts of 5 to 1500 tokens), warms up, then
times under torch.profiler:

  * --ticks batched decode ticks with all 8 slots active, and
  * one admission (prefill + first token) of a 1500-token prompt into
    the 1536 bucket.

For each window it prints one JSON line: the host wall time of a run
without the profiler (ending in a synchronize), the summed device time
of the CUDA kernels the profiler saw in a second run of the same work,
the device idle share 1 - device/wall (one stream, so kernels do not
overlap), and the kernels with the most device time. Every line
carries the card's name and power limit. CUDA only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def _window(torch, name, fn, card, top=8):
    """Time fn() on the host clock (ending in a synchronize), then run it
    again under the profiler for the kernels' device times, and print
    the window's breakdown. The profiler's own host overhead stays out
    of wall_ms. Returns (wall_ms, {kernel name: (device ms, count)})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us / 1e3,
                          e.count)
    device_ms = sum(ms for ms, _ in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    print(json.dumps({
        "window": name, "card": card, "steps": n, "wall_ms": wall_ms,
        "device_ms": device_ms if kernels else "not measured",
        "device_idle_share": (1 - device_ms / wall_ms) if kernels
        else "not measured",
        "kernel_launches": sum(c for _, c in kernels.values()),
        "top_kernels": [{"kernel": k[:90], "ms": ms, "count": c,
                         "share_of_device": ms / device_ms}
                        for k, (ms, c) in ranked]}), flush=True)
    return wall_ms, kernels


def main(argv=None) -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ticks", type=int, default=10)
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from megatron_tpu_torch.inference.engine import InferenceEngine, Request
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    card = _card()
    cfg = presets.from_model_name("llama2-7B")
    params = init_params(cfg, args.seed)
    eng = InferenceEngine(cfg, params, num_slots=8, max_seq_len=2048,
                          metrics=MetricsRegistry())
    rng = np.random.default_rng(args.seed)
    lens = (5, 100, 300, 500, 700, 1000, 1200, 1500)
    new = 20 + 2 * args.ticks
    for n in lens:
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size - 1,
                                               size=n).astype(np.int32),
                           max_new_tokens=new))
    eng.step()                         # admits all 8, one decode tick
    for _ in range(5):                 # warm decode ticks
        eng.step()

    def ticks():
        for _ in range(args.ticks):
            eng._decode_tick()
        return args.ticks

    _window(torch, "decode_ticks_8_slots", ticks, card)
    eng.run_until_idle()

    def prefill():
        eng.submit(Request(prompt=rng.integers(
            0, cfg.vocab_size - 1, size=lens[-1]).astype(np.int32),
            max_new_tokens=1))
        return eng._admit()

    prefill()                          # warm this bucket once
    _window(torch, f"prefill_bucket_{eng._bucket(lens[-1])}", prefill, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
