"""The engines' decode tick as one captured CUDA graph (the port's
counterpart of the JAX engine's one jitted decode step).

CapturedStep runs a step body (a function of the engine's static device
buffers that returns a dict of output tensors) twice on a side stream of
its own, which creates the cuBLAS workspaces and the decode kernel's
tickets for that stream, then captures it once and replays the capture
on the caller's stream. The body's inputs are the engine's static
buffers, refreshed in place between replays; its outputs are tensors of
the graph's private pool, overwritten by every replay.

The kernel wrappers count their launches on the host, so a replay would
launch kernels without counting them: the capture records the counters'
difference (and puts the counters back: a capture launches nothing) and
every replay adds it (flash_template.add_launch_counts).

A capture that fails raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from megatron_tpu_torch.ops.flash import flash_template

#: eager runs of the body on the capture stream before the capture
WARMUP_RUNS = 2


class CapturedStep:
    """One step body captured as a CUDA graph; call it to replay."""

    def __init__(self, body: Callable[[], Dict[str, torch.Tensor]],
                 device: torch.device):
        t0 = time.monotonic()
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_RUNS):
                body()
        torch.cuda.current_stream(device).wait_stream(self.stream)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        before = flash_template.launch_counts()
        try:
            with torch.cuda.graph(self.graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self.out = body()
        except Exception as e:
            flash_template.set_launch_counts(before)
            raise RuntimeError(
                f"CUDA graph capture of the decode step failed: {e}") from e
        after = flash_template.launch_counts()
        flash_template.set_launch_counts(before)
        self.launch_delta = {key: n - before.get(key, 0)
                             for key, n in after.items()
                             if n != before.get(key, 0)}
        torch.cuda.synchronize(device)
        #: wall seconds of the warm-up runs and the capture
        self.capture_seconds = time.monotonic() - t0

    def __call__(self) -> Dict[str, torch.Tensor]:
        self.graph.replay()
        flash_template.add_launch_counts(self.launch_delta)
        return self.out
