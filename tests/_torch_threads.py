"""Imported first by every tests/test_torch_*.py: torch runs its CPU
operations on one intra-op thread in the test processes.

The suite runs in several pytest-xdist workers at once, and the
multi-rank tests spawn their gloo ranks beside them, so torch's default
of one thread per core oversubscribes the cores many times over; at the
tests' tiny widths a thread pool that waits for cores costs far more
than the parallelism gains. Spawned ranks set the same in their own
processes (_torch_parallel_worker.py and the other workers)."""

import torch

torch.set_num_threads(1)
