"""Context-parallel serving: chunked prefill and decode over
sequence-striped paged KV (counterpart of
megatron_tpu/inference/context_parallel/).

The paged serving stack (inference/paging/) keeps one host view of every
request (radix prefix cache, chunked-prefill queue, preempt/resume,
sliding-window release); this package re-homes the device KV under it:
the page pools are striped over the context group (logical page l of a
sequence lives on context rank ``l % cp``, pool.py), each chunk and
decode tick attends a rank's stripe and merges the ranks' partials over
a ring or the 2d geometry (ring_kv.py; the decode partial on B5's
partial form), and the merge's transport is policy-gated compressible
(quant/collectives.CpComm). engine.py holds ContextParallelEngine.

Exactness: greedy decode through the engine gives the one-process paged
engine's tokens, with logprobs at fp32 merge tolerance
(tests/test_torch_cp_serving.py, against the JAX engine too).
"""

from megatron_tpu_torch.inference.context_parallel.engine import (  # noqa: F401
    ContextParallelEngine,
)
from megatron_tpu_torch.inference.context_parallel.pool import (  # noqa: F401
    StripedPagePool,
)
