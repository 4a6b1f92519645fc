"""Compressed collectives (counterpart of megatron_tpu/quant/; Flash
Communication, arXiv 2412.04964).

Low-bit (int8 / fp8) collectives for serving: quantize/dequantize
primitives with worst-case error bounds (primitives.py), the compressed
all-reduce, all-gather, ring hop and 2d head legs over torch.distributed
groups with the tensor-parallel seams and the byte models
(collectives.py), and the per-site enable policy (policy.py, stdlib
only). Serving takes them through ``--serve_compress_collectives
{none,int8,fp8}`` and ``--serve_comm_policy`` (tensor parallelism) and
``--serve_cp_collectives`` (the context-parallel ring,
inference/context_parallel/).
"""

from megatron_tpu_torch.quant.collectives import (  # noqa: F401
    MODES, CpComm, TpComm, compressed_all_gather, compressed_psum,
    cp_ring_comm_bytes, forward_comm_bytes, grouped_all_gather,
    grouped_all_to_all, make_cp_comm, make_tp_comm, ring_permute,
    wire_bytes_per_call,
)
from megatron_tpu_torch.quant.policy import (  # noqa: F401
    CommPolicy, DEFAULT_SITES, SITE_COLLECTIVES, default_policy,
    load_policy, policy_from_exposure, resolve_policy,
)
from megatron_tpu_torch.quant.primitives import (  # noqa: F401
    dequantize_chunked, effective_chunk, fp8_supported,
    quantization_error_bound, quantize_chunked,
)
