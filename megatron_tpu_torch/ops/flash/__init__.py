"""Hand-written Hopper flash-attention kernels and their plain versions
(counterpart of megatron_tpu/ops/pallas/).

flash_template.py holds each kernel's wrapper, launch counter and plain
PyTorch version; csrc/ holds the CUDA sources; build.py compiles them at
first use; masks.py is the shared position model.
"""
