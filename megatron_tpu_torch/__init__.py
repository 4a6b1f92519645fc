"""megatron_tpu_torch: the PyTorch/CUDA port of megatron_tpu for NVIDIA Hopper.

The module tree mirrors megatron_tpu's paths and function names so each
piece has an obvious counterpart. This package imports torch and never
jax, and nothing from megatron_tpu: modules it shares with the JAX
package (metrics, tokenizer) are kept here as copies.

Entry points run on the GPU ("cuda") unless the caller passes
device="cpu". On the CPU the flash-attention wrappers run their plain
PyTorch versions; on a CUDA tensor they launch the hand-written Hopper
kernels in csrc/ or raise.
"""
