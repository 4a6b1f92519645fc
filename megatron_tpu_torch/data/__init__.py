"""Pretraining data: the mmap .bin/.idx token format, GPT sample packing,
blending and samplers (counterpart of megatron_tpu/data/, host-side
numpy code copied from the JAX package)."""

from megatron_tpu_torch.data.indexed_dataset import (
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
    make_builder,
    make_dataset,
)
from megatron_tpu_torch.data.gpt_dataset import GPTDataset, build_gpt_datasets
from megatron_tpu_torch.data.blendable_dataset import BlendableDataset
from megatron_tpu_torch.data.samplers import (
    PretrainingSampler,
    PretrainingRandomSampler,
    build_data_loader,
)

__all__ = [
    "MMapIndexedDataset",
    "MMapIndexedDatasetBuilder",
    "make_builder",
    "make_dataset",
    "GPTDataset",
    "build_gpt_datasets",
    "BlendableDataset",
    "PretrainingSampler",
    "PretrainingRandomSampler",
    "build_data_loader",
]
