"""Weighted blend of multiple datasets.

(A copy of megatron_tpu/data/blendable_dataset.py with its imports rewritten.)

Equivalent of megatron/data/blendable_dataset.py: sample i of the blend maps
to (dataset, sample-within-dataset) via the greedy proportional assignment
built by the native helper (build_blending_indices)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from megatron_tpu_torch.data import helpers


class BlendableDataset:
    def __init__(self, datasets: Sequence, weights: Sequence[float], size: int):
        if len(datasets) != len(weights):
            raise ValueError("need one weight per dataset")
        self.datasets = list(datasets)
        weights = np.asarray(weights, np.float64)
        self.weights = weights / weights.sum()
        self.size = int(size)
        self.dataset_index, self.dataset_sample_index = \
            helpers.build_blending_indices(self.weights, self.size)
        # wrap around member datasets that are smaller than their quota
        self._lens = np.asarray([len(d) for d in self.datasets], np.int64)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        d = int(self.dataset_index[idx])
        s = int(self.dataset_sample_index[idx]) % int(self._lens[d])
        return self.datasets[d][s]
