"""Instruction-tuning dataset: paired text/role token streams
(counterpart of megatron_tpu/data/instruction_dataset.py, host-side numpy
code copied from the JAX package).

Equivalent of megatron/data/instruction_dataset.py (355 LoC): preprocessing
emits two aligned indexed datasets, `<prefix>-text` (tokens) and
`<prefix>-role` (per-token role ids); the collator pads to seq_length (or a
multiple of 16 under variable_seq_lengths) and builds the masked loss:
assistant tokens weigh 1.0, other text weighs scalar_loss_mask, padding 0
(ref: instruction_dataset.py:321-355 + finetune.py:153-166).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from megatron_tpu_torch.data.indexed_dataset import make_dataset

# role ids stored in the -role dataset (ref: instruction_dataset.py:20-23)
ROLE_PAD = 0
ROLE_SYSTEM = 1
ROLE_PROMPTER = 2
ROLE_ASSISTANT = 3
ROLES = {"system": ROLE_SYSTEM, "prompter": ROLE_PROMPTER,
         "assistant": ROLE_ASSISTANT}


class InstructionDataset:
    def __init__(self, prefix: str, num_samples: Optional[int] = None,
                 seed: int = 1234):
        self.text = make_dataset(prefix + "-text")
        self.role = make_dataset(prefix + "-role")
        if len(self.text) != len(self.role):
            raise ValueError("text/role datasets disagree on length")
        n_docs = len(self.text)
        rng = np.random.RandomState(seed)
        if num_samples is None:
            self.index = np.arange(n_docs)
            rng.shuffle(self.index)
        else:
            epochs = (num_samples + n_docs - 1) // n_docs
            parts = []
            for _ in range(epochs):
                p = np.arange(n_docs)
                rng.shuffle(p)
                parts.append(p)
            self.index = np.concatenate(parts)[:num_samples]

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        doc = int(self.index[idx])
        return {
            "text": self.text[doc].astype(np.int64),
            "role": self.role[doc].astype(np.int64),
        }


def round_to_multiple(x: int, multiple: int) -> int:
    return multiple * ((x + multiple - 1) // multiple)


def instruction_collator(
    items: Sequence[Dict[str, np.ndarray]],
    seq_length: int,
    pad_token: int,
    scalar_loss_mask: float = 0.0,
    variable_seq_lengths: bool = False,
    loss_mask_roles: Sequence[int] = (ROLE_ASSISTANT,),
) -> Dict[str, np.ndarray]:
    """Pad/truncate to a common length and emit the training batch.

    Output: tokens/labels [B, L-1], loss_mask [B, L-1], position_ids.
    Labels are the shifted view; loss weights follow the label positions so
    only predictions *of* assistant tokens train at weight 1.
    """
    max_len = max(len(it["text"]) for it in items)
    if variable_seq_lengths:
        # pad to a multiple of 16 (ref: round_to_multiple_of(max_len,
        # 16)); the kernels take any length, this keeps the JAX batches
        length = min(round_to_multiple(max_len, 16), seq_length + 1)
    else:
        length = seq_length + 1

    B = len(items)
    tokens = np.full((B, length), pad_token, np.int64)
    roles = np.full((B, length), ROLE_PAD, np.int64)
    for i, it in enumerate(items):
        t = it["text"][:length]
        r = it["role"][:length]
        tokens[i, :len(t)] = t
        roles[i, :len(r)] = r

    inputs = tokens[:, :-1]
    labels = tokens[:, 1:]
    label_roles = roles[:, 1:]
    loss_mask = np.full(labels.shape, scalar_loss_mask, np.float32)
    for role in loss_mask_roles:
        loss_mask[label_roles == role] = 1.0
    loss_mask[label_roles == ROLE_PAD] = 0.0

    return {
        "tokens": inputs,
        "labels": labels,
        "loss_mask": loss_mask,
        "position_ids": np.broadcast_to(
            np.arange(inputs.shape[1], dtype=np.int64), inputs.shape).copy(),
    }
