"""Pluggable validation metrics (counterpart of
megatron_tpu/training/metrics.py).

A registry of named metrics computed on eval batches under --metrics
(the reference's METRICS mapping). Each is a function of (logits,
labels, loss_mask, per_token_loss) that returns a device scalar, so
the eval step reads them with its loss in one host sync.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from megatron_tpu_torch.ops.cross_entropy import vocab_argmax


def perplexity(logits, labels, loss_mask, per_token_loss):
    mask = loss_mask.float()
    mean = (per_token_loss * mask).sum() / mask.sum().clamp_min(1.0)
    return torch.exp(mean.clamp_max(20.0))


def accuracy(logits, labels, loss_mask, per_token_loss):
    correct = (vocab_argmax(logits) == labels).float()
    mask = (loss_mask > 0).float()
    return (correct * mask).sum() / mask.sum().clamp_min(1.0)


def instruct_accuracy(logits, labels, loss_mask, per_token_loss):
    """Accuracy over full-weight (assistant) tokens only."""
    correct = (vocab_argmax(logits) == labels).float()
    mask = (loss_mask >= 1.0).float()
    return (correct * mask).sum() / mask.sum().clamp_min(1.0)


def count_loss_mask(logits, labels, loss_mask, per_token_loss):
    return (loss_mask > 0).float().sum()


METRICS: Dict[str, Callable] = {
    "perplexity": perplexity,
    "accuracy": accuracy,
    "instruct_accuracy": instruct_accuracy,
    "count_loss_mask": count_loss_mask,
}


def compute_metrics(names, logits, labels, loss_mask, per_token_loss):
    out = {}
    for name in names:
        if name not in METRICS:
            raise ValueError(
                f"unknown metric {name!r}; one of {sorted(METRICS)}")
        out[name] = METRICS[name](logits, labels, loss_mask, per_token_loss)
    return out
