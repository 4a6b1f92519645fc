"""Pluggable validation metrics (counterpart of
megatron_tpu/training/metrics.py).

A registry of named metrics computed on eval batches under --metrics
(the reference's METRICS mapping). Each metric is a pair: its
(numerator, denominator) token sums over a batch, a function of
(pred, labels, loss_mask, per_token_loss) with pred the predicted ids,
and the function that finishes the summed pair into the metric's
value. The sums add over microbatches, pipeline stages and data ranks,
so one definition serves one rank (compute_metrics, with the argmax of
whole logits) and the parallel eval step (training/train_step.py, with
the vocab-parallel argmax, ops/cross_entropy.vocab_parallel_argmax,
and the vocab-parallel cross-entropy's per-token losses). Every value
stays a device scalar, so the eval step reads them with its loss in one
host sync.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

from megatron_tpu_torch.ops.cross_entropy import vocab_argmax

Sums = Tuple[torch.Tensor, torch.Tensor]


def _mean(num, den):
    return num / den.clamp_min(1.0)


def _correct(pred, labels, mask) -> Sums:
    mask = mask.float()
    return ((pred == labels).float() * mask).sum(), mask.sum()


def perplexity(pred, labels, loss_mask, per_token_loss) -> Sums:
    mask = loss_mask.float()
    return (per_token_loss * mask).sum(), mask.sum()


def accuracy(pred, labels, loss_mask, per_token_loss) -> Sums:
    return _correct(pred, labels, loss_mask > 0)


def instruct_accuracy(pred, labels, loss_mask, per_token_loss) -> Sums:
    """Accuracy over full-weight (assistant) tokens only."""
    return _correct(pred, labels, loss_mask >= 1.0)


def count_loss_mask(pred, labels, loss_mask, per_token_loss) -> Sums:
    n = (loss_mask > 0).float().sum()
    return n, torch.zeros_like(n)


class Metric(NamedTuple):
    sums: Callable[..., Sums]
    finish: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


METRICS: Dict[str, Metric] = {
    "perplexity": Metric(
        perplexity, lambda num, den: torch.exp(_mean(num, den)
                                               .clamp_max(20.0))),
    "accuracy": Metric(accuracy, _mean),
    "instruct_accuracy": Metric(instruct_accuracy, _mean),
    "count_loss_mask": Metric(count_loss_mask, lambda num, den: num),
}


def _metric(name: str) -> Metric:
    if name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; one of {sorted(METRICS)}")
    return METRICS[name]


def metric_sums(names: Sequence[str], pred, labels, loss_mask,
                per_token_loss) -> torch.Tensor:
    """[len(names), 2] fp32: each metric's (numerator, denominator) token
    sums over this batch, given the predicted ids `pred`."""
    return torch.stack([
        torch.stack([s.float() for s in _metric(name).sums(
            pred, labels, loss_mask, per_token_loss)])
        for name in names])


def finish_metrics(names: Sequence[str], sums: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The metrics from their summed (numerator, denominator) rows."""
    return {name: _metric(name).finish(num, den)
            for name, (num, den) in zip(names, sums)}


def compute_metrics(names, logits, labels, loss_mask, per_token_loss):
    """One rank's metrics from its whole logits."""
    names = tuple(names)
    if not names:
        return {}
    return finish_metrics(names, metric_sums(
        names, vocab_argmax(logits), labels, loss_mask, per_token_loss))
