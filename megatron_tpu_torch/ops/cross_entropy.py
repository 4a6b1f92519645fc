"""Cross-entropy over vocab logits (counterpart of
megatron_tpu/ops/cross_entropy.py).

A plain fp32 log-softmax expression with the JAX package's options:
loss_mask weights, label smoothing and the PaLM-style z_loss.

vocab_parallel_cross_entropy is the same loss over logits whose vocab
axis is cut over the tensor group (the LM head's column-parallel
output): the counterpart of the reference's vocab_parallel_cross_entropy
(megatron/core/tensor_parallel/cross_entropy.py:14-127), which the JAX
package leaves to XLA (megatron_tpu/parallel/sharding.py:64-69). Three
reductions over the group: the max, the sum of exponentials and the
target's logit (a fourth, the logit sum, only with label smoothing).
The max is a constant shift and is detached; the sums go through
reduce_from_tp (all-reduce forward, identity backward), which is the
exact gradient because every rank of the group computes the same loss
from them. cross_entropy_loss stays the tp = 1 path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy_loss(
    logits: torch.Tensor,          # [B, S, V] (any float dtype; computed fp32)
    targets: torch.Tensor,         # [B, S] int
    loss_mask: Optional[torch.Tensor] = None,  # [B, S] float weights
    label_smoothing: float = 0.0,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean_loss, per_token_loss [B, S])."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)                        # [B, S]
    target_logit = logits.gather(-1, targets[..., None].long())[..., 0]
    loss = lse - target_logit
    if label_smoothing > 0.0:
        # (1-eps)*nll + eps * mean over vocab of nll_v
        eps = label_smoothing
        loss = lse - (1.0 - eps) * target_logit - eps * logits.mean(-1)
    if z_loss > 0.0:
        loss = loss + z_loss * lse.square()
    if loss_mask is not None:
        mask = loss_mask.float()
        mean = (loss * mask).sum() / mask.sum().clamp_min(1.0)
    else:
        mean = loss.mean()
    return mean, loss


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Predicted token ids."""
    return logits.argmax(-1)


def vocab_parallel_argmax(logits: torch.Tensor, mesh) -> torch.Tensor:
    """Global predicted ids [B, S] from this rank's vocab block [B, S,
    V/tp] (the reference's vocab_parallel_max_indices): each rank's max
    and its first index, the max agreed over the tensor group, then the
    lowest global index among the ranks that hold it, so a tie resolves
    as torch.argmax over the whole logits does. The same ids on every
    rank of the group."""
    from megatron_tpu_torch.parallel.mappings import all_reduce

    if mesh is None or mesh.tp == 1:
        return vocab_argmax(logits)
    group = mesh.group("tensor")
    rows = logits.shape[-1]
    local_max, local_idx = logits.detach().float().max(-1)
    best = all_reduce(local_max, group, "max")
    none = rows * mesh.tp                      # past every real id
    idx = torch.where(local_max == best, local_idx + mesh.tp_rank * rows,
                      torch.full_like(local_idx, none))
    return all_reduce(idx, group, "min")


def vocab_parallel_cross_entropy(
    logits: torch.Tensor,          # [B, S, V/tp]: this rank's vocab block
    targets: torch.Tensor,         # [B, S] int, global ids
    mesh,                          # parallel.mesh.MeshRuntime, tp > 1
    loss_mask: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean_loss, per_token_loss [B, S]), the values of
    cross_entropy_loss over the whole vocabulary, on every rank of the
    tensor group."""
    from megatron_tpu_torch.parallel.mappings import (
        all_reduce, reduce_from_tp,
    )

    logits = logits.float()
    rows = logits.shape[-1]
    m = all_reduce(logits.detach().amax(-1), mesh.group("tensor"), "max")
    sumexp = reduce_from_tp((logits - m[..., None]).exp().sum(-1), mesh)
    lse = m + torch.log(sumexp)                                  # [B, S]
    local = targets.long() - mesh.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    picked = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    target_logit = reduce_from_tp(picked.masked_fill(~inside, 0.0), mesh)
    loss = lse - target_logit
    if label_smoothing > 0.0:
        eps = label_smoothing
        mean_logit = reduce_from_tp(logits.sum(-1), mesh) / (rows * mesh.tp)
        loss = lse - (1.0 - eps) * target_logit - eps * mean_logit
    if z_loss > 0.0:
        loss = loss + z_loss * lse.square()
    if loss_mask is not None:
        mask = loss_mask.float()
        mean = (loss * mask).sum() / mask.sum().clamp_min(1.0)
    else:
        mean = loss.mean()
    return mean, loss
