"""Cross-entropy over vocab logits (counterpart of
megatron_tpu/ops/cross_entropy.py).

A plain fp32 log-softmax expression with the JAX package's options:
loss_mask weights, label smoothing and the PaLM-style z_loss.
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
