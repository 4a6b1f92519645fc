"""Sequence classification and multiple-choice heads over the BERT
encoder (counterpart of megatron_tpu/models/classification.py).

Both run the padded bidirectional encoder and the pooler (tanh of the
[CLS] hidden state), then one linear head: [h, num_classes] for
classification, [h, 1] scored per choice for multiple choice (the
choices flattened into the batch).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.bert import (
    bert_config, encoder_hidden, pooled,
)
from megatron_tpu_torch.models.params import (
    _NORMAL, _ZEROS, init_leaf, init_params, param_shapes, param_specs,
    tree_from_numpy,
)
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.parallel.sharding import P

HEAD = "classification_head"


def classification_config(**kw) -> ModelConfig:
    """The BERT-shaped encoder; its binary-head flag brings the pooler."""
    return bert_config(**kw)


def cls_param_shapes(cfg: ModelConfig, num_classes: int) -> Dict[str, tuple]:
    """Flat {path: shape}: the encoder's leaves and the head's."""
    return {**param_shapes(cfg),
            f"{HEAD}/w": (cfg.hidden_size, num_classes),
            f"{HEAD}/b": (num_classes,)}


def cls_param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Flat {path: PartitionSpec}: the encoder's and a replicated head."""
    return {**param_specs(cfg), f"{HEAD}/w": P(), f"{HEAD}/b": P()}


def cls_init_params(cfg: ModelConfig, seed: int, num_classes: int,
                    device="cuda") -> Dict[str, Any]:
    """Encoder params and a fresh classification head [h, num_classes]."""
    params = init_params(cfg, seed, device=device)
    params[HEAD] = {
        "w": init_leaf(f"{HEAD}/w", (cfg.hidden_size, num_classes), _NORMAL,
                       cfg.init_method_std, seed, torch.device(device),
                       cfg.dtype),
        "b": init_leaf(f"{HEAD}/b", (num_classes,), _ZEROS, 0.0, seed,
                       torch.device(device), cfg.dtype),
    }
    return params


def cls_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                          device="cuda") -> Dict[str, Any]:
    """A JAX cls_init_params tree (numpy leaves) -> this package's tree."""
    num_classes = np.shape(tree[HEAD]["b"])[0]
    return tree_from_numpy(tree, cls_param_shapes(cfg, num_classes), device,
                           cfg.dtype)


def _pooled(cfg, params, tokens, padding_mask, tokentype_ids, recompute,
            mesh=None):
    hidden = encoder_hidden(cfg, params, tokens, padding_mask, tokentype_ids,
                            recompute, mesh)
    return pooled(params, hidden, mesh)


def classification_forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,            # [B, S]
    padding_mask: torch.Tensor,      # [B, S] True = real token
    tokentype_ids: Optional[torch.Tensor] = None,
    recompute: str = "none",
    mesh=None,
) -> torch.Tensor:
    """[B, num_classes] logits."""
    head = params[HEAD]
    return (_pooled(cfg, params, tokens, padding_mask, tokentype_ids,
                    recompute, mesh) @ head["w"] + head["b"])


def multichoice_forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,            # [B, C, S]
    padding_mask: torch.Tensor,      # [B, C, S]
    tokentype_ids: Optional[torch.Tensor] = None,
    recompute: str = "none",
    mesh=None,
) -> torch.Tensor:
    """[B, C] per-choice scores (the head is [h, 1])."""
    b, c, s = tokens.shape

    def flat(x):
        return x.reshape(b * c, s) if x is not None else None

    head = params[HEAD]
    scores = (_pooled(cfg, params, flat(tokens), flat(padding_mask),
                      flat(tokentype_ids), recompute, mesh) @ head["w"]
              + head["b"])
    return scores.reshape(b, c)


def classification_logits(
    cfg: ModelConfig,
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    recompute: str = "none",
    mesh=None,
) -> torch.Tensor:
    """Rank-3 tokens are multiple choice, rank 2 classification."""
    fwd = (multichoice_forward if batch["tokens"].dim() == 3
           else classification_forward)
    return fwd(cfg, params, batch["tokens"], batch["padding_mask"] > 0,
               batch.get("tokentype_ids"), recompute, mesh)


def classification_loss(
    cfg: ModelConfig,
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    recompute: str = "none",
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens, padding_mask, tokentype_ids, label. Returns (CE,
    {"loss", "accuracy"}). mesh: tensor and sequence parallelism (the
    head is computed whole on every tensor rank, models/bert.py)."""
    logits = classification_logits(cfg, params, batch, recompute, mesh)
    loss, _ = cross_entropy_loss(logits[:, None, :], batch["label"][:, None])
    acc = (logits.argmax(-1) == batch["label"]).float().mean()
    return loss, {"loss": loss, "accuracy": acc}
