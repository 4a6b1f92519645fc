"""BERT: the bidirectional encoder with the MLM and binary (SOP) heads
(counterpart of megatron_tpu/models/bert.py).

The encoder is the decoder models' layer stack run with
attn_mask_type="padding" (bidirectional attention plus a per-row key
padding mask) and token-type embeddings. The heads: the MLM transform
(dense -> exact GELU -> LayerNorm) over the tied decoder with an output
bias, and the pooler (tanh of the [CLS] hidden state) under the binary
head. A padding mask routes attention to the dense path in both packages
(ops/attention.py), so these models launch no flash kernel.

Tensor and sequence parallelism (a MeshRuntime as `mesh`): the encoder
is the decoder stack's; the MLM transform runs where the last layer
leaves its hidden states (this rank's sequence chunk under sequence
parallelism, so its replicated weights' gradients are partial sums that
reduce_grads sums, as it sums the norms'), then enters the tied decoder
through enter_tp, whose logits are this rank's vocab columns (plus its
block of mlm_head/bias, P(tensor)) and whose loss is the vocab-parallel
CE. The pooler and every [CLS] head read the row through
parallel/mappings.cls_row and are computed whole on every tensor rank.
Above one data rank the MLM loss is each rank's share of the global
microbatch's masked mean (language_model.batch_mean), as the JAX loss
over the global batch weighs every masked token alike.

The config defaults hidden and attention dropout to 0.1, as the JAX
package's does; a training pass given a dropout key (parallel/
random.py) draws them in the encoder (language_model.lm_forward), and
the classification heads add the pooled state's (models/
classification.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.language_model import (
    _ce, batch_mean, lm_forward,
)
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.ops.normalization import layernorm
from megatron_tpu_torch.parallel.mappings import cls_row, enter_tp


def bert_config(
    num_layers: int = 12,
    hidden_size: int = 768,
    num_attention_heads: int = 12,
    vocab_size: int = 30592,   # 30522 padded
    seq_length: int = 512,
    **kw,
) -> ModelConfig:
    """The JAX package's BERT config (hidden and attention dropout 0.1)."""
    base = dict(
        num_layers=num_layers, hidden_size=hidden_size,
        num_attention_heads=num_attention_heads, vocab_size=vocab_size,
        seq_length=seq_length, max_position_embeddings=seq_length,
        position_embedding_type="absolute",
        normalization="layernorm", activation="gelu",
        use_bias_linear=True, use_bias_qkv=True,
        tie_embed_logits=True, attn_mask_type="padding",
        num_tokentypes=2, bert_binary_head=True,
        hidden_dropout=0.1, attention_dropout=0.1,
    )
    base.update(kw)
    cfg = ModelConfig(**base).validate()
    refuse_moe(cfg)
    return cfg


def refuse_moe(cfg: ModelConfig) -> None:
    """The task heads' losses do not carry the router aux loss, so a MoE
    backbone would train its routing silently wrong (the JAX rule)."""
    if cfg.num_experts is not None:
        raise NotImplementedError(
            "MoE backbones are supported for the decoder (GPT) family "
            "only; encoder task heads would drop the router losses")


def pooled(params: Dict[str, Any], hidden: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """tanh of the [CLS] hidden state through the pooler [B, h];
    `hidden` as encoder_hidden returns it."""
    return torch.tanh(cls_row(hidden, mesh) @ params["pooler"]["w"]
                      + params["pooler"]["b"])


def encoder_hidden(cfg: ModelConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, padding_mask: torch.Tensor,
                   tokentype_ids: Optional[torch.Tensor] = None,
                   recompute: str = "none", mesh=None,
                   dropout_key=None) -> torch.Tensor:
    """The encoder's final-normed hidden states [B, S, h], under
    sequence parallelism this rank's chunk [B, S/tp, h] (the module
    docstring)."""
    return lm_forward(cfg, params, tokens, attention_mask=padding_mask,
                      tokentype_ids=tokentype_ids, recompute=recompute,
                      return_hidden=True, mesh=mesh, head_input=False,
                      dropout_key=dropout_key)


def bert_forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,            # [B, S]
    padding_mask: torch.Tensor,      # [B, S] True = real token
    tokentype_ids: Optional[torch.Tensor] = None,
    recompute: str = "none",
    mesh=None,
    dropout_key=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (mlm_logits [B, S, V], binary_logits [B, 2] or None);
    under tensor parallelism the logits are this rank's vocab columns
    [B, S, V/tp]."""
    hidden = encoder_hidden(cfg, params, tokens, padding_mask,
                            tokentype_ids, recompute, mesh, dropout_key)
    mh = params["mlm_head"]
    h = F.gelu(hidden @ mh["dense_w"] + mh["dense_b"], approximate="none")
    h = layernorm(h, mh["norm_scale"], mh["norm_bias"], cfg.layernorm_epsilon)
    logits = enter_tp(h, mesh) @ params["embed"]["tokens"].t() + mh["bias"]

    binary_logits = None
    if cfg.bert_binary_head:
        binary_logits = (pooled(params, hidden, mesh)
                         @ params["binary_head"]["w"]
                         + params["binary_head"]["b"])
    return logits, binary_logits


def bert_loss(
    cfg: ModelConfig,
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    recompute: str = "none",
    mesh=None,
    dropout_key=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens, padding_mask, tokentype_ids, labels (the MLM
    targets), loss_mask (1 at masked positions), is_random (the binary
    target). Returns (MLM CE + SOP CE, {"mlm_loss", "sop_loss", "loss"});
    under tensor parallelism the MLM CE is the vocab-parallel one."""
    logits, binary_logits = bert_forward(
        cfg, params, batch["tokens"], batch["padding_mask"] > 0,
        tokentype_ids=batch.get("tokentype_ids"), recompute=recompute,
        mesh=mesh, dropout_key=dropout_key)
    mlm_loss = batch_mean(_ce(logits, batch["labels"], mesh)[1],
                          batch["loss_mask"], mesh)
    total = mlm_loss
    aux = {"mlm_loss": mlm_loss}
    if binary_logits is not None and "is_random" in batch:
        sop, _ = cross_entropy_loss(binary_logits[:, None, :],
                                    batch["is_random"][:, None])
        total = total + sop
        aux["sop_loss"] = sop
    aux["loss"] = total
    return total, aux
