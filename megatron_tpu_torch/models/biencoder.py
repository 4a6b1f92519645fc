"""ICT/REALM biencoder: two BERT towers for retrieval pretraining
(counterpart of megatron_tpu/models/biencoder.py).

A query tower and a context tower, or one shared tower
(--biencoder_shared_query_context_model), each embed a text as a linear
ict_head projection of its [CLS] hidden state, trained with the in-batch
softmax of the reference's pretrain_ict.py: scores = Q @ C^T over the
batch, the labels on the diagonal, optionally scaled by 1/sqrt(h), with
the top-k retrieval accuracies reported. The in-batch negatives are the
whole global batch, so the loop runs it as one microbatch
(TrainLoop(fixed_num_microbatches=1)). Above one data rank each rank
embeds its rows, and the loss gathers the embeddings over the batch
group (parallel/mappings.gather_batch) to score the whole batch, as
GSPMD's gather gives the JAX loss the global batch; under tensor
parallelism the towers are BERT's (models/bert.py) and the ict_heads
are computed whole on every tensor rank.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.bert import bert_config, encoder_hidden
from megatron_tpu_torch.models.params import (
    _NORMAL, _ZEROS, init_leaf, init_params, param_shapes, param_specs,
    tree_from_numpy,
)
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.parallel.mappings import cls_row, gather_batch
from megatron_tpu_torch.parallel.sharding import P

HEAD = "ict_head"


def biencoder_config(**kw) -> ModelConfig:
    """A BERT config without the pooler and MLM head (the towers')."""
    base = dict(bert_binary_head=False)
    base.update(kw)
    return bert_config(**base)


def _towers(shared: bool) -> Tuple[str, ...]:
    return ("shared",) if shared else ("query", "context")


def biencoder_param_shapes(cfg: ModelConfig, ict_head_size: int = 128,
                           shared: bool = False) -> Dict[str, tuple]:
    """Flat {path: shape}: each tower's encoder leaves and its ict_head."""
    out = {}
    for name in _towers(shared):
        for path, shape in param_shapes(cfg).items():
            out[f"{name}/{path}"] = shape
        out[f"{name}/{HEAD}/w"] = (cfg.hidden_size, ict_head_size)
        out[f"{name}/{HEAD}/b"] = (ict_head_size,)
    return out


def biencoder_param_specs(cfg: ModelConfig, ict_head_size: int = 128,
                          shared: bool = False) -> Dict[str, P]:
    """Flat {path: PartitionSpec}: each tower's encoder specs and a
    replicated ict_head (the JAX package's)."""
    out = {}
    for name in _towers(shared):
        for path, spec in param_specs(cfg).items():
            out[f"{name}/{path}"] = spec
        out[f"{name}/{HEAD}/w"] = P()
        out[f"{name}/{HEAD}/b"] = P()
    return out


def biencoder_init_params(cfg: ModelConfig, seed: int,
                          ict_head_size: int = 128, shared: bool = False,
                          device="cuda") -> Dict[str, Any]:
    """{"query": tower, "context": tower} or {"shared": tower}; each tower
    draws from a seed folded with its name, as the JAX package folds its
    key."""
    device = torch.device(device)
    out = {}
    for name in _towers(shared):
        tseed = zlib.crc32(name.encode(), int(seed) & 0xFFFFFFFF)
        tower = init_params(cfg, tseed, device=device)
        tower[HEAD] = {
            "w": init_leaf(f"{HEAD}/w", (cfg.hidden_size, ict_head_size),
                           _NORMAL, cfg.init_method_std, tseed, device,
                           cfg.dtype),
            "b": init_leaf(f"{HEAD}/b", (ict_head_size,), _ZEROS, 0.0, tseed,
                           device, cfg.dtype),
        }
        out[name] = tower
    return out


def biencoder_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                                device="cuda") -> Dict[str, Any]:
    """A JAX biencoder_init_params tree (numpy leaves) -> this package's
    tree."""
    shared = "shared" in tree
    size = np.shape(tree["shared" if shared else "query"][HEAD]["b"])[0]
    return tree_from_numpy(tree, biencoder_param_shapes(cfg, size, shared),
                           device, cfg.dtype)


def load_biencoder_params(cfg: ModelConfig, load: Optional[str],
                          ict_head_size: int, shared: bool,
                          device="cuda", seed: int = 0) -> Dict[str, Any]:
    """The towers, initialized from `seed` and restored from `load` when
    given: a biencoder checkpoint restores every leaf; a BERT checkpoint
    restores each tower's encoder leaves, and the ict_heads keep their
    init (the reference's --bert_load)."""
    from megatron_tpu_torch.training.checkpointing import (
        load_params_only, saved_param_names,
    )

    params = biencoder_init_params(cfg, seed, ict_head_size, shared, device)
    if not load:
        return params
    names = saved_param_names(load)
    if any(n.split("/", 1)[0] in ("query", "context", "shared")
           for n in names):
        return load_params_only(load, params)
    out = {}
    for name, tower in params.items():
        encoder = {k: v for k, v in tower.items() if k != HEAD}
        out[name] = {**load_params_only(load, encoder), HEAD: tower[HEAD]}
    return out


def embed_text(cfg: ModelConfig, tower: Dict[str, Any],
               tokens: torch.Tensor,          # [B, S]
               padding_mask: torch.Tensor,    # [B, S] True = real
               recompute: str = "none", mesh=None) -> torch.Tensor:
    """[B, ict_head_size]: the ict_head of the [CLS] hidden state."""
    hidden = encoder_hidden(cfg, tower, tokens, padding_mask,
                            recompute=recompute, mesh=mesh)
    return cls_row(hidden, mesh) @ tower[HEAD]["w"] + tower[HEAD]["b"]


def biencoder_forward(cfg: ModelConfig, params: Dict[str, Any],
                      query_tokens, query_pad_mask, context_tokens,
                      context_pad_mask, recompute: str = "none", mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(query embeddings, context embeddings) of this rank's rows."""
    qt = params.get("shared", params.get("query"))
    ct = params.get("shared", params.get("context"))
    return (embed_text(cfg, qt, query_tokens, query_pad_mask, recompute,
                       mesh),
            embed_text(cfg, ct, context_tokens, context_pad_mask, recompute,
                       mesh))


def biencoder_loss(
    cfg: ModelConfig,
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    score_scaling: bool = False,
    topk: Tuple[int, ...] = (1, 5),
    recompute: str = "none",
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: query_tokens, query_pad_mask, context_tokens,
    context_pad_mask. The in-batch softmax with diagonal labels over the
    whole batch (every batch rank's rows, the module docstring); aux has
    the loss and top{k}_acc in percent (the reference's convention)."""
    q, c = biencoder_forward(
        cfg, params, batch["query_tokens"], batch["query_pad_mask"] > 0,
        batch["context_tokens"], batch["context_pad_mask"] > 0, recompute,
        mesh)
    q, c = gather_batch(q, mesh), gather_batch(c, mesh)
    scores = q.float() @ c.float().t()
    if score_scaling:
        scores = scores / math.sqrt(cfg.hidden_size)
    labels = torch.arange(scores.shape[0], device=scores.device)
    loss, _ = cross_entropy_loss(scores[:, None, :], labels[:, None])
    aux = {"loss": loss}
    ranks = (scores > scores.gather(1, labels[:, None])).sum(1)
    for k in topk:
        aux[f"top{k}_acc"] = 100.0 * (ranks < k).float().mean()
    return loss, aux
