"""The pipelined inference forward for pp > 1 (counterpart of
megatron_tpu/inference/pipelined.py).

The reference streams each forward through the pipeline stages with
NCCL p2p and broadcasts the last stage's logits back
(megatron/text_generation/forward_step.py:45-204,
communication.py's broadcast_from_last_pipeline_stage); the JAX package
writes the same program under shard_map over its "pipe" axis. Here each
rank runs its own stage of one forward:

  * stage 0 embeds the tokens (the vocab-parallel embedding under
    tensor parallelism);
  * every stage runs its L/pp layers over its own KV caches [L/pp, B,
    total_len, nkv/tp, D] (models/params.stage_holds gives it those
    layers' params), so each stage's caches stay on its card;
  * the hidden state [B, S, h] goes from stage to stage by send/recv
    (parallel/mappings.p2p, as training/pipeline.py moves activations);
  * the last stage applies the final norm and the LM head, gathers the
    logits over its tensor group to [B, S, V] and broadcasts them to
    every stage over the pipe group.

So one forward costs pp sequential stage-times, the pipeline's latency
for a single batch, as in the JAX package. inference/generation.py's
generate_tokens and score_tokens run it whenever their mesh has pp > 1
(the JAX package passes it as their forward_fn): called with kv_caches
it returns (logits, kv_caches), without them (scoring) the logits.
Every rank of the serving world calls it with the same arguments (rank
0 announced the request: inference/server.py). int8 caches are refused
with it (generation.pipelined), as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.language_model import (
    _layers, embed_tokens, final_hidden_norm, lm_logits, run_layers,
)
from megatron_tpu_torch.models.transformer import block_forward
from megatron_tpu_torch.ops.rotary import precompute_rope
from megatron_tpu_torch.parallel.mappings import (
    all_gather, broadcast, enter_tp, p2p,
)

_ACT = 1                       # the p2p tag of a stage's hidden state


class PipelinedForward:
    """One rank's stage of the pipelined serving forward."""

    def __init__(self, cfg: ModelConfig, mesh):
        if mesh is None or mesh.pp < 2:
            raise ValueError("PipelinedForward needs a mesh with pp > 1")
        if mesh.vpp > 1 or mesh.sequence_parallel:
            raise ValueError("pipelined serving runs one chunk a stage "
                             "without sequence parallelism")
        if cfg.num_layers % mesh.pp:
            raise ValueError(f"num_layers={cfg.num_layers} not divisible "
                             f"by stages {mesh.pp}")
        self.cfg, self.mesh = cfg, mesh
        #: the layers this stage holds (its caches' leading axis)
        self.num_layers = cfg.num_layers // mesh.pp

    def __call__(self, params: Any, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 kv_caches: Optional[Tuple[torch.Tensor, ...]] = None,
                 cache_index=None,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 mesh=None):
        """lm_forward's contract for a forward over caches of this
        stage's layers (or none), with the logits [B, S, V] whole on
        every rank. `mesh` is accepted for the call's shape only: the
        forward's own is the one it was built with."""
        cfg, mesh = self.cfg, self.mesh
        B, S = tokens.shape
        dev = tokens.device
        if positions is None and kv_caches is not None:
            positions = int(cache_index) + torch.arange(S, device=dev)[None]
        if rope is None and cfg.position_embedding_type == "rotary":
            n = (kv_caches[0].shape[2] if kv_caches is not None
                 else max(cfg.seq_length, S))
            rope = precompute_rope(cfg.head_dim, n, cfg.rope_theta,
                                   cfg.rope_scaling_factor, device=dev)
        if mesh.is_first_stage:
            x = embed_tokens(cfg, params, tokens, positions, mesh=mesh)
        else:
            x = p2p([], [((B, S, cfg.hidden_size), cfg.dtype, dev,
                          mesh.pipe_prev, _ACT)])[0]
        layers = []
        for i, lp in enumerate(_layers(params["layers"], self.num_layers)):
            cache = (None if kv_caches is None
                     else tuple(c[i] for c in kv_caches))
            layers.append(functools.partial(
                block_forward, cfg, lp, rope=rope, positions=positions,
                kv_cache=cache, cache_index=cache_index, mesh=mesh))
        x, _ = run_layers(layers, x)
        V = cfg.vocab_size
        if mesh.is_last_stage:
            logits = lm_logits(cfg, params, enter_tp(
                final_hidden_norm(cfg, params, x), mesh))
            if mesh.tp > 1:
                logits = all_gather(logits, mesh.group("tensor"), dim=-1)
        else:
            p2p([(x, mesh.pipe_next, _ACT)], [])
            logits = torch.empty((B, S, V), dtype=cfg.dtype, device=dev)
        logits = broadcast(logits, mesh.group("pipe"), src=mesh.pp - 1)
        if kv_caches is not None:
            return logits, kv_caches
        return logits
