"""Pipeline parallelism for the T5 encoder-decoder (counterpart of
megatron_tpu/training/t5_pipeline.py).

The JAX package maps the encoder -> decoder dependency onto its
interleaved ring: every stage holds one chunk of encoder layers and one
of decoder layers (V = 2 virtual chunks), a microbatch goes round the
ring twice (the encoder pass, the wrap-around, the decoder pass), and
the carry is the pair (hidden, enc_out). The port runs the same ring on
training/pipeline.py's interleaved schedule and its p2p, with the pair
packed into the one activation the schedule sends: [mbs, Smax + Se, h],
the hidden slot padded to Smax = max(Se, Sd) first, the enc_out slot
after it.

  * chunk 0 (encoder) on stage s runs encoder layers [s*Le/pp,
    (s+1)*Le/pp) on the hidden slot's first Se rows; stage 0 embeds the
    encoder tokens into it; the last stage applies the encoder's final
    norm and writes the result into the enc_out slot;
  * chunk 1 (decoder) on stage s runs its decoder slice on the first Sd
    rows, cross-attending to the enc_out slot; stage 0 embeds the
    decoder tokens (the wrap-around brings it the encoder's output);
  * the last stage's chunk 1 applies the decoder's final norm, the tied
    logits and the CE. The loss is the JAX loss: the masked per-token
    CE summed over every microbatch over the batch's masked token count
    (over the batch group's rows at dp > 1, the global batch's);
    train_step averages each microbatch's share over the microbatches
    and the batch ranks, so a share is its sum times M * dp over that
    count.

The backward is the schedule's: the decoder stages' gradient of the
enc_out slot rides the ring back with the hidden slot's and reaches the
encoder's final norm on the last stage. Each stage holds its slices of
both stacks (models/t5.t5_param_specs(pipeline=True)); the embedding and
the final norms are held by every stage and their gradients summed over
the pipe group (training/train_step.reduce_grads). Tensor parallelism
runs inside each stage (models/t5.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.language_model import _ce
from megatron_tpu_torch.models.t5 import (
    _norm, dec_stack, embed, enc_stack, t5_stack_depths, tied_logits,
)
from megatron_tpu_torch.parallel.mappings import all_reduce
from megatron_tpu_torch.parallel.mesh import BATCH_AXES
from megatron_tpu_torch.training.pipeline import Pipeline


def check_t5_pipeline(cfg: ModelConfig, num_stages: int,
                      num_microbatches: int) -> None:
    """The JAX package's constraints and messages: each stack's depth
    divisible by the stages, and the microbatches by the stages."""
    Le, Ld = t5_stack_depths(cfg)
    for name, L in (("encoder", Le), ("decoder", Ld)):
        if L % num_stages:
            raise ValueError(
                f"{name}_num_layers={L} not divisible by stages "
                f"{num_stages}")
    if num_microbatches % num_stages:
        raise ValueError(
            f"the enc+dec interleaved ring needs num_microbatches % "
            f"num_stages == 0 (got {num_microbatches} % {num_stages})")


class T5Pipeline(Pipeline):
    """The enc+dec ring of one rank's stage for one microbatch count (the
    pipeline_loss_factory of TrainLoop: T5Pipeline(cfg, mesh,
    num_microbatches, recompute))."""

    TOKENS = "enc_tokens"

    def __init__(self, cfg: ModelConfig, mesh, num_microbatches: int,
                 recompute: str = "none"):
        if mesh.vpp > 1:
            raise ValueError(
                "T5 pp>1 is already interleaved (encoder+decoder chunks "
                "per stage); --num_layers_per_virtual_pipeline_stage "
                "doesn't apply")
        if mesh.sequence_parallel:
            raise ValueError("T5 under sequence parallelism is not ported "
                             "(ROADMAP.md): run tensor parallelism alone")
        check_t5_pipeline(cfg, mesh.pp, num_microbatches)
        self.cfg, self.mesh = cfg, mesh
        self.M, self.V, self.pp = num_microbatches, 2, mesh.pp
        self.recompute = recompute
        self.metric_sums = None
        self._count: Optional[torch.Tensor] = None

    def _rope(self, batch):
        return None

    def _act_shape(self, batch):
        mbs = batch["enc_tokens"].shape[0] // self.M
        se, sd = batch["enc_tokens"].shape[1], batch["dec_tokens"].shape[1]
        return (mbs, max(se, sd) + se, self.cfg.hidden_size)

    def _token_count(self, batch) -> torch.Tensor:
        """The masked token count the loss divides by: this data rank's
        batch's, summed over the batch group (cached per batch)."""
        if self._count is None:
            lm = batch.get("loss_mask")
            count = (lm.float().sum() if lm is not None else
                     torch.tensor(float(batch["labels"].numel()),
                                  device=batch["labels"].device))
            if self.mesh.dp > 1:
                count = all_reduce(count, self.mesh.group(BATCH_AXES))
            self._count = count.clamp_min(1.0)
        return self._count

    def _forward(self, params, batch, rope, m: int, c: int,
                 x: Optional[torch.Tensor], metrics=(), dropout_key=None):
        # T5 applies no dropout, whatever the config says (the JAX
        # package's t5.py draws none): the key is taken and unused
        cfg, mesh = self.cfg, self.mesh
        mbs = batch["enc_tokens"].shape[0] // self.M
        mb = {k: v[m * mbs:(m + 1) * mbs] for k, v in batch.items()}
        se, sd = mb["enc_tokens"].shape[1], mb["dec_tokens"].shape[1]
        smax = max(se, sd)
        mask = mb["enc_padding_mask"] > 0
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        if x is None:                       # stage 0's encoder chunk
            h = embed(params, mb["enc_tokens"], mesh).to(cfg.dtype)
            enc_out = h.new_zeros((mbs, se, cfg.hidden_size))
        else:
            h, enc_out = x[:, :smax], x[:, smax:]
        if c == 0:
            h = enc_stack(cfg, params["encoder"], h[:, :se], mask,
                          self.recompute, mesh)
            if mesh.is_last_stage:
                enc_out = _norm(cfg, params["encoder"]["final_ln"], h)
        else:
            if mesh.is_first_stage:
                h = embed(params, mb["dec_tokens"], mesh).to(cfg.dtype)
            h = dec_stack(cfg, params["decoder"], h[:, :sd], enc_out, mask,
                          self.recompute, mesh)
            if mesh.is_last_stage:
                logits = tied_logits(cfg, params, h, mesh)
                lm = mb.get("loss_mask")
                per_token = _ce(logits, mb["labels"], mesh)[1]
                total = (per_token * lm.float()).sum() if lm is not None \
                    else per_token.sum()
                return (total * (self.M * mesh.dp)
                        / self._token_count(batch), zero)
        if h.shape[1] < smax:
            h = torch.cat([h, h.new_zeros((mbs, smax - h.shape[1],
                                           h.shape[2]))], dim=1)
        return torch.cat([h, enc_out], dim=1), zero

    def forward_backward(self, params, batch, scale, on_backward,
                         dropout_key=None):
        self._count = None
        self._token_count(batch)    # the batch group's one collective
        return super().forward_backward(params, batch, scale, on_backward,
                                        dropout_key)

    def forward_only(self, params, batch: Dict[str, torch.Tensor],
                     metrics=()) -> Optional[torch.Tensor]:
        """Every microbatch through the ring (evaluation): on the last
        stage the mean of the microbatches' shares, which the pipe and
        batch groups' agreement (training/train_step.agreed_loss) makes
        the JAX loss of the batch; None elsewhere."""
        self._count = None
        self._token_count(batch)
        return super().forward_only(params, batch)
