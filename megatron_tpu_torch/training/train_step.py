"""The training step: microbatch gradient accumulation + optimizer
(counterpart of megatron_tpu/training/train_step.py).

train_step(state, batch) splits the global batch's leading axis into
microbatches, runs forward and backward on each, accumulates the
gradients in fp32 (the reference's accumulate_allreduce_grads_in_fp32 /
main_grad) in buffers allocated once per step function, averages them
and applies the optimizer. Everything stays on the device: the metrics
are device tensors, and reading them is the caller's one host sync.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from megatron_tpu_torch.config import (ModelConfig, OptimizerConfig,
                                       TrainingConfig)
from megatron_tpu_torch.models.language_model import lm_forward, lm_loss
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.training.optimizer import (
    TrainState, leaf_paths, make_optimizer_step, tree_map,
)


def make_train_step(
    model_cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    train_cfg: TrainingConfig,
    num_microbatches: int,
    train_iters: Optional[int] = None,
    loss_fn: Optional[Callable] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build train_step(state, batch) -> (state, metrics).

    batch leaves are [num_microbatches * micro_batch, ...]. loss_fn(cfg,
    params, microbatch) -> (loss, aux) defaults to lm_loss with the
    configured recompute policy. The state's params must require grad;
    the state is updated in place and returned. metrics: loss (mean over
    microbatches), grad_norm, lr, skipped, skip_streak (+ loss_scale with
    an fp16 scaler)."""
    loss_fn = loss_fn or (lambda cfg, p, b: lm_loss(
        cfg, p, b, recompute=train_cfg.recompute_granularity))
    opt_apply = make_optimizer_step(opt_cfg,
                                    train_iters or train_cfg.train_iters or 1)
    acc: Dict[str, Any] = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        n = num_microbatches
        gbs = next(iter(batch.values())).shape[0]
        if gbs % n:
            raise ValueError(f"batch of {gbs} not divisible into {n} "
                             "microbatches")
        mbs = gbs // n
        if not acc:
            # allocated once per step function: with fp32 Adam state this
            # is the largest buffer a step touches besides the state
            acc["tree"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
        grads = acc["tree"]
        for _, a in leaf_paths(grads):
            a.zero_()
        params = [p for _, p in leaf_paths(state.params)]
        accs = [a for _, a in leaf_paths(grads)]
        scale = state.scaler.scale if state.scaler is not None else None
        losses = []
        for i in range(n):
            mb = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
            loss, _ = loss_fn(model_cfg, state.params, mb)
            (loss * scale if scale is not None else loss).backward()
            with torch.no_grad():
                for a, p in zip(accs, params):
                    if p.grad is not None:
                        a.add_(p.grad)
                        p.grad = None
            losses.append(loss.detach())
        with torch.no_grad():
            # mean over microbatches; scaled grads stay scaled for the
            # optimizer, which unscales them
            for a in accs:
                a.div_(n)
        state, metrics = opt_apply(state, grads)
        metrics["loss"] = torch.stack(losses).mean()
        return state, metrics

    return train_step


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainingConfig):
    """Forward-only LM loss (the JAX package's eval_step):
    eval_step(params, batch) -> {"lm_loss", "ntokens", and each of
    train_cfg.metrics (training/metrics.py)}, device tensors."""
    from megatron_tpu_torch.training.metrics import compute_metrics

    @torch.no_grad()
    def eval_step(params: Any, batch: Dict[str, torch.Tensor]):
        logits = lm_forward(model_cfg, params, batch["tokens"],
                            positions=batch.get("position_ids"))
        loss_mask = batch.get("loss_mask")
        if loss_mask is None:
            loss_mask = torch.ones(batch["labels"].shape,
                                   dtype=torch.float32,
                                   device=batch["labels"].device)
        loss, per_token = cross_entropy_loss(logits, batch["labels"],
                                             loss_mask=loss_mask)
        out = {"lm_loss": loss, "ntokens": loss_mask.sum()}
        out.update(compute_metrics(train_cfg.metrics, logits,
                                   batch["labels"], loss_mask, per_token))
        return out

    return eval_step
