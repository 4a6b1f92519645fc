"""Learning-rate / weight-decay schedule (counterpart of
megatron_tpu/training/scheduler.py).

Linear warmup followed by {constant, linear, cosine, inverse-square-root}
decay, plus a weight-decay ramp: pure functions of the step. The step may
be a Python int or a device tensor (the train step keeps its counter on
the device, so the schedule never syncs the host); the result is a
float32 tensor on the step's device.
"""

from __future__ import annotations

import math

import torch

from megatron_tpu_torch.config import OptimizerConfig


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def lr_at_step(cfg: OptimizerConfig, step, train_iters: int) -> torch.Tensor:
    """LR at an integer step (OptimizerParamScheduler.get_lr)."""
    step = _f32(step)
    warmup = float(cfg.lr_warmup_iters if cfg.lr_warmup_fraction is None
                   else cfg.lr_warmup_fraction
                   * (cfg.lr_decay_iters or train_iters))
    decay_steps = float(cfg.lr_decay_iters or train_iters)
    max_lr, min_lr = cfg.lr, cfg.min_lr

    warmup_lr = max_lr * step / max(warmup, 1.0)
    frac = ((step - warmup) / max(decay_steps - warmup, 1.0)).clamp(0.0, 1.0)
    if cfg.lr_decay_style == "constant":
        decay_lr = torch.full_like(step, max_lr)
    elif cfg.lr_decay_style == "linear":
        decay_lr = max_lr + (min_lr - max_lr) * frac
    elif cfg.lr_decay_style == "cosine":
        decay_lr = min_lr + 0.5 * (max_lr - min_lr) * (
            1.0 + torch.cos(math.pi * frac))
    elif cfg.lr_decay_style == "inverse-square-root":
        # lr * sqrt(warmup) / sqrt(step), floored at min_lr
        eff = step.clamp_min(warmup + 1.0)
        decay_lr = (max_lr * math.sqrt(max(warmup, 1.0))
                    / torch.sqrt(eff)).clamp_min(min_lr)
    else:
        raise ValueError(f"unknown lr_decay_style {cfg.lr_decay_style!r}")
    return torch.where(step < warmup, warmup_lr, decay_lr)


def wd_at_step(cfg: OptimizerConfig, step, train_iters: int) -> torch.Tensor:
    """Weight-decay ramp (start/end_weight_decay + incr style)."""
    step = _f32(step)
    if (cfg.start_weight_decay is None or cfg.end_weight_decay is None
            or cfg.weight_decay_incr_style == "constant"):
        return torch.full_like(step, cfg.weight_decay)
    total = float(cfg.lr_decay_iters or train_iters)
    frac = (step / max(total, 1.0)).clamp(0.0, 1.0)
    w0, w1 = cfg.start_weight_decay, cfg.end_weight_decay
    if cfg.weight_decay_incr_style == "linear":
        return w0 + (w1 - w0) * frac
    if cfg.weight_decay_incr_style == "cosine":
        return w1 + 0.5 * (w0 - w1) * (1.0 + torch.cos(math.pi * frac))
    raise ValueError(
        f"unknown weight_decay_incr_style {cfg.weight_decay_incr_style!r}")
