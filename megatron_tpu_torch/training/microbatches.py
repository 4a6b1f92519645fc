"""Global-batch rampup / microbatch accounting.

(A copy of megatron_tpu/training/microbatches.py with its imports rewritten.)

Equivalent of megatron/microbatches.py (144 LoC):
ConstantNumMicroBatches and RampupBatchsizeNumMicroBatches behind one
calculator. Rampup semantics match the reference: with
(start, increment, ramp_samples), the global batch starts at `start` and
steps up by `increment`; each intermediate size consumes an equal share of
`ramp_samples` (ramp_samples / num_increments samples per level).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from megatron_tpu_torch.config import TrainingConfig


@dataclasses.dataclass
class MicroBatchCalculator:
    micro_batch_size: int
    target_global_batch: int
    data_parallel: int
    rampup: Optional[Tuple[int, int, int]] = None  # (start, incr, ramp_samples)

    def __post_init__(self):
        if self.target_global_batch % (self.micro_batch_size * self.data_parallel):
            raise ValueError(self._indivisible_message(
                self.target_global_batch, self.micro_batch_size,
                self.data_parallel))
        if self.rampup is not None:
            start, incr, _ = self.rampup
            if (self.target_global_batch - start) % incr:
                raise ValueError("(global_batch - start) must be divisible by increment")
            if start % (self.micro_batch_size * self.data_parallel):
                raise ValueError("rampup start batch not divisible by micro_batch*dp")
            if incr % (self.micro_batch_size * self.data_parallel):
                raise ValueError("rampup increment not divisible by micro_batch*dp")

    @staticmethod
    def _indivisible_message(gbs: int, micro: int, dp: int) -> str:
        """A loud, actionable error for the elastic-resume foot-gun: the
        global batch is the training-dynamics invariant (sample order,
        LR schedule, consumed_samples watermark all key off it), so an
        indivisible combination must name the valid gradient-accumulation
        choices rather than let anyone 'fix' it by drifting the batch
        size (docs/fault_tolerance.md "Preemption and elastic resume")."""
        head = (f"global_batch_size={gbs} not divisible by "
                f"micro_batch_size*data_parallel={micro}*{dp}={micro * dp}. "
                f"The global batch must stay invariant across topology "
                f"changes (it defines sample order and the LR schedule)")
        if gbs % dp == 0:
            per_rank = gbs // dp
            valid = [m for m in range(1, per_rank + 1) if per_rank % m == 0]
            shown = valid if len(valid) <= 16 else valid[:15] + [valid[-1]]
            return (f"{head}; at data_parallel={dp} choose "
                    f"micro_batch_size from {shown} (gradient accumulation "
                    f"= {gbs}/(micro_batch_size*{dp}) steps)")
        valid_dp = [d for d in range(1, gbs + 1) if gbs % d == 0]
        shown = valid_dp if len(valid_dp) <= 16 else valid_dp[:15] + [valid_dp[-1]]
        return (f"{head}; no micro_batch_size works at data_parallel={dp} "
                f"because {gbs} % {dp} != 0 — resume at a data-parallel "
                f"degree dividing {gbs} (valid: {shown}) or change "
                f"--global_batch_size deliberately")

    def global_batch(self, consumed_samples: int) -> int:
        if self.rampup is None:
            return self.target_global_batch
        start, incr, ramp_samples = self.rampup
        n_levels = (self.target_global_batch - start) // incr
        if n_levels == 0:
            return self.target_global_batch
        per_level = ramp_samples // n_levels
        level = min(consumed_samples // max(per_level, 1), n_levels)
        return min(start + level * incr, self.target_global_batch)

    def num_microbatches(self, consumed_samples: int) -> int:
        return self.global_batch(consumed_samples) // (
            self.micro_batch_size * self.data_parallel)

    @staticmethod
    def from_config(cfg: TrainingConfig, data_parallel: int) -> "MicroBatchCalculator":
        return MicroBatchCalculator(
            micro_batch_size=cfg.micro_batch_size,
            target_global_batch=cfg.global_batch_size,
            data_parallel=data_parallel,
            rampup=cfg.rampup_batch_size,
        )
