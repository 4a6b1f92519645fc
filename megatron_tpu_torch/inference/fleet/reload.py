"""Manifest-verified weight loads for hot reload (counterpart of
megatron_tpu/inference/fleet/reload.py).

A rolling weight update must never push a torn or bitrotted checkpoint
into a serving replica. A checkpoint is eligible only when its manifest
verifies (training/checkpointing.py: verify_checkpoint,
list_valid_checkpoints); with no pinned iteration the pick is the newest
valid committed iteration, as a training resume falls back.

save_params_checkpoint is the write-side helper for serving tools and
tests: a params-only checkpoint (state/params.pt, torch.save) with the
same staging -> manifest -> rename commit, readable by
checkpointing.load_params_only.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.optimizer import leaf_paths


class NoValidCheckpointError(RuntimeError):
    """No committed checkpoint in the load dir passes manifest verify."""


def resolve_reload_iteration(load: str, iteration: Optional[int] = None,
                             deep: bool = False) -> int:
    """The iteration a reload serves: `iteration` if pinned (it must
    verify: a pinned but corrupt checkpoint fails loudly rather than
    falling back), else the newest iteration whose manifest verifies."""
    if iteration is not None:
        ok, detail = ckpt.verify_checkpoint(
            ckpt.checkpoint_dir(load, int(iteration)), deep=deep)
        if not ok:
            raise NoValidCheckpointError(
                f"checkpoint iter {iteration} under {load} failed "
                f"verification: {detail}")
        return int(iteration)
    valid = ckpt.list_valid_checkpoints(load, deep=deep)
    if not valid:
        raise NoValidCheckpointError(
            f"no committed checkpoint under {load} passes manifest "
            "verification")
    return valid[-1]


def load_verified_params(load: str, params_template: Any,
                         iteration: Optional[int] = None,
                         deep: bool = False) -> Tuple[Any, int]:
    """(params, iteration): manifest-verify, then restore just the params
    (fp32 masters preferred when present) onto the template's devices and
    dtypes (checkpointing.load_params_only)."""
    it = resolve_reload_iteration(load, iteration, deep=deep)
    return ckpt.load_params_only(load, params_template, iteration=it), it


def save_params_checkpoint(save: str, iteration: int, params: Any) -> str:
    """Commit a params-only checkpoint at `iteration` under `save`: stage
    -> state/params.pt -> meta + manifest commit -> rename -> tracker
    bump. No masters: serving saves are already in the serving dtype.
    Returns the committed directory."""
    stage = ckpt._staging_dir(save, iteration)
    shutil.rmtree(stage, ignore_errors=True)
    os.makedirs(stage)
    ckpt._write_state(stage, ckpt._to_host(
        {"params": dict(leaf_paths(params))}))
    return ckpt._finalize(save, stage, iteration, consumed_samples=0,
                          config=None, keep_latest_k=None)
