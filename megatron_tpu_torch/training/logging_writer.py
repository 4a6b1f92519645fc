"""Scalar logging: tensorboard and/or wandb behind one add_scalar API.

A copy of megatron_tpu/training/logging_writer.py. Both backends stay
optional: a missing one prints one line and writes nothing.

Equivalent of the reference's tensorboard wiring in training_log
(training.py:462-641) and the WandbTBShim (megatron/wandb_logger.py, 174
LoC — exposes add_scalar over wandb). Here one Writer multiplexes both;
each backend is optional and failures to import degrade to console-only.
"""

from __future__ import annotations

from typing import Optional


class Writer:
    def __init__(self, tensorboard_dir: Optional[str] = None,
                 wandb: bool = False, wandb_project: str = "megatron_tpu",
                 wandb_name: Optional[str] = None, config: Optional[dict] = None):
        self._tb = None
        self._wandb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"tensorboard unavailable ({e}); scalars not written")
            else:
                try:
                    self._tb = SummaryWriter(log_dir=tensorboard_dir)
                except Exception as e:  # noqa: BLE001 - unwritable dir is
                    # OSError but version-skewed protobuf/tensorboard raise
                    # their own types; an optional logger must never kill
                    # the training run
                    print(f"tensorboard unavailable ({e}); "
                          "scalars not written")
        if wandb:
            try:
                import wandb as wandb_mod
            except ImportError as e:
                print(f"wandb unavailable ({e}); scalars not written")
            else:
                try:
                    wandb_mod.init(project=wandb_project, name=wandb_name,
                                   config=config or {})
                    self._wandb = wandb_mod
                except Exception as e:  # noqa: BLE001 - third-party init
                    # (network, auth, server) raises wandb-internal types;
                    # an optional logger must never kill the training run
                    print(f"wandb unavailable ({e}); scalars not written")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value}, step=step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
