"""Training orchestration: the pretrain() / train loop (counterpart of
megatron_tpu/training/pretrain.py, its core).

TrainLoop builds the state on one device, trains for train_iters with
batch-size rampup, evaluates every eval_interval and logs each
log_interval window in the JAX package's line format (iteration,
consumed samples, lm loss, lr, grad norm, skipped, tokens/sec, model
TFLOP/s from 3 x flops_per_token_fwd). The step itself never syncs the
host: the log line is the one place metrics are read, and the window's
wall clock runs from one log line (or evaluation, or checkpoint save) to
the next, so tokens/sec counts training time only.

With --load it resumes at start (training/checkpointing.py; nothing
found: a fresh start, logged), and with --save it checkpoints every
save_interval iterations and once at the end, through an
AsyncCheckpointSaver that every exit path flushes. consumed_samples is
restored with the state, and the data iterator is rebuilt from it, so
a resumed run reads the samples an uninterrupted one would.

Not ported yet: resilience (sentinels, rollback, preemption), the async
prefetch loop, profiling windows, telemetry and multi-host coordination.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import RunConfig
from megatron_tpu_torch.models.params import init_params, num_params
from megatron_tpu_torch.training import checkpointing
from megatron_tpu_torch.training.microbatches import MicroBatchCalculator
from megatron_tpu_torch.training.optimizer import (
    TrainState, init_train_state, leaf_paths,
)
from megatron_tpu_torch.training.train_step import (
    make_eval_step, make_train_step,
)


def get_ltor_masks_and_position_ids(
    tokens: np.ndarray,
    eod_token: Optional[int] = None,
    reset_position_ids: bool = False,
    eod_mask_loss: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(loss_mask, position_ids) for left-to-right LM batches; the
    block-diagonal attention reset is packed position ids + causal
    masking, not a materialized [S, S] mask."""
    b, s = tokens.shape
    loss_mask = np.ones((b, s), np.float32)
    if eod_mask_loss and eod_token is not None:
        loss_mask[tokens == eod_token] = 0.0
    position_ids = np.tile(np.arange(s, dtype=np.int64), (b, 1))
    if reset_position_ids and eod_token is not None:
        for i in range(b):
            for j in np.nonzero(tokens[i] == eod_token)[0]:
                if j + 1 < s:
                    position_ids[i, j + 1:] = np.arange(s - (j + 1))
    return loss_mask, position_ids


def gpt_collate(items, eod_token=None, eod_mask_loss=False,
                reset_position_ids=False):
    """'text' [seq+1] items -> tokens/labels/loss_mask batch (+ packed
    position_ids with reset_position_ids)."""
    text = np.stack([it["text"] for it in items]).astype(np.int64)
    tokens, labels = text[:, :-1], text[:, 1:]
    _, position_ids = get_ltor_masks_and_position_ids(
        tokens, eod_token, reset_position_ids=reset_position_ids)
    loss_mask = np.ones(labels.shape, np.float32)
    if eod_mask_loss and eod_token is not None:
        loss_mask[labels == eod_token] = 0.0
    batch = {"tokens": tokens, "labels": labels, "loss_mask": loss_mask}
    if reset_position_ids:
        batch["position_ids"] = position_ids
    return batch


class TrainLoop:
    """Owns the state, the step functions and the iteration loop on one
    device ("cuda" unless the caller asks for the CPU).

    After train(), `history` holds one record per logged window
    (iteration, consumed, lm_loss, lr, grad_norm, skipped, window_s,
    tokens_per_s, model_tflops_per_s), `evals` one per evaluation,
    `saves` one per committed checkpoint (AsyncCheckpointSaver.history)
    and `load_s` the seconds the --load took (None without one)."""

    def __init__(self, run_cfg: RunConfig, log: Callable[[str], None] = print,
                 device="cuda"):
        run_cfg.validate()
        self.cfg = run_cfg
        self.log = log
        self.device = torch.device(device)
        model_cfg = run_cfg.model
        if model_cfg.attention_impl == "pallas":
            # the gradient path is never a mystery in the log
            self.log("attention: flash kernels, "
                     + ("fused fwd+bwd (autograd Function)"
                        if model_cfg.flash_bwd
                        else "fwd only — dense O(S^2) attention gradient "
                        "(--no_flash_bwd)"))
        params = init_params(model_cfg, run_cfg.training.seed,
                             device=self.device)
        for _, p in leaf_paths(params):
            p.requires_grad_(True)
        self.state: TrainState = init_train_state(
            run_cfg.optimizer, params,
            use_fp16_scaler=(model_cfg.params_dtype == "float16"))
        self.calc = MicroBatchCalculator.from_config(run_cfg.training, 1)
        self.iteration = 0
        self.consumed_samples = 0
        self._step_cache: Dict[int, Callable] = {}
        self.eval_step = make_eval_step(model_cfg, run_cfg.training)
        self.history: List[Dict[str, float]] = []
        self.evals: List[Dict[str, float]] = []
        self._save_config = run_cfg.to_dict()
        self._saver: Optional[checkpointing.AsyncCheckpointSaver] = None
        self.saves: List[Dict[str, Any]] = []
        self.load_s: Optional[float] = None
        if run_cfg.training.load:
            self._load()

    # -- checkpoint ---------------------------------------------------------

    def _load(self) -> None:
        t = self.cfg.training
        t0 = time.perf_counter()
        try:
            self.state, it, consumed = checkpointing.load_checkpoint(
                t.load, self.state, finetune=t.finetune,
                no_load_optim=t.no_load_optim, config=self._save_config)
        except FileNotFoundError:
            self.log(f"no checkpoint found in {t.load}, starting fresh")
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_s = time.perf_counter() - t0
        self.iteration, self.consumed_samples = it, consumed
        self.log(f"loaded checkpoint at iteration {it} "
                 f"(consumed {consumed} samples)")

    def save(self) -> None:
        """Checkpoint the state at this iteration. Returns once it is on
        the host; the write and commit overlap the next steps unless
        --no_async_save."""
        t = self.cfg.training
        if self._saver is None:
            self._saver = checkpointing.AsyncCheckpointSaver(
                t.save, keep_latest_k=t.keep_latest_k, log=self.log,
                async_save=t.async_save)
            self.saves = self._saver.history
        self._saver.save(self.state, self.iteration, self.consumed_samples,
                         config=self._save_config)

    def _train_step_for(self, num_microbatches: int) -> Callable:
        step = self._step_cache.get(num_microbatches)
        if step is None:
            t = self.cfg.training
            step = make_train_step(self.cfg.model, self.cfg.optimizer, t,
                                   num_microbatches,
                                   train_iters=t.train_iters)
            self._step_cache[num_microbatches] = step
        return step

    def put_batch(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a host batch. Returns DEVICE metrics."""
        device_batch = self.put_batch(batch)
        gbs = next(iter(device_batch.values())).shape[0]
        n_micro = max(gbs // self.cfg.training.micro_batch_size, 1)
        self.state, metrics = self._train_step_for(n_micro)(
            self.state, device_batch)
        self.iteration += 1
        self.consumed_samples += gbs
        return metrics

    def evaluate(self, data_iter: Iterator, eval_iters: int
                 ) -> Dict[str, float]:
        total, count = 0.0, 0
        for _ in range(eval_iters):
            batch = next(data_iter, None)
            if batch is None:
                break
            out = self.eval_step(self.state.params, self.put_batch(batch))
            total += float(out["lm_loss"])
            count += 1
        loss = total / max(count, 1)
        return {"lm_loss": loss, "ppl": float(np.exp(min(loss, 20.0)))}

    def _reset_window(self) -> None:
        self._win_tokens = 0
        self._win_loss: Any = 0.0
        self._win_n = 0
        self._win_t0 = time.time()

    def _log_window(self, metrics: Dict[str, torch.Tensor]) -> None:
        t = self.cfg.training
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in keys]
                           + [torch.as_tensor(self._win_loss).to(
                               metrics[keys[0]].device).float()]).tolist()
        host = dict(zip(keys, vals))                   # the one host sync
        loss = vals[-1] / max(self._win_n, 1)
        dt = time.time() - self._win_t0
        tps = self._win_tokens / max(dt, 1e-9)
        tflops = tps * self._model_flops_per_token / 1e12
        self.log(
            f"iteration {self.iteration}/{t.train_iters} | "
            f"consumed samples: {self.consumed_samples} | "
            f"lm loss: {loss:.6f} | "
            f"lr: {host['lr']:.3e} | "
            f"grad norm: {host['grad_norm']:.3f} | "
            f"skipped: {int(host['skipped'])} | "
            f"tokens/sec: {tps:,.0f} | "
            f"model TFLOP/s: {tflops:.1f}")
        self.history.append({
            "iteration": self.iteration, "consumed": self.consumed_samples,
            "lm_loss": loss, "lr": host["lr"],
            "grad_norm": host["grad_norm"], "skipped": host["skipped"],
            "steps": self._win_n, "window_s": dt, "tokens_per_s": tps,
            "model_tflops_per_s": tflops})
        self._reset_window()

    def train(self, train_iter_factory: Callable[[int, int], Iterator],
              valid_iter_factory: Optional[Callable[[], Iterator]] = None
              ) -> TrainState:
        """train_iter_factory(consumed_samples, global_batch) returns an
        iterator of host batches at that batch size (rampup-aware)."""
        t = self.cfg.training
        self._model_flops_per_token = \
            3.0 * self.cfg.model.flops_per_token_fwd()
        try:
            self._train(t, train_iter_factory, valid_iter_factory)
        finally:
            # the forced flush of every exit path, an exception's too
            if self._saver is not None:
                self._saver.close()
        return self.state

    def _train(self, t, train_iter_factory, valid_iter_factory) -> None:
        self._reset_window()
        data_iter, current_gbs = None, None
        last_saved = None
        while self.iteration < (t.train_iters or 0):
            gbs = self.calc.global_batch(self.consumed_samples)
            if gbs != current_gbs or data_iter is None:
                current_gbs = gbs
                data_iter = train_iter_factory(self.consumed_samples, gbs)
            batch = next(data_iter, None)
            if batch is None:
                # epoch boundary: a fresh iterator at the exact
                # consumed_samples watermark
                data_iter = train_iter_factory(self.consumed_samples, gbs)
                batch = next(data_iter, None)
                if batch is None:
                    self.log("data exhausted, stopping")
                    break
            metrics = self.train_step(batch)
            self._win_tokens += int(batch["tokens"].size)
            self._win_loss = self._win_loss + metrics["loss"]
            self._win_n += 1
            if self.iteration % t.log_interval == 0:
                self._log_window(metrics)
            if (valid_iter_factory and t.eval_interval
                    and self.iteration % t.eval_interval == 0):
                ev = self.evaluate(valid_iter_factory(), t.eval_iters)
                self.log(f"validation | lm loss: {ev['lm_loss']:.6f} | "
                         f"ppl: {ev['ppl']:.3f}")
                self.evals.append(dict(ev, iteration=self.iteration))
                self._win_t0 = time.time()
            if (t.save and t.save_interval
                    and self.iteration % t.save_interval == 0):
                self.save()
                last_saved = self.iteration
                self._win_t0 = time.time()
        if t.save and last_saved != self.iteration:
            self.save()


def pretrain(run_cfg: RunConfig, train_iter_factory,
             valid_iter_factory=None, log: Callable[[str], None] = print,
             device="cuda") -> TrainLoop:
    """One-call entry (the reference's megatron/training.py pretrain()).
    Returns the finished TrainLoop (its state, history and evals)."""
    loop = TrainLoop(run_cfg, log=log, device=device)
    log(f"device: {loop.device} | params: {num_params(run_cfg.model):,}")
    loop.train(train_iter_factory, valid_iter_factory)
    return loop
