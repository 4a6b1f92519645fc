"""Training orchestration: the pretrain() / train loop (counterpart of
megatron_tpu/training/pretrain.py, one host).

TrainLoop builds the state on one device per rank ("cuda" unless the
caller asks for the CPU), trains for train_iters with batch-size
rampup, evaluates every eval_interval, logs each log_interval window in
the JAX package's line format, checkpoints through an
AsyncCheckpointSaver that every exit path flushes, and resumes from
--load. Around that, the JAX loop's single-host machinery:

  * the async loop (training/prefetch.py): a background thread lands
    step N+1's batch on the card while step N runs, and each step's
    metrics are read --metrics_lag steps late, so the host never waits
    between steps. One code path: lag 0 and no prefetcher IS the
    synchronous loop (--no_async_loop), so the two are bitwise equal.
    `host_sync_points` counts the blocking device->host reads: one per
    step in steady state.
  * preemption: SIGTERM (a scheduler's notice) drains the pipeline and
    forces a synchronous checkpoint tagged "preemption", bounded by
    --preempt_save_timeout (else exit 75 from a timer thread); SIGINT,
    --exit_interval and --exit_duration_in_mins checkpoint and exit.
  * the step watchdog (--step_timeout_s): no progress dumps a flight
    bundle and exits 70.
  * the divergence sentinel: a streak of non-finite steps (or a loss
    spike) aborts, or with --rollback_on_divergence restores the newest
    valid checkpoint INTO the live state tensors and fast-forwards the
    data past the poison window.
  * the replay check (--replay_check_interval): every N steps the step
    runs again from a copy of its state and batch, and any bitwise
    difference raises SDCError.
  * --skip_iters, --eval_only, --metrics, --log_params_norm,
    --log_memory_to_tensorboard, the timers, the tensorboard/wandb
    writer, torch.profiler windows (--profile, SIGUSR1) written as Chrome
    traces, and the run telemetry (journal, goodput, /metrics sidecar,
    flight recorder).

Ranks (a MeshRuntime from parallel/mesh.py, under python -m
torch.distributed.run): each rank holds its slices of the parameters
(models/params.py) and trains on its data rank's rows of every global
batch (data/samplers.rank_rows) through the parallel step
(training/train_step.py, training/pipeline.py). Logging, the writer,
telemetry (journal, /metrics, flight recorder) and profiling run on
rank 0 only. The decisions a rank may reach alone (a signal, the
--save_interval auto cadence, --exit_interval, --exit_duration_in_mins)
are agreed over every rank each step by one MAX-reduce of the flags
(save, exit, preempt) on a host-side gloo group, so every rank saves,
and stops, after the same iteration; a rollback is driven by the loss
and grad norm, which every rank already shares. The step watchdog stays
per rank: a stalled collective stalls every rank, each rank's watchdog
fires on the same deadline and exits 70, and the launcher tears the
group down. Checkpoints at world size > 1 take the sharded layout
(training/checkpointing.py): every rank saves its blocks and votes,
rank 0 commits, and --load (a resume, at this or any other topology),
a rollback and the preemption save work as at world size 1; world size
1 keeps the one-file-per-field format.

Not ported (ROADMAP.md): multi-host coordination (peer aborts, the
two-phase commit) and elastic-topology journaling.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import signal as signal_module
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import RunConfig
from megatron_tpu_torch.data.samplers import rank_rows
from megatron_tpu_torch.models.params import (
    StatePlacement, init_params, leaf_layout, num_params,
    shard_task_params, task_tree,
)
from megatron_tpu_torch.parallel.mappings import all_reduce
from megatron_tpu_torch.training import checkpointing, prefetch, resilience
from megatron_tpu_torch.training.logging_writer import Writer
from megatron_tpu_torch.training.microbatches import MicroBatchCalculator
from megatron_tpu_torch.training.optimizer import (
    TrainState, init_train_state, leaf_paths,
)
from megatron_tpu_torch.training.signal_handler import (
    DistributedSignalHandler,
)
from megatron_tpu_torch.training.timers import Timers
from megatron_tpu_torch.training.train_step import (
    make_eval_step, make_task_eval_step, make_train_step,
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


def clone_state(state: TrainState) -> TrainState:
    """A bitwise copy of the state on its device (the replay check's
    pre-step copy); params stay leaves that require grad."""
    def copy(t):
        return t.detach().clone() if t is not None else None

    def tree(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return copy(t)

    params = tree(state.params)
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    scaler = (dataclasses.replace(
        state.scaler, **{f.name: copy(getattr(state.scaler, f.name))
                         for f in dataclasses.fields(state.scaler)})
        if state.scaler is not None else None)
    return dataclasses.replace(
        state, params=params, master=tree(state.master),
        mu=tree(state.mu), nu=tree(state.nu), step=copy(state.step),
        scaler=scaler, nonfinite_streak=copy(state.nonfinite_streak))


class TrainLoop:
    """Owns the state, the step functions and the iteration loop on one
    device ("cuda" unless the caller asks for the CPU).

    After train(), `history` holds one record per logged window
    (iteration, consumed, lm_loss, lr, grad_norm, skipped, steps,
    window_s, tokens_per_s, model_tflops_per_s), `evals` one per
    evaluation, `saves` one per committed checkpoint
    (AsyncCheckpointSaver.history), `load_s` the seconds the --load took
    (None without one), `profile_traces` the Chrome traces written,
    `step_records` and `replay_checks` (see __init__), and
    `host_sync_points` the blocking device->host reads the loop made."""

    def __init__(self, run_cfg: RunConfig, log: Callable[[str], None] = print,
                 device="cuda", mesh=None,
                 init_params_fn: Optional[Callable] = None,
                 param_specs_fn: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 fixed_num_microbatches: Optional[int] = None,
                 pipeline_loss_factory: Optional[Callable] = None):
        """The task hooks (the JAX loop's) let the encoder families reuse
        the loop: init_params_fn(model_cfg, seed, device) builds a
        parameter tree of their own (T5's stacks, a task head), whole;
        param_specs_fn(model_cfg) gives its flat {path: PartitionSpec},
        which must name the same leaves and, above one rank, cuts the
        tree into this rank's slices (models/params.shard_task_params)
        and places its optimizer state and checkpoint blocks;
        loss_fn(model_cfg, params, batch, mesh=mesh) -> (loss, aux)
        swaps the objective (the mesh gives it tensor and sequence
        parallelism and the batch group; evaluation runs it under
        no_grad: the port has no dropout to turn off), and
        fixed_num_microbatches pins the microbatch count whatever the
        batch (ICT's in-batch softmax needs the whole global batch as
        negatives; at dp > 1 each rank's microbatch is its part of it).
        pipeline_loss_factory(model_cfg, mesh, num_microbatches,
        recompute) builds the pipe schedule a task loss runs through at
        pp > 1 (T5's, training/t5_pipeline.T5Pipeline); a loss_fn at
        pp > 1 without one is refused, as the JAX loop refuses it.
        Checkpoints save and load whatever tree the state holds."""
        if mesh is not None and mesh.world_size > 1 and (
                init_params_fn is not None or loss_fn is not None):
            if init_params_fn is not None and param_specs_fn is None:
                raise ValueError("a task tree above one rank needs "
                                 "param_specs_fn to cut it")
            if mesh.cp > 1:
                raise ValueError(
                    "context parallelism splits a decoder's sequence; the "
                    "task hooks (the BERT, T5, ICT and finetuning "
                    "families) run at cp 1, as in the JAX package")
            if mesh.pp > 1 and loss_fn is not None and \
                    pipeline_loss_factory is None:
                from megatron_tpu_torch.training.train_step import (
                    TASK_LOSS_PP_REFUSAL,
                )

                raise ValueError(TASK_LOSS_PP_REFUSAL)
        run_cfg.validate()
        self.cfg = run_cfg
        self.mesh = mesh
        self._multi = mesh is not None and mesh.world_size > 1
        self.loss_fn = loss_fn
        self.pipeline_loss_factory = pipeline_loss_factory
        self.fixed_num_microbatches = fixed_num_microbatches
        self.is_rank0 = mesh is None or mesh.rank == 0
        self.log = log if self.is_rank0 else (lambda msg: None)
        self.device = torch.device(device)
        t = run_cfg.training
        level = t.timing_log_level
        if t.log_timers_to_tensorboard:
            level = max(level, 1)  # sub-spans become real timers
        self.timers = Timers(level)
        self._profiler = None
        self._profile_signal_pending = False
        self._profile_until: Optional[int] = None
        self._profile_range: Tuple[int, int] = (0, 0)
        self.profile_traces: List[str] = []

        model_cfg = run_cfg.model
        if model_cfg.attention_impl == "pallas":
            # the gradient path is never a mystery in the log
            self.log("attention: flash kernels, "
                     + ("fused fwd+bwd (autograd Function)"
                        if model_cfg.flash_bwd
                        else "fwd only — dense O(S^2) attention gradient "
                        "(--no_flash_bwd)"))
        if init_params_fn is not None:
            params = init_params_fn(model_cfg, t.seed, self.device)
        else:
            params = init_params(model_cfg, t.seed, device=self.device,
                                 mesh=mesh)
        # the task tree's shapes and specs (None: the decoder table)
        self.tree = None
        if param_specs_fn is not None:
            specs = param_specs_fn(model_cfg)
            leaves = {k for k, _ in leaf_paths(params)}
            if set(specs) != leaves:
                raise ValueError(
                    "param_specs_fn and the parameter tree disagree: "
                    f"no spec for {sorted(leaves - set(specs))}, no leaf "
                    f"for {sorted(set(specs) - leaves)}")
            if init_params_fn is not None:
                self.tree = task_tree(params, specs)
                if self._multi:
                    params = shard_task_params(params, self.tree, mesh)
        for _, p in leaf_paths(params):
            p.requires_grad_(True)
        # {path: (spec, zero1 dim, owner)} of this rank's leaves (None at
        # world size 1)
        self.layout = (leaf_layout(model_cfg, mesh,
                                   run_cfg.optimizer.use_distributed_optimizer,
                                   tree=self.tree)
                       if self._multi else None)
        self.state: TrainState = init_train_state(
            run_cfg.optimizer, params,
            use_fp16_scaler=(model_cfg.params_dtype == "float16"),
            mesh=mesh if self._multi else None, layout=self.layout)
        # where each rank's state lies in the global tensors: the sharded
        # checkpoint layout's input (None at world size 1)
        self.placement = (StatePlacement.of(
            model_cfg, mesh, run_cfg.optimizer.use_distributed_optimizer,
            tree=self.tree)
            if self._multi else None)
        self.dp = mesh.dp if mesh is not None else 1
        self._cp = mesh.cp if mesh is not None else 1
        self.calc = MicroBatchCalculator.from_config(t, self.dp)
        self.iteration = 0
        self.consumed_samples = 0
        self._step_cache: Dict[int, Callable] = {}
        self.eval_step = (make_eval_step(model_cfg, t, mesh)
                          if loss_fn is None
                          else make_task_eval_step(
                              model_cfg, loss_fn, mesh,
                              pipeline_loss_factory, t.micro_batch_size))
        self.history: List[Dict[str, float]] = []
        self.evals: List[Dict[str, float]] = []
        self._save_config = run_cfg.to_dict()
        self._saver: Optional[checkpointing.AsyncCheckpointSaver] = None
        self.saves: List[Dict[str, Any]] = []
        self.load_s: Optional[float] = None
        self.load_read_bytes: Optional[int] = None
        if t.load:
            self._load()

        # fault tolerance (training/resilience.py)
        self._sentinel = None
        if t.divergence_patience or t.loss_spike_factor:
            self._sentinel = resilience.DivergenceSentinel(
                patience=t.divergence_patience,
                spike_factor=t.loss_spike_factor,
                spike_patience=t.loss_spike_patience)
        self._rollbacks = 0
        self._skip_data_until = 0  # fast-forward bound after a rollback
        # healthy steps since the last rollback; far enough past the
        # poison window the rollback budget is restored, so widely
        # separated transient divergences don't exhaust max_rollbacks
        self._healthy_steps = 0
        self._rollback_reset_after = 20 * max(
            t.divergence_patience, t.loss_spike_patience, 25)

        # the async loop: the prefetcher (rebuilt at every watermark
        # change) and the count of blocking device->host reads
        self._prefetcher: Optional[prefetch.DevicePrefetcher] = None
        self._pf_credited = (0.0, 0.0)
        self.host_sync_points = 0

        # which signal ended the run, the step watchdog, and the
        # per-iteration batch fingerprints _process_record consumes
        self._exit_signal: Optional[str] = None
        self._watchdog: Optional[resilience.StepWatchdog] = None
        self._batch_fps: Dict[int, str] = {}
        # what the run's caller reads after train(): one record per
        # processed step (iteration, loss, step_s, data_wait_s, warmup,
        # and the prefetcher's record of the pop, DevicePrefetcher.last_pop:
        # kept here, not in the journal, whose step event carries the JAX
        # package's keys)
        # and the iterations a replay check passed
        self.step_records: List[Dict[str, Any]] = []
        self.replay_checks: List[int] = []

        # --save_interval auto, seeded from earlier incarnations' journal
        self._cadence: Optional[resilience.CheckpointCadenceTuner] = None
        self._cadence_commit_seen: Optional[float] = None
        self._last_save_iter = self.iteration
        if t.save_interval_auto:
            self._cadence = resilience.CheckpointCadenceTuner(
                grace_s=t.preempt_save_timeout,
                floor_steps=t.save_interval_floor)
            if t.telemetry_dir:
                from megatron_tpu_torch.telemetry.journal import read_events

                path = os.path.join(t.telemetry_dir, "events.jsonl")
                if os.path.exists(path):
                    n = self._cadence.seed_from_journal(read_events(path)[0])
                    if n:
                        self.log(f"save cadence: seeded from {n} journaled "
                                 "commit-latency samples")

        self.writer = Writer(
            tensorboard_dir=t.tensorboard_dir if self.is_rank0 else None,
            wandb=t.wandb_logger and self.is_rank0,
            wandb_project=t.wandb_project, wandb_name=t.wandb_name,
            config=run_cfg.to_dict())

        from megatron_tpu_torch.telemetry.run import for_training

        self.telemetry = (for_training(t, log=self.log) if self.is_rank0
                          else None)
        if self.telemetry is not None:
            self.telemetry.emit(
                "run_start", iteration=self.iteration,
                consumed_samples=self.consumed_samples,
                device=str(self.device),
                model_flops_per_token_fwd=model_cfg.flops_per_token_fwd(),
                async_loop=t.async_loop, prefetch_depth=t.prefetch_depth,
                metrics_lag=t.metrics_lag,
                compilation_cache_dir=t.compilation_cache_dir)

    # -- checkpoint ---------------------------------------------------------

    def _load(self) -> None:
        t = self.cfg.training
        t0 = time.perf_counter()
        stats: Dict[str, Any] = {}
        try:
            self.state, it, consumed = checkpointing.load_checkpoint(
                t.load, self.state, finetune=t.finetune,
                no_load_optim=t.no_load_optim, config=self._save_config,
                placement=self.placement, stats=stats)
        except FileNotFoundError:
            self.log(f"no checkpoint found in {t.load}, starting fresh")
            return
        self._sync()
        self.load_s = time.perf_counter() - t0
        self.load_read_bytes = stats.get("read_bytes")
        self.iteration, self.consumed_samples = it, consumed
        self.log(f"loaded checkpoint at iteration {it} "
                 f"(consumed {consumed} samples)")

    def save(self, tags: Tuple[str, ...] = ()) -> None:
        """Checkpoint the state at this iteration. Returns once it is on
        the host; the write and commit overlap the next steps unless
        --no_async_save. The save-checkpoint span is the loop's stall."""
        t = self.cfg.training
        if not t.save:
            return
        self.timers("save-checkpoint", 0).start()
        if self._saver is None:
            self._saver = checkpointing.AsyncCheckpointSaver(
                t.save, keep_latest_k=t.keep_latest_k, log=self.log,
                async_save=t.async_save,
                journal=(self.telemetry.journal_sink()
                         if self.telemetry else None),
                placement=self.placement)
            self.saves = self._saver.history
        self._saver.save(self.state, self.iteration, self.consumed_samples,
                         config=self._save_config, tags=tags)
        self._last_save_iter = self.iteration
        self.timers("save-checkpoint", 0).stop()
        if self.telemetry is not None:
            self.telemetry.stall(
                "checkpoint_stall", self.timers.last_s("save-checkpoint"),
                iteration=self.iteration)

    def _flush_saves(self) -> None:
        """Barrier on any in-flight checkpoint write."""
        if self._saver is not None:
            self._saver.wait()

    def _cadence_due(self) -> bool:
        """--save_interval auto: is a checkpoint due this iteration?
        Feeds the tuner any newly observed commit latency and journals
        `cadence_retune` when the derived interval moves."""
        if not self.cfg.training.save:
            return False
        if (self._saver is not None
                and self._saver.last_commit_seconds is not None
                and self._saver.last_commit_seconds
                != self._cadence_commit_seen):
            self._cadence_commit_seen = self._saver.last_commit_seconds
            self._cadence.note_commit(self._cadence_commit_seen)
        retune = self._cadence.retune()
        if retune is not None:
            self.log(
                f"save cadence: interval {retune['from_interval']} -> "
                f"{retune['to_interval']} steps (grace "
                f"{retune['grace_s']:g}s - p95 commit "
                f"{retune['p95_commit_ms']:g}ms over p50 step "
                f"{retune['p50_step_ms']:g}ms, floor {retune['floor']})")
            if self.telemetry is not None:
                self.telemetry.emit("cadence_retune", iteration=self.iteration,
                                    **retune)
        interval = self._cadence.interval()
        if not interval:
            return False
        return (self.iteration - self._last_save_iter) >= interval

    # -- preemption / hang / SDC sentinels -----------------------------------

    def _flush_journal(self) -> None:
        if self.telemetry is not None and self.telemetry.journal is not None:
            try:
                self.telemetry.journal.flush()
            except OSError:
                pass

    def _preempt_save(self, sig, already_saved: bool = False) -> None:
        """The preemption path: the caller drained the metrics pipeline;
        here a SYNCHRONOUS committed checkpoint tagged "preemption"
        (bypassing --save_interval, never pruned) is forced, bounded by
        --preempt_save_timeout counted from the notice's arrival, and a
        `preemption` event records the notice->commit latency. A save
        that misses the deadline exits PREEMPT_TIMEOUT_EXIT_CODE from a
        timer thread with the journal flushed: overstaying a notice means
        the scheduler's SIGKILL lands mid-write anyway. already_saved:
        the periodic save of this pass already wrote this iteration, so
        only its commit is flushed."""
        t = self.cfg.training
        self._stop_watchdog()  # the preempt deadline takes over
        first = sig.first_signal()
        notice_t = first[1] if first else time.monotonic()
        if self._profiler is not None:
            flush_budget = 10.0
            if t.preempt_save_timeout:
                remaining = (t.preempt_save_timeout
                             - (time.monotonic() - notice_t))
                flush_budget = min(10.0, max(remaining * 0.2, 1.0))
            self._profile_abort("preemption", flush_timeout_s=flush_budget)
        budget = (max(t.preempt_save_timeout
                      - (time.monotonic() - notice_t), 1.0)
                  if t.preempt_save_timeout else 0.0)
        timer = None
        committed = threading.Event()
        if t.preempt_save_timeout:
            def _overdue():
                # timer.cancel() cannot stop a callback already running:
                # a save that commits right AT the deadline is not a
                # timeout, so the flag is checked here and before dying
                if committed.is_set():
                    return
                sys.stderr.write(
                    f"preemption checkpoint exceeded --preempt_save_timeout"
                    f"={t.preempt_save_timeout}s; forcing exit "
                    f"{resilience.PREEMPT_TIMEOUT_EXIT_CODE}\n")
                sys.stderr.flush()

                def _journal_timeout():
                    if self.telemetry is None:
                        return
                    self.telemetry.emit(
                        "preemption_timeout", iteration=self.iteration,
                        timeout_s=t.preempt_save_timeout)
                    self._flush_journal()

                # the journal may share the wedged filesystem: bounded
                jt = threading.Thread(target=_journal_timeout, daemon=True)
                jt.start()
                jt.join(timeout=5.0)
                if committed.is_set():
                    return
                os._exit(resilience.PREEMPT_TIMEOUT_EXIT_CODE)

            timer = threading.Timer(budget, _overdue)
            timer.daemon = True
            timer.start()
        try:
            t0 = time.monotonic()
            if not already_saved:
                self.save(tags=("preemption",))
            self._flush_saves()  # commit NOW: the exit must find it durable
            t1 = time.monotonic()
        finally:
            committed.set()
            if timer is not None:
                timer.cancel()
        save_ms = (t1 - t0) * 1e3
        notice_ms = (t1 - notice_t) * 1e3
        self.log(f"preemption checkpoint committed at iteration "
                 f"{self.iteration} (save {save_ms:.0f} ms, "
                 f"notice->commit {notice_ms:.0f} ms"
                 + ("" if t.save else "; no --save dir: nothing written")
                 + ")")
        if self.telemetry is not None:
            extra = {"pre_saved": True} if already_saved else {}
            self.telemetry.emit(
                "preemption", iteration=self.iteration,
                signal="SIGTERM", consumed_samples=self.consumed_samples,
                save_latency_ms=round(save_ms, 1),
                notice_to_commit_ms=round(notice_ms, 1),
                save_timeout_s=t.preempt_save_timeout,
                saved=bool(t.save), **extra)

    def _heartbeat(self, note: str) -> None:
        """Progress beat shared by the flight recorder and the step
        watchdog: once per processed record and after save/eval stalls."""
        if self.telemetry is not None:
            self.telemetry.heartbeat(note)
        if self._watchdog is not None:
            self._watchdog.beat()

    def _stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    def _on_hang(self, age: float) -> None:
        """StepWatchdog verdict (on the watchdog thread): no progress past
        --step_timeout_s. Dump a flight bundle (with the armed recorder
        when there is one), journal `hang_detected` and exit
        HANG_EXIT_CODE. A hung CUDA kernel cannot be interrupted; the
        process exit is what ends it."""
        t = self.cfg.training
        stuck_at = self.iteration + 1  # the step in flight
        self.log(f"step watchdog: no progress for {age:.1f}s "
                 f"(step_timeout_s={t.step_timeout_s}) at iteration "
                 f"~{stuck_at} — dumping flight bundle and aborting")
        self._profile_abort("hang")
        bundle = None
        try:
            flight = self.telemetry.flight if self.telemetry else None
            if flight is not None:
                # park the recorder's own thread: one hang, one bundle
                flight.stop()
            if flight is None:
                from megatron_tpu_torch.telemetry.flight_recorder import (
                    FlightRecorder,
                )

                base = t.telemetry_dir or t.save
                out = (os.path.join(base, "flight_bundles") if base
                       else "flight_bundles")
                flight = FlightRecorder(
                    out_dir=out, deadline_s=t.step_timeout_s,
                    journal=(self.telemetry.journal if self.telemetry
                             else None), log=self.log)
            bundle = flight.dump(
                reason=f"step watchdog: no heartbeat for {age:.1f}s "
                       f"(step_timeout_s={t.step_timeout_s})")
            self.log(f"step watchdog: bundle written to {bundle}")
        except Exception as e:  # noqa: BLE001 - the abort must proceed
            # even when the bundle can't be written (a full disk)
            self.log(f"step watchdog: bundle dump failed: {e}")
        if self.telemetry is not None:
            self.telemetry.emit(
                "hang_detected", iteration=stuck_at,
                heartbeat_age_s=round(age, 1),
                step_timeout_s=t.step_timeout_s, bundle=bundle)
            self._flush_journal()
        os._exit(resilience.HANG_EXIT_CODE)

    def _note_fingerprint(self, batch: Dict[str, np.ndarray],
                          iteration: int) -> Dict[str, np.ndarray]:
        """Record the host batch's crc32 for `iteration` (on the
        prefetcher's thread in the async loop; one key per iteration)."""
        if self.cfg.training.log_data_fingerprint:
            self._batch_fps[iteration] = resilience.batch_fingerprint(batch)
        return batch

    def _replay_check(self, pre_state: TrainState,
                      device_batch: Dict[str, torch.Tensor],
                      metrics: Dict[str, torch.Tensor]) -> None:
        """SDC sentinel (--replay_check_interval): run the step again on
        the retained pre-step state and batch, and compare the committed
        state and metrics with the replay's BITWISE, on the device (only
        the per-leaf verdicts reach the host). A step is deterministic for
        fixed inputs, so any difference means the first run was corrupted:
        journal `sdc_detected` and raise SDCError. The corrupt_step fault
        flips one params bit after the committed step to test this."""
        it = self.iteration
        t0 = time.perf_counter()
        if resilience.fault_active("corrupt_step", it):
            resilience.corrupt_params(self.state.params, it)
        gbs = next(iter(device_batch.values())).shape[0]
        n_micro = gbs // self.cfg.training.micro_batch_size
        step = self._train_step_for(max(n_micro, 1))
        replay_state, replay_metrics = step(pre_state, device_batch)
        bad = resilience.mismatch_paths(resilience.bitwise_equal_tree(
            {"state": self.state, "metrics": metrics},
            {"state": replay_state, "metrics": replay_metrics}))
        seconds = time.perf_counter() - t0
        if self.telemetry is not None:
            self.telemetry.goodput.attribute("other", seconds)
            self.telemetry.emit(
                "replay_check", iteration=it, ok=not bad,
                seconds=round(seconds, 4))
        if bad:
            if self.telemetry is not None:
                self.telemetry.emit("sdc_detected", iteration=it,
                                    leaves=bad)
                self._flush_journal()
            raise resilience.SDCError(
                f"silent data corruption at iteration {it}: replaying the "
                f"step on the retained batch diverged bitwise at "
                f"{len(bad)} leaf path(s), first: {bad}")
        self.replay_checks.append(it)
        self.log(f"replay check: iteration {it} bitwise-identical "
                 f"({seconds * 1e3:.0f} ms)")

    def _handle_divergence(self, reason: str,
                           trip_iter: Optional[int] = None) -> bool:
        """Sentinel tripped: restore the newest valid checkpoint INTO the
        live state tensors (with --rollback_on_divergence, while rollbacks
        remain) or raise DivergenceError. trip_iter is the iteration whose
        metrics tripped; with lagged metrics the <= K newer steps in
        flight are discarded by the restore, and the fast-forward bound
        stays at trip_iter so the post-rollback trajectory equals the
        synchronous loop's. Returns True after a rollback."""
        t = self.cfg.training
        trip_iter = self.iteration if trip_iter is None else trip_iter
        diag = (f"divergence sentinel tripped at iteration "
                f"{trip_iter}: {reason}")
        if self.telemetry is not None:
            self.telemetry.emit(
                "divergence", iteration=trip_iter, reason=reason,
                action=("rollback" if t.rollback_on_divergence
                        and self._rollbacks < t.max_rollbacks else "abort"))
        if not t.rollback_on_divergence:
            self.log(diag + " — aborting (use --rollback_on_divergence "
                     "to auto-recover from the last good checkpoint)")
            raise resilience.DivergenceError(diag)
        if self._rollbacks >= t.max_rollbacks:
            raise resilience.DivergenceError(
                f"{diag} — giving up after {self._rollbacks} rollbacks "
                f"(max_rollbacks={t.max_rollbacks}); the model re-diverges "
                "after every restore")
        # our own saves first; a resumed run that diverges before its
        # first save still has the checkpoint it was launched from
        sources = [s for s in dict.fromkeys((t.save, t.load)) if s]
        if not sources:
            raise resilience.DivergenceError(
                diag + " — no --save/--load directory to roll back to")
        self._flush_saves()  # never roll back onto a half-written save
        t_rollback = time.perf_counter()
        loaded = None
        errors = []
        for src in sources:
            try:
                loaded = checkpointing.load_checkpoint(
                    src, self.state, config=self._save_config,
                    placement=self.placement)
                break
            except FileNotFoundError as e:
                errors.append(str(e))
        if loaded is None:
            raise resilience.DivergenceError(
                f"{diag} — no valid checkpoint to roll back to "
                f"({'; '.join(errors)})")
        self.state, it, consumed = loaded
        self.iteration = it
        self.consumed_samples = consumed
        self._rollbacks += 1
        self._skip_data_until = trip_iter
        self._sentinel.reset()
        if self.telemetry is not None:
            self.telemetry.stall(
                "rollback_replay", time.perf_counter() - t_rollback,
                event="restore", from_iteration=trip_iter, to_iteration=it,
                rollback=self._rollbacks)
        self.log(f"{diag} — rolled back to checkpoint at iteration {it} "
                 f"(rollback {self._rollbacks}/{t.max_rollbacks}); "
                 f"fast-forwarding data through iteration {trip_iter} to "
                 "skip the poison window")
        return True

    # -- steps --------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_step_for(self, num_microbatches: int) -> Callable:
        step = self._step_cache.get(num_microbatches)
        if step is None:
            t = self.cfg.training
            step = make_train_step(self.cfg.model, self.cfg.optimizer, t,
                                   num_microbatches,
                                   train_iters=t.train_iters,
                                   loss_fn=self.loss_fn, mesh=self.mesh,
                                   tree=self.tree,
                                   pipeline_factory=self.pipeline_loss_factory)
            self._step_cache[num_microbatches] = step
        return step

    def put_batch(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return prefetch.to_device(batch, self.device)

    def _transfer(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """Host->device placement with honest spans: `batch-transfer-
        dispatch` is the host cost of issuing the copies, `batch-transfer`
        also waits for them to land. Under the async loop the prefetcher
        copies on its thread and the loop credits the same two spans from
        its measurements (_credit_prefetch_spans)."""
        tm_all = self.timers("batch-transfer", 1)
        tm_disp = self.timers("batch-transfer-dispatch", 1)
        tm_all.start()
        tm_disp.start()
        device_batch = self.put_batch(batch)
        tm_disp.stop()
        if self.timers.log_level >= 1 and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        tm_all.stop()
        return device_batch

    def train_step(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a host batch. Returns DEVICE metrics."""
        return self.train_step_placed(self._transfer(batch))

    def train_step_placed(self, device_batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch already on the device (this data
        rank's rows). Returns DEVICE metrics: no host sync; the caller
        decides when to pay it (_fetch_metrics)."""
        rows = next(iter(device_batch.values())).shape[0]
        # the step marker of a profiled window (telemetry/tracing reads
        # per-step wall and per-step comm.* counts between its ends)
        with torch.profiler.record_function("train_step"):
            self.state, metrics = self._train_step_for(
                self._num_micro(rows))(self.state, device_batch)
        self.iteration += 1
        self.consumed_samples += rows * self.dp
        return metrics

    def _num_micro(self, rows: int) -> int:
        """The microbatch count of a step on `rows` of this rank's rows."""
        if self.fixed_num_microbatches is not None:
            return self.fixed_num_microbatches
        return max(rows // self.cfg.training.micro_batch_size, 1)

    def _rank_rows(self, batches: Iterator) -> Iterator:
        """This batch rank's rows of each global batch, microbatch by
        microbatch (data/samplers.rank_rows)."""
        if self.dp == 1 and (self.mesh is None or self.mesh.cp == 1):
            return batches
        return rank_rows(batches, self.mesh,
                         self.cfg.training.micro_batch_size)

    def _agree(self, *flags: bool) -> Tuple[bool, ...]:
        """Every rank's flags, MAX-reduced in one collective on the
        host-side group (no device sync): a flag any rank raised holds
        on all ranks, so they save and stop after the same iteration."""
        if not self._multi:
            return tuple(bool(f) for f in flags)
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32)
        return tuple(bool(v) for v in
                     all_reduce(t, self.mesh.control_group, "max"))

    def _fetch_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, float]:
        """ONE blocking device->host read of every step metric at once:
        the single host sync a steady-state step makes."""
        self.host_sync_points += 1
        if self.telemetry is not None:
            self.telemetry.host_syncs.inc()
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in keys]).tolist()
        return dict(zip(keys, vals))

    def _params_norm(self) -> float:
        """Global params L2 (the reference's calc_params_l2_norm); across
        ranks each element counted once (models/params.leaf_layout)."""
        with torch.no_grad():
            leaves = leaf_paths(self.state.params)
            if self._multi:
                owned = leaf_layout(self.cfg.model, self.mesh, False,
                                    tree=self.tree)
                leaves = [(k, p) for k, p in leaves if owned[k][2]]
            sq = torch.stack([p.detach().float().square().sum()
                              for _, p in leaves]).sum()
            if self._multi:
                import torch.distributed as dist

                sq = all_reduce(sq, dist.group.WORLD)
            return float(sq.sqrt())

    def _memory_stats(self) -> Dict[str, float]:
        """Device memory in MB (the JAX package's keys) from
        torch.cuda.memory_stats; empty on the CPU."""
        if self.device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self.device)
        total = torch.cuda.get_device_properties(self.device).total_memory
        return {"mb_in_use": stats.get("allocated_bytes.all.current", 0) / 1e6,
                "peak_mb_in_use": stats.get("allocated_bytes.all.peak", 0)
                / 1e6,
                "mb_limit": total / 1e6}

    # -- async-loop plumbing -------------------------------------------------

    def _make_data_iter(self, factory, gbs: int, depth: int):
        """Iterator of batches at the current consumed_samples watermark:
        the raw host iterator (sync path), or a DevicePrefetcher whose
        transform fingerprints and fault-poisons each host batch with the
        iteration it will be consumed at, so faults hit the same batches
        in both modes."""
        it = self._rank_rows(factory(self.consumed_samples, gbs))
        if depth <= 0:
            return it
        self._prefetcher = prefetch.DevicePrefetcher(
            it, self.device, depth=depth,
            first_iteration=self.iteration + 1,
            # fingerprint BEFORE fault poisoning
            transform=(lambda b, i:
                       resilience.host_batch_faults(
                           self._note_fingerprint(b, i), i, self.log)))
        self._pf_credited = (0.0, 0.0)
        return self._prefetcher

    def _close_prefetcher(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def _credit_prefetch_spans(self) -> None:
        """The prefetch worker's copy time in the loop's timers, as
        credited deltas once per pop."""
        pf = self._prefetcher
        if pf is None:
            return
        put_now, land_now = pf.put_s, pf.land_s
        put, land = self._pf_credited
        d_put, d_land = put_now - put, land_now - land
        if d_put or d_land:
            self._pf_credited = (put_now, land_now)
            self.timers.record("batch-transfer-dispatch", d_put, level=1)
            self.timers.record("batch-transfer", d_put + d_land, level=1)

    def evaluate(self, data_iter: Iterator, eval_iters: int
                 ) -> Dict[str, float]:
        """Forward-only evaluation: lm_loss, ppl and the --metrics, each
        averaged over the batches (one host read per batch)."""
        total, count = 0.0, 0
        extras: Dict[str, float] = {}
        data_iter = self._rank_rows(iter(data_iter))
        for _ in range(eval_iters):
            batch = next(data_iter, None)
            if batch is None:
                break
            out = self.eval_step(self.state.params, self.put_batch(batch))
            keys = [k for k in sorted(out) if k != "ntokens"]
            host = dict(zip(keys, torch.stack(
                [out[k].float().reshape(()) for k in keys]).tolist()))
            total += host.pop("lm_loss")
            for k, v in host.items():
                extras[k] = extras.get(k, 0.0) + v
            count += 1
        loss = total / max(count, 1)
        out = {"lm_loss": loss, "ppl": float(np.exp(min(loss, 20.0)))}
        for m in extras:
            out[m] = extras[m] / max(count, 1)
        return out

    # -- profiling ----------------------------------------------------------

    def _profile_window(self) -> None:
        """torch.profiler windows (CPU and, on the card, CUDA activity)
        written as a Chrome trace. The static --profile window
        [profile_step_start, profile_step_end) and a SIGUSR1 received
        mid-run (a --profile_signal_steps window at the next pass) share
        one window. Called before each iteration; range checks so a
        resume landing mid-window still traces the rest of it."""
        t = self.cfg.training
        nxt = self.iteration + 1
        if not self.is_rank0:
            return
        if self._profiler is not None:
            if self._profile_until is not None and nxt >= self._profile_until:
                self._profile_stop()
            return
        if self._profile_signal_pending:
            self._profile_signal_pending = False
            self._profile_start(nxt, nxt + max(t.profile_signal_steps, 1),
                                source="SIGUSR1")
        elif (t.profile
                and t.profile_step_start <= nxt < t.profile_step_end):
            self._profile_start(nxt, t.profile_step_end, source="--profile")

    def _profile_out_dir(self) -> str:
        t = self.cfg.training
        return (t.profile_dir or t.tensorboard_dir
                or (os.path.join(t.telemetry_dir, "traces")
                    if t.telemetry_dir else "runs/profile"))

    def _profile_start(self, start: int, until: int, source: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        out = self._profile_out_dir()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(out, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except (RuntimeError, OSError) as e:
            # a profiler session another tool owns must not kill the run
            self.log(f"profiler: could not start trace ({e})")
            return
        self._profiler = prof
        self._profile_until = until
        self._profile_range = (start, until)
        self.log(f"profiler: tracing steps [{start}, {until}) to {out}")
        if self.telemetry is not None:
            self.telemetry.emit("profile_begin", iteration=start,
                                until=until, dir=out, source=source)

    def _profile_flush(self) -> str:
        """Stop the live profiler and write its Chrome trace; returns the
        path."""
        prof, self._profiler = self._profiler, None
        self._profile_until = None
        self._sync()   # the window's device work belongs in the trace
        prof.stop()
        start, until = self._profile_range
        path = os.path.join(self._profile_out_dir(),
                            f"trace-steps-{start}-{until}-pid{os.getpid()}"
                            ".json")
        prof.export_chrome_trace(path)
        self.profile_traces.append(path)
        return path

    def _profile_stop(self) -> None:
        if self._profiler is None:
            return
        try:
            path = self._profile_flush()
        except (RuntimeError, OSError) as e:
            self.log(f"profiler: stop failed ({e})")
            return
        self.log(f"profiler: trace written to {path}")
        if self.telemetry is not None:
            self.telemetry.emit("profile_end", iteration=self.iteration,
                                dir=self._profile_out_dir(), path=path)

    def _profile_abort(self, reason: str, flush: bool = True,
                       flush_timeout_s: float = 10.0) -> None:
        """Close a live trace window on an abort path, flushing on a
        bounded helper thread (the conditions that bring us here, a hung
        step or a wedged filesystem, are the ones where a flush could
        block), and journal `profile_aborted` either way."""
        if self._profiler is None:
            return
        flushed = False
        if flush:
            done = threading.Event()

            def _flush():
                try:
                    self._profile_flush()
                    done.set()
                except Exception as e:  # noqa: BLE001 - the abort
                    # proceeds regardless; the journal says the trace is
                    # unusable
                    self.log(f"profiler: abort flush failed: {e}")

            ft = threading.Thread(target=_flush, daemon=True)
            ft.start()
            ft.join(timeout=flush_timeout_s)
            flushed = done.is_set()
            if flushed:
                self.log(f"profiler: trace flushed on abort ({reason})")
            elif ft.is_alive():
                self.log("profiler: abort flush did not finish in "
                         f"{flush_timeout_s:.0f}s; trace may be torn")
        self._profiler = None
        if self.telemetry is not None:
            self.telemetry.emit("profile_aborted", reason=reason,
                                flushed=flushed, iteration=self.iteration)

    # -- loop ---------------------------------------------------------------

    def train(self, train_iter_factory: Callable[[int, int], Iterator],
              valid_iter_factory: Optional[Callable[[], Iterator]] = None
              ) -> TrainState:
        """train_iter_factory(consumed_samples, global_batch) returns an
        iterator of host batches at that batch size (rampup-aware)."""
        try:
            self._train_inner(train_iter_factory, valid_iter_factory)
        finally:
            # the forced flush of every exit path (return, SIGTERM,
            # exception): a committed tracker is what a resume finds
            if self._saver is not None:
                self._saver.close()
            if self.telemetry is not None:
                self.telemetry.close(
                    **({"received_signal": self._exit_signal}
                       if self._exit_signal else {}))
        return self.state

    def _reset_log_window(self) -> None:
        self._win_tokens = 0
        self._win_t0 = time.time()
        self._win_loss = 0.0
        self._win_n = 0

    def _process_record(self, rec: Dict[str, Any]) -> bool:
        """Consume one pipeline record (a step's device metrics, or a
        skipped iteration) in dispatch order: host read, journal and
        metrics, sentinel, log-window bookkeeping. With --metrics_lag K
        this runs K records behind dispatch, so its one blocking read
        overlaps the K newer steps already queued. Returns True when the
        sentinel tripped AND _handle_divergence rolled back."""
        it = rec["iteration"]
        if "skip_reason" in rec:
            self._batch_fps.pop(it, None)
            fast_forward = rec["skip_reason"] == "rollback_fast_forward"
            self.log(f"iteration {it}: update skipped "
                     + ("(post-rollback fast-forward)" if fast_forward
                        else "(--skip_iters)"))
            if self.telemetry is not None:
                self.telemetry.emit("step_skipped", iteration=it,
                                    reason=rec["skip_reason"])
            self._heartbeat(f"iteration {it} (skipped)")
            self._maybe_log_window(rec)
            return False

        host = rec["host"]
        if host is None:
            # lagged read: this wait is the device catching up, in steady
            # state the device's step time
            fm = self.timers("metrics-fetch", 0)
            fm.start()
            host = self._fetch_metrics(rec["metrics"])
            fm.stop()
            step_s = rec["dispatch_s"] + self.timers.last_s("metrics-fetch")
        else:
            step_s = rec["dispatch_s"]
        if self._cadence is not None:
            self._cadence.note_step(step_s)
        loss_host = float(host["loss"])
        self._last_host_metrics = host
        ntok = rec["ntok"]
        data_crc = self._batch_fps.pop(it, None)
        if self.telemetry is not None:
            compile_delta = {}
            if rec["warmup"]:
                # a step function's first call: its whole time is warm-up
                # (telemetry/goodput.py)
                self.telemetry.recompiles.note_warmup(step_s)
                compile_delta = {"compile_seconds": step_s}
            extra = {"data_crc": data_crc} if data_crc else {}
            self.telemetry.step(
                it, step_s, ntok, compile_delta,
                loss=loss_host,
                lr=float(host["lr"]),
                grad_norm=float(host["grad_norm"]),
                skipped=bool(float(host.get("skipped", 0.0))),
                data_wait_ms=round(rec["data_wait_s"] * 1e3, 3),
                tokens_per_s=round(ntok / max(step_s, 1e-9), 1),
                model_tflops_per_s=round(
                    ntok / max(step_s, 1e-9)
                    * self._model_flops_per_token / 1e12, 3),
                consumed_samples=rec["consumed"],
                **extra)
        self.step_records.append({
            "iteration": it, "loss": loss_host, "step_s": step_s,
            "data_wait_s": rec["data_wait_s"], "warmup": rec["warmup"],
            "prefetch": rec["prefetch"]})
        self._heartbeat(f"iteration {it}")

        if self._sentinel is not None:
            streak = host.get("skip_streak")
            step_skipped = bool(float(host.get("skipped", 0.0)))
            trip = self._sentinel.observe(
                loss_host, step_skipped,
                streak=(int(float(streak)) if streak is not None
                        else None))
            if trip is None and not step_skipped:
                self._healthy_steps += 1
                if (self._rollbacks
                        and it > self._skip_data_until
                        and self._healthy_steps
                        >= self._rollback_reset_after):
                    self.log(
                        f"sentinel: {self._healthy_steps} healthy"
                        " steps since the last rollback —"
                        " restoring the rollback budget")
                    self._rollbacks = 0
            else:
                self._healthy_steps = 0
            if trip and self._handle_divergence(trip, trip_iter=it):
                return True

        self._win_tokens += ntok
        self._win_loss += loss_host
        self._win_n += 1
        self._maybe_log_window(rec)
        return False

    def _maybe_log_window(self, rec: Dict[str, Any]) -> None:
        """Close the log window when the processed record's iteration hits
        log_interval (records arrive in order, so the cadence is the
        synchronous loop's)."""
        t = self.cfg.training
        it = rec["iteration"]
        if it % t.log_interval != 0:
            return
        if self._win_n == 0:
            self.log(f"iteration {it}/{t.train_iters} | "
                     f"consumed samples: {rec['consumed']} | "
                     "all iterations in window skipped")
            self.timers.elapsed_ms(reset=True)
            self._win_tokens, self._win_t0 = 0, time.time()
            return
        metrics = self._last_host_metrics
        loss = self._win_loss / max(self._win_n, 1)
        dt = time.time() - self._win_t0
        tps = self._win_tokens / max(dt, 1e-9)
        tflops = tps * self._model_flops_per_token / 1e12
        self.log(
            f"iteration {it}/{t.train_iters} | "
            f"consumed samples: {rec['consumed']} | "
            f"lm loss: {loss:.6f} | "
            f"lr: {float(metrics['lr']):.3e} | "
            f"grad norm: {float(metrics['grad_norm']):.3f} | "
            f"skipped: {int(metrics['skipped'])} | "
            + (f"moe aux loss: {float(metrics['moe_aux_loss']):.6f} | "
               if "moe_aux_loss" in metrics else "")
            + f"tokens/sec: {tps:,.0f} | "
            f"model TFLOP/s: {tflops:.1f}")
        record = {
            "iteration": it, "consumed": rec["consumed"], "lm_loss": loss,
            "lr": float(metrics["lr"]),
            "grad_norm": float(metrics["grad_norm"]),
            "skipped": float(metrics["skipped"]), "steps": self._win_n,
            "window_s": dt, "tokens_per_s": tps,
            "model_tflops_per_s": tflops}
        if "moe_aux_loss" in metrics:
            record["moe_aux_loss"] = float(metrics["moe_aux_loss"])
            self.writer.add_scalar("train/moe_aux_loss",
                                   record["moe_aux_loss"], it)
        self.writer.add_scalar("train/lm_loss", loss, it)
        self.writer.add_scalar("train/lr", record["lr"], it)
        self.writer.add_scalar("train/grad_norm", record["grad_norm"], it)
        self.writer.add_scalar("train/tokens_per_sec", tps, it)
        if "num_zeros" in metrics:
            self.writer.add_scalar(
                "train/num_zeros", float(metrics["num_zeros"]), it)
        if t.log_batch_size:
            self.writer.add_scalar("train/global_batch_size", rec["gbs"], it)
        if t.log_world_size:
            self.writer.add_scalar(
                "train/world_size",
                self.mesh.world_size if self.mesh is not None else 1, it)
        if t.log_params_norm:
            record["params_norm"] = self._params_norm()
            self.writer.add_scalar("train/params_norm",
                                   record["params_norm"], it)
        if t.log_memory:
            record["memory"] = self._memory_stats()
            for k, v in record["memory"].items():
                self.writer.add_scalar(f"memory/{k}", v, it)
        if t.log_timers_to_tensorboard:
            for name, ms in self.timers.elapsed_ms(reset=False).items():
                self.writer.add_scalar(
                    f"timers/{name}", ms / max(self._win_n, 1), it)
        ts = self.timers.log_string(normalizer=max(self._win_n, 1))
        if ts:
            self.log(ts)
        if self.telemetry is not None:
            self.telemetry.emit("goodput", iteration=it,
                                **self.telemetry.goodput_report())
        self.writer.flush()
        self.history.append(record)
        self._win_tokens, self._win_t0 = 0, time.time()
        self._win_loss, self._win_n = 0.0, 0

    def _train_inner(self, train_iter_factory, valid_iter_factory) -> None:
        t = self.cfg.training
        if t.eval_only:
            if valid_iter_factory is None:
                self.log("--eval_only with no validation data; nothing to do")
                return
            ev = self.evaluate(valid_iter_factory(), t.eval_iters)
            self.evals.append(dict(ev, iteration=self.iteration))
            self.log(f"validation | lm loss: {ev['lm_loss']:.6f} | "
                     f"ppl: {ev['ppl']:.3f}")
            return
        self._model_flops_per_token = \
            3.0 * self.cfg.model.flops_per_token_fwd()
        start_time = time.time()
        self._reset_log_window()
        self._last_host_metrics = None

        # dispatch-ahead with device-resident metrics: the prefetcher
        # lands step N+1's batch while step N runs; lag K leaves up to K
        # dispatched steps' metrics unread. lag 0 + depth 0 IS the
        # synchronous loop: one code path, bitwise equal by construction
        lag = max(t.metrics_lag, 0) if t.async_loop else 0
        depth = max(t.prefetch_depth, 0) if t.async_loop else 0
        pending: collections.deque = collections.deque()

        last_saved = None
        # a trace window or prefetch worker still open at ANY exit from
        # the loop is closed
        with DistributedSignalHandler() as sig, contextlib.ExitStack() as _s:
            _s.callback(self._profile_stop)
            _s.callback(self._close_prefetcher)
            if threading.current_thread() is threading.main_thread():
                # SIGUSR1 arms a profile window at the next pass
                prev_usr1 = signal_module.signal(
                    signal_module.SIGUSR1,
                    lambda s, f: setattr(self, "_profile_signal_pending",
                                         True))
                _s.callback(signal_module.signal,
                            signal_module.SIGUSR1, prev_usr1)
            if t.step_timeout_s:
                # the deadline clock starts at the FIRST processed step,
                # so the first step's warm-up is exempt
                self._watchdog = resilience.StepWatchdog(
                    t.step_timeout_s, self._on_hang).start()
                _s.callback(self._stop_watchdog)
            data_iter = None
            current_gbs = None

            def drain(n_keep: int) -> bool:
                """Process pending records down to n_keep, oldest first;
                True if one tripped the sentinel into a rollback."""
                while len(pending) > n_keep:
                    if self._process_record(pending.popleft()):
                        return True
                return False

            def on_rollback():
                """Everything in flight (pending records, prefetched
                batches, the log window) belongs to the discarded
                trajectory."""
                nonlocal data_iter, current_gbs
                pending.clear()
                self._batch_fps.clear()
                self._close_prefetcher()
                data_iter = None
                current_gbs = None
                self._reset_log_window()
                self.timers.elapsed_ms(reset=True)

            while True:
                if self.iteration >= (t.train_iters or 0):
                    # a sentinel trip hiding in the tail rolls back and
                    # resumes training instead of silently finishing
                    if drain(0):
                        on_rollback()
                        continue
                    break
                gbs = self.calc.global_batch(self.consumed_samples)
                if gbs != current_gbs or data_iter is None:
                    self._close_prefetcher()
                    current_gbs = gbs
                    data_iter = self._make_data_iter(
                        train_iter_factory, gbs, depth)

                self.timers("batch-generator", 0).start()
                batch = next(data_iter, None)
                if batch is None:
                    # epoch boundary: a fresh iterator at the exact
                    # consumed_samples watermark
                    self._close_prefetcher()
                    data_iter = self._make_data_iter(
                        train_iter_factory, gbs, depth)
                    batch = next(data_iter, None)
                    if batch is None:
                        self.timers("batch-generator", 0).stop()
                        self.log("data exhausted, stopping")
                        if drain(0):
                            on_rollback()
                            continue
                        break
                self.timers("batch-generator", 0).stop()
                # with the prefetcher this is the queue pop's wait
                data_wait_s = self.timers.last_s("batch-generator")
                pop = (dict(self._prefetcher.last_pop)
                       if self._prefetcher is not None else {})
                self._credit_prefetch_spans()

                fast_forward = self.iteration < self._skip_data_until
                skipped_iter = (fast_forward
                                or (self.iteration + 1) in t.skip_iters)
                if self.telemetry is not None:
                    self.telemetry.goodput.attribute(
                        "rollback_replay" if fast_forward else "data_wait",
                        data_wait_s)
                self._profile_window()
                if skipped_iter:
                    # consume the data, skip the update
                    self.iteration += 1
                    self.consumed_samples += gbs
                    pending.append({
                        "iteration": self.iteration, "gbs": gbs,
                        "consumed": self.consumed_samples,
                        "skip_reason": ("rollback_fast_forward"
                                        if fast_forward else "skip_iters")})
                else:
                    resilience.maybe_kill("kill_at", self.iteration + 1)
                    # a preemption NOTICE at an exact step: the handler
                    # records it; the save path below runs after this step
                    resilience.maybe_signal("preempt_at", self.iteration + 1)
                    # a wedged step: only the watchdog ends it
                    resilience.maybe_hang("hang_step", self.iteration + 1)
                    replay_due = bool(
                        t.replay_check_interval
                        and (self.iteration + 1) % t.replay_check_interval
                        == 0)
                    if self._prefetcher is None:
                        # the prefetcher's transform fingerprints and
                        # poisons; the sync path does both here
                        batch = self._note_fingerprint(
                            batch, self.iteration + 1)
                        batch = resilience.host_batch_faults(
                            batch, self.iteration + 1, self.log)
                        if replay_due:
                            # the replay needs the PLACED batch retained
                            batch = self._transfer(batch)
                    warmup = self._num_micro(gbs) not in self._step_cache
                    if self._watchdog is not None and warmup:
                        # a fresh step function's warm-up is not a hang
                        self._watchdog.pause()
                    pre_state = (clone_state(self.state) if replay_due
                                 else None)
                    tm = self.timers("forward-backward-optimizer", 0)
                    tm.start()
                    if self._prefetcher is not None or replay_due:
                        metrics = self.train_step_placed(batch)
                    else:
                        metrics = self.train_step(batch)
                    # lag 0 pays the host read inside the span (the
                    # synchronous loop's behavior); lag K defers it
                    host = self._fetch_metrics(metrics) if lag == 0 else None
                    tm.stop()
                    if replay_due:
                        self._replay_check(pre_state, batch, metrics)
                        del pre_state
                    # a rank's rows are its context piece: dp x cp of
                    # them make the global batch
                    ntok = self.dp * self._cp * int(np.prod(tuple(
                        batch.get("tokens",
                                  next(iter(batch.values()))).shape)))
                    pending.append({
                        "iteration": self.iteration, "gbs": gbs,
                        "consumed": self.consumed_samples, "ntok": ntok,
                        "metrics": metrics, "host": host,
                        "dispatch_s": self.timers.last_s(
                            "forward-backward-optimizer"),
                        "data_wait_s": data_wait_s, "warmup": warmup,
                        "prefetch": pop})
                if self._prefetcher is not None:
                    # the step is dispatched: the worker may start the
                    # next batch while this thread waits on the card
                    self._prefetcher.release()

                if drain(lag):
                    on_rollback()
                    continue

                if (valid_iter_factory and t.eval_interval
                        and self.iteration % t.eval_interval == 0):
                    # eval is a pipeline sync point: drain so the
                    # sentinel's verdicts precede it
                    if drain(0):
                        on_rollback()
                        continue
                    if self._watchdog is not None and not self.evals:
                        self._watchdog.pause()  # the first eval warms up
                    self.timers("eval-time", 0).start()
                    ev = self.evaluate(valid_iter_factory(), t.eval_iters)
                    self.timers("eval-time", 0).stop()
                    self.evals.append(dict(ev, iteration=self.iteration))
                    if self.telemetry is not None:
                        self.telemetry.stall(
                            "eval", self.timers.last_s("eval-time"),
                            iteration=self.iteration,
                            lm_loss=float(ev["lm_loss"]))
                    self._heartbeat(f"iteration {self.iteration} (post-eval)")
                    extra = " | ".join(f"{k}: {v:.4f}" for k, v in ev.items()
                                       if k not in ("lm_loss", "ppl"))
                    self.log(f"validation | lm loss: {ev['lm_loss']:.6f} | "
                             f"ppl: {ev['ppl']:.3f}"
                             + (f" | {extra}" if extra else ""))
                    for k, v in ev.items():
                        self.writer.add_scalar(f"valid/{k}", v, self.iteration)
                    self.writer.flush()
                    self._win_t0 = time.time()

                if self._cadence is not None:
                    saved_now = self._cadence_due()
                else:
                    saved_now = bool(
                        t.save and t.save_interval
                        and self.iteration % t.save_interval == 0)
                names = [signal_module.Signals(s).name
                         for s in sig.signals_received()]
                # SIGTERM is a preemption notice: the expedited
                # synchronous save; SIGINT the ordinary one
                preempting = "SIGTERM" in names
                should_exit = bool(names)
                if t.exit_interval and self.iteration % t.exit_interval == 0:
                    should_exit = True
                if t.exit_duration_in_mins and (
                        (time.time() - start_time) / 60
                        > t.exit_duration_in_mins):
                    should_exit = True
                saved_now, should_exit, preempting = self._agree(
                    saved_now, should_exit, preempting)
                if saved_now:
                    # never checkpoint past unjudged metrics: a sentinel
                    # trip still in the pipeline CANCELS the save
                    if drain(0):
                        on_rollback()
                        continue
                    self.save()
                    self._heartbeat(f"iteration {self.iteration} (post-save)")
                    self._win_t0 = time.time()
                if names:
                    self._exit_signal = ",".join(sorted(set(names)))
                if should_exit and (names or preempting):
                    self.log(
                        f"received {self._exit_signal or 'SIGTERM'}, "
                        "checkpointing and exiting"
                        + (" (preemption notice: expedited "
                           "synchronous save)" if preempting else ""))

                if should_exit:
                    # a sentinel trip still in the pipeline CANCELS the
                    # exit save
                    if drain(0):
                        on_rollback()
                        continue
                    if preempting:
                        self._preempt_save(sig, already_saved=saved_now)
                    elif not saved_now:
                        self.save()
                    self._heartbeat(f"iteration {self.iteration} (post-save)")
                    return
                last_saved = self.iteration if saved_now else None

        if t.save and last_saved != self.iteration:
            self.save()


def launch_mesh(run_cfg: RunConfig, mesh=None):
    """The mesh of this launch: `mesh` when given, else with
    torch.distributed initialized (parallel/distributed.py) the one
    run_cfg.parallel lays out over its world (JAX pretrain.py:176-216),
    else None; a parallel topology without a launch of one process per
    rank is refused."""
    import torch.distributed as dist

    if mesh is None and dist.is_available() and dist.is_initialized():
        from megatron_tpu_torch.parallel.mesh import build_mesh

        mesh = build_mesh(run_cfg.parallel)
    p = run_cfg.parallel
    if mesh is None and (p.tensor_parallel * p.pipeline_parallel
                         * p.context_parallel * p.expert_parallel
                         * (p.data_parallel or 1)) > 1:
        raise ValueError(
            "a parallel topology needs one process per rank: launch under "
            "python -m torch.distributed.run --nproc_per_node N")
    return mesh


def _log_mesh(loop: TrainLoop) -> None:
    mesh = loop.mesh
    if mesh is not None:
        loop.log(f"mesh: world {mesh.world_size} = dp {mesh.dp}"
                 + (f" (ep {mesh.ep})" if mesh.ep > 1 else "")
                 + f" x pp {mesh.pp} (vpp {mesh.vpp})"
                 + (f" x cp {mesh.cp}" if mesh.cp > 1 else "")
                 + f" x tp {mesh.tp}"
                 + (" with sequence parallelism" if mesh.sequence_parallel
                    else ""))


def pretrain(run_cfg: RunConfig, train_iter_factory,
             valid_iter_factory=None, log: Callable[[str], None] = print,
             device="cuda", mesh=None) -> TrainLoop:
    """One-call entry (the reference's megatron/training.py pretrain()).
    Returns the finished TrainLoop (its state, history and evals), on
    the launch's mesh (launch_mesh)."""
    loop = TrainLoop(run_cfg, log=log, device=device,
                     mesh=launch_mesh(run_cfg, mesh))
    _log_mesh(loop)
    loop.log(f"device: {loop.device} | params: {num_params(run_cfg.model):,}")
    return run_task_loop(loop, train_iter_factory, valid_iter_factory)


def task_loop(run_cfg: RunConfig, log: Callable[[str], None] = print,
              device="cuda", **hooks) -> TrainLoop:
    """A TrainLoop with the task hooks (TrainLoop.__init__) on the
    launch's mesh (launch_mesh): the encoder families' entry points
    under python -m torch.distributed.run."""
    loop = TrainLoop(run_cfg, log=log, device=device,
                     mesh=launch_mesh(run_cfg), **hooks)
    _log_mesh(loop)
    return loop


def run_distributed(args, body: Callable[[], Any]) -> Any:
    """body() inside the process group of this launch (a plain call
    outside one): the group joined from the launcher's environment on
    args.device over args.distributed_backend, and left as it was found
    (a group the caller made, for several runs in one launch, stays)."""
    import torch.distributed as dist

    from megatron_tpu_torch.parallel.distributed import (
        destroy_distributed, initialize_distributed,
    )

    ours = not (dist.is_available() and dist.is_initialized())
    if initialize_distributed(args.device, args.distributed_backend):
        try:
            return body()
        finally:
            if ours:
                destroy_distributed()
    return body()


def run_task_loop(loop: TrainLoop, train_iter_factory,
                  valid_iter_factory=None) -> TrainLoop:
    """Train a task-hook loop to its end and close its writer."""
    try:
        loop.train(train_iter_factory, valid_iter_factory)
    finally:
        loop.writer.close()
    return loop
