"""Typed configuration (counterpart of megatron_tpu/config.py).

Only the fields the serving and training paths read are ported; the
field names, defaults and derived helpers (head_dim, n_kv_heads,
ffn_size, flops_per_token_fwd, validate) are the JAX package's, so a
config round-trips between the two packages by field name. ``dtype`` is
a torch dtype here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

POSITION_EMBEDDING_TYPES = ("rotary", "absolute")
NORMALIZATION_TYPES = ("layernorm", "rmsnorm")
ACTIVATION_TYPES = ("gelu", "gelu_tanh", "geglu", "swiglu", "reglu", "liglu",
                    "relu", "squared_relu")
GLU_ACTIVATIONS = ("geglu", "swiglu", "reglu", "liglu")
ATTN_MASK_TYPES = ("causal", "bidirectional", "padding")
# "pallas" keeps the JAX package's name for the kernel route: on CUDA
# tensors it selects the hand-written Hopper kernels (ops/flash/);
# "ring" and "ulysses" are the explicit context-parallel schemes
# (ops/ring_attention.py, ops/ulysses.py)
ATTENTION_IMPLS = ("xla", "pallas", "ring", "ulysses")
# fp8 training products (ops/fp8.py): e4m3 throughout, or e4m3 forward
# and e5m2 gradients
FP8_FORMATS = (None, "e4m3", "hybrid")
# per-layer policies; "block:N" (fully recompute the first N layers) and
# "uniform:N" (checkpoint every N-layer chunk) are parsed by
# parse_recompute
RECOMPUTE_POLICIES = ("none", "selective", "full")
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; one of {sorted(DTYPES)}")
    return DTYPES[name]


def parse_recompute(recompute: str) -> Tuple[str, Optional[int]]:
    """(granularity, n) of a recompute policy (the JAX package's rule):
    "block:N" fully recomputes the first N layers (N >= 0) and saves the
    rest; "uniform:N" checkpoints chunks of N layers (N >= 1), each layer
    inside a replayed chunk rematted too. A per-layer policy name gives
    (name, None). Raises ValueError on anything else."""
    for prefix in ("block", "uniform"):
        if recompute.startswith(prefix + ":"):
            try:
                n = int(recompute.split(":", 1)[1])
            except ValueError:
                n = -1
            if n < (1 if prefix == "uniform" else 0):
                raise ValueError(
                    f"bad recompute_granularity {recompute!r}: the form is "
                    f"'{prefix}:<N>' with N a "
                    + ("positive chunk size" if prefix == "uniform"
                       else "non-negative layer count"))
            return prefix, n
    if recompute not in RECOMPUTE_POLICIES:
        raise ValueError(
            f"bad recompute_granularity {recompute!r}; one of "
            f"{RECOMPUTE_POLICIES}, 'block:N' or 'uniform:N'")
    return recompute, None


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of one transformer: a decoder-only LM, or the BERT
    encoder and the T5 encoder-decoder (models/bert.py, models/t5.py)."""

    num_layers: int
    hidden_size: int
    num_attention_heads: int
    vocab_size: int
    seq_length: int

    # encoder-decoder models (T5) may give the two stacks different
    # depths (--encoder_num_layers / --decoder_num_layers); None =
    # num_layers. Decoder-only models ignore both.
    encoder_num_layers: Optional[int] = None
    decoder_num_layers: Optional[int] = None

    num_kv_heads: Optional[int] = None
    kv_channels: Optional[int] = None
    ffn_hidden_size: Optional[int] = None

    position_embedding_type: str = "rotary"
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 1.0
    # rows of the embed/pos table (absolute position embeddings only)
    max_position_embeddings: Optional[int] = None

    normalization: str = "rmsnorm"
    layernorm_epsilon: float = 1e-5
    activation: str = "swiglu"
    # Falcon parallel attention: attn(ln1(x)) + mlp(ln1(x)) in one
    # residual add, the MLP optionally behind its own ln_mlp (Falcon-40B)
    parallel_attn: bool = False
    parallel_layernorm: bool = False
    # post-LN: no pre-norm, each layer ends with its own norm (the ln1
    # slot), no final stack norm
    use_post_ln: bool = False
    # the residual taken from the norm's output instead of its input
    apply_residual_post_ln: bool = False

    use_bias_linear: bool = False
    use_bias_qkv: bool = False
    tie_embed_logits: bool = False
    sliding_window_size: Optional[int] = None

    # Mixture-of-Experts (ops/moe.py): GShard/Switch capacity dispatch
    # with Mixtral's renormalized top-k gates, or dropless dispatch.
    # None = dense MLP. The JAX package's fields, names and defaults.
    num_experts: Optional[int] = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coeff: float = 1e-2
    moe_z_loss_coeff: float = 0.0
    moe_renorm_gates: bool = True
    # "capacity": per-group capacity, overflow dropped; "dropless": every
    # (token, choice) row through its expert (grouped products)
    moe_dispatch: str = "capacity"
    # the dropless receive buffer under expert parallelism: n * top_k *
    # factor rows a rank (None: ep, dropless for any routing; smaller
    # drops greedily in source order, ops/moe.moe_block_dropless_ep)
    moe_ep_buffer_factor: Optional[float] = None
    # tokens per dispatch group; 0 = auto (largest divisor of seq_length
    # <= 2048). Must divide seq_length when set
    moe_group_size: int = 0

    init_method_std: float = 0.02
    use_scaled_init: bool = True

    # regularization: dropout is not ported (the kernels have no Philox
    # generator yet), so validate() holds both at 0.0, the JAX default
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0

    params_dtype: str = "bfloat16"
    # fp8 training products (ops/fp8.py, TransformerEngine's formats with
    # current scaling): None | "e4m3" | "hybrid"
    fp8_format: Optional[str] = None
    fp8_margin: int = 0          # --fp8_margin: scale back-off 2^-m
    fp8_wgrad: bool = True       # --no_fp8_wgrad: fp32 weight gradient
    softmax_fp32: bool = True
    attn_mask_type: str = "causal"

    # chunked logits + cross-entropy: the LM head and CE over sequence
    # chunks of this many tokens, each chunk's logits recomputed in the
    # backward. 0 = unchunked. Must divide seq_length.
    ce_chunk_size: int = 0

    attention_impl: str = "xla"
    # BERT-style extras (models/bert.py): rows of the embed/tokentype
    # table (0: none), and the pooler + binary (SOP) head + MLM transform
    # head leaves
    num_tokentypes: int = 0
    bert_binary_head: bool = False
    # full-sequence attention through flash_mha's backward kernels;
    # False (--no_flash_bwd) is the escape hatch to the dense O(S^2)
    # attention and its autograd gradient, loudly warned
    flash_bwd: bool = True

    @property
    def head_dim(self) -> int:
        return self.kv_channels or self.hidden_size // self.num_attention_heads

    @property
    def n_kv_heads(self) -> int:
        return self.num_kv_heads or self.num_attention_heads

    @property
    def is_glu(self) -> bool:
        return self.activation in GLU_ACTIVATIONS

    @property
    def ffn_size(self) -> int:
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        if self.is_glu:
            raw = int(2 * 4 * self.hidden_size / 3)
            return 256 * ((raw + 255) // 256)
        return 4 * self.hidden_size

    @property
    def dtype(self) -> torch.dtype:
        return _resolve_dtype(self.params_dtype)

    def validate(self) -> "ModelConfig":
        if self.position_embedding_type not in POSITION_EMBEDDING_TYPES:
            raise ValueError(
                f"bad position_embedding_type {self.position_embedding_type}")
        if self.normalization not in NORMALIZATION_TYPES:
            raise ValueError(f"bad normalization {self.normalization}")
        if self.activation not in ACTIVATION_TYPES:
            raise ValueError(f"bad activation {self.activation}")
        if self.attn_mask_type not in ATTN_MASK_TYPES:
            raise ValueError(f"bad attn_mask_type {self.attn_mask_type}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"bad attention_impl {self.attention_impl}")
        if self.fp8_format not in FP8_FORMATS:
            raise ValueError(
                f"fp8_format={self.fp8_format!r} must be None, 'e4m3' or "
                "'hybrid' (--fp8_e4m3 / --fp8_hybrid)")
        _resolve_dtype(self.params_dtype)
        if self.use_post_ln and self.parallel_attn:
            raise ValueError("use_post_ln is incompatible with parallel_attn")
        if (self.hidden_size % self.num_attention_heads
                and self.kv_channels is None):
            raise ValueError("num_attention_heads must divide hidden_size")
        if self.num_attention_heads % self.n_kv_heads:
            raise ValueError(
                "num_attention_heads must be divisible by num_kv_heads")
        if (self.position_embedding_type == "absolute"
                and not self.max_position_embeddings):
            raise ValueError(
                "absolute position embeddings need max_position_embeddings")
        if self.parallel_layernorm and not self.parallel_attn:
            raise ValueError("parallel_layernorm requires parallel_attn")
        if self.hidden_dropout != 0.0 or self.attention_dropout != 0.0:
            raise ValueError(
                f"hidden_dropout={self.hidden_dropout} and attention_dropout"
                f"={self.attention_dropout}: dropout is not ported yet (the "
                "kernels have no random generator); both must be 0.0")
        if self.num_experts is not None:
            if self.num_experts < 1:
                raise ValueError("num_experts must be >= 1")
            if not 1 <= self.moe_top_k <= self.num_experts:
                raise ValueError(
                    f"moe_top_k={self.moe_top_k} must be in "
                    f"[1, num_experts={self.num_experts}]")
            if self.moe_dispatch not in ("capacity", "dropless"):
                raise ValueError(
                    f"moe_dispatch={self.moe_dispatch!r} must be "
                    "'capacity' or 'dropless'")
            if self.moe_group_size < 0:
                raise ValueError("moe_group_size must be >= 0")
            if (self.moe_ep_buffer_factor is not None
                    and self.moe_ep_buffer_factor <= 0):
                raise ValueError(
                    f"moe_ep_buffer_factor={self.moe_ep_buffer_factor} "
                    "must be > 0 (None = exact dropless)")
            if self.moe_group_size and self.seq_length % self.moe_group_size:
                raise ValueError(
                    f"moe_group_size={self.moe_group_size} must divide "
                    f"seq_length={self.seq_length}")
        if self.num_tokentypes < 0:
            raise ValueError("num_tokentypes must be >= 0")
        for name in ("encoder_num_layers", "decoder_num_layers"):
            if getattr(self, name) is not None and getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1 (None: num_layers)")
        if self.ce_chunk_size < 0:
            raise ValueError("ce_chunk_size must be >= 0")
        if self.ce_chunk_size and self.seq_length % self.ce_chunk_size:
            raise ValueError(
                f"ce_chunk_size={self.ce_chunk_size} must divide "
                f"seq_length={self.seq_length}")
        return self

    def flops_per_token_fwd(self, seq_length: Optional[int] = None) -> float:
        """Model FLOPs per token of one forward pass, for MFU (the JAX
        package's formula: attention counted over the full S x S)."""
        s = seq_length or self.seq_length
        h, hd = self.hidden_size, self.head_dim
        nq, nkv = self.num_attention_heads, self.n_kv_heads
        f = self.ffn_size
        per_layer = 2 * h * (nq + 2 * nkv) * hd        # qkv proj
        per_layer += 2 * 2 * s * nq * hd               # qk^T and av
        per_layer += 2 * nq * hd * h                   # out proj
        mlp = 2 * h * f * (2 if self.is_glu else 1) + 2 * f * h
        if self.num_experts is not None:
            # each token visits top_k experts; the router product is extra
            mlp = mlp * self.moe_top_k + 2 * h * self.num_experts
        per_layer += mlp
        return float(self.num_layers * per_layer + 2 * h * self.vocab_size)


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam/SGD + lr schedule + mixed-precision policy (the JAX package's
    fields, names and defaults)."""

    optimizer: str = "adam"
    lr: float = 3e-4
    min_lr: float = 0.0
    lr_decay_style: str = "cosine"  # constant | linear | cosine | inverse-square-root
    lr_decay_iters: Optional[int] = None
    lr_warmup_iters: int = 0
    lr_warmup_fraction: Optional[float] = None

    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9
    weight_decay: float = 0.01
    start_weight_decay: Optional[float] = None
    end_weight_decay: Optional[float] = None
    weight_decay_incr_style: str = "constant"  # constant | linear | cosine

    # ((path_regex, lr_mult, wd_mult), ...): first match wins
    param_group_mults: tuple = ()

    clip_grad: float = 1.0
    # ZeRO-1: fp32 masters and Adam moments sharded over the data axis
    # (ref: megatron/optimizer/distrib_optimizer.py; training/optimizer.py)
    use_distributed_optimizer: bool = False
    fp32_master_weights: bool = True
    # dynamic loss scaling for fp16 (never needed for bf16)
    loss_scale: Optional[float] = None  # None => dynamic when fp16
    initial_loss_scale: float = 2.0**32
    min_loss_scale: float = 1.0
    loss_scale_window: int = 1000
    hysteresis: int = 2
    log_num_zeros_in_grad: bool = False


@dataclass(frozen=True)
class TrainingConfig:
    """The JAX package's TrainingConfig, single host: batching, duration,
    evaluation, seed, recompute, checkpointing, the async loop, the
    fault-tolerance sentinels, logging, profiling and telemetry, with its
    names, defaults and validation. Left out: the multi-host fields
    (coordination_dir, peer_death_timeout_s, seed_pipeline_offset,
    data_parallel_random_init). compilation_cache_dir is kept for the
    name's sake and refused when set: eager PyTorch has no compilation
    to cache."""

    micro_batch_size: int = 1
    global_batch_size: int = 1
    # (start_batch, increment, ramp_samples)
    rampup_batch_size: Optional[Tuple[int, int, int]] = None
    train_iters: Optional[int] = None
    train_samples: Optional[int] = None
    eval_interval: int = 1000
    eval_iters: int = 100
    seed: int = 1234
    recompute_granularity: str = "none"

    # checkpointing (training/checkpointing.py)
    save: Optional[str] = None
    load: Optional[str] = None
    save_interval: Optional[int] = None
    exit_interval: Optional[int] = None
    exit_duration_in_mins: Optional[int] = None
    finetune: bool = False
    no_load_optim: bool = False
    # accepted for the name's sake: the port keeps no RNG state (no
    # dropout), so there is nothing to skip loading
    no_load_rng: bool = False
    # overlap the checkpoint write with training (AsyncCheckpointSaver);
    # --no_async_save blocks the loop on each write
    async_save: bool = True
    # retention: keep only the newest K committed checkpoints; None = all
    keep_latest_k: Optional[int] = None

    # the async loop (training/prefetch.py and the lagged metrics):
    # --no_async_loop is the synchronous loop, the bitwise oracle
    async_loop: bool = True
    # depth of the background prefetcher's queue of landed batches
    prefetch_depth: int = 2
    # read each step's metrics this many steps late
    metrics_lag: int = 1
    # refused when set (see the class docstring)
    compilation_cache_dir: Optional[str] = None

    # divergence sentinel (training/resilience.py): abort, or roll back
    # with rollback_on_divergence, after this many CONSECUTIVE
    # non-finite/skipped steps; 0 disables
    divergence_patience: int = 100
    # trip when loss > factor * EMA for loss_spike_patience steps; 0 off
    loss_spike_factor: float = 0.0
    loss_spike_patience: int = 5
    rollback_on_divergence: bool = False
    max_rollbacks: int = 3

    # deadline (s) on the expedited checkpoint a SIGTERM forces; past it
    # the process exits 75. 0 disables the deadline
    preempt_save_timeout: float = 600.0
    # step watchdog: no step for this many seconds dumps a flight bundle
    # and exits 70. 0 disables
    step_timeout_s: float = 0.0
    # every N steps replay the step from a copy of its state and compare
    # bitwise (silent data corruption sentinel). 0 disables
    replay_check_interval: int = 0
    # journal a crc32 of every host batch as data_crc on step records
    log_data_fingerprint: bool = False

    # --save_interval auto: the cadence from measured commit latency
    save_interval_auto: bool = False
    save_interval_floor: int = 25

    # logging
    log_interval: int = 100
    tensorboard_dir: Optional[str] = None
    wandb_logger: bool = False
    wandb_project: str = "megatron_tpu"
    wandb_name: Optional[str] = None
    timing_log_level: int = 0
    log_timers_to_tensorboard: bool = False
    # torch.profiler trace window over iterations
    # [profile_step_start, profile_step_end) into profile_dir
    profile: bool = False
    profile_step_start: int = 10
    profile_step_end: int = 12
    profile_dir: Optional[str] = None
    # SIGUSR1 mid-run arms a trace window of this many steps
    profile_signal_steps: int = 2

    # telemetry (megatron_tpu_torch/telemetry): the event journal dir,
    # its rotation size, the sidecar /metrics port (0 binds a free one)
    # and the flight recorder
    telemetry_dir: Optional[str] = None
    journal_max_mb: float = 64.0
    metrics_port: Optional[int] = None
    flight_recorder: bool = False
    flight_recorder_deadline_s: float = 600.0
    flight_recorder_abort: bool = False

    # run only the validation loop, then exit
    eval_only: bool = False
    # iterations whose update is skipped (their data is consumed)
    skip_iters: tuple = ()

    # extra per-log-interval scalars
    log_params_norm: bool = False
    log_memory: bool = False
    log_batch_size: bool = False
    log_world_size: bool = False

    # instruction data (data/instruction_dataset.py): the loss weight of
    # non-assistant tokens, and padding each batch to a multiple of 16
    # instead of seq_length
    scalar_loss_mask: float = 0.0
    variable_seq_lengths: bool = False
    # validation metrics (training/metrics.py names)
    metrics: Tuple[str, ...] = ()

    def validate(self) -> "TrainingConfig":
        parse_recompute(self.recompute_granularity)
        if self.compilation_cache_dir:
            raise ValueError(
                f"compilation_cache_dir={self.compilation_cache_dir!r}: "
                "eager PyTorch compiles nothing, so there is no "
                "compilation cache to keep (the flag is the JAX "
                "package's); drop it")
        if self.flight_recorder and self.flight_recorder_deadline_s <= 0:
            raise ValueError(
                f"flight_recorder_deadline_s="
                f"{self.flight_recorder_deadline_s} must be > 0 (seconds "
                "without a step heartbeat before the stall bundle dumps)")
        if self.journal_max_mb < 0:
            raise ValueError(
                "journal_max_mb must be >= 0 (0 disables rotation: one "
                "unbounded journal file)")
        if self.prefetch_depth < 0:
            raise ValueError(
                "prefetch_depth must be >= 0 (0 disables the background "
                "prefetcher; use --no_async_loop for the fully "
                "synchronous loop)")
        if self.metrics_lag < 0:
            raise ValueError(
                "metrics_lag must be >= 0 (0 fetches metrics inside each "
                "step, the synchronous behavior)")
        if self.preempt_save_timeout < 0:
            raise ValueError(
                "preempt_save_timeout must be >= 0 seconds (0 disables "
                "the preemption-save deadline)")
        if self.step_timeout_s < 0:
            raise ValueError(
                "step_timeout_s must be >= 0 seconds (0 disables the "
                "step-deadline hang watchdog)")
        if self.replay_check_interval < 0:
            raise ValueError(
                "replay_check_interval must be >= 0 steps (0 disables "
                "the SDC replay check)")
        if self.save_interval_auto and self.save_interval is not None:
            raise ValueError(
                "--save_interval auto and a fixed --save_interval are "
                "mutually exclusive")
        if self.save_interval_auto and not self.preempt_save_timeout:
            raise ValueError(
                "--save_interval auto derives the cadence from the "
                "--preempt_save_timeout grace window; set a positive one")
        if self.save_interval_floor < 1:
            raise ValueError("save_interval_floor must be >= 1 step")
        return self


@dataclass(frozen=True)
class ParallelConfig:
    """Parallel topology (a copy of megatron_tpu/config.py's
    ParallelConfig: the same fields, defaults, derive_data_parallel and
    validate).

    Replaces the reference's process-group builder
    (megatron/core/parallel_state.py:51-199). Rank layout is
    ("data", "expert", "pipe", "context", "tensor") with tensor the
    fastest-varying, the reference's TP-innermost-contiguous layout
    (parallel/mesh.py). The port trains every axis: data, expert, pipe,
    context (all-gathered K/V, the ring or Ulysses, by attention_impl)
    and tensor, with sequence parallelism and the interleaved schedule.
    """

    tensor_parallel: int = 1
    pipeline_parallel: int = 1
    # context/sequence-dimension sharding (ops/attention.py's dispatch)
    context_parallel: int = 1
    # expert parallelism: a sub-axis of data parallelism that MoE expert
    # weights shard over
    expert_parallel: int = 1
    # data_parallel: None => derived from the world size
    data_parallel: Optional[int] = None
    # Korthikanti sequence parallelism: residual-stream activations
    # sharded along seq over the *tensor* axis outside matmul blocks
    # (ref: layers.py:225-236,285-296,691-692)
    sequence_parallel: bool = False
    # number of virtual-pipeline chunks per stage (interleaved 1F1B),
    # ref: schedules.py:253-502. None => non-interleaved.
    virtual_pipeline_parallel: Optional[int] = None

    def derive_data_parallel(self, n_devices: int) -> int:
        model_devices = (self.tensor_parallel * self.pipeline_parallel
                         * self.context_parallel * self.expert_parallel)
        if n_devices % model_devices:
            raise ValueError(
                f"{n_devices} devices not divisible by "
                f"tp*pp*cp*ep={model_devices}")
        dp = n_devices // model_devices
        if self.data_parallel is not None and self.data_parallel != dp:
            raise ValueError(
                f"data_parallel={self.data_parallel} inconsistent with "
                f"{n_devices} devices / (tp*pp*cp*ep={model_devices})")
        return dp

    def validate(self) -> "ParallelConfig":
        for name in ("tensor_parallel", "pipeline_parallel",
                     "context_parallel", "expert_parallel"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.virtual_pipeline_parallel is not None:
            if self.pipeline_parallel < 2:
                raise ValueError("interleaved schedule needs pipeline_parallel >= 2")
            if self.virtual_pipeline_parallel < 2:
                raise ValueError("virtual_pipeline_parallel must be >= 2")
        if self.sequence_parallel and self.tensor_parallel == 1:
            # ref disables SP when tp==1 (arguments.py:331-341)
            return dataclasses.replace(self, sequence_parallel=False)
        return self


@dataclass(frozen=True)
class RunConfig:
    """The configs of one training run (the JAX package's RunConfig):
    model, parallel topology, optimizer and training."""

    model: ModelConfig
    parallel: ParallelConfig = ParallelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    training: TrainingConfig = TrainingConfig()

    def validate(self) -> "RunConfig":
        self.model.validate()
        self.parallel.validate()
        self.training.validate()
        return self

    def to_dict(self) -> dict:
        """The run config as plain JSON types, as a checkpoint's
        meta.json records it."""
        return dataclasses.asdict(self)
