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
# tensors it selects the hand-written Hopper kernels (ops/flash/)
ATTENTION_IMPLS = ("xla", "pallas")
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
    """Architecture of one decoder-only transformer LM."""

    num_layers: int
    hidden_size: int
    num_attention_heads: int
    vocab_size: int
    seq_length: int

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

    init_method_std: float = 0.02
    use_scaled_init: bool = True

    # regularization: dropout is not ported (the kernels have no Philox
    # generator yet), so validate() holds both at 0.0, the JAX default
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0

    params_dtype: str = "bfloat16"
    softmax_fp32: bool = True
    attn_mask_type: str = "causal"

    # chunked logits + cross-entropy: the LM head and CE over sequence
    # chunks of this many tokens, each chunk's logits recomputed in the
    # backward. 0 = unchunked. Must divide seq_length.
    ce_chunk_size: int = 0

    attention_impl: str = "xla"
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
        per_layer += 2 * h * f * (2 if self.is_glu else 1) + 2 * f * h
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
    """The TrainingConfig fields the training path reads: batching,
    duration, evaluation, seed, recompute, logging, checkpointing and
    the instruction collator's options."""

    micro_batch_size: int = 1
    global_batch_size: int = 1
    # (start_batch, increment, ramp_samples)
    rampup_batch_size: Optional[Tuple[int, int, int]] = None
    train_iters: Optional[int] = None
    eval_interval: int = 1000
    eval_iters: int = 100
    seed: int = 1234
    recompute_granularity: str = "none"
    log_interval: int = 100

    # checkpointing (training/checkpointing.py)
    save: Optional[str] = None
    load: Optional[str] = None
    save_interval: Optional[int] = None
    finetune: bool = False
    no_load_optim: bool = False
    # overlap the checkpoint write with training (AsyncCheckpointSaver);
    # --no_async_save blocks the loop on each write
    async_save: bool = True
    # retention: keep only the newest K committed checkpoints; None = all
    keep_latest_k: Optional[int] = None

    # instruction data (data/instruction_dataset.py): the loss weight of
    # non-assistant tokens, and padding each batch to a multiple of 16
    # instead of seq_length
    scalar_loss_mask: float = 0.0
    variable_seq_lengths: bool = False

    def validate(self) -> "TrainingConfig":
        parse_recompute(self.recompute_granularity)
        return self


@dataclass(frozen=True)
class RunConfig:
    """The configs of one training run (the JAX package's RunConfig
    without its parallel topology: the port trains on one card)."""

    model: ModelConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    training: TrainingConfig = TrainingConfig()

    def validate(self) -> "RunConfig":
        self.model.validate()
        self.training.validate()
        return self

    def to_dict(self) -> dict:
        """The run config as plain JSON types, as a checkpoint's
        meta.json records it."""
        return dataclasses.asdict(self)
