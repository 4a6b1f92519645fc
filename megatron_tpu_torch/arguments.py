"""Command-line flags of the port's training entry point (counterpart of
megatron_tpu/arguments.py, the subset tools/pretrain_gpt takes).

The flag names and defaults are the JAX package's, so a command line
moves between the two entry points: note that, as there, the precision
defaults to bf16 (--fp32 / --fp16 change it) and --attention_impl to
"xla" (the dense path; --attention_impl pallas selects the flash
kernels). --num_layers overrides the preset's depth, and --device
(default "cuda") picks where the run happens. --save_interval takes an
integer: the JAX CLI's "auto" cadence is not ported.

The port builds every model from a preset (--model_name); the JAX CLI's
architecture flags (--position_embedding_type, --max_position_embeddings,
--rope_theta, --use_post_ln, --apply_residual_connection_post_layernorm,
--parallel_attn, --parallel_layernorm, --use_bias, --no_tie_embed_logits)
override the preset's value when given. --recompute_method and
--recompute_num_layers map onto "block:N" / "uniform:N" with
--recompute_granularity full, as the JAX CLI maps them.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

from megatron_tpu_torch.config import (ModelConfig, OptimizerConfig,
                                       RunConfig, TrainingConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="megatron_tpu_torch GPT pretraining and finetuning")
    g = p.add_argument_group("model")
    g.add_argument("--model_name", default=None,
                   help="preset, optionally 'name-SIZE' (e.g. llama2-7B)")
    g.add_argument("--num_layers", type=int, default=None,
                   help="override the preset's depth")
    g.add_argument("--seq_length", type=int, default=2048)
    g.add_argument("--attention_impl", default="xla",
                   choices=["xla", "pallas"])
    g.add_argument("--no_flash_bwd", dest="flash_bwd", action="store_false",
                   help="escape hatch: dense O(S^2) attention and its "
                        "autograd gradient on the training path (loudly "
                        "warned)")
    g.add_argument("--ce_chunk_size", type=int, default=0)
    g.add_argument("--max_position_embeddings", type=int, default=None)
    g.add_argument("--position_embedding_type", default=None,
                   choices=["rotary", "absolute"])
    g.add_argument("--rope_theta", type=float, default=None)
    g.add_argument("--use_post_ln", action="store_true", default=None,
                   help="post-LN layer convention (no pre-norm; per-layer "
                        "output norm; no final stack norm)")
    g.add_argument("--apply_residual_connection_post_layernorm",
                   action="store_true", default=None,
                   help="take residuals from the norm's output")
    g.add_argument("--parallel_attn", action="store_true", default=None)
    g.add_argument("--parallel_layernorm", action="store_true",
                   default=None)
    g.add_argument("--use_bias", action="store_true", default=None)
    g.add_argument("--tie_embed_logits", action="store_true", default=None)
    g.add_argument("--no_tie_embed_logits", action="store_false",
                   dest="tie_embed_logits",
                   help="untie the word embedding and the LM head")

    g = p.add_argument_group("training")
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=None)
    g.add_argument("--train_iters", type=int, default=None)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--recompute_granularity", default="none",
                   choices=["none", "selective", "full"])
    g.add_argument("--recompute_method", default="uniform",
                   choices=["uniform", "block"],
                   help="with --recompute_granularity full: uniform "
                        "checkpoints chunks of --recompute_num_layers "
                        "layers; block recomputes only the first N layers")
    g.add_argument("--recompute_num_layers", type=int, default=1,
                   help="layer count or chunk for --recompute_method")

    g = p.add_argument_group("optimizer")
    g.add_argument("--lr", type=float, default=3e-4)
    g.add_argument("--min_lr", type=float, default=0.0)
    g.add_argument("--lr_decay_style", default="cosine",
                   choices=["constant", "linear", "cosine",
                            "inverse-square-root"])
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--clip_grad", type=float, default=1.0)
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.999)
    g.add_argument("--adam_eps", type=float, default=1e-8)

    g = p.add_argument_group("mixed precision")
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--fp32", action="store_true")

    g = p.add_argument_group("validation and logging")
    g.add_argument("--eval_interval", type=int, default=1000)
    g.add_argument("--eval_iters", type=int, default=100)
    g.add_argument("--log_interval", type=int, default=100)

    g = p.add_argument_group("checkpointing")
    g.add_argument("--save", default=None)
    g.add_argument("--load", default=None)
    g.add_argument("--save_interval", type=_save_interval, default=None,
                   help="checkpoint every N iterations (and once at the "
                        "end when --save is set)")
    g.add_argument("--finetune", action="store_true",
                   help="load the weights only: iteration, consumed "
                        "samples and optimizer state start fresh")
    g.add_argument("--no_load_optim", action="store_true",
                   help="load weights and iteration, but fresh Adam "
                        "moments")
    g.add_argument("--no_async_save", action="store_false", dest="async_save",
                   default=True,
                   help="block the train loop on each checkpoint write "
                        "instead of overlapping it with compute")
    g.add_argument("--keep_latest_k", type=int, default=None,
                   help="retention: prune all but the newest K committed "
                        "checkpoints after each save (default: keep all)")

    g = p.add_argument_group("data")
    g.add_argument("--data_path", nargs="*", default=None)
    g.add_argument("--split", default="969,30,1")
    g.add_argument("--scalar_loss_mask", type=float, default=0.0,
                   help="instruction data: loss weight of the tokens that "
                        "are not the assistant's")
    g.add_argument("--variable_seq_lengths", action="store_true",
                   help="instruction data: pad each batch to a multiple of "
                        "16 tokens instead of --seq_length")

    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p


def _save_interval(value: str) -> int:
    if value.lower() == "auto":
        raise argparse.ArgumentTypeError(
            "--save_interval auto is not ported yet (ROADMAP.md); give an "
            "integer")
    return int(value)


def parse_args(argv: Optional[Sequence[str]] = None,
               extra_args_provider: Optional[Callable] = None
               ) -> argparse.Namespace:
    """extra_args_provider(parser) -> parser adds an entry point's own
    flags (the JAX CLI's hook)."""
    p = build_parser()
    if extra_args_provider is not None:
        p = extra_args_provider(p)
    return p.parse_args(argv)


def _dtype_name(args) -> str:
    if args.fp16:
        return "float16"
    if args.fp32:
        return "float32"
    return "bfloat16"


#: (flag dest, ModelConfig field) of the architecture flags that override
#: the preset when given
_ARCH_FLAGS = (
    ("max_position_embeddings", "max_position_embeddings"),
    ("position_embedding_type", "position_embedding_type"),
    ("rope_theta", "rope_theta"),
    ("use_post_ln", "use_post_ln"),
    ("apply_residual_connection_post_layernorm", "apply_residual_post_ln"),
    ("parallel_attn", "parallel_attn"),
    ("parallel_layernorm", "parallel_layernorm"),
    ("use_bias", "use_bias_linear"),
    ("use_bias", "use_bias_qkv"),
    ("tie_embed_logits", "tie_embed_logits"),
)


def recompute_policy(args) -> str:
    """--recompute_granularity, with --recompute_method and
    --recompute_num_layers folded in as the JAX CLI folds them: "block:N"
    for the block method, "uniform:N" for uniform with N > 1; both need
    --recompute_granularity full."""
    method, n = args.recompute_method, args.recompute_num_layers
    if method == "block" or (method == "uniform" and n > 1):
        if args.recompute_granularity != "full":
            raise ValueError(
                f"--recompute_method {method} with --recompute_num_layers "
                "needs --recompute_granularity full")
        return f"{method}:{n}"
    return args.recompute_granularity


def args_to_run_config(args) -> RunConfig:
    from megatron_tpu_torch.models import presets

    if not args.model_name:
        raise ValueError("--model_name is required (the port builds models "
                         "from presets)")
    model = presets.from_model_name(args.model_name)
    overrides = dict(attention_impl=args.attention_impl,
                     flash_bwd=args.flash_bwd,
                     ce_chunk_size=args.ce_chunk_size,
                     params_dtype=_dtype_name(args))
    # 2048 is the flag's default: the preset's own length stands unless
    # another one is asked for (the JAX CLI's rule)
    if args.seq_length and args.seq_length != 2048:
        overrides["seq_length"] = args.seq_length
    if args.num_layers is not None:
        overrides["num_layers"] = args.num_layers
    for flag, field in _ARCH_FLAGS:
        if getattr(args, flag) is not None:
            overrides[field] = getattr(args, flag)
    model = ModelConfig(**{**model.__dict__, **overrides}).validate()

    optimizer = OptimizerConfig(
        lr=args.lr, min_lr=args.min_lr, lr_decay_style=args.lr_decay_style,
        lr_warmup_iters=args.lr_warmup_iters,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_eps=args.adam_eps, weight_decay=args.weight_decay,
        clip_grad=args.clip_grad)
    training = TrainingConfig(
        micro_batch_size=args.micro_batch_size,
        global_batch_size=args.global_batch_size or args.micro_batch_size,
        train_iters=args.train_iters, eval_interval=args.eval_interval,
        eval_iters=args.eval_iters, seed=args.seed,
        recompute_granularity=recompute_policy(args),
        log_interval=args.log_interval, save=args.save, load=args.load,
        save_interval=args.save_interval, finetune=args.finetune,
        no_load_optim=args.no_load_optim, async_save=args.async_save,
        keep_latest_k=args.keep_latest_k,
        scalar_loss_mask=args.scalar_loss_mask,
        variable_seq_lengths=args.variable_seq_lengths)
    return RunConfig(model=model, optimizer=optimizer,
                     training=training).validate()
