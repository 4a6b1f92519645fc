"""Command-line flags of the port's training entry point (counterpart of
megatron_tpu/arguments.py, the subset tools/pretrain_gpt takes).

The flag names and defaults are the JAX package's, so a command line
moves between the two entry points: note that, as there, the precision
defaults to bf16 (--fp32 / --fp16 change it) and --attention_impl to
"xla" (the dense path; --attention_impl pallas selects the flash
kernels). --num_layers overrides the preset's depth, and --device
(default "cuda") picks where the run happens.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from megatron_tpu_torch.config import (ModelConfig, OptimizerConfig,
                                       RunConfig, TrainingConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="megatron_tpu_torch GPT pretraining")
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

    g = p.add_argument_group("training")
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=None)
    g.add_argument("--train_iters", type=int, default=None)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--recompute_granularity", default="none",
                   choices=["none", "selective", "full"])

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

    g = p.add_argument_group("data")
    g.add_argument("--data_path", nargs="*", default=None)
    g.add_argument("--split", default="969,30,1")

    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def _dtype_name(args) -> str:
    if args.fp16:
        return "float16"
    if args.fp32:
        return "float32"
    return "bfloat16"


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
        recompute_granularity=args.recompute_granularity,
        log_interval=args.log_interval)
    return RunConfig(model=model, optimizer=optimizer,
                     training=training).validate()
