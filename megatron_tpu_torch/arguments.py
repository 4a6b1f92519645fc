"""Command-line flags of the port's training entry point (counterpart of
megatron_tpu/arguments.py, the subset tools/pretrain_gpt takes).

The flag names and defaults are the JAX package's, so a command line
moves between the two entry points: note that, as there, the precision
defaults to bf16 (--fp32 / --fp16 change it) and --attention_impl to
"xla" (the dense path; --attention_impl pallas selects the flash
kernels). --num_layers overrides the preset's depth, and --device
(default "cuda") picks where the run happens. --save_interval takes an
integer or "auto" (the cadence derived from measured commit latency
against --preempt_save_timeout). The loop's flags (the async loop,
the fault-tolerance sentinels, logging, profiling and telemetry), the
data flags and the tokenizer flags are the JAX CLI's; its multi-host
flags (--coordination_dir, --peer_death_timeout_s) are not ported, and
--compilation_cache_dir is refused (eager PyTorch compiles nothing).
The distributed flags are the JAX CLI's (--tensor_model_parallel_size,
--pipeline_model_parallel_size, --num_layers_per_virtual_pipeline_stage
mapped to virtual_pipeline_parallel as there, --sequence_parallel,
--use_distributed_optimizer, --expert_model_parallel_size,
--context_parallel_size with --attention_impl xla or pallas for the
all-gathered K/V, ring or ulysses for the explicit schemes), and the
process group comes from torch.distributed.run's environment
(parallel/distributed.py). A sequence that does not split evenly over
the context ranks is refused here (the JAX package warns and runs its
dense path). The fp8 flags (--fp8_e4m3, --fp8_hybrid, --fp8_margin,
--no_fp8_wgrad) are the JAX CLI's, with its mapping and its
mutual-exclusion error. The MoE flags (--num_experts,
--moe_top_k, --moe_capacity_factor, --moe_aux_loss_coeff,
--moe_z_loss_coeff, --moe_group_size, --moe_dispatch,
--moe_ep_buffer_factor, --[no_]moe_renorm_gates) are the JAX CLI's: only
a flag that is passed overrides the preset (mixtral carries its own).
SIGTERM checkpoint-and-exit is always on, as there
(--exit_signal_handler is accepted).

The port builds every model from a preset (--model_name); the JAX CLI's
architecture flags (--position_embedding_type, --max_position_embeddings,
--rope_theta, --use_post_ln, --apply_residual_connection_post_layernorm,
--parallel_attn, --parallel_layernorm, --use_bias, --no_tie_embed_logits)
override the preset's value when given. --recompute_method and
--recompute_num_layers map onto "block:N" / "uniform:N" with
--recompute_granularity full, as the JAX CLI maps them.

The encoder families (tools/pretrain_bert, pretrain_t5, pretrain_ict and
tasks/main) build their models from --num_layers, --hidden_size,
--num_attention_heads, --vocab_size (padded to
--make_vocab_size_divisible_by) and --seq_length instead of a preset
(encoder_model_kwargs), and add their own flag groups (bert_args,
t5_args, ict_args, task_args: the JAX entry points' names and defaults);
--mask_prob, --short_seq_prob and --head_lr_mult (the task heads' LR
multiplier, HEAD_PATTERN) are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

from megatron_tpu_torch.config import (ModelConfig, OptimizerConfig,
                                       ParallelConfig, RunConfig,
                                       TrainingConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="megatron_tpu_torch GPT pretraining and finetuning")
    g = p.add_argument_group("model")
    g.add_argument("--model_name", default=None,
                   help="preset, optionally 'name-SIZE' (e.g. llama2-7B)")
    g.add_argument("--num_layers", type=int, default=None,
                   help="override the preset's depth")
    # the encoder families' widths (tools/pretrain_{bert,t5,ict},
    # tasks/main): their models are built from these, not from a preset
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--num_attention_heads", type=int, default=None)
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--make_vocab_size_divisible_by", type=int, default=128)
    g.add_argument("--seq_length", type=int, default=2048)
    g.add_argument("--attention_impl", default="xla",
                   choices=["xla", "pallas", "ring", "ulysses"])
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

    # MoE (ops/moe.py): None = not passed, the preset's value stands
    g.add_argument("--num_experts", type=int, default=None)
    g.add_argument("--moe_top_k", type=int, default=None)
    g.add_argument("--moe_capacity_factor", type=float, default=None)
    g.add_argument("--moe_aux_loss_coeff", type=float, default=None)
    g.add_argument("--moe_z_loss_coeff", type=float, default=None)
    g.add_argument("--moe_group_size", type=int, default=None,
                   help="dispatch group size (tokens); 0 = auto (largest "
                        "divisor of seq_length <= 2048)")
    g.add_argument("--moe_dispatch", choices=["capacity", "dropless"],
                   default=None,
                   help="capacity: per-group capacity, overflow dropped; "
                        "dropless: every routed row through its expert")
    g.add_argument("--moe_ep_buffer_factor", type=float, default=None,
                   help="dropless-EP receive buffer = n*top_k*factor rows "
                        "per expert shard (default: ep, exact dropless; "
                        "smaller scales FLOPs/memory at the cost of "
                        "greedy drops under routing imbalance)")
    g.add_argument("--moe_renorm_gates", action="store_true", default=None)
    g.add_argument("--no_moe_renorm_gates", action="store_false",
                   dest="moe_renorm_gates",
                   help="raw softmax gate values (GShard) instead of "
                        "renormalized top-k weights (Mixtral)")

    g = p.add_argument_group("training")
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=None)
    g.add_argument("--train_iters", type=int, default=None)
    g.add_argument("--train_samples", type=int, default=None)
    g.add_argument("--exit_interval", type=int, default=None)
    g.add_argument("--exit_duration_in_mins", type=int, default=None)
    g.add_argument("--exit_signal_handler", action="store_true",
                   default=True,
                   help="SIGTERM checkpoint-and-exit is always enabled here")
    g.add_argument("--eval_only", action="store_true")
    g.add_argument("--skip_iters", nargs="*", type=int, default=[],
                   help="skip the update on these iterations (their data "
                        "is consumed)")
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
    g.add_argument("--lr_warmup_fraction", type=float, default=None)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--head_lr_mult", type=float, default=1.0,
                   help="LR multiplier of the task heads (classification, "
                        "ICT and binary heads) when finetuning")
    g.add_argument("--clip_grad", type=float, default=1.0)
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.999)
    g.add_argument("--adam_eps", type=float, default=1e-8)

    g = p.add_argument_group("mixed precision")
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--fp32", action="store_true")
    g.add_argument("--fp8_e4m3", action="store_true",
                   help="fp8 training products, everything e4m3 "
                        "(TransformerEngine Format.E4M3)")
    g.add_argument("--fp8_hybrid", action="store_true",
                   help="fp8 training products, e4m3 forward / e5m2 "
                        "gradients (TransformerEngine Format.HYBRID)")
    # None: not passed, the preset's value stands
    g.add_argument("--fp8_margin", type=int, default=None,
                   help="back the quantization scales off by 2^-margin")
    g.add_argument("--no_fp8_wgrad", action="store_false", dest="fp8_wgrad",
                   default=None,
                   help="run the weight-gradient product in fp32")

    g = p.add_argument_group("validation and logging")
    g.add_argument("--eval_interval", type=int, default=1000)
    g.add_argument("--eval_iters", type=int, default=100)
    g.add_argument("--metrics", nargs="*", default=[],
                   help="validation metrics: perplexity, accuracy, "
                        "instruct_accuracy, count_loss_mask")
    g.add_argument("--log_interval", type=int, default=100)
    g.add_argument("--tensorboard_dir", default=None)
    g.add_argument("--wandb_logger", action="store_true")
    g.add_argument("--wandb_project", default="megatron_tpu")
    g.add_argument("--wandb_name", default=None)
    g.add_argument("--wandb_api_key", default=None,
                   help="exported as WANDB_API_KEY if not already set")
    g.add_argument("--timing_log_level", type=int, default=0)
    g.add_argument("--log_params_norm", action="store_true")
    g.add_argument("--log_memory_to_tensorboard", action="store_true")
    g.add_argument("--log_batch_size_to_tensorboard", action="store_true")
    g.add_argument("--log_world_size_to_tensorboard", action="store_true")
    g.add_argument("--log_timers_to_tensorboard", action="store_true",
                   help="per-span timer scalars each log_interval "
                        "(also raises --timing_log_level to 1)")
    g.add_argument("--profile", action="store_true",
                   help="torch.profiler trace window (CPU + CUDA "
                        "activities, a Chrome trace) for steps "
                        "[start, end)")
    g.add_argument("--profile_step_start", type=int, default=10)
    g.add_argument("--profile_step_end", type=int, default=12)
    g.add_argument("--profile_signal_steps", type=int, default=2,
                   help="steps traced when SIGUSR1 arms an on-demand "
                        "profile window mid-run (no --profile needed)")
    g.add_argument("--profile_dir", default=None,
                   help="trace output dir (default: --tensorboard_dir)")

    g = p.add_argument_group("telemetry")
    g.add_argument("--telemetry_dir", default=None,
                   help="write the structured event journal as rotating "
                        "JSONL under this dir")
    g.add_argument("--journal_max_mb", type=float, default=64.0,
                   help="rotate the journal past this size; 0 disables "
                        "rotation")
    g.add_argument("--metrics_port", type=int, default=None,
                   help="sidecar Prometheus /metrics listener for the "
                        "train loop (0 binds a free port)")
    g.add_argument("--flight_recorder", action="store_true",
                   help="arm the stall watchdog: no step heartbeat for "
                        "--flight_recorder_deadline_s dumps all-thread "
                        "stacks + the journal tail to a bundle dir")
    g.add_argument("--flight_recorder_deadline_s", type=float, default=600.0)
    g.add_argument("--flight_recorder_abort", action="store_true",
                   help="after dumping the stall bundle, SIGABRT")

    g = p.add_argument_group("async loop")
    g.add_argument("--no_async_loop", action="store_false", dest="async_loop",
                   default=True,
                   help="the synchronous loop (blocking data fetch, copy "
                        "and metrics read each step), the bitwise oracle "
                        "of the async default")
    g.add_argument("--prefetch_depth", type=int, default=2,
                   help="queue depth of the background batch prefetcher "
                        "(0 keeps the copy on the loop's path)")
    g.add_argument("--metrics_lag", type=int, default=1,
                   help="read step metrics K steps late so the next "
                        "step is queued while the current one runs")
    g.add_argument("--compilation_cache_dir", default=None,
                   help="refused: eager PyTorch compiles nothing")

    g = p.add_argument_group("fault tolerance")
    g.add_argument("--divergence_patience", type=int, default=100,
                   help="trip the divergence sentinel after this many "
                        "CONSECUTIVE non-finite/skipped optimizer steps "
                        "(0 disables)")
    g.add_argument("--loss_spike_factor", type=float, default=0.0,
                   help="trip when loss > factor * EMA(loss) for "
                        "--loss_spike_patience consecutive steps "
                        "(0 disables)")
    g.add_argument("--loss_spike_patience", type=int, default=5)
    g.add_argument("--rollback_on_divergence", action="store_true",
                   help="on a sentinel trip: reload the newest valid "
                        "checkpoint and fast-forward the data past the "
                        "poison window instead of aborting")
    g.add_argument("--max_rollbacks", type=int, default=3)
    g.add_argument("--preempt_save_timeout", type=float, default=600.0,
                   help="deadline (seconds) on the checkpoint a SIGTERM "
                        "forces; past it the process exits 75 (0 "
                        "disables the deadline)")
    g.add_argument("--step_timeout_s", type=float, default=0.0,
                   help="hang watchdog: no step for this many seconds "
                        "dumps a flight bundle and exits 70 (0 disables)")
    g.add_argument("--replay_check_interval", type=int, default=0,
                   help="every N steps re-run the step on its retained "
                        "state and batch and compare BITWISE (0 "
                        "disables)")
    g.add_argument("--log_data_fingerprint", action="store_true",
                   help="journal a crc32 of every host batch as data_crc")

    g = p.add_argument_group("checkpointing")
    g.add_argument("--save", default=None)
    g.add_argument("--load", default=None)
    g.add_argument("--save_interval", type=_save_interval, default=None,
                   help="checkpoint every N iterations (and once at the "
                        "end when --save is set), or 'auto' to derive "
                        "the cadence from measured commit latency "
                        "against the --preempt_save_timeout grace window")
    g.add_argument("--save_interval_floor", type=int, default=25,
                   help="lower clamp (steps) on the '--save_interval "
                        "auto' cadence")
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
    g.add_argument("--no_load_rng", action="store_true",
                   help="accepted: the port keeps no RNG state")
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
    g.add_argument("--dataloader_type", default="single",
                   choices=["single", "cyclic"],
                   help="single = sequential deterministic resume; cyclic "
                        "= epoch-seeded random order")
    g.add_argument("--num_workers", type=int, default=2,
                   help="prefetch depth of the threaded batch loader "
                        "(0 = synchronous)")
    g.add_argument("--data_cache_dir", default=None)
    g.add_argument("--eod_mask_loss", action="store_true")
    g.add_argument("--eod_token_id", type=int, default=None,
                   help="EOD id for --eod_mask_loss/--reset_position_ids "
                        "(the data is pre-tokenized; there is no "
                        "tokenizer to ask)")
    g.add_argument("--reset_position_ids", action="store_true",
                   help="restart position ids after each EOD")
    g.add_argument("--mask_prob", type=float, default=0.15,
                   help="BERT/T5 data: the share of tokens masked")
    g.add_argument("--short_seq_prob", type=float, default=0.1,
                   help="BERT/T5 data: the share of samples cut short")
    g.add_argument("--tokenizer_type", default="SentencePieceTokenizer")
    g.add_argument("--vocab_file", default=None)
    g.add_argument("--merges_file", default=None)
    g.add_argument("--merge_file", dest="merges_file", default=None,
                   help="the reference's spelling of --merges_file")
    g.add_argument("--tokenizer_model", default=None)
    g.add_argument("--vocab_extra_ids", type=int, default=None)
    g.add_argument("--no_new_tokens", action="store_false", dest="new_tokens",
                   help="do not add special/extra-id tokens in the "
                        "sentencepiece tokenizer")

    g = p.add_argument_group("distributed")
    g.add_argument("--tensor_model_parallel_size", type=int, default=1)
    g.add_argument("--pipeline_model_parallel_size", type=int, default=1)
    g.add_argument("--expert_model_parallel_size", type=int, default=1,
                   help="MoE expert-parallel degree (dedicated mesh axis; "
                        "E %% ep == 0, dp unconstrained)")
    g.add_argument("--context_parallel_size", type=int, default=1,
                   help="shard the sequence over this many ranks; "
                        "--attention_impl picks the scheme (xla/pallas: "
                        "all-gathered K/V; ring; ulysses)")
    g.add_argument("--num_layers_per_virtual_pipeline_stage", type=int,
                   default=None,
                   help="enables the interleaved schedule "
                        "(ref schedules.py:253-502)")
    g.add_argument("--sequence_parallel", action="store_true")
    g.add_argument("--use_distributed_optimizer", action="store_true")
    g.add_argument("--distributed_backend", default=None,
                   choices=["nccl", "gloo"],
                   help="the process group's backend: nccl on CUDA, gloo "
                        "on the CPU (default); gloo on CUDA only when "
                        "named here")

    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p


def bert_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """tools/pretrain_bert's flags (the JAX entry point's)."""
    g = p.add_argument_group("bert")
    g.add_argument("--mask_token_id", type=int, default=103)
    g.add_argument("--cls_token_id", type=int, default=101)
    g.add_argument("--sep_token_id", type=int, default=102)
    g.add_argument("--pad_token_id", type=int, default=0)
    g.add_argument("--no_binary_head", action="store_true")
    return p


def t5_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """tools/pretrain_t5's flags (the JAX entry point's)."""
    g = p.add_argument_group("t5")
    g.add_argument("--decoder_seq_length", type=int, default=128)
    g.add_argument("--encoder_num_layers", type=int, default=None,
                   help="encoder depth (default: --num_layers)")
    g.add_argument("--decoder_num_layers", type=int, default=None,
                   help="decoder depth (default: --num_layers)")
    g.add_argument("--bos_token_id", type=int, default=101)
    g.add_argument("--eos_token_id", type=int, default=102)
    g.add_argument("--pad_token_id", type=int, default=0)
    return p


def ict_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """tools/pretrain_ict's flags (the JAX entry point's)."""
    g = p.add_argument_group("ict")
    g.add_argument("--titles_data_path", type=str, default=None)
    g.add_argument("--ict_head_size", type=int, default=128)
    g.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    g.add_argument("--retriever_score_scaling", action="store_true")
    g.add_argument("--retriever_report_topk_accuracies", nargs="*",
                   type=int, default=[1, 5])
    g.add_argument("--query_in_block_prob", type=float, default=0.1)
    g.add_argument("--use_one_sent_docs", action="store_true")
    g.add_argument("--cls_token_id", type=int, default=101)
    g.add_argument("--sep_token_id", type=int, default=102)
    g.add_argument("--pad_token_id", type=int, default=0)
    return p


def task_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """tasks/main's flags (the JAX harness's, the ORQA retriever's
    finetuning flags among them)."""
    g = p.add_argument_group("tasks")
    g.add_argument("--task", required=True,
                   choices=["MNLI", "QQP", "RACE", "RET-FINETUNE-NQ"])
    g.add_argument("--train_data", nargs="+", required=True)
    g.add_argument("--valid_data", nargs="+", required=True)
    g.add_argument("--epochs", type=int, default=3)
    g.add_argument("--pretrained_checkpoint", type=str, default=None)
    g.add_argument("--cls_token_id", type=int, default=101)
    g.add_argument("--sep_token_id", type=int, default=102)
    g.add_argument("--pad_token_id", type=int, default=0)
    # RET-FINETUNE-NQ (tasks/orqa_finetune.py)
    g.add_argument("--retriever_seq_length", type=int, default=256)
    g.add_argument("--train_with_neg", action="store_true")
    g.add_argument("--train_hard_neg", type=int, default=0)
    g.add_argument("--val_av_rank_hard_neg", type=int, default=30)
    g.add_argument("--val_av_rank_other_neg", type=int, default=30)
    g.add_argument("--sample_rate", type=float, default=1.0)
    g.add_argument("--ict_head_size", type=int, default=128)
    g.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    g.add_argument("--retriever_score_scaling", action="store_true")
    g.add_argument("--retriever_report_topk_accuracies", nargs="*",
                   type=int, default=[1, 5, 20])
    return p


def retrieval_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """tools/build_retrieval_index's and tasks/orqa's flags (the JAX
    tools')."""
    g = p.add_argument_group("retrieval")
    g.add_argument("--titles_data_path", type=str, default=None)
    g.add_argument("--ict_head_size", type=int, default=128)
    g.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    g.add_argument("--cls_token_id", type=int, default=101)
    g.add_argument("--sep_token_id", type=int, default=102)
    g.add_argument("--pad_token_id", type=int, default=0)
    return p


def _save_interval(value: str):
    """An integer, or the string "auto"."""
    if value.lower() == "auto":
        return "auto"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--save_interval {value!r}: an integer or 'auto'") from None


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


#: the MoE flags, each overriding the preset only when passed (the JAX
#: CLI's _moe_overrides)
_MOE_FLAGS = ("num_experts", "moe_top_k", "moe_capacity_factor",
              "moe_aux_loss_coeff", "moe_z_loss_coeff", "moe_renorm_gates",
              "moe_group_size", "moe_dispatch", "moe_ep_buffer_factor")


def _moe_overrides(args) -> dict:
    """The MoE knobs that were passed (None: absent, keep the preset's)."""
    return {name: getattr(args, name) for name in _MOE_FLAGS
            if getattr(args, name, None) is not None}


def _fp8_overrides(args) -> dict:
    """--fp8_e4m3 / --fp8_hybrid (mutually exclusive) -> fp8_format, and
    --fp8_margin / --no_fp8_wgrad when passed (the JAX CLI's
    _fp8_overrides)."""
    if getattr(args, "fp8_e4m3", False) and getattr(args, "fp8_hybrid",
                                                     False):
        raise ValueError("cannot train with both fp8 e4m3 and hybrid "
                         "formatting (pick --fp8_e4m3 or --fp8_hybrid)")
    out = {name: getattr(args, name) for name in ("fp8_margin", "fp8_wgrad")
           if getattr(args, name, None) is not None}
    if getattr(args, "fp8_e4m3", False):
        out["fp8_format"] = "e4m3"
    elif getattr(args, "fp8_hybrid", False):
        out["fp8_format"] = "hybrid"
    return out


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


def encoder_model_kwargs(args) -> dict:
    """The encoder families' model arguments from the flags (the JAX
    CLI's non-preset path): depth, widths, the vocabulary padded to
    --make_vocab_size_divisible_by, the length (and the position table's
    rows when --max_position_embeddings is given; the configs default it
    to the length), the precision and the attention route, as
    bert_config, t5_config and biencoder_config take them."""
    from megatron_tpu_torch.models.presets import pad_vocab

    required = ("num_layers", "hidden_size", "num_attention_heads",
                "vocab_size")
    missing = [r for r in required if getattr(args, r) is None]
    if missing:
        raise ValueError(f"missing required model args: {missing}")
    kw = {}
    if args.max_position_embeddings is not None:
        kw["max_position_embeddings"] = args.max_position_embeddings
    return dict(kw, num_layers=args.num_layers, hidden_size=args.hidden_size,
                num_attention_heads=args.num_attention_heads,
                vocab_size=pad_vocab(args.vocab_size,
                                     args.make_vocab_size_divisible_by,
                                     args.tensor_model_parallel_size),
                seq_length=args.seq_length, params_dtype=_dtype_name(args),
                attention_impl=args.attention_impl)


#: the task heads --head_lr_mult scales (the JAX CLI's pattern): GLUE's
#: and RACE's classification_head, the ICT heads, BERT's binary head
HEAD_PATTERN = "(^|/)(classification_head|ict_head|binary_head)(/|$)"


def args_to_run_config(args, model: Optional[ModelConfig] = None
                       ) -> RunConfig:
    """The run config of the flags; `model` (an encoder family's, built
    by its entry point) replaces the preset."""
    if model is None:
        model = _preset_model(args)

    cp = args.context_parallel_size
    if cp > 1 and model.seq_length % cp:
        # the JAX package warns and runs its dense path; here no rank can
        # hold an uneven piece of the sequence
        raise ValueError(
            f"--context_parallel_size {cp} must divide the sequence "
            f"length {model.seq_length}")
    vpp = None
    per_stage = args.num_layers_per_virtual_pipeline_stage
    if per_stage:
        # the JAX CLI's mapping (megatron_tpu/arguments.py:615-627)
        pp = args.pipeline_model_parallel_size
        vpp = model.num_layers // (pp * per_stage)
        if vpp * pp * per_stage != model.num_layers:
            raise ValueError(
                f"num_layers={model.num_layers} not divisible by "
                f"pp*per_stage={pp}*{per_stage}")
    parallel = ParallelConfig(
        tensor_parallel=args.tensor_model_parallel_size,
        pipeline_parallel=args.pipeline_model_parallel_size,
        context_parallel=args.context_parallel_size,
        expert_parallel=args.expert_model_parallel_size,
        sequence_parallel=args.sequence_parallel,
        virtual_pipeline_parallel=vpp if (vpp or 0) > 1 else None,
    ).validate()

    optimizer = OptimizerConfig(
        use_distributed_optimizer=args.use_distributed_optimizer,
        lr=args.lr, min_lr=args.min_lr, lr_decay_style=args.lr_decay_style,
        lr_warmup_iters=args.lr_warmup_iters,
        lr_warmup_fraction=args.lr_warmup_fraction,
        param_group_mults=(((HEAD_PATTERN, args.head_lr_mult, 1.0),)
                           if args.head_lr_mult != 1.0 else ()),
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_eps=args.adam_eps, weight_decay=args.weight_decay,
        clip_grad=args.clip_grad)
    if args.wandb_api_key and "WANDB_API_KEY" not in os.environ:
        os.environ["WANDB_API_KEY"] = args.wandb_api_key
    auto = args.save_interval == "auto"
    training = TrainingConfig(
        micro_batch_size=args.micro_batch_size,
        global_batch_size=args.global_batch_size or args.micro_batch_size,
        train_iters=args.train_iters, train_samples=args.train_samples,
        eval_interval=args.eval_interval,
        eval_iters=args.eval_iters, seed=args.seed,
        recompute_granularity=recompute_policy(args),
        save=args.save, load=args.load,
        save_interval=None if auto else args.save_interval,
        save_interval_auto=auto,
        save_interval_floor=args.save_interval_floor,
        exit_interval=args.exit_interval,
        exit_duration_in_mins=args.exit_duration_in_mins,
        finetune=args.finetune, no_load_optim=args.no_load_optim,
        no_load_rng=args.no_load_rng, async_save=args.async_save,
        keep_latest_k=args.keep_latest_k,
        async_loop=args.async_loop, prefetch_depth=args.prefetch_depth,
        metrics_lag=args.metrics_lag,
        compilation_cache_dir=args.compilation_cache_dir,
        divergence_patience=args.divergence_patience,
        loss_spike_factor=args.loss_spike_factor,
        loss_spike_patience=args.loss_spike_patience,
        rollback_on_divergence=args.rollback_on_divergence,
        max_rollbacks=args.max_rollbacks,
        preempt_save_timeout=args.preempt_save_timeout,
        step_timeout_s=args.step_timeout_s,
        replay_check_interval=args.replay_check_interval,
        log_data_fingerprint=args.log_data_fingerprint,
        log_interval=args.log_interval,
        tensorboard_dir=args.tensorboard_dir,
        wandb_logger=args.wandb_logger, wandb_project=args.wandb_project,
        wandb_name=args.wandb_name,
        timing_log_level=args.timing_log_level,
        log_timers_to_tensorboard=args.log_timers_to_tensorboard,
        profile=args.profile, profile_step_start=args.profile_step_start,
        profile_step_end=args.profile_step_end,
        profile_signal_steps=args.profile_signal_steps,
        profile_dir=args.profile_dir, telemetry_dir=args.telemetry_dir,
        journal_max_mb=args.journal_max_mb, metrics_port=args.metrics_port,
        flight_recorder=args.flight_recorder,
        flight_recorder_deadline_s=args.flight_recorder_deadline_s,
        flight_recorder_abort=args.flight_recorder_abort,
        eval_only=args.eval_only, skip_iters=tuple(args.skip_iters or ()),
        log_params_norm=args.log_params_norm,
        log_memory=args.log_memory_to_tensorboard,
        log_batch_size=args.log_batch_size_to_tensorboard,
        log_world_size=args.log_world_size_to_tensorboard,
        scalar_loss_mask=args.scalar_loss_mask,
        variable_seq_lengths=args.variable_seq_lengths,
        metrics=tuple(args.metrics))
    return RunConfig(model=model, parallel=parallel, optimizer=optimizer,
                     training=training).validate()


def _preset_model(args) -> ModelConfig:
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
    overrides.update(_moe_overrides(args))
    overrides.update(_fp8_overrides(args))
    return ModelConfig(**{**model.__dict__, **overrides}).validate()
