"""BERT pretraining entry point (counterpart of the repo's
pretrain_bert.py): masked-LM plus the sentence-order (binary) head on a
sentence-level indexed dataset (one sequence per sentence, document
boundaries kept: tools/preprocess_data with a sentence splitter
upstream), trained through TrainLoop's loss_fn hook on --device
(default "cuda"), one process or one rank a process under
python -m torch.distributed.run with --tensor_model_parallel_size (and
--sequence_parallel) and --use_distributed_optimizer (data parallelism
takes the rest of the world; pipeline parallelism is refused, as the
JAX loop refuses a task loss at pp > 1).

    python -m megatron_tpu_torch.tools.pretrain_bert --num_layers 24 \\
        --hidden_size 1024 --num_attention_heads 16 --seq_length 512 \\
        --vocab_size 30592 --data_path data/sents --mask_token_id 103 \\
        --cls_token_id 101 --sep_token_id 102 --pad_token_id 0 \\
        --micro_batch_size 8 --global_batch_size 256 --train_iters 10000
    python -m torch.distributed.run --nproc_per_node 8 \
        -m megatron_tpu_torch.tools.pretrain_bert ... \
        --tensor_model_parallel_size 2 --sequence_parallel \
        --use_distributed_optimizer

The model is models/bert.bert_config at the flags' widths (linear and
QKV biases, exact GELU, LayerNorm, the tied MLM decoder): the
architecture tasks/main finetunes, so its checkpoints load there. (The
JAX entry point builds the CLI's generic model instead, whose biases
follow --use_bias.) --no_binary_head is refused: the parameter table
keeps the MLM head's leaves only with the binary head, as the JAX
package's does. Attention takes the dense path: every BERT batch carries a
padding mask, which no flash kernel covers, as in the JAX package.
"""

from __future__ import annotations

import torch


def run_config(args):
    """The run config of the flags: models/bert.bert_config at their
    widths."""
    from megatron_tpu_torch.arguments import (
        args_to_run_config, encoder_model_kwargs,
    )
    from megatron_tpu_torch.models.bert import bert_config

    if args.no_binary_head:
        # the parameter table ties the MLM head's leaves to the binary
        # head's flag (the JAX package's table)
        raise ValueError(
            "--no_binary_head: the parameter table holds the MLM head only "
            "with the binary head (as the JAX package's does); BERT "
            "without the SOP head is ROADMAP.md item 11c")
    return args_to_run_config(args, model=bert_config(
        **encoder_model_kwargs(args)))


def train_dataset(args, cfg):
    """The BertDataset of --data_path, sized for the run."""
    from megatron_tpu_torch.data.bert_dataset import BertDataset
    from megatron_tpu_torch.data.indexed_dataset import make_dataset

    if not args.data_path:
        raise SystemExit("--data_path is required")
    t, model = cfg.training, cfg.model
    return BertDataset(
        make_dataset(args.data_path[0]),
        num_samples=(t.train_iters or 1000) * t.global_batch_size,
        max_seq_length=model.seq_length, mask_token=args.mask_token_id,
        cls_token=args.cls_token_id, sep_token=args.sep_token_id,
        pad_token=args.pad_token_id, vocab_size=model.vocab_size,
        seed=t.seed, masked_lm_prob=args.mask_prob,
        short_seq_prob=args.short_seq_prob)


def main(argv=None, log=print):
    """Returns the finished TrainLoop (training/pretrain.py)."""
    from megatron_tpu_torch.arguments import bert_args, parse_args
    from megatron_tpu_torch.training.pretrain import run_distributed

    args = parse_args(argv, bert_args)
    cfg = run_config(args)
    return run_distributed(args, lambda: _main(args, cfg, log))


def _main(args, cfg, log):
    from megatron_tpu_torch.data.samplers import (
        PretrainingSampler, build_data_loader,
    )
    from megatron_tpu_torch.models.bert import bert_loss
    from megatron_tpu_torch.parallel.distributed import local_device
    from megatron_tpu_torch.training.pretrain import task_loop, run_task_loop

    train_ds = train_dataset(args, cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def train_iter_factory(consumed, gbs):
        sampler = PretrainingSampler(len(train_ds), consumed, gbs, 0, 1)
        return build_data_loader(train_ds, sampler, prefetch=args.num_workers)

    recompute = cfg.training.recompute_granularity
    loop = task_loop(
        cfg, log=log, device=local_device(args.device),
        loss_fn=lambda mc, p, b, mesh=None: bert_loss(
            mc, p, b, recompute=recompute, mesh=mesh))
    return run_task_loop(loop, train_iter_factory)


if __name__ == "__main__":
    main()
