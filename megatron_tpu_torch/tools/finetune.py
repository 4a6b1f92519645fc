"""Instruction finetuning entry point (counterpart of the repo's
finetune.py): loads a converted checkpoint (--load, typically written by
tools/hf_to_native) and trains on paired text/role instruction data
(--data_type instruction, the default: assistant tokens weigh 1, other
text --scalar_loss_mask, padding 0) or hands over to pretrain_gpt
(--data_type gpt).

    python -m megatron_tpu_torch.tools.finetune --model_name llama2-7B \\
        --load ckpts/llama2-7b --finetune --save ckpts/llama2-7b-sft \\
        --save_interval 100 --data_path data/chats --seq_length 4096 \\
        --attention_impl pallas --bf16 --micro_batch_size 1 \\
        --global_batch_size 2 --train_iters 1000 --lr 1e-5 \\
        --lr_decay_style constant --scalar_loss_mask 0.1

--data_path is the prefix that tools/preprocess_instruct_data wrote
(PREFIX-text and PREFIX-role). Runs on --device (default "cuda").
"""

from __future__ import annotations

import torch


def extra_args(parser):
    g = parser.add_argument_group("finetuning")
    g.add_argument("--data_type", default="instruction",
                   choices=["gpt", "instruction"])
    g.add_argument("--pad_token_id", type=int, default=0)
    return parser


def main(argv=None, log=print):
    """Returns the finished TrainLoop (training/pretrain.py)."""
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.data.instruction_dataset import (
        InstructionDataset, instruction_collator,
    )
    from megatron_tpu_torch.data.samplers import (
        PretrainingRandomSampler, build_data_loader,
    )
    from megatron_tpu_torch.training.pretrain import pretrain

    args = parse_args(argv, extra_args_provider=extra_args)
    if not args.data_path:
        raise SystemExit("--data_path is required")
    if args.data_type == "gpt":
        from megatron_tpu_torch.tools import pretrain_gpt

        return pretrain_gpt.main(argv, log=log,
                                 extra_args_provider=extra_args)
    cfg = args_to_run_config(args)
    t = cfg.training
    if not t.train_iters:
        raise SystemExit("--train_iters is required")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_ds = InstructionDataset(args.data_path[0], seed=t.seed)

    def collate(items):
        return instruction_collator(
            items, seq_length=cfg.model.seq_length,
            pad_token=args.pad_token_id,
            scalar_loss_mask=t.scalar_loss_mask,
            variable_seq_lengths=t.variable_seq_lengths)

    def train_iter_factory(consumed, gbs):
        sampler = PretrainingRandomSampler(
            total_samples=len(train_ds), consumed_samples=consumed,
            micro_batch_size=gbs, data_parallel_rank=0,
            data_parallel_size=1, seed=t.seed)
        return build_data_loader(train_ds, sampler, collate_fn=collate,
                                 prefetch=0)

    return pretrain(cfg, train_iter_factory, log=log, device=args.device)


if __name__ == "__main__":
    main()
