"""GPT-family pretraining entry point (counterpart of the repo's
pretrain_gpt.py): parses the flags, builds the datasets from --data_path,
and runs the training loop on --device (default "cuda").

    python -m megatron_tpu_torch.tools.pretrain_gpt --model_name llama2-7B \\
        --num_layers 8 --seq_length 4096 --attention_impl pallas \\
        --recompute_granularity selective --micro_batch_size 1 \\
        --global_batch_size 2 --train_iters 8 --data_path corpus_text_document

--device cpu runs the flash kernels' plain versions (with a small preset,
e.g. --model_name tiny --fp32).
"""

from __future__ import annotations

import torch


def main(argv=None, log=print):
    """Returns the finished TrainLoop (training/pretrain.py)."""
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.data.gpt_dataset import build_gpt_datasets
    from megatron_tpu_torch.data.samplers import (
        PretrainingSampler, build_data_loader,
    )
    from megatron_tpu_torch.training.pretrain import gpt_collate, pretrain

    args = parse_args(argv)
    cfg = args_to_run_config(args)
    if not args.data_path:
        raise SystemExit("--data_path is required")
    t = cfg.training
    if not t.train_iters:
        raise SystemExit("--train_iters is required")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n_train = t.train_iters * t.global_batch_size
    n_valid = (t.train_iters // max(t.eval_interval, 1) + 1) * t.eval_iters \
        * t.global_batch_size
    train_ds, valid_ds, _ = build_gpt_datasets(
        args.data_path, args.split, cfg.model.seq_length,
        (n_train, n_valid, t.eval_iters * t.global_batch_size), seed=t.seed)

    def train_iter_factory(consumed, gbs):
        sampler = PretrainingSampler(
            total_samples=len(train_ds), consumed_samples=consumed,
            micro_batch_size=gbs, data_parallel_rank=0,
            data_parallel_size=1)
        return build_data_loader(train_ds, sampler, collate_fn=gpt_collate,
                                 prefetch=0)

    def valid_iter_factory():
        if valid_ds is None:
            return iter(())
        sampler = PretrainingSampler(
            total_samples=len(valid_ds), consumed_samples=0,
            micro_batch_size=t.global_batch_size, data_parallel_rank=0,
            data_parallel_size=1)
        return build_data_loader(valid_ds, sampler, collate_fn=gpt_collate,
                                 prefetch=0)

    return pretrain(cfg, train_iter_factory, valid_iter_factory, log=log,
                    device=args.device)


if __name__ == "__main__":
    main()
