"""GPT-family pretraining entry point (counterpart of the repo's
pretrain_gpt.py): parses the flags, builds the datasets from --data_path,
and runs the training loop on --device (default "cuda").

    python -m megatron_tpu_torch.tools.pretrain_gpt --model_name llama2-7B \\
        --num_layers 8 --seq_length 4096 --attention_impl pallas \\
        --recompute_granularity selective --micro_batch_size 1 \\
        --global_batch_size 2 --train_iters 8 --data_path corpus_text_document

The data flags are the JAX entry point's: --dataloader_type cyclic
(epoch-seeded random order), --eod_token_id with --eod_mask_loss and
--reset_position_ids, --num_workers (the threaded batch loader's depth),
--data_cache_dir (the dataset index cache) and --train_samples (the run
length in samples when --train_iters is not given). --device cpu runs
the flash kernels' plain versions (with a small preset, e.g.
--model_name tiny --fp32).

Under python -m torch.distributed.run each process is one rank: the
process group comes from the launcher's environment (NCCL on CUDA, gloo
on the CPU or with --distributed_backend gloo), the topology from
--tensor_model_parallel_size, --pipeline_model_parallel_size,
--num_layers_per_virtual_pipeline_stage, --sequence_parallel and
--use_distributed_optimizer (data parallelism takes the rest of the
world), and rank 0 logs:

    python -m torch.distributed.run --nproc_per_node 8 \\
        -m megatron_tpu_torch.tools.pretrain_gpt --model_name llama2-7B \\
        --tensor_model_parallel_size 2 --sequence_parallel \\
        --pipeline_model_parallel_size 2 --use_distributed_optimizer ...
"""

from __future__ import annotations

import dataclasses

import torch


def main(argv=None, log=print, extra_args_provider=None):
    """Returns the finished TrainLoop (training/pretrain.py).
    extra_args_provider: a caller's own flags (tools/finetune's)."""
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.training.pretrain import run_distributed

    args = parse_args(argv, extra_args_provider)
    cfg = args_to_run_config(args)
    return run_distributed(args, lambda: _main(args, cfg, log))


def _main(args, cfg, log):
    from megatron_tpu_torch.data.gpt_dataset import build_gpt_datasets
    from megatron_tpu_torch.data.samplers import (
        PretrainingRandomSampler, PretrainingSampler, build_data_loader,
    )
    from megatron_tpu_torch.parallel.distributed import local_device
    from megatron_tpu_torch.training.pretrain import gpt_collate, pretrain

    if not args.data_path:
        raise SystemExit("--data_path is required")
    t = cfg.training
    if not t.train_iters:
        if not t.train_samples:
            raise SystemExit("--train_iters or --train_samples is required")
        t = dataclasses.replace(
            t, train_iters=t.train_samples // t.global_batch_size)
        cfg = dataclasses.replace(cfg, training=t)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n_train = t.train_iters * t.global_batch_size
    n_valid = (t.train_iters // max(t.eval_interval, 1) + 1) * t.eval_iters \
        * t.global_batch_size
    def build():
        return build_gpt_datasets(
            args.data_path, args.split, cfg.model.seq_length,
            (n_train, n_valid, t.eval_iters * t.global_batch_size),
            seed=t.seed, cache_dir=args.data_cache_dir)

    import torch.distributed as dist

    if args.data_cache_dir and dist.is_initialized():
        # rank 0 writes the index cache, the others read it afterwards
        if dist.get_rank() == 0:
            train_ds, valid_ds, _ = build()
        dist.barrier()
        if dist.get_rank() != 0:
            train_ds, valid_ds, _ = build()
    else:
        train_ds, valid_ds, _ = build()

    eod = args.eod_token_id
    if (args.eod_mask_loss or args.reset_position_ids) and eod is None:
        raise SystemExit(
            "--eod_mask_loss/--reset_position_ids need --eod_token_id "
            "(the data is pre-tokenized; there is no tokenizer to ask)")

    def collate(items):
        return gpt_collate(items, eod_token=eod,
                           eod_mask_loss=args.eod_mask_loss,
                           reset_position_ids=args.reset_position_ids)

    def train_iter_factory(consumed, gbs):
        if args.dataloader_type == "cyclic":
            sampler = PretrainingRandomSampler(
                total_samples=len(train_ds), consumed_samples=consumed,
                micro_batch_size=gbs, data_parallel_rank=0,
                data_parallel_size=1, seed=t.seed)
        else:
            sampler = PretrainingSampler(
                total_samples=len(train_ds), consumed_samples=consumed,
                micro_batch_size=gbs, data_parallel_rank=0,
                data_parallel_size=1)
        return build_data_loader(train_ds, sampler, collate_fn=collate,
                                 prefetch=args.num_workers)

    def valid_iter_factory():
        if valid_ds is None:
            return iter(())
        sampler = PretrainingSampler(
            total_samples=len(valid_ds), consumed_samples=0,
            micro_batch_size=t.global_batch_size, data_parallel_rank=0,
            data_parallel_size=1)
        return build_data_loader(valid_ds, sampler, collate_fn=collate,
                                 prefetch=args.num_workers)

    return pretrain(cfg, train_iter_factory, valid_iter_factory, log=log,
                    device=local_device(args.device))


if __name__ == "__main__":
    main()
