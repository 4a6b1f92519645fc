"""ICT (inverse cloze task) biencoder pretraining entry point
(counterpart of the repo's pretrain_ict.py): blocks of a sentence-level
indexed dataset, optionally prefixed with the titles of a title dataset
(--titles_data_path, one title sequence per document), trained through
TrainLoop's init_params_fn, param_specs_fn, loss_fn and
fixed_num_microbatches hooks on --device (default "cuda"), one process
or one rank a process under python -m torch.distributed.run with
--tensor_model_parallel_size (and --sequence_parallel) and
--use_distributed_optimizer (data parallelism takes the rest; the
in-batch softmax gathers every data rank's embeddings).

    python -m megatron_tpu_torch.tools.pretrain_ict --num_layers 12 \\
        --hidden_size 768 --num_attention_heads 12 --seq_length 256 \\
        --vocab_size 30592 --data_path data/sents \\
        --titles_data_path data/titles --ict_head_size 128 \\
        --retriever_score_scaling --global_batch_size 128 --train_iters 1000

The in-batch softmax takes the whole global batch as its negatives, so
each step is one microbatch of --global_batch_size rows. The towers run
without dropout (the port has none; the JAX entry point's towers default
to 0.1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def run_config(args):
    """The run config of the flags: models/biencoder.biencoder_config at
    their widths."""
    from megatron_tpu_torch.arguments import (
        args_to_run_config, encoder_model_kwargs,
    )
    from megatron_tpu_torch.models.biencoder import biencoder_config

    return args_to_run_config(args, model=biencoder_config(
        **encoder_model_kwargs(args)))


def train_dataset(args, cfg):
    """The ICTDataset of --data_path (and --titles_data_path), sized for
    the run."""
    from megatron_tpu_torch.data.ict_dataset import ICTDataset
    from megatron_tpu_torch.data.indexed_dataset import make_dataset

    if not args.data_path:
        raise SystemExit("--data_path is required")
    t = cfg.training
    titles = (make_dataset(args.titles_data_path) if args.titles_data_path
              else None)
    return ICTDataset(
        make_dataset(args.data_path[0]), titles,
        num_samples=(t.train_iters or 1000) * t.global_batch_size,
        max_seq_length=cfg.model.seq_length, cls_token=args.cls_token_id,
        sep_token=args.sep_token_id, pad_token=args.pad_token_id,
        seed=t.seed, query_in_block_prob=args.query_in_block_prob,
        use_titles=titles is not None,
        use_one_sent_docs=args.use_one_sent_docs)


def collate(items):
    """A batch of ICT items without their block_data."""
    return {k: np.stack([it[k] for it in items])
            for k in items[0] if k != "block_data"}


def loop_hooks(args, cfg):
    """TrainLoop's task hooks for the towers and the in-batch softmax."""
    from megatron_tpu_torch.models.biencoder import (
        biencoder_init_params, biencoder_loss, biencoder_param_specs,
    )

    shared = args.biencoder_shared_query_context_model
    topk = tuple(args.retriever_report_topk_accuracies)
    recompute = cfg.training.recompute_granularity

    def loss_fn(mc, p, b, mesh=None, dropout_key=None):
        return biencoder_loss(mc, p, b,
                              score_scaling=args.retriever_score_scaling,
                              topk=topk, recompute=recompute, mesh=mesh,
                              dropout_key=dropout_key)

    return dict(
        init_params_fn=lambda mc, seed, device: biencoder_init_params(
            mc, seed, args.ict_head_size, shared, device),
        param_specs_fn=functools.partial(
            biencoder_param_specs, ict_head_size=args.ict_head_size,
            shared=shared),
        loss_fn=loss_fn, fixed_num_microbatches=1)


def main(argv=None, log=print):
    """Returns the finished TrainLoop (training/pretrain.py)."""
    from megatron_tpu_torch.arguments import ict_args, parse_args
    from megatron_tpu_torch.training.pretrain import run_distributed

    args = parse_args(argv, ict_args)
    cfg = run_config(args)
    return run_distributed(args, lambda: _main(args, cfg, log))


def _main(args, cfg, log):
    from megatron_tpu_torch.data.samplers import (
        PretrainingSampler, build_data_loader,
    )
    from megatron_tpu_torch.parallel.distributed import local_device
    from megatron_tpu_torch.training.pretrain import task_loop, run_task_loop

    train_ds = train_dataset(args, cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def train_iter_factory(consumed, gbs):
        sampler = PretrainingSampler(len(train_ds), consumed, gbs, 0, 1)
        return build_data_loader(train_ds, sampler, collate_fn=collate,
                                 prefetch=args.num_workers)

    loop = task_loop(cfg, log=log, device=local_device(args.device),
                     **loop_hooks(args, cfg))
    return run_task_loop(loop, train_iter_factory)


if __name__ == "__main__":
    main()
