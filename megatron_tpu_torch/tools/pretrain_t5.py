"""T5 span-corruption pretraining entry point (counterpart of the repo's
pretrain_t5.py): a sentence-level indexed dataset, span-corrupted with
sentinel ids from the top of the padded vocabulary (--vocab_extra_ids,
100 when not given), trained through TrainLoop's init_params_fn,
param_specs_fn and loss_fn hooks on --device (default "cuda"), one
process or one rank a process under python -m torch.distributed.run with
--tensor_model_parallel_size, --pipeline_model_parallel_size (T5's
interleaved encoder-decoder ring, training/t5_pipeline.py: each stage an
encoder and a decoder slice) and --use_distributed_optimizer (data
parallelism takes the rest of the world).

    python -m megatron_tpu_torch.tools.pretrain_t5 --num_layers 12 \\
        --hidden_size 768 --num_attention_heads 12 --seq_length 512 \\
        --decoder_seq_length 128 --vocab_size 32128 --vocab_extra_ids 100 \\
        --data_path data/sents --micro_batch_size 16 \\
        --global_batch_size 256 --train_iters 100000

--encoder_num_layers / --decoder_num_layers give the stacks their own
depths. Every attention of T5 takes the dense path, as in the JAX
package. At pp > 1 --num_layers_per_virtual_pipeline_stage is refused
(the ring is already interleaved, the JAX entry point's rule), and so is
--sequence_parallel for T5 at any topology (ROADMAP.md item 11c).
"""

from __future__ import annotations

import torch


def run_config(args):
    """The run config of the flags: models/t5.t5_config at their
    widths."""
    from megatron_tpu_torch.arguments import (
        args_to_run_config, encoder_model_kwargs,
    )
    from megatron_tpu_torch.models.t5 import t5_config

    if args.pipeline_model_parallel_size > 1 and \
            args.num_layers_per_virtual_pipeline_stage:
        raise SystemExit(
            "T5 pp>1 is already interleaved (encoder+decoder chunks per "
            "stage); --num_layers_per_virtual_pipeline_stage doesn't apply")
    if args.sequence_parallel and args.tensor_model_parallel_size > 1:
        raise ValueError("T5 under sequence parallelism is not ported: "
                         "ROADMAP.md item 11c")
    return args_to_run_config(args, model=t5_config(
        **encoder_model_kwargs(args),
        decoder_seq_length=args.decoder_seq_length,
        encoder_num_layers=args.encoder_num_layers,
        decoder_num_layers=args.decoder_num_layers))


def train_dataset(args, cfg):
    """The T5Dataset of --data_path, sized for the run, its sentinels the
    top --vocab_extra_ids ids of the padded vocabulary."""
    from megatron_tpu_torch.data.indexed_dataset import make_dataset
    from megatron_tpu_torch.data.t5_dataset import T5Dataset

    if not args.data_path:
        raise SystemExit("--data_path is required")
    n_extra = 100 if args.vocab_extra_ids is None else args.vocab_extra_ids
    if n_extra <= 0:
        raise SystemExit("T5 span corruption needs sentinel ids: pass "
                         "--vocab_extra_ids N (the reference uses 100)")
    t, v = cfg.training, cfg.model.vocab_size
    return T5Dataset(
        make_dataset(args.data_path[0]),
        num_samples=(t.train_iters or 1000) * t.global_batch_size,
        max_seq_length=cfg.model.seq_length,
        max_seq_length_dec=args.decoder_seq_length,
        bos_token=args.bos_token_id, eos_token=args.eos_token_id,
        pad_token=args.pad_token_id,
        sentinel_tokens=list(range(v - n_extra, v)), seed=t.seed,
        masked_lm_prob=args.mask_prob, short_seq_prob=args.short_seq_prob)


def main(argv=None, log=print):
    """Returns the finished TrainLoop (training/pretrain.py)."""
    from megatron_tpu_torch.arguments import parse_args, t5_args
    from megatron_tpu_torch.training.pretrain import run_distributed

    args = parse_args(argv, t5_args)
    cfg = run_config(args)
    return run_distributed(args, lambda: _main(args, cfg, log))


def loop_hooks(cfg):
    """TrainLoop's task hooks for T5; at pp > 1 the stacks cut over the
    stages and the interleaved ring as the pipeline_loss_factory."""
    import functools

    from megatron_tpu_torch.models.t5 import (
        t5_init_params, t5_loss, t5_param_specs,
    )
    from megatron_tpu_torch.training.t5_pipeline import T5Pipeline

    pp = cfg.parallel.pipeline_parallel > 1
    recompute = cfg.training.recompute_granularity
    return dict(
        init_params_fn=t5_init_params,
        param_specs_fn=functools.partial(t5_param_specs, pipeline=pp),
        loss_fn=lambda mc, p, b, mesh=None: t5_loss(
            mc, p, b, recompute=recompute, mesh=mesh),
        pipeline_loss_factory=T5Pipeline if pp else None)


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
        return build_data_loader(train_ds, sampler, prefetch=args.num_workers)

    loop = task_loop(cfg, log=log, device=local_device(args.device),
                     **loop_hooks(cfg))
    return run_task_loop(loop, train_iter_factory)


if __name__ == "__main__":
    main()
