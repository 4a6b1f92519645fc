"""The task finetune and eval harness (counterpart of the repo's
tasks/main.py): GLUE's MNLI and QQP (sentence-pair classification) and
RACE (multiple choice) over a BERT encoder, and RET-FINETUNE-NQ (the
ORQA retriever's supervised finetuning, tasks/orqa_finetune.py), on
--device (default "cuda"), one process or one rank a process under
python -m torch.distributed.run with --tensor_model_parallel_size (and
--sequence_parallel) and --use_distributed_optimizer.

    python -m megatron_tpu_torch.tasks.main --task MNLI \\
        --train_data glue/MNLI/train.tsv \\
        --valid_data glue/MNLI/dev_matched.tsv \\
        --pretrained_checkpoint ckpts/bert --num_layers 24 \\
        --hidden_size 1024 --num_attention_heads 16 --seq_length 128 \\
        --vocab_size 30592 --tokenizer_type HF \\
        --tokenizer_model bert-large-uncased --epochs 3 \\
        --micro_batch_size 8 --global_batch_size 128 --lr 5e-5 \\
        --lr_decay_style linear --lr_warmup_fraction 0.065 \\
        --head_lr_mult 10.0

--pretrained_checkpoint loads the encoder leaves of a BERT checkpoint
(tools/pretrain_bert's) into the classification tree; the heads start
fresh (tasks/finetune_utils.py). The position table keeps the
checkpoint's rows (its max_position_embeddings) unless
--max_position_embeddings is given, so a --seq_length shorter than the
pretraining one reads the same table. The run length is --epochs over the
training set. RET-FINETUNE-NQ trains the biencoder at
--retriever_seq_length on DPR JSON (--train_data, --valid_data), from a
biencoder checkpoint given as --pretrained_checkpoint.
"""

from __future__ import annotations

import dataclasses

import torch


def _build_task_tokenizer(args, vocab_size):
    from megatron_tpu_torch.tokenizer.tokenizer import build_tokenizer

    return build_tokenizer(args.tokenizer_type, vocab_size=vocab_size,
                           tokenizer_model=args.tokenizer_model,
                           name_or_path=args.tokenizer_model,
                           vocab_file=args.vocab_file,
                           merges_file=args.merges_file,
                           vocab_extra_ids=args.vocab_extra_ids or 0,
                           new_tokens=args.new_tokens)


def _finetune_cfg(cfg, epochs: int, n_train: int):
    """train_iters from the epochs over n_train samples."""
    t = cfg.training
    iters = max(1, epochs * n_train // t.global_batch_size)
    return dataclasses.replace(
        cfg, training=dataclasses.replace(t, train_iters=iters)), iters


def run_config(args):
    """The run config of the flags: models/classification's BERT encoder
    at their widths, its position table the pretrained checkpoint's."""
    from megatron_tpu_torch.arguments import (
        args_to_run_config, encoder_model_kwargs,
    )
    from megatron_tpu_torch.models.classification import (
        classification_config,
    )

    if args.pretrained_checkpoint and args.max_position_embeddings is None:
        # the encoder's position table as it was pretrained (BERT at S 512
        # finetunes MNLI at S 128 over the same 512 rows)
        from megatron_tpu_torch.training.checkpointing import (
            saved_run_config,
        )

        saved = saved_run_config(args.pretrained_checkpoint).get("model", {})
        args.max_position_embeddings = saved.get("max_position_embeddings")
    return args_to_run_config(args, model=classification_config(
        **encoder_model_kwargs(args)))


def task_datasets(args, model):
    """(num_classes, train dataset, valid dataset) of --task."""
    from megatron_tpu_torch.tasks.glue import (
        GlueDataset, load_mnli, load_qqp,
    )
    from megatron_tpu_torch.tasks.race import RaceDataset, load_race

    tok = _build_task_tokenizer(args, model.vocab_size)
    ids = dict(cls_id=args.cls_token_id, sep_id=args.sep_token_id,
               pad_id=args.pad_token_id)
    if args.task == "RACE":
        num_classes = 1   # the per-choice score head [h, 1]
        load, dataset = load_race, RaceDataset
    else:
        num_classes = 3 if args.task == "MNLI" else 2
        load = load_mnli if args.task == "MNLI" else load_qqp
        dataset = GlueDataset
    return num_classes, *(
        dataset([s for p in paths for s in load(p)], tok.tokenize,
                model.seq_length, **ids)
        for paths in (args.train_data, args.valid_data))


def run_orqa(args, log=print):
    """RET-FINETUNE-NQ: the DPR-style supervised retriever finetuning.
    Returns (loop, final eval stats)."""
    import numpy as np

    from megatron_tpu_torch.arguments import (
        args_to_run_config, encoder_model_kwargs,
    )
    from megatron_tpu_torch.models.biencoder import biencoder_config
    from megatron_tpu_torch.parallel.distributed import local_device
    from megatron_tpu_torch.tasks.orqa_finetune import (
        NQSupervisedDataset, finetune_orqa, load_dpr_json,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = encoder_model_kwargs(args)
    kw["seq_length"] = args.retriever_seq_length
    cfg = args_to_run_config(args, model=biencoder_config(**kw))
    tok = _build_task_tokenizer(args, cfg.model.vocab_size)
    ids = dict(cls_id=args.cls_token_id, sep_id=args.sep_token_id,
               pad_id=args.pad_token_id, seed=cfg.training.seed)
    train_raw = [s for p in args.train_data for s in load_dpr_json(p)]
    if args.sample_rate < 1.0:
        rng = np.random.RandomState(cfg.training.seed)
        keep = rng.permutation(len(train_raw))[
            : int(len(train_raw) * args.sample_rate)]
        train_raw = [train_raw[i] for i in sorted(keep)]
    valid_raw = [s for p in args.valid_data for s in load_dpr_json(p)]
    num_neg = args.train_hard_neg if args.train_with_neg else 0
    seq = cfg.model.seq_length
    train_ds = NQSupervisedDataset(train_raw, tok.tokenize, seq,
                                   evaluate=False, num_neg=num_neg, **ids)
    valid_ds = NQSupervisedDataset(valid_raw, tok.tokenize, seq,
                                   evaluate=True,
                                   val_hard_neg=args.val_av_rank_hard_neg,
                                   val_other_neg=args.val_av_rank_other_neg,
                                   **ids)
    cfg, iters = _finetune_cfg(cfg, args.epochs, len(train_ds))
    if args.pretrained_checkpoint:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, load=args.pretrained_checkpoint, finetune=True))
    log(f"RET-FINETUNE-NQ: {len(train_ds)} train / {len(valid_ds)} valid, "
        f"{num_neg} hard negatives/sample, {iters} iterations")
    return finetune_orqa(
        cfg, train_ds, valid_ds, ict_head_size=args.ict_head_size,
        shared=args.biencoder_shared_query_context_model,
        score_scaling=args.retriever_score_scaling,
        topk=tuple(args.retriever_report_topk_accuracies), log=log,
        device=local_device(args.device))


def main(argv=None, log=print):
    """Returns the finished TrainLoop (training/pretrain.py); for
    RET-FINETUNE-NQ, (loop, final eval stats)."""
    from megatron_tpu_torch.arguments import parse_args, task_args
    from megatron_tpu_torch.training.pretrain import run_distributed

    args = parse_args(argv, task_args)
    if args.task == "RET-FINETUNE-NQ":
        return run_distributed(args, lambda: run_orqa(args, log))
    cfg = run_config(args)
    return run_distributed(args, lambda: _main(args, cfg, log))


def _main(args, cfg, log):
    from megatron_tpu_torch.parallel.distributed import local_device
    from megatron_tpu_torch.tasks.finetune_utils import (
        finetune_classification,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    num_classes, train_ds, valid_ds = task_datasets(args, cfg.model)
    cfg, iters = _finetune_cfg(cfg, args.epochs, len(train_ds))
    log(f"{args.task}: {len(train_ds)} train / {len(valid_ds)} valid "
        f"samples, {num_classes} classes, {iters} iterations")
    return finetune_classification(
        cfg, num_classes, train_ds, valid_ds,
        pretrained=args.pretrained_checkpoint, log=log,
        device=local_device(args.device))


if __name__ == "__main__":
    main()
