"""The finetune loop of the classification tasks (counterpart of the
repo's tasks/finetune_utils.py): epoch-based training over an in-memory
tokenized dataset with the classification loss through TrainLoop's task
hooks, and argmax accuracy over the validation set at the end.

A --pretrained_checkpoint (a BERT checkpoint, e.g. one that
tools/pretrain_bert wrote) gives the encoder leaves, ENCODER: the
embeddings, the layers, the final norm and the pooler (the reference's
language model with its pooler); the heads (the classification head,
and BERT's MLM and binary heads, which the loss never reads) keep their
fresh init. The fp32 masters take the checkpoint's masters. Above one
rank (tasks/main under python -m torch.distributed.run) the loop runs on
the launch's mesh and each rank loads its slices of the encoder leaves
from a checkpoint saved at any topology.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from megatron_tpu_torch.models.classification import (
    classification_logits, classification_loss, cls_init_params,
    cls_param_specs,
)
from megatron_tpu_torch.training.optimizer import leaf_paths, tree_map
from megatron_tpu_torch.training.pretrain import (
    TrainLoop, run_task_loop, task_loop,
)

#: the top-level subtrees a pretrained BERT checkpoint gives the
#: classification tree
ENCODER = ("embed", "layers", "final_ln", "pooler")


def _collate(items: List[Dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _epoch_iter(ds, consumed: int, gbs: int, seed: int):
    """Deterministic shuffled sample stream resumable at `consumed` (the
    reference's MegatronPretrainingRandomSampler policy). Batches may
    straddle epoch boundaries, so no tail is dropped: the position in the
    epoch-concatenated permutation stream is exactly `consumed`."""
    n = len(ds)
    orders: dict = {}

    def sample(pos):
        e, o = divmod(pos, n)
        if e not in orders:
            orders[e] = np.random.RandomState(seed + e).permutation(n)
        if hasattr(ds, "set_epoch"):
            ds.set_epoch(e)
        return ds[int(orders[e][o])]

    pos = consumed
    while True:
        yield _collate([sample(pos + i) for i in range(gbs)])
        pos += gbs


@torch.no_grad()
def accuracy(loop: TrainLoop, ds, batch: int = 32) -> float:
    """Argmax accuracy over the whole dataset: the tail batch is padded
    to the batch size and only its real rows count."""
    model_cfg = loop.cfg.model
    correct, total = 0.0, 0
    for i in range(0, len(ds), batch):
        rows = [ds[j] for j in range(i, min(i + batch, len(ds)))]
        n_real = len(rows)
        rows += [rows[0]] * (batch - n_real)
        b = loop.put_batch(_collate(rows))
        logits = classification_logits(model_cfg, loop.state.params, b,
                                       mesh=loop.mesh)
        vec = (logits.argmax(-1) == b["label"]).float()
        correct += float(vec[:n_real].sum())
        total += n_real
    return correct / max(total, 1)


@torch.no_grad()
def load_pretrained_encoder(loop: TrainLoop, load: str,
                            subtrees=ENCODER) -> int:
    """The `subtrees` leaves of the checkpoint at `load` into the loop's
    params (cast to their dtype) and fp32 masters, in place (this rank's
    slices of them above one rank; a ZeRO-1 master its shard). Returns
    the number of leaves loaded."""
    from megatron_tpu_torch.training.checkpointing import load_params_only
    from megatron_tpu_torch.training.optimizer import (
        zero1_layout, zero1_shard,
    )

    params = loop.state.params
    template = {k: tree_map(lambda t: torch.empty(
        t.shape, dtype=torch.float32, device=t.device), params[k])
        for k in subtrees if k in params}
    loaded = leaf_paths(load_params_only(load, template,
                                         placement=loop.placement))
    zdims = zero1_layout(loop.cfg.optimizer, loop.mesh, loop.layout)
    for tree in (params, loop.state.master):
        if tree is None:
            continue
        dst = dict(leaf_paths({k: tree[k] for k in template}))
        for path, src in loaded:
            if tree is loop.state.master and path in zdims:
                src = zero1_shard(src, loop.mesh, *zdims[path])
            dst[path].copy_(src)
    return len(loaded)


def finetune_loop(cfg, num_classes: int, pretrained: Optional[str] = None,
                  log: Callable[[str], None] = print,
                  device="cuda") -> TrainLoop:
    """The classification TrainLoop, its encoder loaded from
    `pretrained` when given."""
    recompute = cfg.training.recompute_granularity
    loop = task_loop(
        cfg, log=log, device=device,
        init_params_fn=lambda mc, seed, dev: cls_init_params(
            mc, seed, num_classes, device=dev),
        param_specs_fn=cls_param_specs,
        loss_fn=functools.partial(classification_loss, recompute=recompute))
    if pretrained:
        n = load_pretrained_encoder(loop, pretrained)
        log(f"loaded {n} encoder leaves from {pretrained}")
    return loop


def finetune_classification(cfg, num_classes: int, train_ds, valid_ds,
                            pretrained: Optional[str] = None,
                            log: Callable[[str], None] = print,
                            device="cuda") -> TrainLoop:
    """Train with the classification loss; returns the loop (its state
    inside). cfg.training.train_iters already reflects epochs * len /
    gbs."""
    loop = finetune_loop(cfg, num_classes, pretrained, log, device)
    seed = cfg.training.seed

    def train_iter_factory(consumed, gbs):
        return _epoch_iter(train_ds, consumed, gbs, seed)

    def valid_iter_factory():
        return _epoch_iter(valid_ds, 0, cfg.training.micro_batch_size, seed)

    run_task_loop(loop, train_iter_factory, valid_iter_factory)
    log(f"final validation accuracy: {accuracy(loop, valid_ds):.4f}")
    return loop
