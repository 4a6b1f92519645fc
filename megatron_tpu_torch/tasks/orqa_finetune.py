"""ORQA supervised retriever finetuning on DPR-format Natural Questions
(counterpart of tasks/orqa_finetune.py, the reference's
tasks/orqa/supervised/{data,finetune,eval_utils}.py).

The biencoder's query and context towers are finetuned with a softmax
retrieval loss whose candidates are the batch's positive contexts and,
with --train_with_neg, each sample's hard negatives, the labels on the
diagonal. Evaluation reports the mean rank and the top-k accuracies over
the positives and each sample's negatives. Above one data rank each rank
embeds its rows and the loss gathers the query, positive and negative
embeddings over the batch group (parallel/mappings.gather_batch), so the
candidates are the global batch's, as GSPMD's gather gives the JAX loss.
Negative counts are padded to a fixed [B, N, S] block (all-pad rows are
easy negatives in training and are masked out of evaluation).

Data (the DPR codebase's JSON): a list of rows with question, answers,
positive_ctxs, hard_negative_ctxs and negative_ctxs; each ctx has title
and text.
"""

from __future__ import annotations

import functools
import json
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.parallel.mappings import gather_batch


def normalize_question(q: str) -> str:
    return q[:-1] if q.endswith("?") else q


def load_dpr_json(path: str) -> List[Dict[str, Any]]:
    """DPR retriever JSON -> samples; rows without a positive are
    dropped."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    samples = []
    for row in data:
        if not row.get("positive_ctxs"):
            continue
        samples.append({
            "question": normalize_question(row["question"]),
            "pos_context": row["positive_ctxs"][0],
            "hard_negative_context": row.get("hard_negative_ctxs") or [],
            "negative_context": row.get("negative_ctxs") or [],
            "answers": row.get("answers") or [],
        })
    return samples


def _encode(ids: Sequence[int], seq_len: int, cls_id: int, sep_id: int,
            pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """[CLS] ids [SEP] pad -> (tokens [S] int64, pad_mask [S] int64)."""
    enc = [cls_id] + list(ids)
    enc = enc[: seq_len - 1] + [sep_id]
    n = len(enc)
    toks = np.full((seq_len,), pad_id, np.int64)
    toks[:n] = enc
    mask = np.zeros((seq_len,), np.int64)
    mask[:n] = 1
    return toks, mask


class NQSupervisedDataset:
    """Tokenized DPR samples with a fixed number of negatives an item.

    Training (evaluate False): num_neg hard negatives, topped up with
    simple negatives, then all-pad rows; shuffled per (seed, idx, epoch),
    so a resumed run draws the same negatives. Evaluation: the first
    val_other_neg simple and val_hard_neg hard negatives, in order."""

    def __init__(self, samples: List[Dict],
                 tokenize: Callable[[str], List[int]], seq_len: int,
                 cls_id: int = 101, sep_id: int = 102, pad_id: int = 0,
                 evaluate: bool = False, num_neg: int = 0,
                 val_hard_neg: int = 30, val_other_neg: int = 30,
                 seed: int = 1234):
        self.samples = samples
        self.tokenize = tokenize
        self.seq_len = seq_len
        self.ids = (cls_id, sep_id, pad_id)
        self.evaluate = evaluate
        self.num_neg = (val_hard_neg + val_other_neg) if evaluate else num_neg
        self.val_hard_neg, self.val_other_neg = val_hard_neg, val_other_neg
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.samples)

    def _ctx_ids(self, ctx: Dict[str, str]) -> List[int]:
        # title [SEP] text
        return (self.tokenize(ctx.get("title") or "") + [self.ids[1]]
                + self.tokenize(ctx.get("text") or ""))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cls_id, sep_id, pad_id = self.ids
        s = self.samples[idx]
        qt, qm = _encode(self.tokenize(s["question"]), self.seq_len,
                         cls_id, sep_id, pad_id)
        ct, cm = _encode(self._ctx_ids(s["pos_context"]), self.seq_len,
                         cls_id, sep_id, pad_id)
        item = {"query_tokens": qt, "query_pad_mask": qm,
                "context_tokens": ct, "context_pad_mask": cm}
        if self.num_neg > 0:
            if self.evaluate:
                negs = (s["negative_context"][: self.val_other_neg]
                        + s["hard_negative_context"][: self.val_hard_neg])
            else:
                rng = np.random.RandomState(
                    (self.seed + idx + 1000003 * self.epoch) & 0x7FFFFFFF)
                hard = list(s["hard_negative_context"])
                simple = list(s["negative_context"])
                rng.shuffle(hard)
                rng.shuffle(simple)
                negs = (hard + simple)[: self.num_neg]
            nt = np.full((self.num_neg, self.seq_len), pad_id, np.int64)
            nm = np.zeros((self.num_neg, self.seq_len), np.int64)
            for i, ctx in enumerate(negs[: self.num_neg]):
                nt[i], nm[i] = _encode(self._ctx_ids(ctx), self.seq_len,
                                       cls_id, sep_id, pad_id)
            item["neg_context_tokens"] = nt
            item["neg_context_pad_mask"] = nm
        return item


def _embed_candidates(cfg, params, batch, mesh=None, dropout_key=None):
    """(q [B, D], positives [B, D], negatives [B*N, D] or None) of this
    rank's rows; a dropout key splits into the pair's and the
    negatives' (the JAX package's)."""
    from megatron_tpu_torch.models.biencoder import (
        biencoder_forward, embed_text,
    )

    k_pair = kn = None
    if dropout_key is not None:
        k_pair, kn = dropout_key.split(2)
    q, c = biencoder_forward(
        cfg, params, batch["query_tokens"], batch["query_pad_mask"] > 0,
        batch["context_tokens"], batch["context_pad_mask"] > 0, mesh=mesh,
        dropout_key=k_pair)
    neg = None
    if "neg_context_tokens" in batch:
        ct = params.get("shared", params.get("context"))
        nt = batch["neg_context_tokens"]
        B, N, S = nt.shape
        neg = embed_text(cfg, ct, nt.reshape(B * N, S),
                         batch["neg_context_pad_mask"].reshape(B * N, S) > 0,
                         mesh=mesh, dropout_key=kn)
    return q, c, neg


def _scores(cfg, q, c, neg, score_scaling):
    """Query rows against the positives, then the negatives (the
    reference's torch.cat([context, neg_context]) order)."""
    cand = c if neg is None else torch.cat([c, neg], dim=0)
    scores = q.float() @ cand.float().t()
    if score_scaling:
        scores = scores / math.sqrt(cfg.hidden_size)
    return scores


def orqa_loss(cfg, params, batch, score_scaling: bool = False,
              topk: Tuple[int, ...] = (1, 5, 20), mesh=None,
              dropout_key=None):
    """The softmax retrieval loss over the batch's positives and
    negatives (every batch rank's, the module docstring); aux has the
    loss and the top-k accuracies in percent."""
    q, c, neg = _embed_candidates(cfg, params, batch, mesh, dropout_key)
    q, c = gather_batch(q, mesh), gather_batch(c, mesh)
    if neg is not None:
        neg = gather_batch(neg, mesh)
    scores = _scores(cfg, q, c, neg, score_scaling)
    labels = torch.arange(q.shape[0], device=scores.device)
    loss, _ = cross_entropy_loss(scores[:, None, :], labels[:, None])
    ranks = (scores > scores.gather(1, labels[:, None])).sum(1)
    aux = {"loss": loss}
    for k in topk:
        if k <= scores.shape[1]:
            aux[f"top{k}_acc"] = 100.0 * (ranks < k).float().mean()
    return loss, aux


@torch.no_grad()
def orqa_eval(loop, valid_ds, batch: int = 8, score_scaling: bool = False,
              topk: Sequence[int] = (1, 5, 20)) -> Dict[str, float]:
    """The mean rank and top-k accuracies over the evaluation set, the
    candidates each batch's positives and negatives (tail-batch padding
    and all-pad negative rows masked out). Every rank evaluates the whole
    set (tensor ranks in step)."""
    from megatron_tpu_torch.tasks.finetune_utils import _collate

    model_cfg = loop.cfg.model
    n_neg = getattr(valid_ds, "num_neg", 0)
    ranks: List[int] = []
    for i in range(0, len(valid_ds), batch):
        rows = [valid_ds[j] for j in range(i, min(i + batch, len(valid_ds)))]
        n_real = len(rows)
        rows += [rows[0]] * (batch - n_real)
        row_real = np.arange(batch) < n_real
        if n_neg:
            neg_nonpad = np.stack(
                [r["neg_context_pad_mask"].any(-1) for r in rows])
            col_real = np.concatenate(
                [row_real, (neg_nonpad & row_real[:, None]).reshape(-1)])
        else:
            col_real = row_real
        b = loop.put_batch(_collate(rows))
        q, c, neg = _embed_candidates(model_cfg, loop.state.params, b,
                                      loop.mesh)
        scores = _scores(model_cfg, q, c, neg, score_scaling)
        scores = scores.masked_fill(
            ~torch.from_numpy(col_real).to(scores.device)[None, :],
            -float("inf"))
        labels = torch.arange(q.shape[0], device=scores.device)
        vec = (scores > scores.gather(1, labels[:, None])).sum(1)
        ranks.extend(int(r) for r in vec[:n_real].tolist())
    arr = np.asarray(ranks, np.float64)
    out = {"rank": float(arr.mean())}
    for k in topk:
        out[f"top{k}_acc"] = 100.0 * float((arr < k).mean())
    return out


def finetune_orqa(cfg, train_ds, valid_ds, *, ict_head_size: int = 128,
                  shared: bool = False, score_scaling: bool = False,
                  topk: Sequence[int] = (1, 5, 20),
                  log: Callable[[str], None] = print, device="cuda"):
    """Train the biencoder on the retrieval objective through the task
    hooks (on the launch's mesh); returns (loop, final eval stats).
    cfg.training.train_iters must be set; cfg.training.load (with
    finetune) gives a biencoder checkpoint's weights."""
    from megatron_tpu_torch.models.biencoder import (
        biencoder_init_params, biencoder_param_specs,
    )
    from megatron_tpu_torch.tasks.finetune_utils import _epoch_iter
    from megatron_tpu_torch.training.pretrain import run_task_loop, task_loop

    def loss_fn(model_cfg, p, b, mesh=None, dropout_key=None):
        return orqa_loss(model_cfg, p, b, score_scaling=score_scaling,
                         topk=tuple(topk), mesh=mesh, dropout_key=dropout_key)

    # one microbatch: the in-batch softmax takes the whole global batch
    loop = task_loop(
        cfg, log=log, device=device,
        init_params_fn=lambda mc, seed, dev: biencoder_init_params(
            mc, seed, ict_head_size, shared, dev),
        param_specs_fn=functools.partial(
            biencoder_param_specs, ict_head_size=ict_head_size,
            shared=shared),
        loss_fn=loss_fn, fixed_num_microbatches=1)
    seed = cfg.training.seed

    def train_iter_factory(consumed, gbs):
        return _epoch_iter(train_ds, consumed, gbs, seed)

    run_task_loop(loop, train_iter_factory)
    # the training batch as the candidate set's size
    stats = orqa_eval(loop, valid_ds, batch=cfg.training.global_batch_size,
                      score_scaling=score_scaling, topk=topk)
    log(" | ".join(f"{k} = {v:.4f}" for k, v in stats.items()))
    return loop, stats
