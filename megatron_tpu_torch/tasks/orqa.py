"""ORQA-style retriever evaluation (counterpart of tasks/orqa.py, the
reference's tasks/orqa/evaluate_orqa.py and evaluate_utils.py): embed the
questions with the query tower, search the block index that
tools/build_retrieval_index wrote, and report the top-k answer-hit
rates.

    python -m megatron_tpu_torch.tasks.orqa --index_dir index/ \\
        --questions nq_dev.tsv --load ckpts/ict --data_path data/blocks \\
        --num_layers 12 --hidden_size 768 --num_attention_heads 12 \\
        --vocab_size 30592 --seq_length 256 --topk 1 5 20

Questions come from a tsv (question<TAB>answer, the answer a string or
an NQ-style list). A retrieval is a hit when the answer's tokens appear
inside the retrieved block (--match token, the JAX tool's default), or
by DPR's text criteria over the detokenized block (--match string or
regex, tasks/qa_utils.has_answer).
"""

from __future__ import annotations

import ast
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def _contains(haystack: np.ndarray, needle: Sequence[int]) -> bool:
    n, m = len(haystack), len(needle)
    if m == 0 or m > n:
        return False
    needle = np.asarray(needle, haystack.dtype)
    windows = np.lib.stride_tricks.sliding_window_view(haystack, m)
    return bool((windows == needle).all(axis=1).any())


def evaluate_retriever(
    questions: List[str],
    answers: List,                # str or List[str] per question
    tokenize: Callable[[str], List[int]],
    query_embed: Callable[[np.ndarray, np.ndarray], np.ndarray],
    index: np.ndarray,           # [N, D]
    get_block_tokens: Callable[[int], np.ndarray],
    max_query_len: int,
    cls_id: int,
    sep_id: int,
    pad_id: int,
    topk: Sequence[int] = (1, 5, 20),
    batch_size: int = 32,
    match: str = "token",
    detokenize: Optional[Callable[[Sequence[int]], str]] = None,
):
    """Returns {f"top{k}": hit rate}. match "token": the answer's token
    sequence inside the block's tokens; "string"/"regex": DPR's text
    criteria over the detokenized block (needs `detokenize`)."""
    from megatron_tpu_torch.tools.build_retrieval_index import search

    if not questions:
        raise SystemExit("no questions parsed (expected question<TAB>answer "
                         "lines)")
    if not topk:
        raise SystemExit("--topk needs at least one value")
    if match != "token" and detokenize is None:
        raise SystemExit(f"--match {match} needs a detokenizing tokenizer")
    toks = np.full((len(questions), max_query_len), pad_id, np.int64)
    mask = np.zeros((len(questions), max_query_len), np.float32)
    for i, q in enumerate(questions):
        ids = [cls_id] + tokenize(q)[: max_query_len - 2] + [sep_id]
        toks[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1.0

    embs = []
    n = len(questions)
    for i in range(0, n, batch_size):
        j = min(i + batch_size, n)
        pad = batch_size - (j - i)
        t = np.concatenate([toks[i:j], np.tile(toks[i:i + 1], (pad, 1))]) \
            if pad else toks[i:j]
        m = np.concatenate([mask[i:j], np.tile(mask[i:i + 1], (pad, 1))]) \
            if pad else mask[i:j]
        embs.append(np.asarray(query_embed(t, m), np.float32)[: j - i])
    q_emb = np.concatenate(embs)

    kmax = max(topk)
    _, ids = search(index, q_emb, topk=kmax)
    hits = np.zeros((n, kmax), bool)
    for qi in range(n):
        ans_list = (answers[qi] if isinstance(answers[qi], (list, tuple))
                    else [answers[qi]])
        if match == "token":
            ans_toks = [tokenize(a) for a in ans_list]
            found = lambda block: any(
                _contains(block, t) for t in ans_toks if t)
            get = lambda bid: np.asarray(get_block_tokens(bid), np.int64)
        else:
            from megatron_tpu_torch.tasks.qa_utils import has_answer

            found = lambda text: has_answer(ans_list, text, match)
            get = lambda bid: detokenize(
                [int(t) for t in get_block_tokens(bid)])
        for rank, bid in enumerate(ids[qi]):
            if found(get(int(bid))):
                hits[qi, rank:] = True
                break
    return {f"top{k}": float(hits[:, k - 1].mean()) for k in topk}


def read_questions(path: str):
    """(questions, answers) of a question<TAB>answer tsv; an answer
    written as a list ("['a', 'b']") becomes the list."""
    questions, answers = [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                questions.append(parts[0])
                a = parts[1]
                if a.startswith("[") and a.endswith("]"):
                    try:
                        a = list(ast.literal_eval(a))
                    except (ValueError, SyntaxError):
                        pass
                answers.append(a)
    return questions, answers


def main(argv=None, log=print):
    """Returns {f"top{k}": hit rate}."""
    from megatron_tpu_torch.arguments import parse_args, retrieval_args
    from megatron_tpu_torch.data.indexed_dataset import make_dataset
    from megatron_tpu_torch.models.biencoder import embed_text
    from megatron_tpu_torch.parallel.distributed import local_device
    from megatron_tpu_torch.tasks.main import _build_task_tokenizer
    from megatron_tpu_torch.tools.build_retrieval_index import load_towers

    def extra(p):
        p = retrieval_args(p)
        g = p.add_argument_group("orqa")
        g.add_argument("--index_dir", required=True)
        g.add_argument("--questions", required=True,
                       help="tsv: question<TAB>answer per line")
        g.add_argument("--topk", nargs="*", type=int, default=[1, 5, 20])
        g.add_argument("--match", choices=["token", "string", "regex"],
                       default="token")
        return p

    args = parse_args(argv, extra)
    if not args.data_path:
        raise SystemExit("--data_path is required")
    device = local_device(args.device)
    model, params = load_towers(args, device)
    qtower = params.get("shared", params.get("query"))
    tok = _build_task_tokenizer(args, model.vocab_size)
    index = np.load(os.path.join(args.index_dir, "block_index.npy"))
    meta = np.load(os.path.join(args.index_dir, "block_meta.npy"))
    blocks_ds = make_dataset(args.data_path[0])
    cache = {}

    def get_block_tokens(bid: int) -> np.ndarray:
        # only the retrieved blocks are ever read
        if bid not in cache:
            s, e = int(meta[bid][0]), int(meta[bid][1])
            cache[bid] = np.concatenate(
                [np.asarray(blocks_ds[i], np.int64) for i in range(s, e)])
        return cache[bid]

    @torch.no_grad()
    def query_embed(toks, mask):
        return embed_text(model, qtower, torch.from_numpy(toks).to(device),
                          torch.from_numpy(mask).to(device) > 0
                          ).float().cpu().numpy()

    questions, answers = read_questions(args.questions)
    out = evaluate_retriever(
        questions, answers, tok.tokenize, query_embed, index,
        get_block_tokens, max_query_len=model.seq_length,
        cls_id=args.cls_token_id, sep_id=args.sep_token_id,
        pad_id=args.pad_token_id, topk=args.topk, match=args.match,
        detokenize=tok.detokenize)
    for k, v in out.items():
        log(f"{k} retrieval hit rate: {v:.4f} ({len(questions)} questions)")
    return out


if __name__ == "__main__":
    main()
