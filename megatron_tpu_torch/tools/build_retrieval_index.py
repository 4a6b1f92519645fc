"""Build a dense retrieval index of evidence blocks with the biencoder's
context tower (counterpart of tools/build_retrieval_index.py, the
reference's megatron/indexer.py and realm_index's data store).

One pass over the block dataset: the context tower's embeddings in fp32
as block_index.npy [N, D] and each block's (start, end, doc, block id)
as block_meta.npy [N, 4]. search is the brute-force dot-product top-k
(the reference's FAISS flat index) on the host.

    python -m megatron_tpu_torch.tools.build_retrieval_index \\
        --load ckpts/ict --data_path data/blocks \\
        --titles_data_path data/titles --output index_dir \\
        --num_layers 12 --hidden_size 768 --num_attention_heads 12 \\
        --vocab_size 30592 --seq_length 256 --ict_head_size 128

--load is an ICT (biencoder) checkpoint or a BERT one (each tower's
encoder leaves; the ict_heads keep their init), saved at any topology.
"""

from __future__ import annotations

import os

import numpy as np
import torch


@torch.no_grad()
def build_index(cfg, tower, dataset, batch_size: int = 64, log=print,
                log_interval: int = 50):
    """Embed every block of `dataset` (an ICTDataset) with `tower` on its
    device. Returns (emb [N, D] fp32, meta [N, 4])."""
    from megatron_tpu_torch.models.biencoder import embed_text

    device = next(iter(tower["embed"].values())).device
    n = len(dataset)
    if n == 0:
        raise SystemExit("no blocks to index (empty block dataset/mapping)")
    embs, metas = [], []
    for i in range(0, n, batch_size):
        rows = [dataset[j] for j in range(i, min(i + batch_size, n))]
        pad = batch_size - len(rows)
        rows_p = rows + [rows[0]] * pad  # fixed shapes; padded rows dropped
        toks = torch.from_numpy(np.stack(
            [r["context_tokens"] for r in rows_p])).to(device)
        mask = torch.from_numpy(np.stack(
            [r["context_pad_mask"] for r in rows_p])).to(device)
        out = embed_text(cfg, tower, toks, mask > 0)
        embs.append(out.float().cpu().numpy()[: len(rows)])
        metas.extend(r["block_data"] for r in rows)
        if (i // batch_size) % log_interval == 0:
            log(f"indexed {min(i + batch_size, n)}/{n} blocks")
    return np.concatenate(embs), np.stack(metas)


def search(index: np.ndarray, query_emb: np.ndarray, topk: int = 5):
    """Brute-force dot-product top-k: query_emb [B, D] -> (scores
    [B, topk], ids [B, topk])."""
    scores = query_emb @ index.T
    ids = np.argsort(-scores, axis=1)[:, :topk]
    return np.take_along_axis(scores, ids, axis=1), ids


def load_towers(args, device):
    """(model config, the biencoder params) of the flags: the towers at
    their widths, restored from --load."""
    from megatron_tpu_torch.arguments import encoder_model_kwargs
    from megatron_tpu_torch.models.biencoder import (
        biencoder_config, load_biencoder_params,
    )

    model = biencoder_config(**encoder_model_kwargs(args))
    return model, load_biencoder_params(
        model, args.load, args.ict_head_size,
        args.biencoder_shared_query_context_model, device=device,
        seed=args.seed)


def main(argv=None, log=print):
    """Writes the index; returns (emb, meta)."""
    from megatron_tpu_torch.arguments import parse_args, retrieval_args
    from megatron_tpu_torch.data.ict_dataset import ICTDataset
    from megatron_tpu_torch.data.indexed_dataset import make_dataset
    from megatron_tpu_torch.parallel.distributed import local_device

    def extra(p):
        p = retrieval_args(p)
        g = p.add_argument_group("indexer")
        g.add_argument("--output", required=True)
        g.add_argument("--indexer_batch_size", type=int, default=64)
        g.add_argument("--indexer_log_interval", type=int, default=50)
        return p

    args = parse_args(argv, extra)
    if not args.data_path:
        raise SystemExit("--data_path is required")
    model, params = load_towers(args, local_device(args.device))
    tower = params.get("shared", params.get("context"))
    blocks = make_dataset(args.data_path[0])
    titles = (make_dataset(args.titles_data_path)
              if args.titles_data_path else None)
    ds = ICTDataset(blocks, titles, num_samples=None,
                    max_seq_length=model.seq_length,
                    cls_token=args.cls_token_id, sep_token=args.sep_token_id,
                    pad_token=args.pad_token_id, query_in_block_prob=1.0,
                    use_titles=titles is not None)
    emb, meta = build_index(model, tower, ds,
                            batch_size=args.indexer_batch_size, log=log,
                            log_interval=args.indexer_log_interval)
    os.makedirs(args.output, exist_ok=True)
    np.save(os.path.join(args.output, "block_index.npy"), emb)
    np.save(os.path.join(args.output, "block_meta.npy"), meta)
    log(f"wrote {emb.shape[0]} block embeddings (dim {emb.shape[1]}) "
        f"to {args.output}")
    return emb, meta


if __name__ == "__main__":
    main()
