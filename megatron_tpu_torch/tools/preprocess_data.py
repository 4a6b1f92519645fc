"""JSONL -> indexed dataset (counterpart of the repo's
tools/preprocess_data.py, with the same flags and output).

Reads JSONL, tokenizes the chosen keys of each document in worker
processes, appends EOD with --append_eod, and writes .bin/.idx in the
mmap format the JAX package writes, byte for byte:

    python -m megatron_tpu_torch.tools.preprocess_data --input docs.jsonl \\
        --output_prefix corpus --tokenizer_type GPT2BPETokenizer \\
        --vocab_file vocab.json --merges_file merges.txt --append_eod \\
        --workers 4

Workers start with the "spawn" method. Documents keep their input order.
The last line on stderr gives the documents, tokens and rates.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time

_worker_tokenizer = None
_worker_args = None


def _init_worker(args):
    global _worker_tokenizer, _worker_args
    from megatron_tpu_torch.tokenizer import build_tokenizer

    _worker_args = args
    _worker_tokenizer = build_tokenizer(
        args.tokenizer_type,
        vocab_file=args.vocab_file,
        merges_file=args.merges_file,
        tokenizer_model=args.tokenizer_model,
        name_or_path=args.tokenizer_name_or_path,
        vocab_size=args.vocab_size,
        vocab_extra_ids=args.vocab_extra_ids,
        new_tokens=args.new_tokens,
    )


def _encode(line):
    line = line.strip()
    if not line:
        return None
    doc = json.loads(line)
    out = {}
    for key in _worker_args.json_keys:
        ids = _worker_tokenizer.tokenize(doc[key])
        if _worker_args.append_eod:
            ids = list(ids) + [_worker_tokenizer.eod]
        out[key] = ids
    return out


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="input jsonl file")
    p.add_argument("--output_prefix", required=True)
    p.add_argument("--json_keys", nargs="+", default=["text"])
    p.add_argument("--append_eod", action="store_true")
    p.add_argument("--tokenizer_type", default="SentencePieceTokenizer")
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--merges_file", default=None)
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--tokenizer_name_or_path", default=None)
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--vocab_extra_ids", type=int, default=0)
    p.add_argument("--no_new_tokens", action="store_false",
                   dest="new_tokens",
                   help="do not add special/extra-id tokens in the "
                        "sentencepiece tokenizer")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--log_interval", type=int, default=10000)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {"documents", "tokens", "seconds"} (tokens over every
    key, EOD included)."""
    from megatron_tpu_torch.data.indexed_dataset import make_builder

    args = get_args(argv)
    _init_worker(args)
    vocab_size = _worker_tokenizer.vocab_size

    builders = {}
    for key in args.json_keys:
        suffix = f"_{key}" if len(args.json_keys) > 1 else ""
        prefix = args.output_prefix + suffix
        builders[key] = (prefix, make_builder(prefix, vocab_size=vocab_size))

    t0 = time.time()
    n = n_tokens = 0
    pool = None
    with open(args.input, encoding="utf-8") as f:
        if args.workers > 1:
            pool = multiprocessing.get_context("spawn").Pool(
                args.workers, initializer=_init_worker, initargs=(args,))
            encoded = pool.imap(_encode, f, chunksize=32)
        else:
            encoded = map(_encode, f)
        try:
            for doc in encoded:
                if doc is None:
                    continue
                for key, ids in doc.items():
                    builders[key][1].add_doc(ids)
                    n_tokens += len(ids)
                n += 1
                if n % args.log_interval == 0:
                    rate = n / (time.time() - t0)
                    print(f"processed {n} documents ({rate:.0f} docs/s)",
                          file=sys.stderr)
        finally:
            if pool is not None:
                pool.close()
                pool.join()

    for key, (prefix, builder) in builders.items():
        builder.finalize(prefix + ".idx")
        print(f"wrote {prefix}.bin/.idx ({n} documents)")
    seconds = time.time() - t0
    print(f"{n} documents, {n_tokens} tokens in {seconds:.2f} s "
          f"({n / max(seconds, 1e-9):.0f} docs/s, "
          f"{n_tokens / max(seconds, 1e-9):.0f} tokens/s)", file=sys.stderr)
    return {"documents": n, "tokens": n_tokens, "seconds": seconds}


if __name__ == "__main__":
    main()
