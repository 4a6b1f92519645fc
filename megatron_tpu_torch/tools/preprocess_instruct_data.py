"""Chat JSONL -> paired text/role indexed datasets for instruction tuning
(counterpart of the repo's tools/preprocess_instruct_data.py).

Each input line holds one conversation:

  {"conversation": [{"role": "system"|"prompter"|"assistant", "text": "..."}]}

(role aliases "user"/"human" -> prompter, "gpt"/"bot"/"model" ->
assistant). Its turns are tokenized and concatenated, and a parallel
stream records each token's role, so the collator can weight the
assistant's tokens in the loss. Output: <output_prefix>-text.bin/.idx
and <output_prefix>-role.bin/.idx, through the port's
MMapIndexedDatasetBuilder.

    python -m megatron_tpu_torch.tools.preprocess_instruct_data \\
        --input chats.jsonl --output_prefix data/chats \\
        --tokenizer_type null --vocab_size 32000

The tokenizer flags are the JAX tool's (tokenizer/tokenizer.py
build_tokenizer: GPT-2 BPE, SentencePiece, HF, null).
"""

from __future__ import annotations

import argparse
import json


_ALIASES = {"user": "prompter", "human": "prompter", "gpt": "assistant",
            "bot": "assistant", "model": "assistant"}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output_prefix", required=True)
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
    p.add_argument("--conversation_key", default="conversation")
    p.add_argument("--append_eod", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of conversations written."""
    from megatron_tpu_torch.data.indexed_dataset import make_builder
    from megatron_tpu_torch.data.instruction_dataset import ROLES
    from megatron_tpu_torch.tokenizer import build_tokenizer

    args = get_args(argv)
    tok = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merges_file=args.merges_file, tokenizer_model=args.tokenizer_model,
        name_or_path=args.tokenizer_name_or_path, vocab_size=args.vocab_size,
        vocab_extra_ids=args.vocab_extra_ids, new_tokens=args.new_tokens)
    text_prefix = args.output_prefix + "-text"
    role_prefix = args.output_prefix + "-role"
    text_builder = make_builder(text_prefix, vocab_size=tok.vocab_size)
    role_builder = make_builder(role_prefix, vocab_size=tok.vocab_size)

    n = 0
    with open(args.input, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            convo = json.loads(line)[args.conversation_key]
            tokens, roles = [], []
            for turn in convo:
                role_name = _ALIASES.get(turn["role"], turn["role"])
                if role_name not in ROLES:
                    raise ValueError(f"unknown role {turn['role']!r}")
                ids = tok.tokenize(turn["text"])
                tokens.extend(ids)
                roles.extend([ROLES[role_name]] * len(ids))
            if args.append_eod:
                tokens.append(tok.eod)
                roles.append(ROLES["assistant"])
            text_builder.add_doc(tokens)
            role_builder.add_doc(roles)
            n += 1

    text_builder.finalize(text_prefix + ".idx")
    role_builder.finalize(role_prefix + ".idx")
    print(f"wrote {n} conversations to {text_prefix}* and {role_prefix}*")
    return n


if __name__ == "__main__":
    main()
