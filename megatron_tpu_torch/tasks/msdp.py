#!/usr/bin/env python
"""Multi-Stage Dialogue Prompting (MSDP): knowledge/response generation by
few-shot prompting a pretrained GPT, plus token-level F1 evaluation
(counterpart of tasks/msdp.py, the reference's tasks/msdp/).

Three subcommands mirror the reference's MSDP-PROMPT (knowledge|response)
and MSDP-EVAL-F1 tasks:

  python -m megatron_tpu_torch.tasks.msdp prompt-knowledge \
      --prompt_file k.jsonl --sample_input_file test.tsv \
      --sample_output_file knwl.txt --load ck --tokenizer_type ...
  python -m megatron_tpu_torch.tasks.msdp prompt-response \
      --prompt_file r.txt --sample_input_file test.tsv \
      --sample_output_file resp.txt --megatron_api_url http://host:port/api
  python -m megatron_tpu_torch.tasks.msdp eval-f1 --guess_file resp.txt \
      --answer_file gold.txt

Input formats match the reference exactly (prompt.py:96-131):
  knowledge prompts: jsonl, each line {"<topic> <last_turn>": [examples...]}
  response prompt:   plain text, first N lines joined
  test samples:      tsv  topic \t turn1 [SEP] turn2 ... [\t knowledge]

Generation runs on the local model through inference/api (greedy top-k=1,
as the reference, prompt.py:265; on the card unless --device cpu) or
against a running generation server with --megatron_api_url (the
reference's --api_prompt mode). Response inputs are split by a regex
stand-in for nltk.word_tokenize (the JAX package's).
"""

import json
import re
import sys
from collections import Counter
from typing import Dict, List, Sequence, Tuple

# ---------------------------------------------------------------- metrics

_RE_ART = re.compile(r"\b(a|an|the)\b")
_RE_PUNC = re.compile(r"[!\"#$%&()*+,\-./:;<=>?@\[\]\\^`{|}~_']")


def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation/articles/extra whitespace (the standard
    SQuAD/ParlAI normalization the reference's metrics.py uses)."""
    s = _RE_PUNC.sub(" ", s.lower())
    s = _RE_ART.sub(" ", s)
    return " ".join(s.split())


def token_f1(guess: str, answer: str):
    """(precision, recall, f1) over normalized token bags; (None,)*3 when
    the gold answer is empty (sample excluded, ref metrics.py:52-54)."""
    if answer == "":
        return None, None, None
    if guess == "":
        return 0.0, 0.0, 0.0
    g, a = Counter(normalize_answer(guess).split()), \
        Counter(normalize_answer(answer).split())
    same = sum((g & a).values())
    if same == 0:
        return 0.0, 0.0, 0.0
    p, r = same / sum(g.values()), same / sum(a.values())
    return p, r, 2 * p * r / (p + r)


def corpus_f1(guesses: Sequence[str], answers: Sequence[str]):
    """Mean (precision, recall, f1) over non-empty-gold pairs."""
    if len(guesses) != len(answers):
        raise ValueError(f"{len(guesses)} guesses vs {len(answers)} answers")
    ps, rs, fs = [], [], []
    for g, a in zip(guesses, answers):
        p, r, f = token_f1(g, a)
        if p is None:
            continue
        ps.append(p), rs.append(r), fs.append(f)
    n = max(len(fs), 1)
    return sum(ps) / n, sum(rs) / n, sum(fs) / n


# ------------------------------------------------------------ prompt build

_RE_WORD = re.compile(r"\w+|[^\w\s]")


def word_tokenize(text: str) -> List[str]:
    """Regex stand-in for nltk.word_tokenize: words and punctuation as
    separate tokens (what the response-prompt format needs)."""
    return _RE_WORD.findall(text)


def read_knowledge_prompts(path: str) -> Dict[str, str]:
    """jsonl {key: [examples]} -> {key: joined prompt} (ref prompt.py:96)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            key = next(iter(d))
            if key not in out:
                out[key] = "".join(e.strip() + " \n" for e in d[key])
    return out


def read_response_prompt(path: str, n_examples: int) -> str:
    """First n lines of the prompt file, joined (ref prompt.py:122-131)."""
    with open(path) as f:
        lines = f.readlines()[:n_examples]
    return "".join(ln.strip() + " \n" for ln in lines)


def build_knowledge_input(sample_line: str,
                          prompts: Dict[str, str]) -> str:
    """topic \t turns -> few-shot prompt + "( last_turn ) topic =>"."""
    parts = sample_line.strip().split("\t")
    topic, last_turn = parts[0], parts[1].split(" [SEP] ")[-1]
    return prompts[topic + " " + last_turn] + \
        "( " + last_turn + " ) " + topic + " =>"


def build_response_input(sample_line: str, prompt: str) -> str:
    """topic \t turns \t knowledge -> prompt + Topic/User/We-know template."""
    parts = sample_line.strip().split("\t")
    topic = parts[0]
    last_turn = " ".join(word_tokenize(parts[1].split(" [SEP] ")[-1])).strip()
    knowledge = " ".join(word_tokenize(parts[2])).strip()
    return (prompt + "Topic: " + topic + ". "
            + "User says: " + last_turn + " "
            + "We know that: " + knowledge + " "
            + "System replies:")


def first_line_continuation(full_text: str, prompt_len: int) -> str:
    """Generation minus prompt, truncated at the first newline (how the
    reference post-processes every MSDP generation, prompt.py:270-274)."""
    return full_text[prompt_len:].split("\n")[0].strip()


# --------------------------------------------------------------- driving


def generate_file(sample_input_file: str, sample_output_file: str,
                  prompt_type: str, prompt_file: str,
                  generate_fn, num_prompt_examples: int = 10) -> int:
    """Build one prompt per test line, generate, write one output line each.
    generate_fn(prompt: str) -> str returns prompt+continuation (the raw
    model text); returns the number of samples processed."""
    if prompt_type == "knowledge":
        prompts = read_knowledge_prompts(prompt_file)
        build = lambda ln: build_knowledge_input(ln, prompts)
    elif prompt_type == "response":
        prompt = read_response_prompt(prompt_file, num_prompt_examples)
        build = lambda ln: build_response_input(ln, prompt)
    else:
        raise ValueError(f"prompt_type must be knowledge|response, "
                         f"got {prompt_type!r}")
    n = 0
    with open(sample_input_file) as fin, \
            open(sample_output_file, "w") as fout:
        for line in fin:
            if line.strip():
                inp = build(line)
                fout.write(first_line_continuation(generate_fn(inp), len(inp)))
            # blank input still emits a (blank) output line: guess/gold files
            # must stay line-aligned for eval-f1
            fout.write("\n")
            n += 1
    return n


def evaluate_f1(guess_file: str, answer_file: str) -> Tuple[float, float, float]:
    """Token F1 between generated and gold files (ref evaluate.py:12-38):
    strips <|endoftext|>, maps the WoW no_passages_used marker to empty."""
    with open(guess_file) as f:
        guesses = [ln.strip().replace("<|endoftext|>", "") for ln in f]
    with open(answer_file) as f:
        answers = ["" if ln.strip() == "no_passages_used" else ln.strip()
                   for ln in f]
    p, r, f1 = corpus_f1(guesses, answers)
    print(f"Precision: {p:.4f}; recall: {r:.4f}; f1: {f1:.4f}")
    return p, r, f1


def _local_generate_fn(args):
    """Greedy local generation through the checkpointed model."""
    from megatron_tpu_torch.arguments import args_to_run_config
    from megatron_tpu_torch.inference.api import generate_and_post_process
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.parallel.distributed import local_device
    from megatron_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from megatron_tpu_torch.training import checkpointing

    cfg = args_to_run_config(args)
    tok = build_tokenizer(args.tokenizer_type, vocab_size=cfg.model.vocab_size,
                          tokenizer_model=args.tokenizer_model,
                          vocab_file=args.vocab_file,
                          merges_file=args.merges_file,
                          vocab_extra_ids=args.vocab_extra_ids or 0,
                          new_tokens=args.new_tokens)
    params = init_params(cfg.model, cfg.training.seed,
                         device=local_device(args.device))
    if cfg.training.load:
        params = checkpointing.load_params_only(cfg.training.load, params)

    def gen(prompt: str) -> str:
        texts, _, _, _ = generate_and_post_process(
            cfg.model, params, tok, [prompt],
            tokens_to_generate=args.out_seq_length, top_k_sampling=1)
        return texts[0]

    return gen


def _api_generate_fn(url: str, out_seq_length: int):
    """The reference's --api_prompt mode: PUT to a generation server."""
    import urllib.request

    def gen(prompt: str) -> str:
        req = urllib.request.Request(
            url, method="PUT",
            data=json.dumps({"prompts": [prompt],
                             "tokens_to_generate": out_seq_length,
                             "top_k": 1}).encode(),
            headers={"Content-Type": "application/json; charset=UTF-8"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())["text"][0]

    return gen


def main(argv=None):
    from megatron_tpu_torch.arguments import parse_args

    task = (argv or sys.argv[1:])[:1]
    rest = (argv or sys.argv[1:])[1:]
    if task not in (["prompt-knowledge"], ["prompt-response"], ["eval-f1"]):
        raise SystemExit("usage: tasks.msdp {prompt-knowledge|prompt-response"
                         "|eval-f1} [args]")
    task = task[0]

    def extra(p):
        g = p.add_argument_group("msdp")
        g.add_argument("--prompt_file", type=str, default=None)
        g.add_argument("--sample_input_file", type=str, default=None)
        g.add_argument("--sample_output_file", type=str, default=None)
        g.add_argument("--num_prompt_examples", type=int, default=10)
        g.add_argument("--guess_file", type=str, default=None)
        g.add_argument("--answer_file", type=str, default=None)
        g.add_argument("--out_seq_length", type=int, default=100)
        g.add_argument("--megatron_api_url", type=str, default=None)
        return p

    args = parse_args(rest, extra_args_provider=extra)

    if task == "eval-f1":
        evaluate_f1(args.guess_file, args.answer_file)
        return

    gen = (_api_generate_fn(args.megatron_api_url, args.out_seq_length)
           if args.megatron_api_url else _local_generate_fn(args))
    n = generate_file(args.sample_input_file, args.sample_output_file,
                      task.split("-")[1], args.prompt_file, gen,
                      args.num_prompt_examples)
    print(f"wrote {n} generations to {args.sample_output_file}")


if __name__ == "__main__":
    main()
