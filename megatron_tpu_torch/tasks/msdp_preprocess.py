#!/usr/bin/env python
"""MSDP preprocessing: Wizard-of-Wikipedia / Wizard-of-Internet corpus
munging + prompt-database selection (counterpart of
tasks/msdp_preprocess.py).

Equivalent of the reference's tasks/msdp/preprocessing.py (581 LoC), the
stage that produces the .tsv test files and prompt files consumed by
tasks/msdp.py. Five subcommands mirror the reference's --func choices:

  python -m megatron_tpu_torch.tasks.msdp_preprocess --func process_wow_dataset \
      --raw_file data.json --processed_file test.tsv \
      [--knwl_ref_file k.txt --resp_ref_file r.txt]
  python -m megatron_tpu_torch.tasks.msdp_preprocess --func process_woi_dataset ...
  python -m megatron_tpu_torch.tasks.msdp_preprocess --func get_knwl_gen_prompts \
      --test_file test.tsv --train_file train.tsv \
      --processed_file prompts.jsonl --data_type wow_seen
  python -m megatron_tpu_torch.tasks.msdp_preprocess --func get_resp_gen_prompts \
      --train_file train.tsv --processed_file prompt.txt
  python -m megatron_tpu_torch.tasks.msdp_preprocess --func prepare_input \
      --test_file test.tsv --knwl_gen_file knwl.txt \
      --processed_file resp_input.tsv

Output formats are byte-compatible with the reference so the prompting
stage (megatron_tpu_torch/tasks/msdp.py) consumes either's files:
  processed tsv:  topic \t turn1 [SEP] turn2 ... \t knowledge \t response
  knwl prompts:   jsonl {"<topic> <last_turn>": [instances...]}
  resp prompt:    20 "Topic: ... System replies: ..." lines

Differences from the reference, by design:
- nltk.word_tokenize -> the regex splitter shared with tasks/msdp.py
  (same punctuation separation, no nltk dependency).
- Prompt selection by embedding similarity (preprocessing.py:322-455)
  uses a pluggable embed_fn instead of a hard-coded CUDA DPR encoder:
  the default is a deterministic hashed bag-of-words cosine (no model
  download, no device); pass any `embed_fn(list[str]) -> [N, D]` —
  e.g. the in-repo biencoder query tower — for learned selection.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from megatron_tpu_torch.tasks.msdp import word_tokenize

NO_KNWL = "no_passages_used"


def _clean(s: str) -> str:
    return s.replace("\n", "").replace("\r", "").replace("\t", "")


def _end_punct(text: str) -> str:
    # ref preprocessing.py:68-70
    return text if text.endswith(("?", ".", "!")) else text + "."


def process_wow_dataset(raw_file: str, processed_file: str,
                        knwl_ref_file: Optional[str] = None,
                        resp_ref_file: Optional[str] = None) -> int:
    """WoW json -> `topic \t context \t knowledge \t response` tsv, one row
    per wizard turn (ref preprocessing.py:43-125). Returns rows written."""
    with open(raw_file, encoding="utf-8") as f:
        dialog_data = json.load(f)
    rows = 0
    fproc = open(processed_file, "w", encoding="utf-8")
    fknwl = open(knwl_ref_file, "w", encoding="utf-8") if knwl_ref_file else None
    fresp = open(resp_ref_file, "w", encoding="utf-8") if resp_ref_file else None
    try:
        for sample in dialog_data:
            turn_list: List[str] = []
            for j, turn in enumerate(sample["dialog"]):
                text = _end_punct(turn["text"])
                if j == 0:
                    turn_list.append(text)
                    continue
                speaker = turn["speaker"].lower()
                if "wizard" in speaker:
                    sent = list(turn.get("checked_sentence", {}).values())
                    passage = list(turn.get("checked_passage", {}).values())
                    knowledge = sent[0] if sent else NO_KNWL
                    checked_passage = passage[0] if len(passage) == 1 else NO_KNWL
                    topic = (checked_passage if checked_passage != NO_KNWL
                             else sample["chosen_topic"])
                    context = " [SEP] ".join(turn_list)
                    fproc.write(_clean(topic) + "\t" + _clean(context) + "\t"
                                + _clean(knowledge) + "\t" + _clean(text) + "\n")
                    rows += 1
                    if fknwl:
                        fknwl.write(_clean(knowledge) + "\n")
                    if fresp:
                        fresp.write(" ".join(word_tokenize(_clean(text))) + "\n")
                    turn_list.append(text)
                else:
                    turn_list.append(text)
    finally:
        fproc.close()
        if fknwl:
            fknwl.close()
        if fresp:
            fresp.close()
    return rows


def process_woi_dataset(raw_file: str, processed_file: str,
                        knwl_ref_file: Optional[str] = None,
                        resp_ref_file: Optional[str] = None) -> int:
    """WoI jsonl -> same tsv format (ref preprocessing.py:128-238).
    Rows with no selected knowledge are skipped (topic == no_topic)."""
    rows = 0
    fproc = open(processed_file, "w", encoding="utf-8")
    fknwl = open(knwl_ref_file, "w", encoding="utf-8") if knwl_ref_file else None
    fresp = open(resp_ref_file, "w", encoding="utf-8") if resp_ref_file else None
    try:
        with open(raw_file, encoding="utf-8") as fr:
            for line in fr:
                line = line.strip()
                if not line:
                    continue
                item = next(iter(json.loads(line).values()))
                turn_list: List[str] = []
                search_text = ""
                for entry in item["dialog_history"]:
                    action = entry["action"]
                    if action == "Wizard => SearchAgent":
                        search_text = entry["text"]
                    elif action == "Wizard => Apprentice":
                        if not turn_list:
                            turn_list.append(entry["text"])
                            continue
                        contents = entry["context"]["contents"]
                        selects = entry["context"]["selected_contents"]
                        no_knwl_flag = selects[0][0]
                        selects = selects[1:]
                        if no_knwl_flag:
                            topic, knwl_sent = "no_topic", NO_KNWL
                        else:
                            topic, knwl_sent = search_text, ""
                            for content, select in zip(contents, selects):
                                for c, s in zip(content["content"], select):
                                    if s:
                                        knwl_sent = c
                                        break
                                if knwl_sent:
                                    break
                        if not knwl_sent:
                            topic, knwl_sent = "no_topic", NO_KNWL
                        response = entry["text"]
                        if topic != "no_topic":
                            context = " [SEP] ".join(turn_list)
                            fproc.write(_clean(topic) + "\t" + _clean(context)
                                        + "\t" + _clean(knwl_sent) + "\t"
                                        + _clean(response) + "\n")
                            rows += 1
                            if fknwl:
                                fknwl.write(_clean(knwl_sent) + "\n")
                            if fresp:
                                fresp.write(
                                    " ".join(word_tokenize(_clean(response)))
                                    + "\n")
                        turn_list.append(response)
                    elif action == "Apprentice => Wizard":
                        turn_list.append(entry["text"])
    finally:
        fproc.close()
        if fknwl:
            fknwl.close()
        if fresp:
            fresp.close()
    return rows


def get_database(test_datapath: str, train_datapath: str, data_type: str):
    """Prompt database keyed by topic (ref preprocessing.py:241-319):
    (train_data_by_topic, dialog_data_by_topic, dialog_examples)."""
    assert data_type in ("wow_seen", "wow_unseen", "woi"), data_type
    test_topics = set()
    with open(test_datapath, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                test_topics.add(line.strip().split("\t")[0])

    train_data_by_topic: Dict[str, List[str]] = {}
    dialog_data_by_topic: Dict[str, List[str]] = {}
    dialog_examples: List[Tuple[str, str, str]] = []
    with open(train_datapath, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            splits = line.split("\t")
            topic, turns = splits[0], splits[1].split(" [SEP] ")[-3:]
            knowledge, response = splits[2], splits[3]
            if knowledge == NO_KNWL:
                continue
            if data_type != "wow_seen" and ("(" in knowledge or ")" in knowledge):
                continue
            if data_type != "wow_seen" and topic not in knowledge:
                continue
            instance = "( " + turns[-1] + " ) " + topic + " => " + knowledge
            dialog_example = ("( " + topic + " ) " if data_type != "wow_seen"
                              else "") + " ".join(turns)
            if topic in test_topics:
                train_data_by_topic.setdefault(topic, []).append(instance)
                dialog_data_by_topic.setdefault(topic, []).append(dialog_example)
            else:
                # out-of-test-topic rows are extra-filtered (ref :308-315)
                if len(knowledge.split()) > 20:
                    continue
                if knowledge.lower().startswith(("it", "this")):
                    continue
            dialog_examples.append((topic, dialog_example, instance))
    return train_data_by_topic, dialog_data_by_topic, dialog_examples


def hash_embed(texts: Sequence[str], dim: int = 1024) -> np.ndarray:
    """Deterministic hashed bag-of-words embedding, l2-normalized — the
    dependency-free default for similarity-based prompt selection."""
    import zlib

    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        for tok in word_tokenize(t.lower()):
            h = zlib.crc32(tok.encode())
            out[i, h % dim] += 1.0 if (h >> 16) & 1 else -1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-6)


def prompt_selection_for_knowledge_generation(
        test_datapath: str, train_datapath: str, output_prompt_path: str,
        data_type: str,
        embed_fn: Callable[[Sequence[str]], np.ndarray] = hash_embed,
        num_prompts: int = 10) -> int:
    """For each test sample pick `num_prompts` knowledge-generation
    examples: same-topic examples ranked by dialog similarity when the
    topic appears in training data, otherwise topic-diverse nearest
    dialogs (ref preprocessing.py:365-455). Writes the jsonl consumed by
    tasks/msdp.py read_knowledge_prompts. Returns samples written."""
    train_by_topic, dialog_by_topic, dialog_examples = get_database(
        test_datapath, train_datapath, data_type)

    # corpus embeddings are only needed for unseen-topic queries; compute
    # them lazily so an all-seen test set never pays the full-corpus embed
    _corpus_embs: List[np.ndarray] = []

    def corpus_embs() -> np.ndarray:
        if not _corpus_embs:
            _corpus_embs.append(embed_fn([d for _, d, _ in dialog_examples]))
        return _corpus_embs[0]

    topic_embs: Dict[str, np.ndarray] = {}

    # one batched embed_fn call for every test query (a model-backed
    # embed_fn pays per invocation, not per string)
    rows: List[Tuple[str, List[str]]] = []
    with open(test_datapath, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            splits = line.split("\t")
            rows.append((splits[0], splits[1].split(" [SEP] ")[-3:]))
    # the reference checks `data_type != "seen"` when building the query
    # (:405) but builds the database with `!= "wow_seen"` (:285); we use
    # the database convention on both sides so query and example
    # embeddings live in the same text space
    queries = [("( " + topic + " ) " if data_type != "wow_seen" else "")
               + " ".join(turns) for topic, turns in rows]
    query_embs = embed_fn(queries) if queries else np.zeros((0, 1))

    written = 0
    with open(output_prompt_path, "w", encoding="utf-8") as out:
        for (topic, turns), q in zip(rows, query_embs):
            if topic not in train_by_topic:
                if not dialog_examples:
                    out.write(json.dumps({topic + " " + turns[-1]: []}) + "\n")
                    written += 1
                    continue
                # nearest dialogs across the corpus, one per topic,
                # least-similar-first (ref :389-421 reverses at the end)
                sims = corpus_embs() @ q
                seen_topics = set()
                selected: List[str] = []
                for idx in np.argsort(-sims):
                    t, _, inst = dialog_examples[int(idx)]
                    if t not in seen_topics:
                        seen_topics.add(t)
                        selected.append(inst)
                        if len(selected) == num_prompts:
                            break
                example_list = selected[::-1]
            else:
                k = min(len(train_by_topic[topic]), num_prompts)
                if topic not in topic_embs:
                    topic_embs[topic] = embed_fn(dialog_by_topic[topic])
                sims = topic_embs[topic] @ q
                top = np.argsort(-sims)[:k]
                # most similar LAST (ref select_prompts...:385-391 reverses)
                example_list = [train_by_topic[topic][int(i)]
                                for i in top][::-1]
            key = topic + " " + turns[-1]
            out.write(json.dumps({key: example_list}) + "\n")
            written += 1
    return written


def prompt_selection_for_response_generation(input_path: str, output_path: str,
                                             seed: int = 1234,
                                             n_prompts: int = 20) -> int:
    """Pick response-generation prompt examples whose response overlaps its
    knowledge in long runs (ref preprocessing.py:458-530): >=10-token
    contiguous overlap totalling 60-90% of the response and >=80% of the
    knowledge. Writes `n_prompts` shuffled examples."""
    examples = []
    with open(input_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            splits = line.split("\t")
            topic, context, knowledge, response = (splits + [""])[:4]
            turns = context.split(" [SEP] ")[-3:]
            if knowledge == NO_KNWL:
                continue
            k_toks = word_tokenize(knowledge)
            k_set = set(k_toks)
            r_toks = word_tokenize(response)
            overlap = run = 0
            for tok in r_toks:
                if tok in k_set:
                    run += 1
                else:
                    if run >= 10:
                        overlap += run
                    run = 0
            if run >= 10:
                overlap += run
            if not (0.6 * len(r_toks) <= overlap <= 0.9 * len(r_toks)):
                continue
            if overlap < 0.8 * len(k_toks):
                continue
            examples.append(
                "Topic: " + topic + ". "
                + "User says: " + " ".join(word_tokenize(turns[-1])) + " "
                + "We know that: " + " ".join(k_toks) + " "
                + "System replies: " + " ".join(r_toks))
    rng = np.random.RandomState(seed)
    rng.shuffle(examples)
    n = min(n_prompts, len(examples))
    with open(output_path, "w", encoding="utf-8") as f:
        for e in examples[:n]:
            f.write(e + "\n")
    return n


def prepare_input_for_response_generation(test_file: str, knwl_gen_file: str,
                                          processed_file: str) -> int:
    """Substitute generated knowledge into the test tsv
    (ref preprocessing.py:533-559)."""
    with open(knwl_gen_file, encoding="utf-8") as f:
        knowledge_list = f.readlines()
    with open(test_file, encoding="utf-8") as f:
        rows = [l for l in (line.strip() for line in f) if l]
    if len(knowledge_list) < len(rows):
        raise ValueError(
            f"{knwl_gen_file} has {len(knowledge_list)} lines but "
            f"{test_file} has {len(rows)} non-blank rows — a truncated "
            "knowledge-generation output would desynchronize the "
            "substitution")
    n = 0
    with open(processed_file, "w", encoding="utf-8") as fw:
        for line in rows:
            splits = line.split("\t")
            # index by written row, not raw line number: blank lines in the
            # tsv must not desynchronize the knowledge alignment
            knowledge = knowledge_list[n].strip().replace("<|endoftext|>", "")
            fw.write(splits[0] + "\t" + splits[1] + "\t" + knowledge + "\t"
                     + splits[3] + "\n")
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="MSDP preprocessing")
    p.add_argument("--func", required=True,
                   choices=["process_wow_dataset", "process_woi_dataset",
                            "get_knwl_gen_prompts", "get_resp_gen_prompts",
                            "prepare_input"])
    p.add_argument("--raw_file")
    p.add_argument("--processed_file")
    p.add_argument("--knwl_ref_file")
    p.add_argument("--resp_ref_file")
    p.add_argument("--knwl_gen_file")
    p.add_argument("--test_file")
    p.add_argument("--train_file")
    p.add_argument("--data_type",
                   choices=["wow_seen", "wow_unseen", "woi"])
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)

    if args.func == "process_wow_dataset":
        n = process_wow_dataset(args.raw_file, args.processed_file,
                                args.knwl_ref_file, args.resp_ref_file)
    elif args.func == "process_woi_dataset":
        n = process_woi_dataset(args.raw_file, args.processed_file,
                                args.knwl_ref_file, args.resp_ref_file)
    elif args.func == "get_knwl_gen_prompts":
        n = prompt_selection_for_knowledge_generation(
            args.test_file, args.train_file, args.processed_file,
            args.data_type)
    elif args.func == "get_resp_gen_prompts":
        n = prompt_selection_for_response_generation(
            args.train_file, args.processed_file, args.seed)
    else:
        n = prepare_input_for_response_generation(
            args.test_file, args.knwl_gen_file, args.processed_file)
    print(f"{args.func}: wrote {n} items")
    return n


if __name__ == "__main__":
    main()
