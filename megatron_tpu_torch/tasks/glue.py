"""GLUE sentence-pair classification data (a copy of the repo's
tasks/glue.py; the reference's tasks/glue/).

MNLI: tab-separated rows, premise col 8, hypothesis col 9, label last col,
labels {contradiction:0, entailment:1, neutral:2} (tasks/glue/mnli.py).
QQP: question1 col 3, question2 col 4, integer label col 5
(tasks/glue/qqp.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from megatron_tpu_torch.tasks.data_utils import (
    build_pair_sample, clean_text,
)

MNLI_LABELS = {"contradiction": 0, "entailment": 1, "neutral": 2}


def _read_tsv(path: str) -> List[List[str]]:
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    return rows[1:]  # header


def load_mnli(path: str) -> List[Dict]:
    out = []
    for row in _read_tsv(path):
        out.append({"text_a": clean_text(row[8]), "text_b": clean_text(row[9]),
                    "label": MNLI_LABELS[row[-1].strip()]})
    return out


def load_qqp(path: str) -> List[Dict]:
    out = []
    for row in _read_tsv(path):
        if len(row) < 6:
            continue  # ref: qqp.py skips malformed rows
        out.append({"text_a": clean_text(row[3]), "text_b": clean_text(row[4]),
                    "label": int(row[5])})
    return out


class GlueDataset:
    """Tokenized fixed-length classification samples."""

    def __init__(self, samples: List[Dict], tokenize: Callable[[str], List[int]],
                 max_seq_length: int, cls_id: int, sep_id: int, pad_id: int):
        self.items = []
        for s in samples:
            item = build_pair_sample(
                tokenize(s["text_a"]), tokenize(s["text_b"]),
                max_seq_length, cls_id, sep_id, pad_id)
            item["label"] = np.int64(s["label"])
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]
