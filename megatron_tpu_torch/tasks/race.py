"""RACE reading-comprehension data (a copy of the repo's tasks/race.py;
the reference's tasks/race/data.py).

Each .txt file holds json lines {article, questions[], options[],
answers[]}; every question yields a 4-way multiple-choice sample. A
question containing "_" is fill-in-the-blank: the option replaces the
blank; otherwise q+option are concatenated (race/data.py:102-124).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, List

import numpy as np

from megatron_tpu_torch.tasks.data_utils import (
    build_pair_sample, clean_text,
)

NUM_CHOICES = 4


def load_race(datapath: str) -> List[Dict]:
    out = []
    for filename in sorted(glob.glob(os.path.join(datapath, "*.txt"))):
        with open(filename) as f:
            for line in f:
                data = json.loads(line)
                context = clean_text(data["article"])
                for q, opts, ans in zip(data["questions"], data["options"],
                                        data["answers"]):
                    q = clean_text(q)
                    assert len(opts) == NUM_CHOICES
                    if "_" in q:
                        qa = [q.replace("_", clean_text(o)) for o in opts]
                    else:
                        qa = [q + " " + clean_text(o) for o in opts]
                    out.append({"context": context, "qa": qa,
                                "label": ord(ans.strip()) - ord("A")})
    return out


class RaceDataset:
    """[B, 4, S] multiple-choice samples."""

    def __init__(self, samples: List[Dict], tokenize: Callable[[str], List[int]],
                 max_seq_length: int, cls_id: int, sep_id: int, pad_id: int):
        self.items = []
        for s in samples:
            ctx_ids = tokenize(s["context"])
            per_choice = [
                build_pair_sample(ctx_ids, tokenize(qa), max_seq_length,
                                  cls_id, sep_id, pad_id)
                for qa in s["qa"]
            ]
            self.items.append({
                "tokens": np.stack([c["tokens"] for c in per_choice]),
                "tokentype_ids": np.stack([c["tokentype_ids"] for c in per_choice]),
                "padding_mask": np.stack([c["padding_mask"] for c in per_choice]),
                "label": np.int64(s["label"]),
            })

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]
