"""Shared task-data helpers (a copy of the repo's tasks/data_utils.py;
the reference's tasks/data_utils.py)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def clean_text(text: str) -> str:
    """Collapse whitespace artifacts (ref: tasks/data_utils.py clean_text)."""
    for bad in ("‘", "’"):
        text = text.replace(bad, "'")
    return " ".join(text.split())


def truncate_pair(ids_a: List[int], ids_b: List[int], budget: int) -> None:
    """Trim the longer sequence from its end until the pair fits
    (ref: tasks/data_utils.py build_tokens_types_paddings_from_ids)."""
    while len(ids_a) + len(ids_b) > budget:
        longer = ids_a if len(ids_a) >= len(ids_b) else ids_b
        longer.pop()


def build_pair_sample(
    ids_a: List[int],
    ids_b: Optional[List[int]],
    max_seq_length: int,
    cls_id: int,
    sep_id: int,
    pad_id: int,
) -> Dict[str, np.ndarray]:
    """[CLS] a [SEP] (b [SEP]) -> fixed-length tokens/tokentypes/padding."""
    ids_a = list(ids_a)
    ids_b = list(ids_b) if ids_b else []
    extra = 3 if ids_b else 2
    truncate_pair(ids_a, ids_b, max_seq_length - extra)

    toks = [cls_id] + ids_a + [sep_id]
    types = [0] * len(toks)
    if ids_b:
        toks += ids_b + [sep_id]
        types += [1] * (len(ids_b) + 1)

    tokens = np.full(max_seq_length, pad_id, np.int64)
    tokens[: len(toks)] = toks
    tokentypes = np.zeros(max_seq_length, np.int64)
    tokentypes[: len(types)] = types
    mask = np.zeros(max_seq_length, np.float32)
    mask[: len(toks)] = 1.0
    return {"tokens": tokens, "tokentype_ids": tokentypes,
            "padding_mask": mask}
