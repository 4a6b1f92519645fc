"""Open-domain QA answer matching, DPR's conventions (counterpart of
tasks/qa_utils.py, itself the reference's tasks/orqa/unsupervised/
qa_utils.py and tokenizers.py).

has_answer decides whether retrieved evidence holds an answer with
DPR's two match types: "string" (an uncased word sequence inside the
text after NFD normalization; punctuation stays a token, so 'New York'
does not match 'New-York') and "regex" (a case-insensitive pattern
search); exact_match_score is the reader-side SQuAD exact match, over
this module's own copy of the SQuAD/ParlAI answer normalization.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, List, Sequence, Tuple

try:  # the `regex` module has the \p classes; `re` is the fallback
    import regex as _re
    _TOKEN = _re.compile(r"[\p{L}\p{N}\p{M}]+|[^\p{Z}\p{C}]", _re.UNICODE)
except ImportError:  # pragma: no cover
    import re as _re
    _TOKEN = _re.compile(r"\w+|[^\w\s]", _re.UNICODE)

_RE_ART = re.compile(r"\b(a|an|the)\b")
_RE_PUNC = re.compile(r"[!\"#$%&()*+,\-./:;<=>?@\[\]\\^`{|}~_']")


def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation, articles and extra whitespace."""
    s = _RE_PUNC.sub(" ", s.lower())
    s = _RE_ART.sub(" ", s)
    return " ".join(s.split())


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def _words(text: str) -> List[str]:
    """The uncased token stream, words and punctuation."""
    return [m.group().lower() for m in _TOKEN.finditer(text)]


def regex_match(text: str, pattern: str) -> bool:
    """A case-insensitive search; a bad pattern matches nothing."""
    try:
        compiled = _re.compile(pattern,
                               _re.IGNORECASE | _re.UNICODE | _re.MULTILINE)
    except BaseException:
        return False
    return compiled.search(text) is not None


def has_answer(answers: Sequence[str], text: str, match_type: str = "string"
               ) -> bool:
    """Does `text` contain any of `answers`?"""
    text = _normalize(text)
    if match_type == "string":
        words = _words(text)
        for answer in answers:
            ans = _words(_normalize(answer))
            if not ans:
                continue
            n = len(ans)
            for i in range(0, len(words) - n + 1):
                if ans == words[i: i + n]:
                    return True
        return False
    if match_type == "regex":
        return any(regex_match(text, _normalize(a)) for a in answers)
    raise ValueError(f"unknown match_type {match_type!r}")


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    """SQuAD-style exact match after normalize_answer."""
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def calculate_matches(get_doc_text: Callable[[object], str],
                      answers: List[List[str]],
                      closest_docs: List[Sequence[object]],
                      match_type: str = "string"
                      ) -> Tuple[List[int], List[List[bool]]]:
    """(top_k_hits, questions_doc_hits): top_k_hits[k-1] counts the
    questions whose answer appears in their top k retrievals;
    get_doc_text maps a doc id to its text."""
    n_docs = len(closest_docs[0]) if closest_docs else 0
    top_k_hits = [0] * n_docs
    questions_doc_hits: List[List[bool]] = []
    for ans, doc_ids in zip(answers, closest_docs):
        hits = [has_answer(ans, get_doc_text(d), match_type)
                for d in doc_ids]
        questions_doc_hits.append(hits)
        best = next((i for i, h in enumerate(hits) if h), None)
        if best is not None:
            for k in range(best, n_docs):
                top_k_hits[k] += 1
    return top_k_hits, questions_doc_hits
