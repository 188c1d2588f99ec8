"""VQAv2-style answer normalization + accuracy.

The port's own copy of ``vast_tpu.evaluation.vqa_metrics``. Reference: evaluation_tools/vqa_tools/vqa_eval.py — contraction fixes,
punctuation stripping, article removal, digit words; accuracy =
min(#matching_humans / 3, 1) for VQAv2, exact match for the simple path
(evaluation_mm.py:94-96 uses plain equality; both are provided).
"""

from __future__ import annotations

import re

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve":
    "could've", "couldnt": "couldn't", "didnt": "didn't", "doesnt":
    "doesn't", "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't",
    "havent": "haven't", "hes": "he's", "im": "i'm", "isnt": "isn't",
    "itd": "it'd", "itll": "it'll", "lets": "let's", "shes": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't", "thats": "that's",
    "theres": "there's", "theyd": "they'd", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "wasnt": "wasn't",
    "werent": "weren't", "whats": "what's", "wheres": "where's",
    "whos": "who's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "youd": "you'd", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}
_DIGITS = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
           "four": "4", "five": "5", "six": "6", "seven": "7",
           "eight": "8", "nine": "9", "ten": "10"}
_ARTICLES = {"a", "an", "the"}
_PUNCT = re.compile(r"[;/\[\]\"{}()=+\\_\-><@`,?!.']")


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _PUNCT.sub("", ans)
    words = []
    for w in ans.split():
        w = _DIGITS.get(w, w)
        w = _CONTRACTIONS.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    return " ".join(words)


def exact_match_accuracy(preds: list[str], gts: list) -> float:
    """Plain equality accuracy (evaluation_mm.py:94-96), one gt entry per
    prediction; a list-valued entry (multi-annotator answers) scores a
    hit when the prediction matches ANY of its elements."""
    assert len(preds) == len(gts)

    def hit(p, g):
        return p in g if isinstance(g, (list, tuple)) else p == g

    return sum(map(hit, preds, gts)) / max(len(gts), 1)


def vqa_accuracy(preds: list[str], gt_answer_lists: list[list[str]]) -> float:
    """VQAv2 consensus accuracy: min(#humans agreeing / 3, 1), averaged."""
    total = 0.0
    for p, answers in zip(preds, gt_answer_lists):
        p = normalize_answer(p)
        matches = sum(normalize_answer(a) == p for a in answers)
        total += min(matches / 3.0, 1.0)
    return total / max(len(preds), 1)
