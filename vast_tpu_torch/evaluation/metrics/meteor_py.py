"""Pure-Python METEOR (exact + Porter-stem stages, METEOR 1.5 scoring).

The port's own copy of ``vast_tpu.evaluation.metrics.meteor_py``, with
its own Porter stemmer (``metrics/porter.py``, equal to nltk's default
``PorterStemmer()``) in place of nltk's, which the port does not need.
The reference computes METEOR in every caption eval through the Java
meteor-1.5.jar (evaluation_tools/caption_tools/pycocoevalcap/meteor/
meteor.py:23-30, eval.py:56-64). The jar is stripped from the snapshot
and the image has no Java, so this module reimplements the metric in
Python so caption evals always report a METEOR number. When the jar IS
present (``VAST_METEOR_JAR``), coco_eval prefers it (see meteor.py).

Scope and documented deviations from meteor-1.5.jar -l en -norm:

* Match stages implemented: **exact** (weight 1.0) and **Porter stem**
  (weight 0.6) — the first two of the jar's four. The **synonym** stage
  needs the WordNet corpus (absent from this image; nltk is installed
  but its wordnet data is not) and the **paraphrase** stage needs the
  ~100 MB paraphrase-en.gz table shipped inside the jar. Both are
  additive recall stages: dropping them can only lose matches, so this
  scorer is a (usually slight) under-estimate. On typical caption data
  the synonym+paraphrase stages move corpus METEOR by roughly 1-3
  points; treat absolute comparisons against jar-computed numbers with
  that margin.
* The English **function-word list** below approximates the jar's
  corpus-derived function.words resource (words with relative frequency
  above 1e-3) with the standard closed-class English words.
* The aligner is a beam search (width 64) over one-to-one word matches
  maximizing total match weight and tie-breaking on fewest chunks —
  the same objective as the jar's Aligner, which also beam-searches.

Scoring follows the Meteor 1.5 parameterization for English
(alpha=0.85, beta=0.2, gamma=0.6, delta=0.75):

    P      = weighted_matches_hyp / weighted_length_hyp
    R      = weighted_matches_ref / weighted_length_ref
    Fmean  = P*R / (alpha*P + (1-alpha)*R)
    Pen    = gamma * (chunks / matches) ** beta      (0 when chunks == 0)
    score  = (1 - Pen) * Fmean

where "weighted" applies the stage weight times delta for content words
and (1-delta) for function words. A hypothesis that matches its
reference completely in a single chunk is scored with zero penalty
(chunks treated as 0), so identical strings score exactly 1.0. The
corpus score aggregates the per-segment sufficient statistics (best
reference per segment, as the jar does) and applies the same formula to
the sums — NOT a mean of segment scores.
"""

from __future__ import annotations

import functools

from vast_tpu_torch.evaluation.metrics.porter import porter_stem

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_EXACT, W_STEM = 1.0, 0.6
_BEAM = 64

# Closed-class English words standing in for the jar's function.words
# resource (corpus words with relative frequency > 1e-3). Content words
# weigh DELTA in P/R; these weigh 1-DELTA.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either
neither and or but nor so yet for if while although though because since
unless until when whenever where wherever whether as than
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves who whom whose which what
am is are was were be been being do does did doing have has had having
will would shall should may might must can could
to of in on at by with from into onto over under above below between
among through during before after about against across behind beyond
within without toward towards up down out off near
not n't there here then now just only also too very quite rather
""".split())


@functools.lru_cache(maxsize=65536)
def _stem(word: str) -> str:
    return porter_stem(word)


def _word_weight(word: str) -> float:
    return (1.0 - DELTA) if word in FUNCTION_WORDS else DELTA


def _align(hyp: list[str], ref: list[str]):
    """One-to-one alignment maximizing (total stage weight, -chunks).

    Returns (pairs, chunks) where pairs is [(i, j, stage_weight), ...]
    sorted by hypothesis index. Beam search over hypothesis positions;
    state = (ref-used bitmask, index of last matched hyp pos, its ref
    pos, total weight, chunks). Chunk increments when the new match does
    not extend the previous one contiguously on both sides — the
    standard METEOR chunk definition.
    """
    ref_stems = [_stem(w) for w in ref]
    cands: list[list[tuple[int, float]]] = []
    for hw in hyp:
        hs = _stem(hw)
        c = [(j, W_EXACT if hw == rw else W_STEM)
             for j, rw in enumerate(ref)
             if hw == rw or hs == ref_stems[j]]
        cands.append(c)

    # state key: (mask, last_i, last_j); value: (weight, -chunks, pairs)
    states = {(0, -2, -2): (0.0, 0, ())}
    for i, c in enumerate(cands):
        nxt: dict = {}

        def push(key, val):
            old = nxt.get(key)
            if old is None or (val[0], val[1]) > (old[0], old[1]):
                nxt[key] = val

        for (mask, li, lj), (w, negch, pairs) in states.items():
            push((mask, li, lj), (w, negch, pairs))  # skip hyp[i]
            for j, sw in c:
                if mask >> j & 1:
                    continue
                contig = (li == i - 1 and lj == j - 1)
                push((mask | (1 << j), i, j),
                     (w + sw, negch - (0 if contig else 1),
                      pairs + ((i, j, sw),)))
        # prune to beam
        if len(nxt) > _BEAM:
            nxt = dict(sorted(nxt.items(),
                              key=lambda kv: (kv[1][0], kv[1][1]),
                              reverse=True)[:_BEAM])
        states = nxt

    _, negch, pairs = max(states.values(), key=lambda v: (v[0], v[1]))
    return list(pairs), -negch


class _Stats:
    """Sufficient statistics; summable across segments like MeteorStats."""

    __slots__ = ("wm_h", "wm_r", "wl_h", "wl_r", "matches", "chunks")

    def __init__(self):
        self.wm_h = self.wm_r = self.wl_h = self.wl_r = 0.0
        self.matches = self.chunks = 0

    def add(self, o: "_Stats"):
        self.wm_h += o.wm_h
        self.wm_r += o.wm_r
        self.wl_h += o.wl_h
        self.wl_r += o.wl_r
        self.matches += o.matches
        self.chunks += o.chunks

    def score(self) -> float:
        if self.matches == 0 or self.wl_h == 0 or self.wl_r == 0:
            return 0.0
        p = self.wm_h / self.wl_h
        r = self.wm_r / self.wl_r
        if p == 0 or r == 0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        pen = 0.0
        if self.chunks > 0:
            pen = GAMMA * (self.chunks / self.matches) ** BETA
        return (1.0 - pen) * fmean


def _segment_stats(hyp: list[str], ref: list[str]) -> _Stats:
    s = _Stats()
    s.wl_h = sum(_word_weight(w) for w in hyp)
    s.wl_r = sum(_word_weight(w) for w in ref)
    if not hyp or not ref:
        return s
    pairs, chunks = _align(hyp, ref)
    s.matches = len(pairs)
    s.chunks = chunks
    for i, j, sw in pairs:
        s.wm_h += sw * _word_weight(hyp[i])
        s.wm_r += sw * _word_weight(ref[j])
    # identical-coverage special case: one chunk spanning BOTH sentences
    # entirely carries no fragmentation (identical strings score 1.0)
    if chunks == 1 and s.matches == len(hyp) == len(ref):
        s.chunks = 0
    return s


def _tokens(text) -> list[str]:
    """Accepts a raw string or a pre-tokenized list (coco_eval passes the
    PTB token lists); lowercase is the remaining normalization (the
    jar's -norm lowercases too)."""
    if isinstance(text, str):
        return text.lower().split()
    return [w.lower() for w in text]


def meteor_segment(hypothesis: str, references: list[str]) -> float:
    """Segment METEOR against the best-scoring reference."""
    hyp = _tokens(hypothesis)
    best = max((_segment_stats(hyp, _tokens(r)) for r in references),
               key=_Stats.score, default=_Stats())
    return best.score()


def meteor_score(gts: dict[str, list[str]],
                 res: dict[str, list[str]]) -> float:
    """Corpus METEOR: per segment pick the best-scoring reference, sum
    the sufficient statistics, score the sums (meteor.py:40-58's EVAL
    aggregation)."""
    total = _Stats()
    for key, hyps in res.items():
        hyp = _tokens(hyps[0])
        best = max((_segment_stats(hyp, _tokens(r)) for r in gts[key]),
                   key=_Stats.score, default=_Stats())
        total.add(best)
    return total.score()
