"""Caption metric primitives: PTB-ish tokenizer, BLEU, ROUGE-L, CIDEr.

The port's own copy of ``vast_tpu.evaluation.metrics.text``. Pure-Python replacements for the reference's vendored pycocoevalcap
(evaluation_tools/caption_tools/), whose METEOR/PTBTokenizer shell out to
Java jars that are stripped from the snapshot (SURVEY §1.8). BLEU/ROUGE-L/
CIDEr follow the standard COCO-caption definitions (Papineni'02 with the
closest-reference brevity penalty; Lin'04 ROUGE-L F with beta=1.2;
Vedantam'15 CIDEr n=1..4, sigma=6, corpus IDF). METEOR is exposed as an
optional Java subprocess (metrics/meteor.py) and skipped when absent.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict

# The reference pipeline is: Java PTBTokenizer with `-preserveLines
# -lowerCase` (so every emitted token is ALREADY lowercase), then a Python
# filter dropping tokens `in PUNCTUATIONS` — an UPPERCASE list
# (tokenizer/ptbtokenizer.py:24-25,69). Consequence the old approximation
# missed: the bracket pseudo-tokens arrive lowercased ("-lrb-") and do NOT
# match the uppercase list entries ("-LRB-"), so brackets SURVIVE the
# filter in the reference output (as they do in the published COCO-caption
# token vocabularies). We replicate the full two-stage pipeline: tokenize
# like CoreNLP 3.4.1 PTBLexer defaults, lowercase, then filter with the
# verbatim list.
_PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                 ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNCT_SET = set(_PUNCTUATIONS)

# CoreNLP PTBLexer unicode normalization (defaults: latexQuotes=true,
# ptb3Dashes=true, ptb3Ellipsis=true, normalizeFractions=true,
# normalizeAmpersandEntity=true). Curly quotes -> latex quotes, unicode
# dashes -> "--", unicode ellipsis -> "...". All of `` '' ` ' -- ... are
# later removed by the PUNCTUATIONS filter, so the quote open/close
# distinction need not be tracked.
_UNICODE_MAP = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
    "–": "--", "—": "--", "―": "--",
    "…": "...",
    # plain 1/4 etc.: the token regex keeps slash-compounds as one token
    # and the downstream escapeForwardSlashAsterisk pass emits the
    # CoreNLP "1\/4" form (a pre-escaped replacement would be shredded
    # by the tokenizer, which has no backslash branch)
    "¼": "1/4", "½": "1/2", "¾": "3/4",
    " ": " ",
}
_UNICODE_RE = re.compile("|".join(map(re.escape, _UNICODE_MAP)))

_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
             "[": "-LSB-", "]": "-RSB-"}

# Common abbreviations the PTBLexer keeps fused with their period
# (PTBLexer ABBREV lists, trimmed to caption-plausible entries). With
# strictTreebank3=false (the default) a sentence-final abbreviation keeps
# its period and an extra "." token is emitted — the extra "." is filtered
# downstream, so we only need the fused form.
_ABBREVS = frozenset(
    "mr mrs ms dr prof rev hon st jr sr gen gov sgt capt lt col "
    "vs etc inc ltd co corp bros vol vols approx dept "
    "mt ft lb lbs hr hrs jan feb apr jun jul aug sep "
    "sept oct nov dec tue tues thur thurs".split())

# Americanize-lite: PTBLexer defaults americanize=true; full
# Americanize.java is a large pattern table — this covers the
# caption-frequent words only (residual divergence documented in
# tests/test_metrics.py::test_ptb_tokenize_residual_divergences).
_AMERICANIZE = {
    "colour": "color", "colours": "colors", "coloured": "colored",
    "colourful": "colorful", "favourite": "favorite",
    "favourites": "favorites", "favour": "favor", "flavour": "flavor",
    "flavours": "flavors", "harbour": "harbor", "harbours": "harbors",
    "neighbour": "neighbor", "neighbours": "neighbors",
    "neighbourhood": "neighborhood", "armour": "armor",
    "humour": "humor", "labour": "labor", "centre": "center",
    "centres": "centers", "theatre": "theater", "theatres": "theaters",
    "metre": "meter", "metres": "meters", "litre": "liter",
    "litres": "liters", "fibre": "fiber", "travelling": "traveling",
    "traveller": "traveler", "jewellery": "jewelry",
    "moustache": "mustache", "pyjamas": "pajamas", "doughnut": "donut",
    "doughnuts": "donuts", "aeroplane": "airplane",
    "aeroplanes": "airplanes",
}

# Token scanner, alternatives in priority order:
#   1. acronyms with periods (u.s., a.m.) — kept fused
#   2. known abbreviations + period — kept fused
#   3. comma-grouped numbers (1,000,000.5)
#   4. decimals / times-scores (3.5, 5:30, 2:1)
#   5. words, possibly hyphen/slash/apostrophe-joined (state-of-the-art,
#      black/white, man's) — PTB keeps hyphenated compounds single
#   6. ellipsis / em-dash runs
#   7. any single non-space char
_ABBREV_ALT = "|".join(sorted(_ABBREVS, key=len, reverse=True))
_TOKEN_RE = re.compile(
    r"(?:[A-Za-z]\.){2,}"
    rf"|(?:{_ABBREV_ALT})\.(?![A-Za-z0-9])"
    r"|\d{1,3}(?:,\d{3})+(?:\.\d+)?"
    r"|\d+[.:]\d+(?:[.:]\d+)*"
    r"|[A-Za-z0-9]+(?:[-/'][A-Za-z0-9]+)*"
    r"|\.\.\.|--+"
    r"|\S",
    re.IGNORECASE)


def _split_clitics(t: str) -> list[str]:
    """Penn-Treebank clitic splitting: don't -> do n't, man's -> man 's,
    cannot -> can not, gonna -> gon na (edu.stanford.nlp PTBTokenizer)."""
    if t == "cannot":
        return ["can", "not"]
    if t in ("gonna", "wanna", "gotta", "lemme", "gimme"):
        return [t[:3], t[3:]]
    m = re.match(r"(.+?)(n't)$", t)
    if m and m.group(1):
        return [m.group(1), "n't"]
    m = re.match(r"(.+?)('(?:s|re|ve|ll|d|m))$", t)
    if m:
        return [m.group(1), m.group(2)]
    return [t]


def ptb_tokenize(text: str) -> list[str]:
    """CoreNLP-3.4.1-faithful lowercase tokenizer + PUNCTUATIONS filter.

    Replicates the pycocoevalcap pipeline (tokenizer/ptbtokenizer.py:31-56:
    `java PTBTokenizer -preserveLines -lowerCase` then drop PUNCTUATIONS)
    without the Java dependency: unicode quote/dash/ellipsis normalization,
    bracket pseudo-tokens (-lrb- etc., which the uppercase filter list does
    NOT remove from lowercased output), hyphenated compounds kept single,
    comma-grouped numbers and times kept single, abbreviations kept fused
    with their period, forward-slash/asterisk escaping, PTB clitic
    splitting, and an Americanize-lite spelling pass. Golden fixtures:
    tests/fixtures/ptb_golden.json.
    """
    text = _UNICODE_RE.sub(lambda m: _UNICODE_MAP[m.group(0)], text)
    text = text.replace("&amp;", "&")
    text = re.sub(r"\s+", " ", text).strip()
    out = []
    for t in _TOKEN_RE.findall(text):
        if t in _BRACKETS:
            out.append(_BRACKETS[t].lower())
            continue
        if t.startswith("--"):
            t = "--"
        if t == '"':
            # latexQuotes: " -> `` or '' — both in PUNCTUATIONS, dropped
            continue
        t = t.lower()
        if t in _PUNCT_SET:
            continue
        for part in _split_clitics(t):
            part = _AMERICANIZE.get(part, part)
            # escapeForwardSlashAsterisk=true (PTBLexer default): / -> \/,
            # * -> \* — inside slash-compounds and standalone alike
            if "/" in part and "\\/" not in part:
                part = part.replace("/", "\\/")
            if part == "*":
                part = "\\*"
            out.append(part)
    return out


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(gts: dict, res: dict, max_n: int = 4) -> list[float]:
    """Corpus BLEU_1..max_n, COCO style (closest-length brevity penalty)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for key, hyps in res.items():
        hyp = hyps[0]
        refs = gts[key]
        cand_len += len(hyp)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            h_ng = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            totals[n - 1] += max(len(hyp) - n + 1, 0)
            clipped[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in h_ng.items())
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = []
    log_sum = 0.0
    tiny, small = 1e-15, 1e-9
    for n in range(max_n):
        p = (clipped[n] + tiny) / (totals[n] + small)
        log_sum += math.log(p)
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out


def _lcs(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(gts: dict, res: dict, beta: float = 1.2) -> float:
    """COCO ROUGE-L: max precision and max recall are taken over the refs
    SEPARATELY before the F-combination (pycocoevalcap rouge.py:70-74),
    possibly from different references."""
    scores = []
    for key, hyps in res.items():
        hyp = hyps[0]
        prec_max = rec_max = 0.0
        for ref in gts[key]:
            l = _lcs(hyp, ref)
            prec_max = max(prec_max, l / len(hyp) if hyp else 0.0)
            rec_max = max(rec_max, l / len(ref) if ref else 0.0)
        if prec_max and rec_max:
            best = ((1 + beta ** 2) * prec_max * rec_max) \
                / (rec_max + beta ** 2 * prec_max)
        else:
            best = 0.0
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def cider(gts: dict, res: dict, n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D style scoring as in pycocoevalcap's cider_scorer."""
    # document frequencies over reference sets
    df = [defaultdict(float) for _ in range(n)]
    for refs in gts.values():
        seen = [set() for _ in range(n)]
        for ref in refs:
            for k in range(n):
                seen[k].update(_ngrams(ref, k + 1).keys())
        for k in range(n):
            for ng in seen[k]:
                df[k][ng] += 1.0
    log_ref = math.log(max(len(gts), 1))

    def vec(tokens):
        out = []
        norms = []
        for k in range(n):
            c = _ngrams(tokens, k + 1)
            v = {}
            for ng, cnt in c.items():
                idf = log_ref - math.log(max(df[k][ng], 1.0))
                v[ng] = cnt * idf
            out.append(v)
            norms.append(math.sqrt(sum(x * x for x in v.values())))
        return out, norms

    scores = []
    for key, hyps in res.items():
        hyp = hyps[0]
        hv, hn = vec(hyp)
        total = 0.0
        for ref in gts[key]:
            rv, rn = vec(ref)
            delta = len(hyp) - len(ref)
            sim = 0.0
            for k in range(n):
                num = sum(min(hv[k].get(ng, 0.0), rv[k][ng]) * rv[k][ng]
                          for ng in rv[k])
                if hn[k] and rn[k]:
                    s = num / (hn[k] * rn[k])
                else:
                    s = 0.0
                s *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                sim += s
            total += sim / n
        scores.append(10.0 * total / max(len(gts[key]), 1))
    return sum(scores) / max(len(scores), 1)
