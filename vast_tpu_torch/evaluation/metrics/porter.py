"""The Porter stemmer, as nltk's default ``PorterStemmer()`` stems.

METEOR's stem stage (``meteor_py``) needs a Porter stemmer; nltk's
default mode (``NLTK_EXTENSIONS``) is what ``vast_tpu`` calls. The port
keeps its own so that it needs no nltk. The algorithm is M. F. Porter's
"An algorithm for suffix stripping" (1980), with nltk's departures from
it:

* a pool of irregular forms (sky/skies, dying, lying, tying, news,
  innings, outings, cannings, howe, proceed, exceed, succeed);
* words of at most two letters stay as they are;
* *o also holds for a two-letter vowel-consonant stem;
* step 1a: a four-letter ``-ies`` becomes ``-ie``; step 1b: ``-ied``
  becomes ``-ie`` (four letters) or ``-i``;
* step 1c: ``y`` -> ``i`` only after a consonant that is not the word's
  first letter;
* step 2: ``-alli`` -> ``-al`` first and again, ``-bli`` -> ``-ble``
  (not ``-abli``), and ``-fulli`` -> ``-ful``, ``-logi`` -> ``-log``.

Each rule list applies its first rule whose suffix matches: if that
rule's condition fails, the word stays as it is.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiou")

_IRREGULAR = {
    "skies": "sky", "sky": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "news": "news", "innings": "inning",
    "inning": "inning", "outings": "outing", "outing": "outing",
    "cannings": "canning", "canning": "canning", "howe": "howe",
    "proceed": "proceed", "exceed": "exceed", "succeed": "succeed",
}


def _consonant(w: str, i: int) -> bool:
    if w[i] in _VOWELS:
        return False
    if w[i] != "y":
        return True
    # a run of y's alternates, starting from the letter before the run
    odd = False
    while i > 0 and w[i] == "y":
        odd = not odd
        i -= 1
    return (w[i] not in _VOWELS) != odd


def _measure(stem: str) -> int:
    """m of [C](VC){m}[V]."""
    cv = "".join("c" if _consonant(stem, i) else "v"
                 for i in range(len(stem)))
    return cv.count("vc")


def _has_vowel(stem: str) -> bool:
    return any(not _consonant(stem, i) for i in range(len(stem)))


def _double_consonant(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _consonant(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """*o: consonant-vowel-consonant, the last not w, x or y; or a
    two-letter vowel-consonant word."""
    n = len(w)
    if n >= 3 and _consonant(w, n - 3) and not _consonant(w, n - 2) \
            and _consonant(w, n - 1) and w[-1] not in "wxy":
        return True
    return n == 2 and not _consonant(w, 0) and _consonant(w, 1)


def _m_gt(k):
    return lambda stem: _measure(stem) > k


def _apply(word: str, rules) -> str:
    """The first rule whose suffix ends ``word``: its replacement where
    its condition holds on the stem, else ``word``."""
    for suffix, repl, cond in rules:
        if word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
            return stem + repl if cond is None or cond(stem) else word
    return word


def _step1a(w: str) -> str:
    if w.endswith("ies") and len(w) == 4:
        return w[:-3] + "ie"
    return _apply(w, (("sses", "ss", None), ("ies", "i", None),
                      ("ss", "ss", None), ("s", "", None)))


def _step1b(w: str) -> str:
    if w.endswith("ied"):
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        return w[:-1] if _measure(w[:-3]) > 0 else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[:-len(suffix)]):
            stem = w[:-len(suffix)]
            break
    else:
        return w
    for end, repl in (("at", "ate"), ("bl", "ble"), ("iz", "ize")):
        if stem.endswith(end):
            return stem[:-len(end)] + repl
    if _double_consonant(stem):
        return stem[:-1] if stem[-1] not in "lsz" else stem
    if _measure(stem) == 1 and _cvc(stem):
        return stem + "e"
    return stem


def _step1c(w: str) -> str:
    return _apply(w, (("y", "i",
                       lambda s: len(s) > 1 and _consonant(s, len(s) - 1)),))


_STEP2 = tuple((s, r, _m_gt(0)) for s, r in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
    ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
    ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ("fulli", "ful")))


def _step2(w: str) -> str:
    if w.endswith("alli") and _measure(w[:-4]) > 0:
        return _step2(w[:-4] + "al")
    # -logi -> -log where the stem with its l has a positive measure
    return _apply(w, _STEP2 + (("logi", "log",
                                lambda s: _measure(w[:-3]) > 0),))


_STEP3 = tuple((s, r, _m_gt(0)) for s, r in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", "")))

_STEP4 = tuple(
    (s, "", (lambda st: _measure(st) > 1 and st[-1] in "st")
     if s == "ion" else _m_gt(1))
    for s in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
              "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
              "ous", "ive", "ize"))


def _step5a(w: str) -> str:
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            return w[:-1]
    return w


def _step5b(w: str) -> str:
    if w.endswith("ll") and _measure(w[:-1]) > 1:
        return w[:-1]
    return w


def porter_stem(word: str) -> str:
    """The stem of ``word``, lowercased first."""
    w = word.lower()
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if len(word) <= 2:
        return w
    for step in (_step1a, _step1b, _step1c, _step2):
        w = step(w)
    w = _apply(w, _STEP3)
    w = _apply(w, _STEP4)
    return _step5b(_step5a(w))
