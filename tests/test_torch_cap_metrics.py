"""The port's caption and VQA metrics against vast_tpu's, exactly.

The PTB tokenizer, BLEU 1-4, ROUGE-L, CIDEr, the pure-Python METEOR and
``compute_caption_metrics`` on the 300 captions of
``tests/fixtures/ptb_golden.json`` and on random captions; the VQA
normalisation and accuracies; and the port's Porter stemmer against
nltk's default ``PorterStemmer()`` over every word those captions hold
(the port keeps its own stemmer: the card's machine has no nltk).
"""

import json
import os
import random

import pytest

from vast_tpu.evaluation import vqa_metrics as j_vqa
from vast_tpu.evaluation.metrics import coco_eval as j_coco
from vast_tpu.evaluation.metrics import meteor_py as j_meteor
from vast_tpu.evaluation.metrics import text as j_text
from vast_tpu_torch.evaluation import vqa_metrics as p_vqa
from vast_tpu_torch.evaluation.metrics import coco_eval as p_coco
from vast_tpu_torch.evaluation.metrics import meteor_py as p_meteor
from vast_tpu_torch.evaluation.metrics import text as p_text
from vast_tpu_torch.evaluation.metrics.porter import porter_stem

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "ptb_golden.json")
WORDS = ("a man woman dog cat is running walks played ball park red blue "
         "green car bikes street water beach sings music guitar drums bird "
         "talking jumps rides eating food table chairs rooms house trees "
         "sky sun raining snow boys girl children people crowd two three "
         "with at near over under small bigger fast slowly video audio "
         "the of and in on happily quickly generalization hopefulness "
         "relational conditional cried flies dying").split()


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as f:
        return [e["caption"] for e in json.load(f)["entries"]]


def _random_captions(seed, n):
    rs = random.Random(seed)
    return [" ".join(rs.choice(WORDS) for _ in range(rs.randint(0, 14)))
            + rs.choice(["", ".", " !", ", too"]) for _ in range(n)]


def _corpus(captions, shift=(1, 2)):
    """gts / res over ``captions``: two references and one hypothesis a
    key, taken at offsets of each other."""
    n = len(captions)
    gts = {f"c{i}": [captions[i], captions[(i + shift[0]) % n]]
           for i in range(n)}
    res = {f"c{i}": [captions[(i + shift[1]) % n]] for i in range(n)}
    return gts, res


def _tokenized(gts, res, tok):
    return ({k: [tok(c) for c in v] for k, v in gts.items()},
            {k: [tok(c) for c in v] for k, v in res.items()})


@pytest.mark.parametrize("source", ["golden", "random"])
def test_scorers_equal(golden, source):
    caps = golden if source == "golden" else _random_captions(0, 200)
    gts, res = _corpus(caps)
    for c in caps:
        assert p_text.ptb_tokenize(c) == j_text.ptb_tokenize(c), c
    pg, pr = _tokenized(gts, res, p_text.ptb_tokenize)
    jg, jr = _tokenized(gts, res, j_text.ptb_tokenize)
    assert p_text.bleu(pg, pr) == j_text.bleu(jg, jr)
    assert p_text.rouge_l(pg, pr) == j_text.rouge_l(jg, jr)
    assert p_text.cider(pg, pr) == j_text.cider(jg, jr)
    assert p_meteor.meteor_score(pg, pr) == j_meteor.meteor_score(jg, jr)
    for k in list(pr)[:50]:
        assert (p_meteor.meteor_segment(pr[k][0], pg[k])
                == j_meteor.meteor_segment(jr[k][0], jg[k]))


@pytest.mark.parametrize("seed", [1, 2])
def test_caption_metrics_file_equal(tmp_path, monkeypatch, golden, seed):
    """compute_caption_metrics on a COCO annfile with several references
    a clip; METEOR through the Python scorer in both packages."""
    monkeypatch.delenv("VAST_METEOR_JAR", raising=False)
    caps = _random_captions(seed, 60) + golden[:40]
    anns = [{"image_id": f"v{i % 25}", "caption": c, "id": i}
            for i, c in enumerate(caps)]
    annfile = tmp_path / "ann.json"
    annfile.write_text(json.dumps({"annotations": anns}))
    rs = random.Random(seed)
    results = [{"video_id": f"v{i}", "caption": rs.choice(caps)}
               for i in range(25)]
    got = p_coco.compute_caption_metrics(results, str(annfile))
    want = j_coco.compute_caption_metrics(results, str(annfile))
    assert got == want
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"}
    assert all(0.0 <= v <= 100.0 for k, v in got.items() if k != "CIDEr")
    assert p_coco.meteor_source() == "python"


def test_porter_stem_equals_nltk(golden):
    from nltk.stem.porter import PorterStemmer

    nltk_stem = PorterStemmer().stem
    words = set(WORDS)
    for c in golden + _random_captions(3, 200):
        words.update(p_text.ptb_tokenize(c))
        words.update(c.split())
    assert len(words) > 500
    diff = {w: (porter_stem(w), nltk_stem(w)) for w in words
            if porter_stem(w) != nltk_stem(w)}
    assert not diff


def test_porter_stem_rules():
    """nltk's departures from Porter's paper, which the port keeps."""
    cases = {"skies": "sky", "dying": "die", "ties": "tie", "cried": "cri",
             "died": "die", "enjoy": "enjoy", "happy": "happi",
             "radically": "radic", "generalli": "gener",
             "archaeologi": "archaeolog", "hopefulli": "hope", "is": "is",
             "controll": "control", "agreed": "agre", "hopping": "hop"}
    from nltk.stem.porter import PorterStemmer

    nltk_stem = PorterStemmer().stem
    for w, want in cases.items():
        assert porter_stem(w) == nltk_stem(w) == want, w


def test_vqa_metrics_equal():
    answers = ["Two", "the dog", "an apple!", "it's red", "none", "cant",
               "three  cats", "yes", "no", "A man."]
    rs = random.Random(4)
    for a in answers + _random_captions(5, 100):
        assert p_vqa.normalize_answer(a) == j_vqa.normalize_answer(a), a
    preds = [rs.choice(answers) for _ in range(200)]
    gts = [rs.choice(answers) if rs.random() < 0.7
           else [rs.choice(answers) for _ in range(3)] for _ in range(200)]
    assert (p_vqa.exact_match_accuracy(preds, gts)
            == j_vqa.exact_match_accuracy(preds, gts))
    lists = [[rs.choice(answers) for _ in range(10)] for _ in range(200)]
    assert (p_vqa.vqa_accuracy(preds, lists)
            == j_vqa.vqa_accuracy(preds, lists))
    assert 0.0 < p_vqa.exact_match_accuracy(preds, gts) < 1.0
