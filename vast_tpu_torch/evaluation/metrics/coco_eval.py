"""COCO-caption metric harness over the pure-Python scorers.

The port's own copy of ``vast_tpu.evaluation.metrics.coco_eval``.
Reference flow (evaluation/evaluation_mm.py:386-393 + the vendored
pycocoevalcap COCOEvalCap): load COCO-format annotations, tokenize both
sides, report Bleu_1-4 / METEOR / ROUGE_L / CIDEr. METEOR comes from the
Java jar where ``VAST_METEOR_JAR`` and ``java`` exist, else from the
pure-Python scorer (``meteor_py``); ``meteor_source`` says which.
"""

from __future__ import annotations

import json

from vast_tpu_torch.evaluation.metrics.text import bleu, cider, ptb_tokenize, rouge_l


def load_coco_annotations(annfile: str) -> dict[str, list[str]]:
    """COCO-format {'annotations': [{'image_id', 'caption'}...]} -> gts."""
    with open(annfile) as f:
        data = json.load(f)
    gts: dict[str, list[str]] = {}
    anns = data["annotations"] if isinstance(data, dict) else data
    for a in anns:
        key = str(a.get("image_id", a.get("video_id")))
        gts.setdefault(key, []).append(a["caption"])
    return gts


def compute_caption_metrics(results: list[dict], annfile: str) -> dict:
    """results: [{'video_id': id, 'caption': text}, ...] -> metric dict
    with values scaled x100/rounded like the reference
    (evaluation_mm.py:386-393)."""
    gts_raw = load_coco_annotations(annfile)
    res_raw = {str(r["video_id"]): [r["caption"]] for r in results}
    keys = [k for k in res_raw if k in gts_raw]
    gts = {k: [ptb_tokenize(c) for c in gts_raw[k]] for k in keys}
    res = {k: [ptb_tokenize(res_raw[k][0])] for k in keys}

    b = bleu(gts, res)
    metrics = {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "ROUGE_L": rouge_l(gts, res),
        "CIDEr": cider(gts, res),
    }
    # METEOR: the jar when present (exact reference parity), else the
    # pure-Python reimplementation (exact+stem stages; see meteor_py.py
    # for the documented deviations)
    from vast_tpu_torch.evaluation.metrics import meteor
    if meteor.available():
        raw_gts = {k: gts_raw[k] for k in keys}
        raw_res = {k: res_raw[k] for k in keys}
        metrics["METEOR"] = meteor.meteor_score(raw_gts, raw_res)
    else:
        from vast_tpu_torch.evaluation.metrics import meteor_py
        metrics["METEOR"] = meteor_py.meteor_score(gts, res)
    return {k: round(v * 100, 2) for k, v in metrics.items()}


def meteor_source() -> str:
    """Which METEOR ``compute_caption_metrics`` runs: 'jar' or 'python'."""
    from vast_tpu_torch.evaluation.metrics import meteor
    return "jar" if meteor.available() else "python"
