"""Optional METEOR metric via the Java jar (pycocoevalcap-compatible).

The port's own copy of ``vast_tpu.evaluation.metrics.meteor``. The
reference shells out to meteor-1.5.jar
(evaluation_tools/caption_tools/pycocoevalcap/meteor/meteor.py:15-30); the
jar is stripped from the snapshot and this image has no Java, so METEOR is
optional: available() gates it, and compute_caption_metrics simply omits
the key when unavailable (BLEU/ROUGE-L/CIDEr are pure Python).

Set VAST_METEOR_JAR to the jar path to enable.
"""

from __future__ import annotations

import os
import shutil
import subprocess


def available() -> bool:
    jar = os.environ.get("VAST_METEOR_JAR", "")
    return bool(jar) and os.path.exists(jar) and shutil.which("java") is not None


def meteor_score(gts: dict[str, list[str]], res: dict[str, list[str]]) -> float:
    """Corpus METEOR via the jar's stdio protocol (meteor.py:32-61)."""
    jar = os.environ["VAST_METEOR_JAR"]
    proc = subprocess.Popen(
        ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en",
         "-norm"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        cwd=os.path.dirname(jar) or ".")
    try:
        eval_line = "EVAL"
        for key in res:
            hyp = res[key][0].replace("|||", "").replace("  ", " ")
            refs = [r.replace("|||", "").replace("  ", " ")
                    for r in gts[key]]
            score_line = " ||| ".join(("SCORE", " ||| ".join(refs), hyp))
            proc.stdin.write((score_line + "\n").encode())
            proc.stdin.flush()
            stats = proc.stdout.readline().decode().strip()
            eval_line += " ||| " + stats
        proc.stdin.write((eval_line + "\n").encode())
        proc.stdin.flush()
        for _ in res:
            proc.stdout.readline()  # per-segment scores
        return float(proc.stdout.readline().strip())
    finally:
        proc.kill()
