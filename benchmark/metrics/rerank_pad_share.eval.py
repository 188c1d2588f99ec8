"""rerank_pad_share.eval: 100 x (1 - pairs / rows) over the traced
evaluation's ``vast.eval.itm_rerank`` spans, %: the share of the rows
its grouped ITM calls scored that were padding to each call's longest
segment (the spans' ``pairs`` and ``rows`` counts)."""

from benchmark.metrics._spans import eval_stages


def read(obs):
    stages = eval_stages(obs, "vast.eval.itm_rerank")
    rows = sum(s["counts"].get("rows", 0) for s in stages or ())
    if not rows:
        return None
    pairs = sum(s["counts"].get("pairs", 0) for s in stages)
    return 100.0 * (1.0 - pairs / rows)
