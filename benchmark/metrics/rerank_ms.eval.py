"""rerank_ms.eval: the device ms of the traced evaluation's
``vast.eval.itm_rerank`` spans, summed: the ITM rerank with no
synchronisation at its edges (``rerank_share.eval`` reads the
synchronised stage clock of a separate evaluation)."""

from benchmark.metrics._spans import eval_stage_ms


def read(obs):
    return eval_stage_ms(obs, "vast.eval.itm_rerank")
