"""rerank_share.eval: the ITM rerank's seconds by the program's stage
clock (``evaluate_ret``'s ``timings["itm_rerank"]``, which synchronises
at each stage's edges) over that evaluation's wall time, %."""


def read(obs):
    stages = obs.get("stage_s") if obs.get("kind") == "eval" else None
    if not stages or "itm_rerank" not in stages:
        return None
    return 100.0 * stages["itm_rerank"] / obs["staged_eval_s"]
