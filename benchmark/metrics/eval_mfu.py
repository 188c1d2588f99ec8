"""eval_mfu: the model FLOPs of the window's evaluations (the towers,
the text encoder and every grouped ITM call, counted from their shapes,
counts/flops.py) over the window's time and the card's bf16 dense
peak, %."""

from benchmark.counts.attention import peaks_for


def read(obs):
    if obs.get("kind") != "eval":
        return None
    peak = peaks_for(obs["device_name"])[0]
    return (100.0 * obs["flops_per_eval"] * obs["evals"] / obs["window_s"]
            / peak)
