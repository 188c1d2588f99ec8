"""train_mfu: the model FLOPs of the window's steps (counted from the
cell's shapes, counts/flops.py) over the window's time and the card's
bf16 dense peak, %."""

from benchmark.counts.attention import peaks_for


def read(obs):
    if obs.get("kind") != "train":
        return None
    peak = peaks_for(obs["device_name"])[0]
    return (100.0 * obs["flops_per_step"] * obs["steps"] / obs["window_s"]
            / peak)
