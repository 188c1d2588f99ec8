"""The program's Video Swin stage spans (``vast.videoswin.stage<S>``) in
the traced steps, as the per-layer readers of a Video Swin cell read
them."""

from benchmark.metrics._spans import recorded

STAGE = "vast.videoswin.stage"


def stages_by_step(obs):
    """For each traced ``vast.train.step`` span, in order, its stage
    spans; None where a run recorded no step or a step no stage."""
    spans = recorded(obs, "train")
    steps = [s for s in spans or () if s["name"] == "vast.train.step"]
    out = [[s for s in spans if s["root"] == step["id"]
            and s["name"].startswith(STAGE)] for step in steps]
    return out if out and all(out) else None
