"""attn_bias_mb.train: the ``bias_bytes`` counts of the Video Swin stage
spans in the first traced forward, summed, in MB (1e6 bytes): the
additive bias that the tower's attention calls materialise beyond the
bias table they are given."""

from benchmark.metrics._videoswin import stages_by_step


def read(obs):
    steps = stages_by_step(obs)
    if steps is None:
        return None
    return sum(s["counts"].get("bias_bytes", 0) for s in steps[0]) / 1e6
