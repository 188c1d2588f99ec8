"""attn_roofline_share.eval: the least time of the traced window's
attention launches, from their shapes (counts/attention.py), over the
device time of the attention kernels, %."""

from benchmark.metrics._shares import attention_roofline


def read(obs):
    return attention_roofline(obs) if obs.get("kind") == "eval" else None
