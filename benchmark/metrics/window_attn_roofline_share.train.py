"""window_attn_roofline_share.train: the least time of the traced steps'
attention launches, from their shapes (Video Swin's windows by
counts/window_attention.py, BEATs' by counts/attention.py), over the
device time of the attention kernels, %; None where the launches
counted differ from the shapes' or none ran."""

from benchmark.counts.window_attention import launches_bound_s


def read(obs):
    trace = obs.get("trace") if obs.get("kind") == "train" else None
    launches = obs.get("window_launches")
    if not trace or not launches or trace["attention_s"] <= 0:
        return None
    if obs.get("attention_launches_counted") != len(launches):
        return None
    return (100.0 * launches_bound_s(obs["device_name"], launches)
            / trace["attention_s"])
