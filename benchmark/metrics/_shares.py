"""Shares that the per-layer readers of several cells compute alike."""

from benchmark.counts.attention import launches_bound_s


def attention_roofline(obs):
    """The least time of the traced window's attention launches (from
    their shapes) over the attention kernels' device time, %; None where
    the launches counted differ from the shapes' or none ran."""
    trace = obs.get("trace")
    launches = obs.get("attention_launches")
    if not trace or not launches or trace["attention_s"] <= 0:
        return None
    if obs.get("attention_launches_counted") != len(launches):
        return None
    return (100.0 * launches_bound_s(obs["device_name"], launches)
            / trace["attention_s"])


def device_idle(obs):
    """One minus the device's busy time a step or evaluation, from the
    traced ones (the union of their operations' intervals), over the
    untraced window's time a step or evaluation, %: the profiler slows
    the host, so the traced window's own wall time would overstate the
    idle share."""
    trace = obs.get("trace")
    if not trace or trace["busy_s"] <= 0 or not obs.get("profiled"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / obs["profiled"] / obs["unit_s"])
