"""device_idle_share.train: one minus the device's busy time a unit of
work (the union of its operations' intervals in the traced window) over
the untraced window's time a unit, %."""

from benchmark.metrics._shares import device_idle


def read(obs):
    return device_idle(obs) if obs.get("kind") == "train" else None
