"""vswin_fwd_ms.train: the median, over the traced steps, of the device
ms of the program's four Video Swin stage spans (``vast.videoswin.
stage<S>``, the tower's forward), summed."""

import statistics

from benchmark.metrics._videoswin import stages_by_step


def read(obs):
    steps = stages_by_step(obs)
    if steps is None or any(s["device_s"] is None for st in steps
                            for s in st):
        return None
    return statistics.median(1e3 * sum(s["device_s"] for s in st)
                             for st in steps)
