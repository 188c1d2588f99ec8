"""The device trace of a traced run, reduced to what the metrics read.

A window of work runs under ``torch.profiler`` (CPU and CUDA activity).
Its device events (kernels, copies, fills) give the busy time as the
union of their intervals, so kernels that overlap count once; the idle
time is the rest of the window's wall time. The gaps between busy
intervals are named by the innermost host event that covers them: the
benchmark's own spans (``bench.*``) or the profiler's CPU ops.
"""

from __future__ import annotations

import contextlib
import re
import time

import numpy as np
import torch

ATTENTION_KERNEL = re.compile(r"attention_(fwd|bwd)\w*_kernel")
LABELLED_GAPS = 300


@contextlib.contextmanager
def traced(device):
    """Profile the body; yields a dict that receives ``summary``."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    out["summary"] = summarize(prof, wall)


def _merge(iv):
    iv = sorted(iv)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, wall_s: float) -> dict:
    dev, cpu = [], []
    for e in prof.events():
        tr = e.time_range
        if tr.end <= tr.start:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors host spans onto the device's timeline
            if not getattr(e, "is_user_annotation", False) \
                    and not e.name.startswith("bench."):
                dev.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    if not dev:
        return {"wall_s": wall_s, "busy_s": 0.0, "device_ops": [],
                "idle_gaps": [], "attention_s": 0.0, "kernels": 0}
    merged = _merge([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    by_name = {}
    attn = 0.0
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        if ATTENTION_KERNEL.search(n):
            attn += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    starts = np.array([c[0] for c in cpu], dtype=np.float64)
    ends = np.array([c[1] for c in cpu], dtype=np.float64)
    by_label = {}
    for length, a, b in gaps[:LABELLED_GAPS]:
        mid = (a + b) / 2
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(cover):
            inner = cover[np.argmin(ends[cover] - starts[cover])]
            label = cpu[inner][2]
        else:
            label = "(no host event)"
        by_label[label] = by_label.get(label, 0.0) + length / 1e6
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_s": wall_s, "busy_s": busy, "kernels": len(dev),
            "attention_s": attn,
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in idle]}
