"""The program's spans (``vast_tpu_torch.profiling``) as the per-layer
readers of a traced run read them. The program records spans only while
the profiler records, so after a run it holds the train runner's
profiled steps, or the eval runner's one traced evaluation (its staged
evaluation runs outside the profiler). A program that records no spans
gives None."""

import statistics


def recorded(obs, kind):
    """The program's recorded spans where ``obs`` is a traced run of
    ``kind``, else None."""
    if obs.get("kind") != kind or not obs.get("trace"):
        return None
    try:
        from vast_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def _children(spans, parent, name):
    return [s for s in spans if s["parent"] == parent and s["name"] == name]


def step_phase_ms(obs, name):
    """The median, over the traced ``vast.train.step`` spans, of the
    device ms of their ``name`` child; None where a step has none or
    its device time was not recorded."""
    spans = recorded(obs, "train")
    steps = [s for s in spans or () if s["name"] == "vast.train.step"]
    per_step = []
    for step in steps:
        device_s = [s["device_s"] for s in _children(spans, step["id"], name)]
        if not device_s or None in device_s:
            return None
        per_step.append(1e3 * sum(device_s))
    return statistics.median(per_step) if per_step else None


def gc_ms_per_step(obs):
    """The host ms of the garbage collector's spans (``vast.gc.*``)
    between the first traced step's start and the last one's end, over
    the number of steps."""
    spans = recorded(obs, "train")
    steps = [s for s in spans or () if s["name"] == "vast.train.step"]
    if not steps:
        return None
    lo = min(s["start_ns"] for s in steps)
    hi = max(s["end_ns"] for s in steps)
    gc = [s["host_s"] for s in spans if s["name"].startswith("vast.gc.")
          and lo <= s["start_ns"] and s["end_ns"] <= hi]
    return 1e3 * sum(gc) / len(steps)


def eval_stages(obs, name):
    """The ``name`` stage spans of the traced evaluation (the last
    ``vast.eval`` span); None without one."""
    spans = recorded(obs, "eval")
    roots = [s for s in spans or () if s["name"] == "vast.eval"]
    if not roots:
        return None
    return _children(spans, roots[-1]["id"], name)


def eval_stage_ms(obs, name):
    """The device ms of the traced evaluation's ``name`` stage spans,
    summed; None without them or their device time."""
    stages = eval_stages(obs, name)
    if not stages or any(s["device_s"] is None for s in stages):
        return None
    return 1e3 * sum(s["device_s"] for s in stages)
