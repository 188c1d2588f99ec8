"""Spans of the port's work, and the profiler window of ``--profile_steps``.

A span (:func:`span`) marks one piece of the program's work:

* ``vast.train.step``, the root of one ``make_train_step`` step, and its
  children ``vast.train.forward`` (forward and losses), ``.backward``
  (with the sharded gradients' reduction) and ``.optimizer``, which
  counts the ``tensors`` its kernel updated and the kernel's
  ``launches`` (``training/step.py``); ``vast.train.loader_wait``, the
  train loop blocked on its loader (``training/pipeline.py``);
* ``vast.eval``, the root of one ``evaluate_ret``, ``evaluate_cap`` or
  ``evaluate_qa``, and its stages ``vast.eval.condition_features``,
  ``.text_features``, ``.itc``, ``.itm_rerank`` (which counts the
  ``pairs`` it scored, the ``rows`` of its grouped calls, padding
  included, and the ``calls``) and ``.decode``
  (``evaluation/evaluation_mm.py``);
* ``vast.videoswin.stage<S>``, one stage of the VideoSwin tower's
  forward (``models/videoswin.py``), which counts its ``windows`` (clips
  times windows a clip), its ``shifted`` blocks and the ``bias_bytes``
  of the additive biases its attention calls materialise beyond the
  bias they are given (``ops/attention.py``, through :func:`count`);
* ``vast.gc.gen<N>``, one collection of Python's garbage collector.

A recorded span holds its name, its id, its parent's id and its root's
(the step's or the evaluation's), its host start and end
(``time.perf_counter_ns``), its counts (``count(key, n)``), and, where
CUDA is initialised, a pair of timing events recorded on the current
stream at its edges. A collection's span holds host times only. The
events are read only by :func:`spans`, with one synchronise: a span
never synchronises the device itself.

Spans are recorded while a ``torch.profiler`` records, where each is
also a ``record_function`` of its name, so that the program's spans
share the timeline that the device's kernels are aligned to, and inside
:func:`recording`. Otherwise :func:`span` checks the two flags and
returns a shared no-op. :func:`summary` sums the recorded spans by name;
:func:`stop_trace` writes it as JSON beside the Chrome trace of
``--profile_steps`` (``<trace>_spans.json``).

``span(..., timings=d)`` also adds the span's seconds into ``d`` under
the last part of its name, whether spans are recorded or not, with the
device synchronised at its edges so that its work lands in it: the stage
clock of the evaluations and of ``pipeline.train``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from vast_tpu_torch.logger import LOGGER


class _NoSpan:
    """What :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key: str, n: int = 1) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Recorder:
    def __init__(self):
        self.depth = 0                  # open recording() contexts
        self.done: list[_Span] = []     # recorded spans, as they closed
        self.ids = itertools.count(1)
        self.local = threading.local()  # .stack: this thread's open spans
        self.gc_span: _Span | None = None

    def on(self) -> bool:
        return self.depth > 0 or _profiler._is_profiler_enabled

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def open(self, sp: _Span, host_only: bool = False) -> None:
        """Give ``sp`` its ids and, under the profiler, a range; unless
        ``host_only`` (a collection's span), its timing events, and the
        spans opened inside it as its children."""
        stack = self.stack()
        parent = stack[-1] if stack else None
        sp.id = next(self.ids)
        sp.parent = parent.id if parent is not None else None
        sp.root = parent.root if parent is not None else sp.id
        if not host_only:
            stack.append(sp)
        if _profiler._is_profiler_enabled:
            sp.range = _profiler.record_function(sp.name)
            sp.range.__enter__()
        if not host_only and torch.cuda.is_initialized():
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record()

    def close(self, sp: _Span) -> None:
        if sp.events is not None:
            sp.events[1].record()
        if sp.range is not None:
            sp.range.__exit__(None, None, None)
            sp.range = None
        stack = self.stack()
        if sp in stack:
            stack.remove(sp)
        self.done.append(sp)


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "timings", "recorded", "id", "parent", "root",
                 "start_ns", "end_ns", "counts", "events", "device_s",
                 "range")

    def __init__(self, name: str, timings: dict | None = None):
        self.name, self.timings = name, timings
        self.recorded = False
        self.counts: dict = {}
        self.events = self.device_s = self.range = None

    def count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self):
        if self.timings is not None:
            _synchronize()
        self.recorded = _REC.on()
        if self.recorded:
            _REC.open(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.timings is not None:
            _synchronize()
        self.end_ns = time.perf_counter_ns()
        if self.recorded:
            _REC.close(self)
        if self.timings is not None:
            key = self.name.rsplit(".", 1)[-1]
            self.timings[key] = (self.timings.get(key, 0.0)
                                 + (self.end_ns - self.start_ns) / 1e9)
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "root": self.root, "start_ns": self.start_ns,
                "end_ns": self.end_ns,
                "host_s": (self.end_ns - self.start_ns) / 1e9,
                "device_s": self.device_s, "counts": dict(self.counts)}


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``key`` of this thread's innermost open span, where
    spans are recorded and one is open; else nothing (one flag check):
    the counter of code that runs inside a span it does not hold."""
    if not (_REC.depth or _profiler._is_profiler_enabled):
        return
    stack = _REC.stack()
    if stack:
        stack[-1].count(key, n)


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def span(name: str, timings: dict | None = None):
    """A context manager around one piece of work, yielding an object
    with ``count(key, n)``; see the module's docstring."""
    if timings is None and not (_REC.depth or
                                _profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, timings)


@contextlib.contextmanager
def recording():
    """Record spans inside, with or without the profiler."""
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1


def spans() -> list[dict]:
    """The recorded spans, in the order they closed: ``name``, ``id``,
    ``parent`` and ``root`` ids, ``start_ns`` / ``end_ns`` and
    ``host_s`` by the host's clock, ``device_s`` (the interval between
    its timing events; None without them) and ``counts``."""
    done = list(_REC.done)
    pending = [s for s in done if s.events is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
            s.events = None
    return [s.as_dict() for s in done]


def summary() -> dict:
    """By span name: ``count``, ``host_s``, ``self_host_s`` (host time
    less the part its children cover), ``device_s`` (None without
    timing events) and the summed ``counts``."""
    recorded = spans()
    children: dict = {}
    for r in recorded:
        if r["parent"] is not None:
            children.setdefault(r["parent"], []).append(
                (r["start_ns"], r["end_ns"]))
    out: dict = {}
    for r in recorded:
        s, e = r["start_ns"], r["end_ns"]
        covered, reach = 0, s
        for a, b in sorted(children.get(r["id"], ())):
            a, b = max(a, reach), min(b, e)
            if b > a:
                covered += b - a
                reach = b
        row = out.setdefault(r["name"], {"count": 0, "host_s": 0.0,
                                         "self_host_s": 0.0,
                                         "device_s": None, "counts": {}})
        row["count"] += 1
        row["host_s"] += r["host_s"]
        row["self_host_s"] += (e - s - covered) / 1e9
        if r["device_s"] is not None:
            row["device_s"] = (row["device_s"] or 0.0) + r["device_s"]
        for k, n in r["counts"].items():
            row["counts"][k] = row["counts"].get(k, 0) + n
    return out


def clear() -> None:
    """Forget every recorded span."""
    _REC.done.clear()


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: a host-only span a collection."""
    if phase == "start":
        if _REC.on():
            _REC.gc_span = _Span(f"vast.gc.gen{info['generation']}")
            _REC.open(_REC.gc_span, host_only=True)
            _REC.gc_span.start_ns = time.perf_counter_ns()
    elif _REC.gc_span is not None:
        sp, _REC.gc_span = _REC.gc_span, None
        sp.end_ns = time.perf_counter_ns()
        _REC.close(sp)


if _gc_span not in gc.callbacks:
    gc.callbacks.append(_gc_span)


def start_trace(device: torch.device):
    """Start torch.profiler (CPU and, on a GPU, CUDA activity), with the
    recorder emptied so that :func:`stop_trace`'s summary is the
    window's."""
    from torch.profiler import ProfilerActivity, profile

    clear()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str, device: torch.device) -> str:
    """Stop ``prof`` (:func:`start_trace`), write its Chrome trace under
    ``log_dir`` and the recorded spans' :func:`summary` beside it
    (``<trace>_spans.json``); returns the trace's path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path[:-len(".json")] + "_spans.json", "w") as f:
        json.dump(summary(), f, indent=1)
    LOGGER.info("profiler trace and span summary written to %s", path)
    return path
