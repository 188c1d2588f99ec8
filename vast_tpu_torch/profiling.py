"""Step timing and the profiler window of ``--profile_steps``.

Counterpart of ``vast_tpu.profiling``: ``StepTimer`` (wall time per step,
its EMA and percentiles) and ``start_trace`` / ``stop_trace``, which record a
window of steps with ``torch.profiler`` (CPU and, on a GPU, CUDA
activity) into a Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import os
import time

import torch

from vast_tpu_torch.logger import LOGGER


class StepTimer:
    def __init__(self, smooth: float = 0.95):
        self._last = None
        self._ema = None
        self._smooth = smooth
        self._history: list[float] = []

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._ema = dt if self._ema is None else (
                self._ema * self._smooth + dt * (1 - self._smooth))
            self._history.append(dt)
            if len(self._history) > 10000:
                del self._history[:5000]
        self._last = now
        return dt

    @property
    def ema_s(self) -> float | None:
        return self._ema

    def summary(self) -> dict:
        if not self._history:
            return {}
        hist = sorted(self._history)
        n = len(hist)
        return {"steps": n, "mean_s": sum(hist) / n, "p50_s": hist[n // 2],
                "p90_s": hist[int(n * 0.9)], "max_s": hist[-1]}


def start_trace(device: torch.device):
    """Start torch.profiler (CPU and, on a GPU, CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str, device: torch.device) -> str:
    """Stop ``prof`` (:func:`start_trace`) and write its Chrome trace
    under ``log_dir``; returns the file's path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    LOGGER.info("profiler trace written to %s", path)
    return path
