"""Logging and running metrics.

The port's own copy of ``vast_tpu.logger``: one package logger, a file
log under the run's output dir (utils/logger.py:7-14,
utils/initialize.py:24-28 of the reference) and the EMA loss meter
(utils/logger.py:18-33).
"""

from __future__ import annotations

import logging
import os

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
LOGGER = logging.getLogger("vast_tpu_torch")
LOGGER.setLevel(logging.INFO)
if not LOGGER.handlers:
    _console = logging.StreamHandler()
    _console.setFormatter(logging.Formatter(_LOG_FMT, _DATE_FMT))
    LOGGER.addHandler(_console)


def add_log_to_file(log_path: str) -> None:
    """Also write the log to ``log_path`` (once per path)."""
    log_path = os.path.abspath(log_path)
    if any(getattr(h, "baseFilename", None) == log_path
           for h in LOGGER.handlers):
        return
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, _DATE_FMT))
    LOGGER.addHandler(fh)


class RunningMeter:
    """Exponential moving average of a loss (smooth 0.99); a non-finite
    value leaves it as it was."""

    def __init__(self, name: str = "", val: float | None = None,
                 smooth: float = 0.99):
        self._name = name
        self._smooth = smooth
        self._val = val

    def __call__(self, value: float) -> None:
        val = (value if self._val is None
               else self._val * self._smooth + value * (1 - self._smooth))
        if val == float("inf") or val != val:  # inf / nan guard
            return
        self._val = val

    def __str__(self) -> str:
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self) -> float | None:
        return self._val

    @property
    def name(self) -> str:
        return self._name
