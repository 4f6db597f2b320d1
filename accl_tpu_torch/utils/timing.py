"""Monotonic microsecond timer (counterpart: ``accl_tpu/utils/timing.py``)."""
from __future__ import annotations

import time


class Timer:
    """start/end/elapsed-us timer used by benchmarks."""

    def __init__(self):
        self._start_ns: int | None = None
        self._end_ns: int | None = None

    def start(self) -> None:
        self._end_ns = None
        self._start_ns = time.monotonic_ns()

    def end(self) -> None:
        self._end_ns = time.monotonic_ns()

    def elapsed(self) -> float:
        """Elapsed microseconds."""
        if self._start_ns is None:
            return 0.0
        end = self._end_ns if self._end_ns is not None else time.monotonic_ns()
        return (end - self._start_ns) / 1e3

    def elapsed_ns(self) -> int:
        if self._start_ns is None:
            return 0
        end = self._end_ns if self._end_ns is not None else time.monotonic_ns()
        return end - self._start_ns
