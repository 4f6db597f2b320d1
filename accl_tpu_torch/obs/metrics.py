"""Process-wide metrics registry (counterpart: ``accl_tpu/obs/metrics.py``).

The registry core the collective path calls, under the JAX package's metric
names: counters, gauges and histograms keyed ``name{label="value",...}``,
:func:`snapshot`/:func:`delta`, and the dispatch helpers :func:`tick`,
:func:`note_call` and :func:`note_latency_dispatch`. Series written so far:

=====================================  =========  ============================
``accl_calls_total``                   counter    op, algorithm, dtype, bucket
``accl_bytes_total``                   counter    op, algorithm, dtype, bucket
``accl_dispatch_seconds``              histogram  op
``accl_algorithm_selected_total``      counter    op, algorithm
``accl_algorithm_fallback_total``      counter    op, algorithm
``accl_select_decline_total``          counter    op, reason
``accl_program_cache_total``           counter    event (hit | miss | evict)
``accl_program_cache_size``            gauge
``accl_latency_dispatch_seconds``      histogram  path (µs buckets)
``accl_serving_tokens_total``          counter    phase, accepted
``accl_flash_decode_fallback_total``   counter    reason
``accl_flash_prefill_fallback_total``  counter    reason
=====================================  =========  ============================

The catalog and the exporters come with the observability slice.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Tuple

SCHEMA_VERSION = 1

#: hot-path guard: every helper checks it before touching the registry
ENABLED = True

#: histogram bucket upper bounds in seconds
BUCKETS = (1e-6, 4e-6, 16e-6, 64e-6, 256e-6, 1e-3, 4e-3, 16e-3,
           64e-3, 256e-3, 1.0, 10.0)

#: microsecond-resolution buckets of the latency-tier dispatch histogram
US_BUCKETS = (1e-6, 2e-6, 4e-6, 8e-6, 16e-6, 32e-6, 64e-6, 128e-6,
              256e-6, 512e-6, 1e-3, 4e-3, 16e-3, 256e-3, 10.0)
#: bucket bounds by metric name; anything absent uses :data:`BUCKETS`
_BUCKET_OVERRIDES = {
    "accl_latency_dispatch_seconds": US_BUCKETS,
}

_KiB = 1024


def _buckets_for(key: str):
    """The bucket bounds of a series key (``name{labels}``)."""
    return _BUCKET_OVERRIDES.get(key.split("{", 1)[0], BUCKETS)


def size_bucket(nbytes: int) -> str:
    """Power-of-four byte bucket label: '<=1KiB', '<=4KiB', ... '>64MiB'."""
    edge = _KiB
    while edge < nbytes:
        if edge >= 64 * _KiB * _KiB:
            return ">64MiB"
        edge *= 4
    if edge >= _KiB * _KiB:
        return f"<={edge // (_KiB * _KiB)}MiB"
    return f"<={edge // _KiB}KiB"


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class MetricsRegistry:
    """Thread-safe counters / gauges / histograms with flat string keys."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, list] = {}

    def inc(self, name: str, value: float = 1.0,
            labels: Tuple[Tuple[str, str], ...] = ()) -> None:
        key = name + _label_str(labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Tuple[Tuple[str, str], ...] = ()) -> None:
        key = name + _label_str(labels)
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float,
                labels: Tuple[Tuple[str, str], ...] = ()) -> None:
        key = name + _label_str(labels)
        edges = _BUCKET_OVERRIDES.get(name, BUCKETS)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = [0] * len(edges) + [0.0, 0]
                self._hists[key] = h
            for i, edge in enumerate(edges):
                if value <= edge:
                    h[i] += 1
                    break
            h[-2] += value
            h[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            hists = {
                k: {"buckets": {repr(e): h[i]
                                for i, e in enumerate(_buckets_for(k))},
                    "sum": h[-2], "count": h[-1]}
                for k, h in self._hists.items()
            }
            return {"schema": SCHEMA_VERSION,
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": hists}

    @staticmethod
    def delta(since: dict, now: Optional[dict] = None) -> dict:
        """Counters and histograms subtract; gauges report their current
        value."""
        if now is None:
            now = REGISTRY.snapshot()
        prev_c = since.get("counters", {})
        counters = {k: v - prev_c.get(k, 0.0)
                    for k, v in now.get("counters", {}).items()
                    if v != prev_c.get(k, 0.0)}
        prev_h = since.get("histograms", {})
        hists = {}
        for k, h in now.get("histograms", {}).items():
            p = prev_h.get(k, {"buckets": {}, "sum": 0.0, "count": 0})
            if h["count"] == p["count"]:
                continue
            hists[k] = {
                "buckets": {le: n - p["buckets"].get(le, 0)
                            for le, n in h["buckets"].items()},
                "sum": h["sum"] - p["sum"],
                "count": h["count"] - p["count"],
            }
        return {"schema": SCHEMA_VERSION,
                "counters": counters,
                "gauges": dict(now.get("gauges", {})),
                "histograms": hists}


REGISTRY = MetricsRegistry()


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def snapshot() -> dict:
    return REGISTRY.snapshot()


def delta(since: dict) -> dict:
    return MetricsRegistry.delta(since)


def tick() -> float:
    """Start-of-dispatch timestamp; 0.0 (no clock read) when disabled."""
    if not ENABLED:
        return 0.0
    return time.perf_counter()


def note_call(op, nbytes: int, dtype=None, key: Optional[Iterable] = None,
              t0: float = 0.0) -> None:
    """One collective host call: ``accl_calls_total`` and
    ``accl_bytes_total`` under (op, algorithm, dtype, size bucket), the
    algorithm read off the program-cache key, and the dispatch latency when
    ``t0`` came from :func:`tick`."""
    if not ENABLED:
        return
    algo = "-"
    if key is not None:
        for part in key:
            v = getattr(part, "value", None)
            if v is not None and part.__class__.__name__ == "Algorithm":
                algo = v
                break
    op_name = getattr(op, "name", str(op))
    labels = (("op", op_name),
              ("algorithm", algo),
              ("dtype", getattr(dtype, "name", str(dtype))),
              ("bucket", size_bucket(int(nbytes))))
    REGISTRY.inc("accl_calls_total", 1.0, labels)
    REGISTRY.inc("accl_bytes_total", float(nbytes), labels)
    if t0:
        REGISTRY.observe("accl_dispatch_seconds", time.perf_counter() - t0,
                         (("op", op_name),))


def inc(name: str, value: float = 1.0,
        labels: Tuple[Tuple[str, str], ...] = ()) -> None:
    if not ENABLED:
        return
    REGISTRY.inc(name, value, labels)


def set_gauge(name: str, value: float,
              labels: Tuple[Tuple[str, str], ...] = ()) -> None:
    if not ENABLED:
        return
    REGISTRY.set_gauge(name, value, labels)


def note_latency_dispatch(path: str, t0: float) -> None:
    """One latency-tier dispatch, host entry to launched, into
    ``accl_latency_dispatch_seconds{path}`` (:data:`US_BUCKETS`): the
    serving steps observe ``prefill`` and ``decode``. No-op when disabled
    or when ``t0`` is 0.0 (the disabled :func:`tick`)."""
    if not ENABLED or not t0:
        return
    REGISTRY.observe("accl_latency_dispatch_seconds",
                     time.perf_counter() - t0, (("path", path),))
