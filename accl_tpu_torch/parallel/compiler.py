"""Program cache (counterpart: ``accl_tpu/parallel/compiler.py``).

Every collective program is built once per ``(op, shape, dtype, algorithm,
static params)`` key and reused. The JAX package caches jitted XLA
programs; here a program is a Python callable over the ``(world, n)``
tensor that pads, launches the kernels and realigns. The cache is
LRU-bounded (``ACCLConfig.program_cache_size``, 0 disables the bound) and
exports hits, misses, evictions and its size through :mod:`..obs.metrics`
(``accl_program_cache_total{event}``, ``accl_program_cache_size``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Tuple

from ..obs import metrics as _metrics

_L_HIT = (("event", "hit"),)
_L_MISS = (("event", "miss"),)
_L_EVICT = (("event", "evict"),)


class ProgramCache:
    """Key -> program callable, LRU-bounded, with hit/miss/eviction
    counters. ``maxsize <= 0`` disables the bound."""

    def __init__(self, maxsize: int = 0):
        self._cache: "OrderedDict[Hashable, Callable]" = OrderedDict()
        self.maxsize = int(maxsize)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable, builder: Callable[[], Callable]) -> Callable:
        fn = self._cache.get(key)
        if fn is None:
            self.misses += 1
            _metrics.inc("accl_program_cache_total", labels=_L_MISS)
            fn = builder()
            self._cache[key] = fn
            self._evict()
        else:
            self.hits += 1
            _metrics.inc("accl_program_cache_total", labels=_L_HIT)
            self._cache.move_to_end(key)
        _metrics.set_gauge("accl_program_cache_size", len(self._cache))
        return fn

    def _evict(self) -> None:
        while self.maxsize > 0 and len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
            self.evictions += 1
            _metrics.inc("accl_program_cache_total", labels=_L_EVICT)

    def set_maxsize(self, maxsize: int) -> None:
        """Apply a new LRU bound (shrinking evicts the oldest-used now)."""
        self.maxsize = int(maxsize)
        self._evict()

    def clear(self) -> None:
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)

    def stats(self) -> Tuple[int, int, int]:
        return (len(self._cache), self.hits, self.misses)
