"""Request handles (counterpart: ``accl_tpu/request.py``).

Every collective call returns through a :class:`Request`: status, return
code, duration, ``wait(timeout)`` and ``test()``. Launches are asynchronous
on the device's current stream; a request records a CUDA event after its
launches and ``wait`` synchronizes on it (CPU work is complete on return).
That one sync completes the call: ``wait`` then reads the error words of
the call's ring-kernel launches, copied to pinned host memory ahead of the
event, raises ``KRNL_TIMEOUT_STS_ERROR`` if a hop timed out and otherwise
runs the finalizer (the host-mirror sync). The external-fulfilment and
cooperative-pump machinery of the two-sided path comes with send/recv.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from .constants import ACCLError, ACCLTimeoutError, errorCode


class requestStatus(enum.Enum):
    QUEUED = 0
    EXECUTING = 1
    COMPLETED = 2
    ERROR = 3
    PEER_FAILED = 4


class Request:
    _next_id = 0
    _id_lock = threading.Lock()

    #: ``wait(timeout)`` polls a pending event with a bare yield for its
    #: first ``SPIN_S`` seconds, so calls up to that long return as soon as
    #: they finish (a sleep overshoots by 50-500 µs on a shared host), and
    #: then sleeps ``POLL_S`` between polls, so a long wait leaves the core
    #: to other threads
    SPIN_S = 10e-3
    POLL_S = 50e-6

    def __init__(self, scenario: str, device=None,
                 finalizer: Optional[Callable[["Request"], None]] = None,
                 error_words: Sequence[torch.Tensor] = ()):
        with Request._id_lock:
            Request._next_id += 1
            self.id = Request._next_id
        self.scenario = scenario
        self.status = requestStatus.EXECUTING
        self.retcode = errorCode.COLLECTIVE_OP_SUCCESS
        self._finalizer = finalizer
        self._error_word = None
        if error_words:
            word = (error_words[0] if len(error_words) == 1
                    else torch.cat(list(error_words)).amax(0, keepdim=True))
            if word.is_cuda:
                host = torch.empty(1, dtype=word.dtype, pin_memory=True)
                host.copy_(word, non_blocking=True)
                word = host
            self._error_word = word
        self._event = None
        if device is not None and torch.device(device).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
        self._start_ns = time.monotonic_ns()
        self._duration_ns: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._done = False

    def _complete(self, error: Optional[BaseException] = None) -> None:
        self._error = error
        if error is None:
            self.status = requestStatus.COMPLETED
        else:
            self.status = requestStatus.ERROR
            if isinstance(error, ACCLError):
                self.retcode = error.code
        self._duration_ns = time.monotonic_ns() - self._start_ns
        self._done = True

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the launches are done and the finalizer ran. Device
        work cannot hang: every spin in the ring kernels is bounded, so the
        wait blocks on the event; ``timeout`` (seconds) bounds a wait only
        while the event is still pending when it expires."""
        if not self._done:
            if self._event is not None:
                if timeout is None:
                    self._event.synchronize()
                else:
                    start = time.monotonic()
                    while not self._event.query():
                        waited = time.monotonic() - start
                        if waited > timeout:
                            raise ACCLTimeoutError(self.scenario)
                        time.sleep(0.0 if waited < self.SPIN_S
                                   else self.POLL_S)
            try:
                if self._error_word is not None and \
                        int(self._error_word[0]) != 0:
                    raise ACCLError(errorCode.KRNL_TIMEOUT_STS_ERROR,
                                    f"{self.scenario}: a ring kernel's flag "
                                    f"spin timed out")
                if self._finalizer is not None:
                    fin, self._finalizer = self._finalizer, None
                    fin(self)
                self._complete()
            except Exception as e:  # surfaced below and via retcode
                self._complete(e)
        if self._error is not None:
            raise self._error

    def test(self) -> bool:
        """Non-blocking completion poll."""
        if self._done:
            return True
        return self._event is None or self._event.query()

    def get_retcode(self) -> errorCode:
        return self.retcode

    def get_duration_ns(self) -> int:
        if self._duration_ns is not None:
            return self._duration_ns
        return time.monotonic_ns() - self._start_ns

    def __repr__(self) -> str:
        return (f"Request(id={self.id}, op={self.scenario}, "
                f"status={self.status.name})")
