"""Admission control: back-pressure and per-request deadlines (the copy of
``paddle_tpu/serving/admission.py``, without EDF shedding).

A serving engine that accepts unbounded work converts overload into
unbounded latency for everyone; a bounded queue fast-fails new arrivals
while in-flight work completes untouched. Deadlines are enforced twice: an
expired request still queued is dropped before it takes a batch slot, and
``Future.result(timeout)`` covers callers that block.
"""

import threading

__all__ = ["ServerOverloadedError", "DeadlineExceededError",
           "AdmissionController"]


class ServerOverloadedError(RuntimeError):
    """Queue depth limit hit — the request was rejected at the door.
    Retryable with backoff (HTTP 429/503 semantics), not a server fault."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before a worker could serve it."""


class AdmissionController:
    """Counting gate over the engine's in-flight examples: ``acquire``
    admits up to ``max_queue_depth`` and raises
    :class:`ServerOverloadedError` beyond that (it never blocks);
    ``release`` returns capacity when a request leaves the system."""

    def __init__(self, max_queue_depth):
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 or None")
        self.max_queue_depth = max_queue_depth
        self._lock = threading.Lock()
        self._in_flight = 0

    @property
    def in_flight(self):
        return self._in_flight

    def acquire(self, n=1):
        with self._lock:
            limit = self.max_queue_depth
            if limit is not None and self._in_flight + n > limit:
                raise ServerOverloadedError(
                    "queue full: %d in flight + %d new > depth limit %d"
                    % (self._in_flight, n, limit))
            self._in_flight += n

    def release(self, n=1):
        with self._lock:
            self._in_flight = max(0, self._in_flight - n)
