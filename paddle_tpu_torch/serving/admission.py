"""Admission control: back-pressure and per-request deadlines (the copy of
``paddle_tpu/serving/admission.py``; ``shortfall`` sizes EDF shedding).

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

    Callers should treat this as retryable-with-backoff (HTTP 429/503
    semantics), not as a server fault."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before a worker could serve it."""


class AdmissionController:
    """Counting gate over the engine's queue depth.

    ``acquire`` admits up to ``max_queue_depth`` in-flight examples and
    raises :class:`ServerOverloadedError` beyond that — it never blocks,
    because blocking the submitter just moves the unbounded queue into the
    callers' threads. ``release`` returns capacity when a request leaves
    the system (served, failed, expired, or rejected by a later check).
    """

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

    def shortfall(self, n=1):
        """How many slots short the gate is of admitting ``n`` more
        examples right now (0 = would be admitted)."""
        with self._lock:
            if self.max_queue_depth is None:
                return 0
            return max(0, self._in_flight + n - self.max_queue_depth)
