"""Dynamic micro-batcher: coalesce requests until size or deadline.

The copy of ``paddle_tpu/serving/batcher.py`` (without EDF shedding).
Fluid's server-side batching idiom: single-example requests
queue up and a worker cuts a batch when either ``max_batch_size`` examples
are waiting or the oldest request has waited ``max_wait_ms`` — the standard
throughput/latency knob pair. Cut batches land on bucket boundaries (the
engine pads them up a rung, ``buckets.pad_to_bucket``) so every dispatch
is one of a bounded set of shapes that ``warmup()`` has run.

Time is injected (``clock=``) instead of read from ``time.monotonic``
directly: the tier-1 unit test drives a fake clock through the deadline
logic with zero sleeping, and the condition-variable wait only engages when
a real clock says the deadline is genuinely in the future.
"""

import threading
import time
from collections import deque

__all__ = ["Request", "DynamicBatcher"]


class Request:
    """One queued inference request: ``feed`` (dict name -> array with a
    leading batch dim), its example count ``n``, the caller's ``future``,
    and the admission timestamps the deadline checks read."""

    __slots__ = ("feed", "n", "future", "enqueue_t", "deadline")

    def __init__(self, feed, n, future, enqueue_t, deadline=None):
        self.feed = feed
        self.n = n
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline = deadline


class DynamicBatcher:
    """Thread-safe request queue with size-or-deadline batch cuts.

    ``get_batch`` blocks the calling worker until a batch is ready (or the
    batcher is closed and drained, returning ``None``); any number of
    workers may call it concurrently — each cut is exclusive under the
    queue lock.
    """

    def __init__(self, max_batch_size, max_wait_ms=5.0, clock=None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = max_wait_ms / 1000.0
        self._clock = clock or time.monotonic
        self._queue = deque()
        self._depth = 0  # queued examples (sum of request.n)
        self._closed = False
        self._cv = threading.Condition()

    def now(self):
        return self._clock()

    def put(self, request):
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(request)
            self._depth += request.n
            self._cv.notify()

    def depth(self):
        """Queued examples not yet cut into a batch (the queue-depth
        gauge; in-flight batches are the engine's to count)."""
        with self._cv:
            return self._depth

    def close(self):
        """Stop the workers once the queue drains: after close, ``put``
        raises and ``get_batch`` returns ``None`` when nothing is left."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def drain(self):
        """Pop everything still queued (shutdown(drain=False) path)."""
        with self._cv:
            out = list(self._queue)
            self._queue.clear()
            self._depth = 0
            self._cv.notify_all()
        return out

    def _cut_locked(self):
        """Pop a batch: greedy fill up to max_batch_size examples."""
        batch = []
        n = 0
        while self._queue and n + self._queue[0].n <= self.max_batch_size:
            r = self._queue.popleft()
            self._depth -= r.n
            batch.append(r)
            n += r.n
        if not batch and self._queue:
            # head request alone exceeds max_batch_size: the engine
            # validates against the ladder at submit time, so this is a
            # defensive cut — serve it solo rather than deadlock
            r = self._queue.popleft()
            self._depth -= r.n
            batch.append(r)
        return batch

    def get_batch(self):
        with self._cv:
            while True:
                if self._queue:
                    if self._depth >= self.max_batch_size or self._closed:
                        return self._cut_locked()
                    deadline = self._queue[0].enqueue_t + self.max_wait_s
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return self._cut_locked()
                    # wall-clock wait even under an injected clock: the
                    # notify on put/close re-checks the injected time, and
                    # the real-time cap keeps the wait from overshooting a
                    # fake deadline by more than one max_wait quantum
                    self._cv.wait(remaining)
                else:
                    if self._closed:
                        return None
                    self._cv.wait()
