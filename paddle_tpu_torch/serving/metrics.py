"""Serving metrics for the one-shot engine.

What a serving operator pages on: the latency tail (p50/p95/p99 over a
sliding window), queue depth, and batch occupancy (real examples / bucket
slots — the padding tax of the ladder). ``Histogram`` is the port's copy of
``paddle_tpu.profiler.Histogram`` (which ``paddle_tpu/serving/metrics.py:25``
uses); the Prometheus registry, the decode-tier and router counters are
not ported.
"""

import threading
from collections import deque

__all__ = ["Histogram", "ServingMetrics"]


class Histogram:
    """Thread-safe sliding-window sample store with exact nearest-rank
    percentiles over the most recent ``max_samples`` observations."""

    def __init__(self, max_samples=8192):
        self._samples = deque(maxlen=max_samples)
        self._lock = threading.Lock()

    def add(self, value):
        with self._lock:
            self._samples.append(float(value))

    @staticmethod
    def _at_rank(data, p):
        if not 0 <= p <= 100:
            raise ValueError("percentile must be in [0, 100], got %r" % p)
        rank = max(0, min(len(data) - 1,
                          int(round(p / 100.0 * (len(data) - 1)))))
        return data[rank]

    def percentiles(self, ps=(50, 95, 99)):
        with self._lock:
            data = sorted(self._samples)
        return {"p%g" % p: (self._at_rank(data, p) if data else None)
                for p in ps}


_COUNTERS = ("requests_completed", "requests_failed", "requests_rejected",
             "requests_expired", "batches", "batched_examples",
             "bucket_slots")


class ServingMetrics:
    def __init__(self):
        self.latency = Histogram()
        self._lock = threading.Lock()
        self._c = dict.fromkeys(_COUNTERS, 0)
        self._queue_depth_fn = lambda: 0
        self._in_flight_fn = lambda: 0

    def bind_gauges(self, queue_depth_fn, in_flight_fn):
        self._queue_depth_fn = queue_depth_fn
        self._in_flight_fn = in_flight_fn

    def _inc(self, field, n=1):
        with self._lock:
            self._c[field] += n

    def observe_completed(self, latency_s):
        self.latency.add(latency_s)
        self._inc("requests_completed")

    def observe_failed(self, n=1):
        self._inc("requests_failed", n)

    def observe_rejected(self, n=1):
        self._inc("requests_rejected", n)

    def observe_expired(self, n=1):
        self._inc("requests_expired", n)

    def observe_batch(self, actual, bucket):
        with self._lock:
            self._c["batches"] += 1
            self._c["batched_examples"] += actual
            self._c["bucket_slots"] += bucket

    def snapshot(self):
        with self._lock:
            c = dict(self._c)
        snap = {k: c[k] for k in ("requests_completed", "requests_failed",
                                  "requests_rejected", "requests_expired",
                                  "batches")}
        snap["queue_depth"] = self._queue_depth_fn()
        snap["in_flight"] = self._in_flight_fn()
        snap["batch_occupancy"] = (c["batched_examples"] / c["bucket_slots"]
                                   if c["bucket_slots"] else None)
        snap["avg_batch_size"] = (c["batched_examples"] / c["batches"]
                                  if c["batches"] else None)
        lat = self.latency.percentiles((50, 95, 99))
        snap["latency_s"] = {k: lat[k] for k in ("p50", "p95", "p99")}
        return snap
