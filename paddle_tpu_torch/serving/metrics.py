"""Serving metrics for the one-shot engine and the decode tier.

What a serving operator pages on: the latency tail (p50/p95/p99 over a
sliding window), queue depth, batch occupancy (real examples / bucket
slots: the padding tax of the ladder) and, for decode, slot occupancy,
time to first token (TTFT), time per output token after it (TPOT), prefix
hits, chunk dispatches and speculative accepts, under
``paddle_tpu/serving/metrics.py``'s names. ``Histogram`` is the port's copy
of ``paddle_tpu.profiler.Histogram``; the Prometheus registry and the
router and reliability counters are not ported.
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
             "bucket_slots", "decode_steps", "decode_tokens", "slot_live",
             "slot_total", "prefix_hits", "prefix_tokens_reused",
             "prefix_evictions", "prefill_chunks", "prefill_tokens",
             "spec_accepted", "spec_rejected")


class ServingMetrics:
    def __init__(self):
        self.latency = Histogram()
        self.ttft = Histogram()
        self.tpot = Histogram()
        self._lock = threading.Lock()
        self._c = dict.fromkeys(_COUNTERS, 0)
        self._queue_depth_fn = lambda: 0
        self._in_flight_fn = lambda: 0
        self._prefix_bytes_fn = lambda: 0

    def bind_gauges(self, queue_depth_fn, in_flight_fn):
        self._queue_depth_fn = queue_depth_fn
        self._in_flight_fn = in_flight_fn

    def bind_prefix_bytes(self, fn):
        """The prefix cache's live byte count (one cache may back several
        batchers, so its owner binds it, as with :meth:`bind_gauges`)."""
        self._prefix_bytes_fn = fn

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

    def observe_decode_step(self, live, bucket, generated):
        """One dispatch of the decode loop (step or chunk): ``live``
        occupied slots of ``bucket``, ``generated`` tokens sampled (prompt
        ingestion does not count)."""
        with self._lock:
            self._c["decode_steps"] += 1
            self._c["decode_tokens"] += generated
            self._c["slot_live"] += live
            self._c["slot_total"] += bucket

    def observe_prefix_hit(self, tokens_reused):
        """One admission cloned a cached KV prefix instead of ingesting
        ``tokens_reused`` prompt tokens."""
        with self._lock:
            self._c["prefix_hits"] += 1
            self._c["prefix_tokens_reused"] += int(tokens_reused)

    def observe_prefix_eviction(self, n=1):
        self._inc("prefix_evictions", n)

    def observe_prefill_chunk(self, rows, tokens):
        """One chunk dispatch that ingested ``tokens`` prompt tokens over
        ``rows`` slot rows (verify lanes count under spec_*)."""
        with self._lock:
            self._c["prefill_chunks"] += 1
            self._c["prefill_tokens"] += int(tokens)

    def observe_spec(self, accepted, rejected):
        """One speculative verify: draft tokens that matched the target's
        greedy choice and those that did not (the verifier's own bonus
        token counts in neither)."""
        with self._lock:
            self._c["spec_accepted"] += int(accepted)
            self._c["spec_rejected"] += int(rejected)

    def observe_ttft(self, latency_s):
        """Admission -> first sampled token, for one request."""
        self.ttft.add(latency_s)

    def observe_tpot(self, latency_s):
        """Mean seconds per output token after the first, for one
        completed request."""
        self.tpot.add(latency_s)

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
        for k in ("decode_steps", "decode_tokens", "prefix_hits",
                  "prefix_tokens_reused", "prefix_evictions",
                  "prefill_chunks", "prefill_tokens", "spec_accepted",
                  "spec_rejected"):
            snap[k] = c[k]
        snap["slot_occupancy"] = (c["slot_live"] / c["slot_total"]
                                  if c["slot_total"] else None)
        snap["prefix_bytes"] = self._prefix_bytes_fn()
        judged = c["spec_accepted"] + c["spec_rejected"]
        snap["spec_accept_rate"] = (c["spec_accepted"] / judged
                                    if judged else None)
        for name, hist in (("latency_s", self.latency), ("ttft_s", self.ttft),
                           ("tpot_s", self.tpot)):
            ps = hist.percentiles((50, 95, 99))
            snap[name] = {k: ps[k] for k in ("p50", "p95", "p99")}
        return snap

    def report(self):
        """The snapshot as a two-column table, times in ms."""
        s = self.snapshot()
        lines = ["%-32s %14s" % ("Serving metric", "Value")]
        for key, v in s.items():
            if isinstance(v, dict):
                for p, t in v.items():
                    lines.append("%-32s %14s" % (
                        "%s_%s_ms" % (key[:-2], p),
                        "-" if t is None else "%.3f" % (t * 1e3)))
            else:
                lines.append("%-32s %14s" % (
                    key, "-" if v is None else
                    "%.4f" % v if isinstance(v, float) else "%d" % v))
        return "\n".join(lines)
