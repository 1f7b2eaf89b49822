"""Serving observability, built on ``obs.registry`` (the port's copy of
``paddle_tpu/serving/metrics.py``).

What a serving operator pages on: the latency tail (p50/p95/p99 over a
sliding window), queue depth, batch occupancy (real examples / bucket
slots: the padding tax of the ladder), the compile-cache hit rate (here:
dispatches on an already-seen feed signature, the shapes a replica has
run and, on the card, captured), the reliability counters (shed, retried,
evicted, respawned, the router's door and worker events) and, for
decode, slot occupancy, TTFT, TPOT, prefix hits, chunk dispatches and
speculative accepts. Exposed three ways:

  * ``snapshot()`` — the plain dict, under the reference's field names;
  * ``report()`` — a formatted table;
  * ``prometheus_text()`` — the registry's Prometheus exposition (every
    counter under ``paddle_tpu_serving_*``, gauges, latency summaries)
    plus the MFU gauge's lines (none until A10 feeds it), served from the
    router's ping path and the worker ``stats`` verb.

``Histogram`` is the port's copy of ``paddle_tpu.profiler.Histogram``.
"""

import threading
from collections import deque

from ..obs.registry import Registry
from ..obs.registry import MFU as _MFU

__all__ = ["Histogram", "ServingMetrics"]


class Histogram:
    """Thread-safe sliding-window sample store with exact nearest-rank
    percentiles over the most recent ``max_samples`` observations, and
    the lifetime ``count`` and ``total`` a Prometheus summary reports."""

    def __init__(self, max_samples=8192):
        self._samples = deque(maxlen=max_samples)
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0

    def add(self, value):
        with self._lock:
            self._samples.append(float(value))
            self._count += 1
            self._total += float(value)

    @property
    def count(self):
        """Lifetime observation count (not capped by the window)."""
        return self._count

    @property
    def total(self):
        return self._total

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


# snapshot field -> Prometheus help string; the registry metric name is
# paddle_tpu_serving_<field>. Order here is the exposition order.
_COUNTERS = (
    ("requests_completed", "requests answered with a result"),
    ("requests_failed", "requests answered with a non-deadline error"),
    ("requests_rejected", "requests refused at admission (no shed victim)"),
    ("requests_expired", "requests whose deadline passed before serving"),
    ("requests_shed", "queued requests displaced by EDF shedding"),
    ("requests_retried", "requests re-enqueued after a failed batch"),
    ("replicas_evicted", "replica predictors evicted and rebuilt"),
    ("workers_respawned", "dead engine worker threads restarted"),
    ("door_shed", "requests displaced at the router door (EDF)"),
    ("rerouted", "requests sent to a non-first-choice worker"),
    ("respawns", "worker processes restarted by the router"),
    ("heartbeat_misses", "worker heartbeat probes that failed"),
    ("deadline_refused", "expired requests refused by a worker"),
    ("batches", "micro-batches dispatched"),
    ("batched_examples", "real examples across all dispatched batches"),
    ("bucket_slots", "padded slots across all dispatched batches"),
    ("compile_cache_hits", "dispatches on an already-seen signature"),
    ("compile_cache_misses", "dispatches that compiled a new signature"),
    ("decode_steps", "continuous-batching decode loop passes"),
    ("decode_tokens", "tokens sampled by the decode loop"),
    ("slot_live", "occupied slots summed over decode steps"),
    ("slot_total", "total slots summed over decode steps"),
    ("prefix_hits", "admissions that cloned a cached KV prefix"),
    ("prefix_tokens_reused", "prompt tokens skipped via prefix-cache hits"),
    ("prefix_evictions", "prefix-cache entries evicted (LRU)"),
    ("prefill_chunks", "chunked-prefill / speculative-verify dispatches"),
    ("prefill_tokens", "prompt tokens ingested through chunk dispatches"),
    ("spec_accepted", "speculative draft tokens accepted by the verifier"),
    ("spec_rejected", "speculative draft tokens rejected by the verifier"),
)

_PREFIX = "paddle_tpu_serving_"


class ServingMetrics:
    def __init__(self, latency_window=8192):
        self.registry = Registry()
        self.latency = Histogram(max_samples=latency_window)
        # decode-tier tails (continuous batcher): time-to-first-token and
        # time-per-output-token — THE serving-latency pair for
        # autoregressive workloads (whole-request latency hides which of
        # queueing vs generation is slow)
        self.ttft = Histogram(max_samples=latency_window)
        self.tpot = Histogram(max_samples=latency_window)
        self._c = {}
        for field, help_text in _COUNTERS:
            self._c[field] = self.registry.counter(_PREFIX + field,
                                                   help=help_text)
        self._queue_depth_fn = lambda: 0
        self._in_flight_fn = lambda: 0
        self._prefix_bytes_fn = lambda: 0
        self.registry.gauge(_PREFIX + "queue_depth",
                            help="examples queued, not yet in a batch",
                            fn=lambda: self._queue_depth_fn())
        self.registry.gauge(_PREFIX + "in_flight",
                            help="admitted examples not yet resolved",
                            fn=lambda: self._in_flight_fn())
        self.registry.gauge(_PREFIX + "prefix_bytes",
                            help="bytes of KV rows held by the prefix "
                                 "cache",
                            fn=lambda: self._prefix_bytes_fn())
        self.registry.histogram(_PREFIX + "latency_seconds", self.latency,
                                help="request latency (sliding window)")
        self.registry.histogram(_PREFIX + "ttft_seconds", self.ttft,
                                help="time to first sampled token")
        self.registry.histogram(_PREFIX + "tpot_seconds", self.tpot,
                                help="time per output token after the first")

    # -- wiring (the engine hands us its live gauges) -----------------------
    def bind_gauges(self, queue_depth_fn, in_flight_fn):
        self._queue_depth_fn = queue_depth_fn
        self._in_flight_fn = in_flight_fn

    def bind_prefix_bytes(self, fn):
        """The prefix cache's live byte count (one cache may back many
        batchers, so the OWNER binds it, same as :meth:`bind_gauges`)."""
        self._prefix_bytes_fn = fn

    # -- observation points -------------------------------------------------
    def observe_completed(self, latency_s):
        self.latency.add(latency_s)
        self._c["requests_completed"].inc()

    def observe_failed(self, n=1):
        self._c["requests_failed"].inc(n)

    def observe_rejected(self, n=1):
        self._c["requests_rejected"].inc(n)

    def observe_expired(self, n=1):
        self._c["requests_expired"].inc(n)

    def observe_shed(self, n=1):
        """An admitted request displaced under overload by a new arrival
        with an earlier deadline (EDF shedding)."""
        self._c["requests_shed"].inc(n)

    def observe_retried(self, n=1):
        """A request re-enqueued after its batch failed (cross-replica
        retry); it will also count completed/failed when it resolves."""
        self._c["requests_retried"].inc(n)

    def observe_evicted(self):
        """A replica's circuit breaker tripped: predictor evicted and
        rebuilt from the parent."""
        self._c["replicas_evicted"].inc()

    def observe_respawned(self):
        """The supervisor found a dead worker thread and restarted it."""
        self._c["workers_respawned"].inc()

    def observe_door_shed(self, n=1):
        """An admitted request displaced AT THE ROUTER DOOR (EDF, before
        any worker saw it) by a new arrival with an earlier deadline."""
        self._c["door_shed"].inc(n)

    def observe_rerouted(self, n=1):
        """A request sent to a different worker than first choice —
        either its preferred worker was unhealthy/at-capacity at pick
        time, or its dispatch failed and the one cross-worker retry ran."""
        self._c["rerouted"].inc(n)

    def observe_respawn(self, n=1):
        """A worker PROCESS was restarted (crash, breaker trip, or
        heartbeat loss) and came back ready."""
        self._c["respawns"].inc(n)

    def observe_heartbeat_miss(self, n=1):
        self._c["heartbeat_misses"].inc(n)

    def observe_deadline_refused(self, n=1):
        """A worker refused a request whose propagated budget was already
        spent — deadline propagation doing its job (the alternative is
        executing work nobody is waiting for)."""
        self._c["deadline_refused"].inc(n)

    def observe_decode_step(self, live, bucket, generated):
        """One pass of the continuous-batching decode loop: ``live``
        occupied slots out of ``bucket`` (the padded slot-table size),
        ``generated`` tokens actually sampled this step (forced prompt
        ingestion doesn't count)."""
        self._c["decode_steps"].inc()
        self._c["decode_tokens"].inc(generated)
        self._c["slot_live"].inc(live)
        self._c["slot_total"].inc(bucket)

    def observe_prefix_hit(self, tokens_reused):
        """One admission cloned a cached KV prefix instead of
        re-prefilling ``tokens_reused`` prompt tokens step by step."""
        self._c["prefix_hits"].inc()
        self._c["prefix_tokens_reused"].inc(int(tokens_reused))

    def observe_prefix_eviction(self, n=1):
        self._c["prefix_evictions"].inc(n)

    def observe_prefill_chunk(self, rows, tokens):
        """One chunk dispatch (prefill and/or speculative verify):
        ``rows`` slot rows participated, ``tokens`` prompt tokens were
        ingested through it (verify lanes count under spec_*)."""
        self._c["prefill_chunks"].inc()
        self._c["prefill_tokens"].inc(int(tokens))

    def observe_spec(self, accepted, rejected):
        """One speculative verify outcome: ``accepted`` draft tokens
        matched the target model's greedy choice, ``rejected`` did not
        (the bonus token the verifier emits itself counts in neither)."""
        self._c["spec_accepted"].inc(int(accepted))
        self._c["spec_rejected"].inc(int(rejected))

    def observe_ttft(self, latency_s):
        """Admission -> first sampled token for one request."""
        self.ttft.add(latency_s)

    def observe_tpot(self, latency_s):
        """Mean seconds per output token AFTER the first, for one
        completed request (the steady-state generation rate its caller
        saw, batching interference included)."""
        self.tpot.add(latency_s)

    def observe_batch(self, actual, bucket, cache_hit):
        self._c["batches"].inc()
        self._c["batched_examples"].inc(actual)
        self._c["bucket_slots"].inc(bucket)
        if cache_hit:
            self._c["compile_cache_hits"].inc()
        else:
            self._c["compile_cache_misses"].inc()

    # -- export -------------------------------------------------------------
    def snapshot(self):
        c = {field: counter.value for field, counter in self._c.items()}
        batches = c["batches"]
        lookups = c["compile_cache_hits"] + c["compile_cache_misses"]
        snap = {
            "requests_completed": c["requests_completed"],
            "requests_failed": c["requests_failed"],
            "requests_rejected": c["requests_rejected"],
            "requests_expired": c["requests_expired"],
            "requests_shed": c["requests_shed"],
            "requests_retried": c["requests_retried"],
            "replicas_evicted": c["replicas_evicted"],
            "workers_respawned": c["workers_respawned"],
            "door_shed": c["door_shed"],
            "rerouted": c["rerouted"],
            "respawns": c["respawns"],
            "heartbeat_misses": c["heartbeat_misses"],
            "deadline_refused": c["deadline_refused"],
            "queue_depth": self._queue_depth_fn(),
            "in_flight": self._in_flight_fn(),
            "batches": batches,
            "batch_occupancy": (c["batched_examples"] / c["bucket_slots"]
                                if c["bucket_slots"] else None),
            "avg_batch_size": (c["batched_examples"] / batches
                               if batches else None),
            "compile_cache_hits": c["compile_cache_hits"],
            "compile_cache_misses": c["compile_cache_misses"],
            "compile_cache_hit_rate": (c["compile_cache_hits"] / lookups
                                       if lookups else None),
            "decode_steps": c["decode_steps"],
            "decode_tokens": c["decode_tokens"],
            "slot_occupancy": (c["slot_live"] / c["slot_total"]
                               if c["slot_total"] else None),
            "prefix_hits": c["prefix_hits"],
            "prefix_tokens_reused": c["prefix_tokens_reused"],
            "prefix_evictions": c["prefix_evictions"],
            "prefix_bytes": self._prefix_bytes_fn(),
            "prefill_chunks": c["prefill_chunks"],
            "prefill_tokens": c["prefill_tokens"],
            "spec_accepted": c["spec_accepted"],
            "spec_rejected": c["spec_rejected"],
            "spec_accept_rate": (
                c["spec_accepted"]
                / (c["spec_accepted"] + c["spec_rejected"])
                if (c["spec_accepted"] + c["spec_rejected"]) else None),
        }
        lat = self.latency.percentiles((50, 95, 99))
        snap["latency_s"] = {k: lat[k] for k in ("p50", "p95", "p99")}
        for name, hist in (("ttft_s", self.ttft), ("tpot_s", self.tpot)):
            ps = hist.percentiles((50, 95, 99))
            snap[name] = {k: ps[k] for k in ("p50", "p95", "p99")}
        return snap

    def prometheus_text(self):
        """Prometheus exposition: this instance's registry plus the
        process-wide MFU/roofline gauge (populated when ``Executor.run``
        executes under tracing)."""
        text = self.registry.prometheus_text()
        mfu = _MFU.prometheus_lines()
        if mfu:
            text += "\n".join(mfu) + "\n"
        return text

    def report(self):
        """Formatted table in the ``profiler._report`` house style."""
        s = self.snapshot()
        lines = ["%-32s %14s" % ("Serving metric", "Value")]

        def fmt(v):
            if v is None:
                return "-"
            if isinstance(v, float):
                return "%.4f" % v
            return "%d" % v

        for key in ("requests_completed", "requests_failed",
                    "requests_rejected", "requests_expired",
                    "requests_shed", "requests_retried",
                    "replicas_evicted", "workers_respawned",
                    "door_shed", "rerouted", "respawns",
                    "heartbeat_misses", "deadline_refused", "queue_depth",
                    "in_flight", "batches", "avg_batch_size",
                    "batch_occupancy", "compile_cache_hits",
                    "compile_cache_misses", "compile_cache_hit_rate",
                    "decode_steps", "decode_tokens", "slot_occupancy",
                    "prefix_hits", "prefix_tokens_reused",
                    "prefix_evictions", "prefix_bytes", "prefill_chunks",
                    "prefill_tokens", "spec_accepted", "spec_rejected",
                    "spec_accept_rate"):
            lines.append("%-32s %14s" % (key, fmt(s[key])))
        for group in ("latency_s", "ttft_s", "tpot_s"):
            prefix = group[:-2]  # strip the _s unit suffix
            for k, v in s[group].items():
                lines.append("%-32s %14s" % (
                    "%s_%s_ms" % (prefix, k),
                    "-" if v is None else "%.3f" % (v * 1e3)))
        return "\n".join(lines)
