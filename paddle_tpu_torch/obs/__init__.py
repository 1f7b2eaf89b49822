"""``paddle_tpu_torch.obs`` — the stdlib-only telemetry plane, the port's
copy of ``paddle_tpu/obs`` (importing that package pulls in jax):

  * :mod:`~paddle_tpu_torch.obs.trace` — Dapper-style request tracing:
    context-manager spans with thread-local context, 64-bit trace/span
    ids, an injectable clock, cross-process propagation through the
    ``serving/rpc.py`` frame header, and chrome-trace export. One
    ``RouterClient.predict`` yields ONE stitched trace spanning the
    router door, the dispatch hop, the worker queue, the engine
    micro-batch, and ``Executor.run``.
  * :mod:`~paddle_tpu_torch.obs.registry` — named Counter/Gauge/Histogram
    primitives with Prometheus-text exposition, under ``ServingMetrics``;
    plus the MFU gauge (its feed from ``Executor.run`` waits for A10).
  * :mod:`~paddle_tpu_torch.obs.flight` — a bounded ring buffer of
    reliability events (fault-site decisions, breaker transitions,
    respawns, EDF displacements, deadline refusals, per-request
    outcomes), dumped as JSON on unhandled crash, SIGUSR2, and
    shutdown; ``paddle_tpu_torch/tools/chaos_router.py`` audits the dump
    against its accepted-request ledger.

The disabled hot path costs zero allocations: ``trace.span(...)``
returns a module singleton when no tracer is active, and
``flight.record`` appends one dict to a bounded deque.
"""

from . import flight, registry, trace  # noqa: F401

__all__ = ["trace", "registry", "flight"]
