"""Named metric primitives with Prometheus-text exposition: the port's
copy of ``paddle_tpu/obs/registry.py`` (stdlib only; same text).

A :class:`Registry` holds :class:`Counter`, :class:`Gauge`, and
histogram entries by name and renders them in the Prometheus text
format (``# HELP`` / ``# TYPE`` + samples). ``ServingMetrics`` builds
its ~20 ad-hoc counters on one of these (satellite 2), the router's
ping path and the worker ``stats`` verb serve the rendered text, and
:data:`MFU` is the process-wide model-vs-measured gauge that
``Executor.run`` feeds under tracing.

Stdlib-only and import-light on purpose: this module must not import
torch or anything under ``serving`` — histograms are duck-typed
(anything with ``percentiles``/``count``/``total`` works, which
``serving.metrics.Histogram`` does) so the dependency points the right
way.
"""

from __future__ import annotations

import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name):
    if not _NAME_RE.match(name):
        raise ValueError("invalid metric name %r (want %s)" % (name, _NAME_RE.pattern))
    return name


def _fmt(v):
    if v is None:
        return "NaN"  # Prometheus' spelling for a not-yet-observed value
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotonic counter; thread-safe."""

    kind = "counter"
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name, help=""):
        self.name = _check_name(name)
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def samples(self):
        return [(self.name, self._value)]


class Gauge:
    """Point-in-time value: either ``set()`` by hand or backed by a fn."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value", "_fn", "_lock")

    def __init__(self, name, help="", fn=None):
        self.name = _check_name(name)
        self.help = help
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def set_function(self, fn):
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return 0.0
        return self._value

    def samples(self):
        return [(self.name, self.value)]


class _HistogramEntry:
    """Wraps a duck-typed histogram (``profiler.Histogram``) for export.

    Rendered as a Prometheus summary: quantile samples plus ``_sum``
    and ``_count`` — the sliding-window percentiles the serving tier
    already keeps map onto quantiles, not cumulative buckets.
    """

    kind = "summary"
    __slots__ = ("name", "help", "hist", "quantiles")

    def __init__(self, name, hist, help="", quantiles=(0.5, 0.95, 0.99)):
        self.name = _check_name(name)
        self.help = help
        self.hist = hist
        self.quantiles = quantiles

    def samples(self):
        ps = self.hist.percentiles([q * 100.0 for q in self.quantiles])
        vals = list(ps.values())
        out = []
        for q, v in zip(self.quantiles, vals):
            out.append(('%s{quantile="%s"}' % (self.name, q), v))
        out.append((self.name + "_sum", self.hist.total))
        out.append((self.name + "_count", self.hist.count))
        return out


class Registry:
    """A namespace of metrics; renders Prometheus exposition text."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def counter(self, name, help=""):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help)
            elif not isinstance(m, Counter):
                raise TypeError("metric %r already registered as %s" % (name, m.kind))
            return m

    def gauge(self, name, help="", fn=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(name, help, fn=fn)
            elif not isinstance(m, Gauge):
                raise TypeError("metric %r already registered as %s" % (name, m.kind))
            elif fn is not None:
                m.set_function(fn)
            return m

    def histogram(self, name, hist, help="", quantiles=(0.5, 0.95, 0.99)):
        """Register an existing duck-typed histogram under ``name``."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = _HistogramEntry(name, hist, help, quantiles)
            elif not isinstance(m, _HistogramEntry):
                raise TypeError("metric %r already registered as %s" % (name, m.kind))
            return m

    def get(self, name):
        return self._metrics.get(name)

    def values(self):
        """{name: value} for counters and gauges (histograms excluded)."""
        with self._lock:
            items = list(self._metrics.items())
        return {n: m.value for n, m in items if isinstance(m, (Counter, Gauge))}

    def prometheus_text(self):
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for name, m in metrics:
            if m.help:
                lines.append("# HELP %s %s" % (name, m.help))
            lines.append("# TYPE %s %s" % (name, m.kind))
            for sample_name, v in m.samples():
                lines.append("%s %s" % (sample_name, _fmt(v)))
        return "\n".join(lines) + "\n" if lines else ""


class MfuGauge:
    """Live model-vs-measured agreement, to be fed by ``Executor.run``.

    In the port nothing feeds it yet: the roofline estimate it compares
    against is ``analysis/cost.py``'s, which comes with ROADMAP A10; until
    then its snapshot stays ``{"steps": 0}`` and it adds no exposition
    lines.

    Under tracing the executor records each step's measured wall time
    next to the ``analysis/cost.py`` roofline estimate for the same
    program+batch. ``mfu_vs_model`` is roofline/measured (1.0 = the
    static model explains the step exactly; <1 = slower than modeled),
    and ``mfu`` is achieved-FLOPs over the matmul ceiling.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._steps = 0
            self._measured_s = 0.0
            self._roofline_s = 0.0
            self._flops = 0.0
            self._peak_flops = 0.0
            self._bound = None
            self._last_measured_s = 0.0

    def record(self, measured_s, roofline):
        """Record one executed step against its roofline dict."""
        if measured_s <= 0.0 or not roofline:
            return
        with self._lock:
            self._steps += 1
            self._measured_s += measured_s
            self._last_measured_s = measured_s
            self._roofline_s += roofline.get("roofline_s") or 0.0
            self._flops += roofline.get("flops") or 0.0
            ceil = roofline.get("ceilings") or {}
            self._peak_flops = ceil.get("matmul_flops") or self._peak_flops
            self._bound = roofline.get("bound", self._bound)

    def snapshot(self):
        with self._lock:
            if self._steps == 0:
                return {"steps": 0}
            measured = self._measured_s
            out = {
                "steps": self._steps,
                "measured_s": measured,
                "last_measured_s": self._last_measured_s,
                "roofline_s": self._roofline_s,
                "mfu_vs_model": (self._roofline_s / measured) if measured > 0 else 0.0,
                "bound": self._bound,
            }
            if self._peak_flops > 0 and measured > 0:
                out["mfu"] = (self._flops / measured) / self._peak_flops
            return out

    def prometheus_lines(self):
        snap = self.snapshot()
        if not snap.get("steps"):
            return []
        lines = [
            "# TYPE paddle_tpu_mfu_vs_model gauge",
            "paddle_tpu_mfu_vs_model %s" % _fmt(snap["mfu_vs_model"]),
            "# TYPE paddle_tpu_executor_steps_traced counter",
            "paddle_tpu_executor_steps_traced %s" % _fmt(snap["steps"]),
        ]
        if "mfu" in snap:
            lines.append("# TYPE paddle_tpu_mfu gauge")
            lines.append("paddle_tpu_mfu %s" % _fmt(snap["mfu"]))
        return lines


# Process-wide MFU gauge; metrics exposition reads it (Executor.run's
# feed waits for A10).
MFU = MfuGauge()
