"""Dapper-style request tracing with an injectable clock: the port's copy
of ``paddle_tpu/obs/trace.py`` (stdlib only).

Design goals, in priority order:

1. **Disabled = free.** Call sites run unconditionally in hot paths
   (``Executor.run``, the engine batch loop, every router request), so
   the off state must cost one module-global load and zero allocations.
   ``span(...)`` returns the preallocated falsy :data:`_NULL_SPAN`
   singleton when no tracer is installed — the same fast-path shape as
   ``reliability.faults.trip``. Tag dicts are only built when a span is
   live: guard with ``if sp: sp.set(...)``.
2. **Deterministic under a fake clock.** :class:`Tracer` takes
   ``clock=`` exactly like ``reliability/policy.py``; tests drive time
   by hand and never sleep. Exports convert the injected monotonic
   clock to wall time via an offset captured at tracer start, so real
   traces line up across processes while fake-clock traces stay exact.
3. **Cross-process stitching over the rpc header.** :func:`inject`
   writes ``header["trace"] = {"tid": ..., "sid": ...}`` beside
   ``deadline_s``; unknown header keys are ignored by old peers, so the
   wire format is unchanged. Unlike the deadline (re-derived per hop),
   the trace id propagates VERBATIM; each hop re-parents by re-injecting
   its own current span context before forwarding. :func:`extract`
   works without an active tracer so a hop that merely forwards does
   not need tracing enabled to preserve the id.

Spans are recorded into a bounded in-memory list and flushed as JSON
lines to ``<dir>/trace-<pid>.jsonl`` when ``PADDLE_TPU_TRACE=<dir>``
(or an explicit ``trace_dir=``) is set — one file per process, stitched
afterwards by trace id (:func:`load_dir`). :func:`chrome_trace`
converts span dicts to the chrome://tracing / Perfetto JSON array
format the reference emits from ``tools/timeline.py``.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import threading
import time

ENV_TRACE_DIR = "PADDLE_TPU_TRACE"

# Header key carrying the propagated context; see serving/rpc.py docs.
HEADER_KEY = "trace"

_ID_BITS = 64


def _new_id() -> str:
    return "%016x" % random.getrandbits(_ID_BITS)


class Span:
    """One timed, named region. Truthy; use as a context manager."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "tags", "tid", "_tracer")

    def __init__(self, tracer, name):
        self._tracer = tracer
        self.name = name
        self.trace_id = None
        self.span_id = None
        self.parent_id = None
        self.t0 = 0.0
        self.t1 = 0.0
        self.tags = None
        self.tid = 0

    def set(self, **tags):
        """Attach tags. Allocates only when the span is live."""
        if self.tags is None:
            self.tags = tags
        else:
            self.tags.update(tags)
        return self

    @property
    def duration(self):
        return self.t1 - self.t0

    def context(self):
        """(trace_id, span_id) of this span, for explicit parenting."""
        return (self.trace_id, self.span_id)

    def __bool__(self):
        return True

    def __enter__(self):
        self._tracer._enter(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        self._tracer._exit(self)
        return False


class _NullSpan:
    """Falsy no-op stand-in returned when tracing is disabled."""

    __slots__ = ()

    def set(self, **tags):
        return self

    def context(self):
        return None

    @property
    def duration(self):
        return 0.0

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans for this process.

    ``clock`` follows the ``reliability/policy.py`` convention: any
    zero-arg callable returning monotonic seconds; ``None`` means
    ``time.perf_counter``. With a real clock, ``_wall_offset`` maps
    span times onto ``time.time()`` so multi-process exports align;
    with a fake clock the offset is forced to 0.0 so tests are exact.
    """

    def __init__(self, clock=None, trace_dir=None, max_spans=65536):
        self.clock = clock or time.perf_counter
        self._wall_offset = 0.0 if clock is not None else time.time() - self.clock()
        self.trace_dir = trace_dir
        self.max_spans = max_spans
        self.spans = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._flushed = 0

    # -- thread-local context stack -------------------------------------

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self):
        """(trace_id, span_id) at the top of this thread's stack, or None."""
        st = getattr(self._local, "stack", None)
        if st:
            return st[-1]
        return None

    def activate(self, ctx):
        """Push a remote context (from :func:`extract`) as the ambient
        parent for this thread. Returns a token for :meth:`deactivate`."""
        st = self._stack()
        st.append(ctx)
        return len(st)

    def deactivate(self, token):
        st = self._stack()
        del st[token - 1:]

    # -- span lifecycle -------------------------------------------------

    def span(self, name, parent=None):
        sp = Span(self, name)
        if parent is not None:
            sp.trace_id, sp.parent_id = parent[0], parent[1]
        return sp

    def _enter(self, sp):
        if sp.trace_id is None:
            cur = self.current()
            if cur is not None:
                sp.trace_id, sp.parent_id = cur
            else:
                sp.trace_id = _new_id()
        sp.span_id = _new_id()
        sp.tid = threading.get_ident()
        self._stack().append((sp.trace_id, sp.span_id))
        sp.t0 = self.clock()

    def _exit(self, sp):
        sp.t1 = self.clock()
        st = self._stack()
        if st and st[-1] == (sp.trace_id, sp.span_id):
            st.pop()
        else:  # mis-nested exit: drop back to this span's frame if present
            try:
                idx = len(st) - 1 - st[::-1].index((sp.trace_id, sp.span_id))
                del st[idx:]
            except ValueError:
                pass
        rec = {
            "name": sp.name,
            "trace_id": sp.trace_id,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "t0": sp.t0 + self._wall_offset,
            "dur": sp.t1 - sp.t0,
            "pid": os.getpid(),
            "tid": sp.tid,
        }
        if sp.tags:
            rec["tags"] = sp.tags
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(rec)
            else:
                self.dropped += 1

    # -- flushing -------------------------------------------------------

    def drain(self):
        """Return all recorded spans and clear the buffer."""
        with self._lock:
            out, self.spans = self.spans, []
            self._flushed = 0
        return out

    def flush(self):
        """Append spans recorded since the last flush to the trace file.

        No-op unless ``trace_dir`` is set. Keeps already-flushed spans
        out of the file on repeated calls (atexit + explicit flush)."""
        if not self.trace_dir:
            return None
        with self._lock:
            new = self.spans[self._flushed:]
            self._flushed = len(self.spans)
        if not new:
            return self.path()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = self.path()
        with open(path, "a", encoding="utf-8") as f:
            for rec in new:
                f.write(json.dumps(rec) + "\n")
        return path

    def path(self):
        if not self.trace_dir:
            return None
        return os.path.join(self.trace_dir, "trace-%d.jsonl" % os.getpid())


# -- module-level fast-path API ----------------------------------------

_TRACER = None
_atexit_installed = False


def start(clock=None, trace_dir=None, max_spans=65536):
    """Install a process-global tracer and return it."""
    global _TRACER, _atexit_installed
    _TRACER = Tracer(clock=clock, trace_dir=trace_dir, max_spans=max_spans)
    if trace_dir and not _atexit_installed:
        atexit.register(_atexit_flush)
        _atexit_installed = True
    return _TRACER


def stop():
    """Flush (if a trace dir is set) and uninstall the global tracer."""
    global _TRACER
    t = _TRACER
    if t is not None:
        t.flush()
    _TRACER = None
    return t


def active():
    return _TRACER


def maybe_start_from_env(clock=None):
    """Start tracing if ``PADDLE_TPU_TRACE`` names a directory."""
    d = os.environ.get(ENV_TRACE_DIR)
    if d and _TRACER is None:
        return start(clock=clock, trace_dir=d)
    return _TRACER


def _atexit_flush():
    t = _TRACER
    if t is not None:
        t.flush()


def span(name, parent=None):
    """Open a span under the global tracer; falsy no-op when disabled."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, parent=parent)


def current():
    """Ambient (trace_id, span_id) for this thread, or None."""
    t = _TRACER
    if t is None:
        return None
    return t.current()


def inject(header, ctx=None):
    """Write the current (or given) context into an rpc header dict."""
    if ctx is None:
        t = _TRACER
        if t is None:
            return header
        ctx = t.current()
    if ctx is not None:
        header[HEADER_KEY] = {"tid": ctx[0], "sid": ctx[1]}
    return header


def extract(header):
    """Read a propagated context out of an rpc header, tracer or not."""
    c = header.get(HEADER_KEY)
    if not c:
        return None
    try:
        return (c["tid"], c["sid"])
    except (TypeError, KeyError):
        return None


def flush():
    t = _TRACER
    if t is None:
        return None
    return t.flush()


# -- export -------------------------------------------------------------

def chrome_trace(spans):
    """Convert span dicts to chrome://tracing "X" complete events."""
    events = []
    for s in spans:
        ev = {
            "name": s["name"],
            "ph": "X",
            "ts": s["t0"] * 1e6,
            "dur": s["dur"] * 1e6,
            "pid": s.get("pid", 0),
            "tid": s.get("tid", 0),
            "args": dict(s.get("tags") or {}),
        }
        ev["args"]["trace_id"] = s["trace_id"]
        ev["args"]["span_id"] = s["span_id"]
        if s.get("parent_id"):
            ev["args"]["parent_id"] = s["parent_id"]
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def load_dir(trace_dir):
    """Read every ``trace-*.jsonl`` under a directory into one span list."""
    spans = []
    if not os.path.isdir(trace_dir):
        return spans
    for fn in sorted(os.listdir(trace_dir)):
        if not (fn.startswith("trace-") and fn.endswith(".jsonl")):
            continue
        with open(os.path.join(trace_dir, fn), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        spans.append(json.loads(line))
                    except ValueError:
                        continue
    return spans
