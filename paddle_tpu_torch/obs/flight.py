"""Flight recorder — a bounded ring of reliability decisions: the port's
copy of ``paddle_tpu/obs/flight.py`` (stdlib only; same dump format).

Every fault-site decision (``reliability/faults.py``), circuit-breaker
transition, worker/replica respawn, EDF displacement, deadline refusal,
and per-request outcome lands here as one small dict in a
``collections.deque(maxlen=...)``. Recording is always on (a deque
append under a lock — no I/O, bounded memory); *dumping* only happens
when ``PADDLE_TPU_FLIGHT=<dir>`` is set, on three triggers:

  * an unhandled exception (chained ``sys.excepthook``),
  * ``SIGUSR2`` (poke a live process for its recent history),
  * orderly shutdown (router/worker mains call :func:`maybe_dump`).

The dump is one JSON file per process, ``<dir>/flight-<pid>.json``,
carrying the event ring plus per-kind counts. ``paddle_tpu_torch/tools/chaos_router.py``
audits it against the drill's accepted-request ledger: every accepted
request must appear as a ``request.outcome`` event — no silent losses.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time

ENV_FLIGHT_DIR = "PADDLE_TPU_FLIGHT"

DEFAULT_CAPACITY = 4096


class FlightRecorder:
    def __init__(self, capacity=DEFAULT_CAPACITY, clock=None):
        self.capacity = capacity
        self.clock = clock or time.monotonic
        self._ring = collections.deque(maxlen=capacity)
        self._counts = collections.Counter()
        self._lock = threading.Lock()
        self._dumped = {}

    def record(self, kind, **fields):
        ev = {"kind": kind, "t": self.clock(), "wall": time.time()}
        if fields:
            ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            self._counts[kind] += 1
        return ev

    def events(self, kind=None):
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def counts(self):
        """Per-kind totals since start (not truncated by the ring)."""
        with self._lock:
            return dict(self._counts)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._counts.clear()

    def dump(self, path, reason="manual"):
        with self._lock:
            payload = {
                "reason": reason,
                "pid": os.getpid(),
                "wall": time.time(),
                "capacity": self.capacity,
                "counts": dict(self._counts),
                "events": list(self._ring),
            }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        self._dumped[reason] = path
        return path


# Process-wide recorder. Always on; dump is opt-in via env.
RECORDER = FlightRecorder()


def record(kind, **fields):
    return RECORDER.record(kind, **fields)


def flight_dir():
    return os.environ.get(ENV_FLIGHT_DIR)


def dump_path():
    d = flight_dir()
    if not d:
        return None
    return os.path.join(d, "flight-%d.json" % os.getpid())


def maybe_dump(reason="shutdown"):
    """Dump the ring if ``PADDLE_TPU_FLIGHT`` is set; else a no-op."""
    path = dump_path()
    if path is None:
        return None
    return RECORDER.dump(path, reason=reason)


_installed = False
_prev_excepthook = None


def _excepthook(exc_type, exc, tb):
    try:
        record("crash", error=exc_type.__name__, message=str(exc)[:200])
        maybe_dump(reason="crash")
    except Exception:
        pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _on_sigusr2(signum, frame):
    try:
        maybe_dump(reason="sigusr2")
    except Exception:
        pass


def install():
    """Hook sys.excepthook and SIGUSR2 for crash/poke dumps.

    Safe to call more than once; signal installation is skipped off the
    main thread (library code may call this from anywhere)."""
    global _installed, _prev_excepthook
    if _installed:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    if threading.current_thread() is threading.main_thread() and hasattr(signal, "SIGUSR2"):
        try:
            signal.signal(signal.SIGUSR2, _on_sigusr2)
        except (ValueError, OSError):
            pass
    _installed = True


def load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_dir(d):
    """Read every ``flight-*.json`` under a directory."""
    dumps = []
    if not os.path.isdir(d):
        return dumps
    for fn in sorted(os.listdir(d)):
        if fn.startswith("flight-") and fn.endswith(".json"):
            try:
                dumps.append(load(os.path.join(d, fn)))
            except ValueError:
                continue
    return dumps
