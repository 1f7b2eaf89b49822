"""Deterministic fault injection (``PADDLE_TPU_FAULTS``): the port's copy of
``paddle_tpu/reliability/faults.py`` (stdlib only; one plan string gives the
same decisions in both packages).

Every recovery path in the framework is exercised against *injected*
failures rather than hoped-for ones. Production code marks its fault
sites with a single cheap call::

    from paddle_tpu_torch.reliability import faults
    ...
    faults.trip("predictor.run")   # no-op unless a plan is active

and a test (or an operator reproducing an incident) activates a plan::

    plan = faults.FaultPlan.from_spec("predictor.run:error@1-3")
    with faults.fault_scope(plan):
        ...   # invocations 1..3 of the site raise InjectedFault

Sites in the port: ``predictor.run`` (serving batch dispatch),
``serving.worker`` (worker-thread top of loop — thread-death drills for
the supervisor), the two-phase swap pair ``swap.prepare`` /
``swap.commit`` (tripped in the serving engine per phase; a prepare
``error`` aborts, ``swap.prepare:corrupt`` models a staged-bytes
mismatch), and the multi-process serving path (``serving/rpc.py`` +
``serving/router.py``): ``rpc.send`` (before a frame is written;
``corrupt`` ships a damaged payload the peer rejects), ``rpc.recv``
(before a frame is read; ``corrupt`` damages the received payload
pre-parse), ``router.dispatch`` (router -> worker hop; ``error``
exercises the one-cross-worker-retry path, ``hang(s)`` burns the
propagated deadline in the router), and ``worker.heartbeat`` (tripped in
the router's health loop before each ping — ``error`` fakes a missed
heartbeat, feeding the per-worker breaker and the respawn path). The
data and streaming plane: ``checkpoint.write`` (array-file writes;
``corrupt`` flips bytes after the write, ``hang(s)`` stalls the writer
thread before the file lands), ``checkpoint.publish`` (per trainer
publish; ``error`` is a failed publish, ``corrupt`` a bad version
landing), ``cursor.write`` (the ingest cursor of a publish),
``recordio.read`` (per record ingested; ``corrupt`` truncates it),
``stream.tail`` (per tail-follow poll) and ``lease.renew`` (per partition
lease heartbeat).

Multi-process note: the env grammar is how faults cross a process
boundary — the router passes ``worker_env={"PADDLE_TPU_FAULTS":
"predictor.run:error@1"}`` to chaos a whole worker tier, e.g.::

    PADDLE_TPU_FAULTS="rpc.send:error@2"           # 2nd frame send dies
    PADDLE_TPU_FAULTS="router.dispatch:hang(0.3)@1" # burn 1st dispatch
    PADDLE_TPU_FAULTS="worker.heartbeat:error@1-3"  # 3 missed pings

Determinism: explicit specs name 1-based invocation numbers per site.
Random ("chaos") plans draw per-(site, invocation) decisions from a
stream seeded by ``(seed, site)`` — the decision for invocation *i*
does not depend on thread interleaving across sites.

Env activation: ``PADDLE_TPU_FAULTS="site:kind@invs[;site:kind@invs]"``
with ``invs`` like ``1,3,5-7`` and ``kind`` one of ``error``,
``hang(seconds)``, ``corrupt``. ``FaultPlan.from_env().install()`` is
called by consumers lazily via :func:`maybe_install_from_env`.
"""

import os
import random
import re
import threading
import time

__all__ = ["InjectedFault", "FaultSpec", "FaultPlan", "trip",
           "corrupt_bytes", "fault_scope", "active_plan",
           "maybe_install_from_env"]

ENV_VAR = "PADDLE_TPU_FAULTS"

_KINDS = ("error", "hang", "corrupt")


class InjectedFault(RuntimeError):
    """Raised by a fault site the active plan chose to fail.

    A typed, recognizable error: recovery paths (retry, eviction,
    checkpoint fallback) treat it like any other failure; assertions in
    tests can tell it apart from genuine bugs."""

    def __init__(self, site, invocation):
        super().__init__("injected fault at %r (invocation %d)"
                         % (site, invocation))
        self.site = site
        self.invocation = invocation


class FaultSpec:
    """One deterministic rule: fail ``site`` on the given 1-based
    ``invocations`` with ``kind`` (error | hang | corrupt)."""

    __slots__ = ("site", "kind", "invocations", "hang_s")

    def __init__(self, site, kind, invocations, hang_s=0.05):
        if kind not in _KINDS:
            raise ValueError("kind must be one of %s, got %r"
                             % (_KINDS, kind))
        self.site = str(site)
        self.kind = kind
        self.invocations = frozenset(int(i) for i in invocations)
        if any(i < 1 for i in self.invocations):
            raise ValueError("invocations are 1-based")
        self.hang_s = float(hang_s)

    def __repr__(self):
        return "FaultSpec(%r, %r, %s)" % (
            self.site, self.kind, sorted(self.invocations))


def _parse_invocations(text):
    out = set()
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(part))
    if not out:
        raise ValueError("empty invocation list")
    return out


_SPEC_RE = re.compile(
    r"^(?P<site>[\w.\-]+):(?P<kind>error|corrupt|hang(?:\("
    r"(?P<hang>[0-9.]+)\))?)@(?P<invs>[0-9,\-\s]+)$")


class FaultPlan:
    """A set of :class:`FaultSpec` rules plus an optional seeded chaos
    mode (``rate`` probability of an ``error`` per invocation on each of
    ``chaos_sites``). Thread-safe; counters are per-site and 1-based."""

    def __init__(self, specs=(), seed=0, rate=0.0, chaos_sites=(),
                 chaos_hang_s=0.002, chaos_kinds=("error",)):
        self.specs = list(specs)
        self.seed = int(seed)
        self.rate = float(rate)
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        self.chaos_sites = tuple(chaos_sites)
        self.chaos_hang_s = float(chaos_hang_s)
        for k in chaos_kinds:
            if k not in _KINDS:
                raise ValueError("chaos kind %r not in %s" % (k, _KINDS))
        self.chaos_kinds = tuple(chaos_kinds)
        self._lock = threading.Lock()
        self._counts = {}
        # per-site decision streams, extended lazily: decision i depends
        # only on (seed, site, i), never on cross-site interleaving
        self._chaos = {}

    # -- construction -------------------------------------------------------
    @classmethod
    def from_spec(cls, text, **kwargs):
        """Parse ``site:kind@invs[;site:kind@invs...]`` (the env grammar)."""
        specs = []
        for clause in str(text).split(";"):
            clause = clause.strip()
            if not clause:
                continue
            m = _SPEC_RE.match(clause)
            if not m:
                raise ValueError(
                    "bad fault spec %r (want site:kind@invocations, e.g. "
                    "predictor.run:error@1-3 or checkpoint.write:"
                    "hang(0.1)@2)" % clause)
            kind = m.group("kind")
            hang_s = 0.05
            if kind.startswith("hang"):
                if m.group("hang"):
                    hang_s = float(m.group("hang"))
                kind = "hang"
            specs.append(FaultSpec(m.group("site"), kind,
                                   _parse_invocations(m.group("invs")),
                                   hang_s=hang_s))
        return cls(specs, **kwargs)

    @classmethod
    def from_env(cls, environ=None):
        """Build a plan from ``PADDLE_TPU_FAULTS``; None when unset."""
        text = (environ or os.environ).get(ENV_VAR)
        if not text:
            return None
        return cls.from_spec(text)

    # -- the hot path -------------------------------------------------------
    def trip(self, site):
        """Record one invocation of ``site`` and act on any matching rule:
        ``error`` raises :class:`InjectedFault`, ``hang`` sleeps the
        rule's seconds then returns None, ``corrupt`` returns the string
        ``"corrupt"`` for the caller to apply (a site that ignores the
        return value simply cannot be corrupted)."""
        with self._lock:
            inv = self._counts.get(site, 0) + 1
            self._counts[site] = inv
            kind, hang_s = self._decide_locked(site, inv)
        if kind is None:
            return None
        # only DECISIONS reach the flight ring — the no-fault path above
        # stays lock+dict-increment only
        from ..obs import flight as _flight
        _flight.record("fault.trip", site=site, invocation=inv, fault=kind)
        if kind == "error":
            raise InjectedFault(site, inv)
        if kind == "hang":
            time.sleep(hang_s)
            return None
        return "corrupt"

    def _decide_locked(self, site, inv):
        for spec in self.specs:
            if spec.site == site and inv in spec.invocations:
                return spec.kind, spec.hang_s
        if self.rate > 0.0 and site in self.chaos_sites:
            stream = self._chaos.get(site)
            if stream is None:
                stream = self._chaos[site] = {
                    "rng": random.Random("%d:%s" % (self.seed, site)),
                    "decisions": []}
            dec = stream["decisions"]
            rng = stream["rng"]
            while len(dec) < inv:
                if rng.random() < self.rate:
                    dec.append(self.chaos_kinds[
                        rng.randrange(len(self.chaos_kinds))])
                else:
                    dec.append(None)
            kind = dec[inv - 1]
            if kind is not None:
                return kind, self.chaos_hang_s
        return None, None

    # -- introspection / lifecycle ------------------------------------------
    def counts(self):
        """Snapshot: site -> invocations recorded so far."""
        with self._lock:
            return dict(self._counts)

    def reset(self):
        with self._lock:
            self._counts.clear()
            self._chaos.clear()

    def install(self):
        """Make this the process-global active plan (see module
        :func:`trip`). Returns self; prefer :func:`fault_scope` in tests."""
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self):
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __repr__(self):
        return ("FaultPlan(specs=%r, seed=%d, rate=%g, chaos_sites=%r)"
                % (self.specs, self.seed, self.rate, self.chaos_sites))


_ACTIVE = None
_env_checked = False


def active_plan():
    return _ACTIVE


def maybe_install_from_env():
    """Install a plan from ``PADDLE_TPU_FAULTS`` once per process (no-op
    when the var is unset or a plan is already active). Called lazily by
    fault-site owners so plain imports stay side-effect-free."""
    global _env_checked
    if _env_checked or _ACTIVE is not None:
        return _ACTIVE
    _env_checked = True
    plan = FaultPlan.from_env()
    if plan is not None:
        plan.install()
    return _ACTIVE


def trip(site):
    """Module-level fast path: no active plan -> pure no-op."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.trip(site)


def corrupt_bytes(data):
    """Deterministically damage one record's bytes: drop the last byte
    (guaranteed size mismatch under fixed-size record schemas) and flip
    the first. Empty input comes back empty."""
    if not data:
        return data
    first = bytes([data[0] ^ 0xFF])
    return first + data[1:-1]


class fault_scope:
    """``with fault_scope(plan):`` — install for the block, restore the
    previous active plan after (exception-safe; nestable)."""

    def __init__(self, plan):
        self.plan = plan
        self._prev = None

    def __enter__(self):
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False
