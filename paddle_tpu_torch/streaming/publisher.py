"""Model-swap plane: watch the checkpoint dir, hot-swap live serving.
(The port's copy of ``paddle_tpu/streaming/publisher.py``.)

Reference: pslib/Downpour's table server shipping fresh parameters to the
serving fleet without restarts. Here the trainer publishes versioned
checkpoints (``checkpoint_<n>`` + atomic ``latest`` marker) and this
watcher detects them and drives the ``reload`` verb — on an in-process
:class:`~paddle_tpu_torch.serving.ServingEngine` directly, or across a whole
router fleet through :class:`RouterTarget`.

Failure story: every staged load is CRC-verified; a corrupt newest
version is recorded (``publish.bad_version`` flight event), counted
against a :class:`~paddle_tpu_torch.reliability.policy.CircuitBreaker` —
repeated bad publishes OPEN it and the publisher stops hammering the
checkpoint dir until the reset timeout — and serving falls back to the
previous intact version. The served version is *pinned*
(``checkpoint.pin_version``) so the trainer's retention GC can never
delete the weights a serving process is using.

Staleness: ``serve-version lag`` (how many publishes behind the fleet
is) and ``staleness seconds`` (publish-to-swap latency, sampled per
swap) export as gauges on the streaming registry.

:class:`FleetPublisher` scales the same contract to N targets with a
two-phase swap (prepare everywhere, then commit per-target on a retry
policy) so a fleet either moves together or fails loudly — see its
docstring for the quarantine / ``fleet_version_skew`` story.
"""

import os
import threading
import time
import warnings

from .. import checkpoint
from ..obs import flight
from ..reliability.policy import CircuitBreaker, RetryError, RetryPolicy
from .stream import REGISTRY

__all__ = ["ModelPublisher", "FleetPublisher", "RouterTarget"]


class RouterTarget:
    """Adapts a :class:`~paddle_tpu_torch.serving.RouterClient` to the
    publisher's target protocol (``reload(ckpt_dir, version=) -> int``
    plus the two-phase ``prepare``/``commit``/``abort`` verbs): each
    call broadcasts to every worker behind the router."""

    def __init__(self, client):
        self.client = client

    def reload(self, ckpt_dir, version=None):
        return self.client.reload(ckpt_dir, version=version)["version"]

    def prepare(self, ckpt_dir, version=None):
        return self.client.prepare(ckpt_dir, version=version)["version"]

    def commit(self, version=None):
        return self.client.commit(version=version)["version"]

    def abort(self):
        return self.client.abort()


class ModelPublisher:
    """Poll ``ckpt_dir`` for fresh versions and hot-swap ``target``.

    ``target`` is anything with ``reload(ckpt_dir, version=) -> version``
    — a ``ServingEngine`` fits directly; wrap a ``RouterClient`` in
    :class:`RouterTarget`. Drive it with ``poll_once()`` (deterministic,
    test/fake-clock friendly) or ``start()``/``stop()`` (background
    watcher thread at ``poll_interval_s``)."""

    def __init__(self, ckpt_dir, target, poll_interval_s=0.2,
                 breaker=None, registry=None, clock=None, sleep=None,
                 pin_owner=None, pin=True):
        self.ckpt_dir = ckpt_dir
        self.target = target
        self.poll_interval_s = float(poll_interval_s)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout_s=10 * poll_interval_s,
            clock=clock, name="publisher")
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self.pin = bool(pin)
        self.pin_owner = pin_owner or ("serving-%d" % os.getpid())
        self.published_version = None
        self.served_version = None
        self.swap_count = 0
        self.bad_publishes = 0
        self.staleness_samples = []  # publish-to-swap latency, seconds
        self._staleness_s = 0.0
        self._last_versions = []
        self._stop = threading.Event()
        self._thread = None
        reg = registry if registry is not None else REGISTRY
        self.registry = reg
        self._c_swaps = reg.counter(
            "paddle_tpu_stream_swaps_total",
            "successful live model hot-swaps")
        self._c_bad = reg.counter(
            "paddle_tpu_stream_bad_publishes_total",
            "published versions that failed the staged CRC load/swap")
        reg.gauge("paddle_tpu_stream_published_version",
                  "newest complete checkpoint version in the publish dir",
                  fn=lambda: -1 if self.published_version is None
                  else self.published_version)
        reg.gauge("paddle_tpu_stream_served_version",
                  "checkpoint version the serving tier runs on",
                  fn=lambda: -1 if self.served_version is None
                  else self.served_version)
        reg.gauge("paddle_tpu_stream_serve_version_lag",
                  "publishes the serving tier is behind the trainer",
                  fn=self.version_lag)
        reg.gauge("paddle_tpu_stream_staleness_seconds",
                  "age of the newest unserved publish (0 when current)",
                  fn=lambda: self._staleness_s)

    # -- staleness -----------------------------------------------------------
    def version_lag(self):
        """How many complete publishes the serving tier is behind (0 =
        serving the newest; N = N fresher versions exist)."""
        vs = self._last_versions
        if not vs:
            return 0
        if self.served_version is None:
            return len(vs)
        try:
            return vs.index(self.served_version)
        except ValueError:
            return len(vs)  # served version already GC'd: fully stale

    def _publish_age_s(self, version):
        try:
            mt = os.path.getmtime(os.path.join(
                self.ckpt_dir, "checkpoint_%d" % version,
                checkpoint._MANIFEST))
            return max(0.0, time.time() - mt)
        except OSError:
            return 0.0

    # -- the watcher ---------------------------------------------------------
    def poll_once(self):
        """One detection + swap attempt. Returns the version swapped to,
        or None (nothing new / breaker open / nothing intact)."""
        versions = checkpoint.candidate_versions(self.ckpt_dir)
        self._last_versions = versions
        if not versions:
            return None
        self.published_version = versions[0]
        if self.served_version == versions[0]:
            self._staleness_s = 0.0
            return None
        self._staleness_s = self._publish_age_s(versions[0])
        if not self.breaker.allow():
            return None  # repeated bad publishes: stop hammering
        swapped = None
        for v in versions:  # newest first; walk back past bad versions
            if self.served_version is not None \
                    and v == self.served_version:
                break  # nothing fresher is intact: keep serving current
            try:
                got = self.target.reload(self.ckpt_dir, version=v)
                swapped = v if got is None else got
                break
            except Exception as e:  # noqa: BLE001 — fall back, stay up
                self.bad_publishes += 1
                self._c_bad.inc()
                tripped = self.breaker.record_failure()
                flight.record("publish.bad_version", version=v,
                              error=type(e).__name__, tripped=tripped)
                warnings.warn(
                    "publisher: version %d failed staged load/swap (%s: "
                    "%s); falling back to the previous intact version"
                    % (v, type(e).__name__, e), RuntimeWarning)
        if swapped is None:
            return None
        if swapped == versions[0]:
            # only serving the NEWEST publish closes the breaker: a
            # fallback swap keeps the bad-publish streak alive
            self.breaker.record_success()
            self._staleness_s = 0.0
        prev = self.served_version
        self.served_version = swapped
        self.swap_count += 1
        self._c_swaps.inc()
        self.staleness_samples.append(self._publish_age_s(swapped))
        if self.pin:
            try:
                checkpoint.pin_version(self.ckpt_dir, swapped,
                                       owner=self.pin_owner)
            except FileNotFoundError:
                pass  # GC raced the swap; the version is gone from disk
            if prev is not None and prev != swapped:
                checkpoint.unpin_version(self.ckpt_dir, prev,
                                         owner=self.pin_owner)
        return swapped

    # -- background thread ---------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="paddle-tpu-publisher")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher survives
                warnings.warn("publisher poll failed: %s: %s"
                              % (type(e).__name__, e), RuntimeWarning)
            self._sleep(self.poll_interval_s)

    def stop(self, unpin=False):
        """Stop the watcher thread. The served version's pin is kept:
        stopping the *publisher* does not stop the *serving process*,
        and unpinning while replicas still serve those weights lets the
        trainer's retention GC delete them out from under live traffic.
        Call :meth:`release` once serving shutdown (or supersession by
        a newer fleet version) is confirmed; ``unpin=True`` collapses
        the two for callers that have already shut serving down."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if unpin:
            self.release()

    def release(self):
        """Drop the retention pin on the served version. Only safe once
        no replica serves those weights any more — after a confirmed
        serving shutdown, or once the fleet converged on a newer
        version and this one is superseded."""
        if self.pin and self.served_version is not None:
            checkpoint.unpin_version(self.ckpt_dir, self.served_version,
                                     owner=self.pin_owner)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class FleetPublisher:
    """Two-phase fleet-wide model swap across N serving targets.

    Each target is anything with the two-phase verbs —
    ``prepare(ckpt_dir, version=) -> version`` (CRC-stage the weights
    without serving them), ``commit(version=) -> version`` (atomic
    swap, idempotent on the already-served version), ``abort()`` — so
    a :class:`~paddle_tpu_torch.serving.ServingEngine` fits directly and a
    :class:`RouterTarget` spans a whole router's worker pool.

    The swap discipline:

    * **prepare** runs on *every* healthy target first. Any single
      failure aborts the round — every staged target gets ``abort()``,
      nothing swaps, the failure feeds the :class:`CircuitBreaker`, and
      the walk falls back to the next older intact version. A fleet
      never half-stages.
    * **commit** then runs per-target under a
      :class:`~paddle_tpu_torch.reliability.policy.RetryPolicy` (``commit``
      is idempotent, so a lost ACK retries safely). A target that
      exhausts its budget is **quarantined**: a
      ``publish.partial_commit`` flight event fires, the
      ``paddle_tpu_stream_fleet_version_skew`` gauge goes positive, and
      the target is skipped until :meth:`readmit` — mixed fleets are
      loud, never silent.

    Retention: the fleet version is pinned; the previous pin is dropped
    only once **no** target (quarantined ones included) still serves
    it."""

    def __init__(self, ckpt_dir, targets, breaker=None, retry=None,
                 registry=None, clock=None, pin_owner=None, pin=True):
        self.ckpt_dir = ckpt_dir
        if isinstance(targets, dict):
            self.targets = dict(targets)
        else:
            self.targets = {"target-%d" % i: t
                            for i, t in enumerate(targets)}
        if not self.targets:
            raise ValueError("FleetPublisher needs at least one target")
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout_s=2.0, clock=clock,
            name="fleet-publisher")
        self.retry = retry or RetryPolicy(max_attempts=3,
                                          base_delay_s=0.05)
        self.pin = bool(pin)
        self.pin_owner = pin_owner or ("fleet-%d" % os.getpid())
        self.fleet_version = None           # version the fleet is on
        self.target_versions = {}           # name -> served version
        self.quarantined = set()            # names skipped until readmit
        self.swap_rounds = 0
        self.prepare_failures = 0
        self.partial_commits = 0
        self._pinned = set()
        reg = registry if registry is not None else REGISTRY
        self.registry = reg
        self._c_partial = reg.counter(
            "paddle_tpu_stream_partial_commits_total",
            "fleet swap rounds that left at least one target behind")
        reg.gauge("paddle_tpu_stream_fleet_version_skew",
                  "targets not serving the fleet version (0 = converged)",
                  fn=self.version_skew)
        reg.gauge("paddle_tpu_stream_fleet_version",
                  "checkpoint version the fleet last committed",
                  fn=lambda: -1 if self.fleet_version is None
                  else self.fleet_version)

    # -- health --------------------------------------------------------------
    def version_skew(self):
        """Targets not serving :attr:`fleet_version` — quarantined or
        never-committed targets count. 0 means the fleet converged."""
        if self.fleet_version is None:
            return 0
        return sum(1 for name in self.targets
                   if self.target_versions.get(name) != self.fleet_version)

    def readmit(self, name):
        """Lift a target's quarantine; the next :meth:`poll_once` tries
        to converge it onto the fleet version again."""
        self.quarantined.discard(name)

    # -- the two-phase round -------------------------------------------------
    def _active(self):
        return [n for n in self.targets if n not in self.quarantined]

    def _abort(self, name):
        # engines expose ``abort_swap`` (``abort`` would be ambiguous on
        # a serving surface); router targets expose ``abort``
        t = self.targets[name]
        fn = getattr(t, "abort_swap", None) or t.abort
        try:
            fn()
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass

    def _prepare_all(self, version, names):
        staged = []
        for name in names:
            try:
                self.targets[name].prepare(self.ckpt_dir, version=version)
                staged.append(name)
            except Exception as e:  # noqa: BLE001 — abort, stay up
                self.prepare_failures += 1
                for other in staged:
                    self._abort(other)
                tripped = self.breaker.record_failure()
                flight.record("publish.prepare_failed", version=version,
                              target=name, error=type(e).__name__,
                              staged=len(staged), tripped=tripped)
                warnings.warn(
                    "fleet publisher: target %r failed prepare of version "
                    "%d (%s: %s); round aborted, nothing swapped"
                    % (name, version, type(e).__name__, e), RuntimeWarning)
                return False
        return True

    def _commit_all(self, version, names):
        committed = []
        for name in names:
            try:
                self.retry.call(
                    lambda t=self.targets[name]: t.commit(version=version))
                self.target_versions[name] = version
                committed.append(name)
            except RetryError as e:
                self.quarantined.add(name)
                self.partial_commits += 1
                self._c_partial.inc()
                self._abort(name)
                flight.record("publish.partial_commit", version=version,
                              target=name, attempts=e.attempts,
                              error=type(e.last).__name__,
                              skew=self.version_skew() + 1)
                warnings.warn(
                    "fleet publisher: target %r exhausted %d commit "
                    "attempt(s) for version %d (%r); QUARANTINED — fleet "
                    "is version-skewed until it heals"
                    % (name, e.attempts, version, e.last), RuntimeWarning)
        return committed

    def _repin(self, version):
        if not self.pin:
            return
        if version not in self._pinned:
            try:
                checkpoint.pin_version(self.ckpt_dir, version,
                                       owner=self.pin_owner)
                self._pinned.add(version)
            except FileNotFoundError:
                pass  # GC raced the swap; the version is gone from disk
        # drop pins no target serves any more — a quarantined target
        # still serving an old version keeps that version's pin alive
        live = set(self.target_versions.values())
        for v in sorted(self._pinned - live - {version}):
            checkpoint.unpin_version(self.ckpt_dir, v,
                                     owner=self.pin_owner)
            self._pinned.discard(v)

    def poll_once(self):
        """One detection + two-phase swap round. Returns the version the
        fleet committed to, or None (nothing new / breaker open /
        nothing intact / round aborted)."""
        versions = checkpoint.candidate_versions(self.ckpt_dir)
        if not versions:
            return None
        names = self._active()
        if not names:
            return None  # whole fleet quarantined: nothing to drive
        stale = [n for n in names
                 if self.target_versions.get(n) != versions[0]]
        if not stale:
            return None
        if not self.breaker.allow():
            return None
        for v in versions:  # newest first; walk back past bad versions
            if self.fleet_version is not None and v < self.fleet_version:
                break  # never roll the fleet backwards
            todo = [n for n in names if self.target_versions.get(n) != v]
            if not todo:
                break
            if not self._prepare_all(v, todo):
                continue  # this version is bad somewhere: try an older
            committed = self._commit_all(v, todo)
            if not committed:
                return None
            self.fleet_version = v
            self.swap_rounds += 1
            if v == versions[0] and len(committed) == len(todo):
                self.breaker.record_success()
            flight.record("publish.fleet_commit", version=v,
                          committed=len(committed), skew=self.version_skew())
            self._repin(v)
            return v
        return None

    def release(self):
        """Drop every retention pin this publisher holds. Only safe once
        serving shutdown is confirmed fleet-wide."""
        for v in sorted(self._pinned):
            checkpoint.unpin_version(self.ckpt_dir, v,
                                     owner=self.pin_owner)
        self._pinned.clear()
