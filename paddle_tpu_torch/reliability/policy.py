"""Retry / circuit-breaker / deadline policies: the port's copy of
``paddle_tpu/reliability/policy.py`` (stdlib only).

The reference's robustness knobs are RPC-layer constants
(``FLAGS_rpc_deadline``, brpc retry counts); here they are small
composable objects shared by every subsystem that talks to something
that can fail — the serving engine's replica breakers, the router's
per-worker breakers and respawn backoff, and callers of ``predictor.run``.

Time is injected exactly like ``serving.DynamicBatcher``'s clock:
``RetryPolicy`` takes ``sleep=``, ``CircuitBreaker``/``Deadline`` take
``clock=`` — the tier-1 tests drive full backoff schedules and breaker
state machines with fakes and zero real sleeping. Jitter is
*deterministic* (seeded) so a recorded schedule is reproducible in a
postmortem.
"""

import random
import time

from ..obs import flight

__all__ = ["RetryPolicy", "RetryError", "CircuitBreaker", "Deadline",
           "DeadlineExpired"]


class RetryError(RuntimeError):
    """The retry budget (or its deadline) is spent; ``.last`` is the
    final exception and ``.attempts`` how many were actually made —
    fewer than ``max_attempts`` when a deadline cut the schedule short."""

    def __init__(self, attempts, last):
        super().__init__("gave up after %d attempt(s); last: %r"
                         % (attempts, last))
        self.attempts = attempts
        self.last = last


class RetryPolicy:
    """Exponential backoff with bounded, deterministic jitter.

    ``delays()`` is the full schedule (``max_attempts - 1`` waits):
    ``base_delay_s * multiplier**k``, capped at ``max_delay_s``, each
    scaled by ``1 + U(-jitter, +jitter)`` drawn from a seeded stream —
    two policies built with the same arguments produce the same
    schedule.

    ``call(fn)`` runs ``fn`` up to ``max_attempts`` times, sleeping the
    schedule between failures, and raises :class:`RetryError` wrapping
    the last exception when the budget is spent.
    """

    def __init__(self, max_attempts=3, base_delay_s=0.05, max_delay_s=2.0,
                 multiplier=2.0, jitter=0.1, seed=0, sleep=None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if base_delay_s < 0 or max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.sleep = sleep or time.sleep

    def delays(self):
        """The deterministic backoff schedule as a list of seconds."""
        rng = random.Random(self.seed)
        out = []
        for k in range(self.max_attempts - 1):
            d = min(self.base_delay_s * (self.multiplier ** k),
                    self.max_delay_s)
            if self.jitter:
                d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
            out.append(d)
        return out

    def call(self, fn, retry_on=(Exception,), on_retry=None,
             deadline=None):
        """Run ``fn()`` with retries. ``retry_on`` limits which exception
        types are retried (others propagate immediately); ``on_retry``
        is called as ``on_retry(attempt_index, exc, delay_s)`` before
        each sleep; a :class:`Deadline` stops early (the remaining
        schedule is skipped and :class:`RetryError` raised) instead of
        sleeping past it."""
        schedule = self.delays()
        last = None
        attempts = 0
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on as e:
                last = e
                attempts = attempt + 1
                if attempt == self.max_attempts - 1:
                    break
                delay = schedule[attempt]
                if deadline is not None:
                    rem = deadline.remaining()
                    if rem <= delay:
                        break
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if delay > 0:
                    self.sleep(delay)
        raise RetryError(attempts, last) from last


class CircuitBreaker:
    """Consecutive-failure breaker: CLOSED -> OPEN after
    ``failure_threshold`` consecutive failures; OPEN -> HALF_OPEN after
    ``reset_timeout_s`` (one probe allowed); a probe success closes it,
    a probe failure re-opens. Not thread-safe by itself — callers that
    share one breaker across threads (the serving engine does not: one
    breaker per replica, touched only by that replica's worker thread)
    must lock around it."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold=3, reset_timeout_s=30.0,
                 clock=None, name=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.clock = clock or time.monotonic
        self.name = name  # flight-recorder label; anonymous if None
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at = None

    def allow(self):
        """May the next call proceed? OPEN turns HALF_OPEN (allowing one
        probe) once the reset timeout has passed."""
        if self.state == self.OPEN:
            if self.clock() - self.opened_at >= self.reset_timeout_s:
                self.state = self.HALF_OPEN
                return True
            return False
        return True

    def record_success(self):
        if self.state != self.CLOSED:
            flight.record("breaker.close", breaker=self.name)
        self.consecutive_failures = 0
        self.state = self.CLOSED
        self.opened_at = None

    def record_failure(self):
        """Returns True exactly when this failure TRIPS the breaker
        (transition into OPEN) — the caller's cue to evict/rebuild."""
        self.consecutive_failures += 1
        was_open = self.state == self.OPEN
        if (self.state == self.HALF_OPEN
                or self.consecutive_failures >= self.failure_threshold):
            self.state = self.OPEN
            self.opened_at = self.clock()
            if not was_open:
                flight.record("breaker.open", breaker=self.name,
                              failures=self.consecutive_failures)
                return True
            return False
        return False

    def reset(self):
        self.record_success()


class DeadlineExpired(TimeoutError):
    pass


class Deadline:
    """A wall-clock budget carried through a call chain."""

    def __init__(self, timeout_s, clock=None):
        self.clock = clock or time.monotonic
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self._t0 = self.clock()

    def remaining(self):
        """Seconds left (may be negative); +inf for a None budget."""
        if self.timeout_s is None:
            return float("inf")
        return self.timeout_s - (self.clock() - self._t0)

    def expired(self):
        return self.remaining() <= 0

    def require(self, what="operation"):
        """Raise :class:`DeadlineExpired` when the budget is spent."""
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExpired(
                "%s exceeded its %.3fs deadline by %.3fs"
                % (what, self.timeout_s, -rem))
        return rem
