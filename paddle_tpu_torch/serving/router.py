"""Multi-process serving front door: a socket router over N workers (the
port of ``paddle_tpu/serving/router.py``).

The reference scales serving by putting processes behind gRPC (pserver
topology: ``distribute_transpiler.py:161`` + ``listen_and_serv``; SURVEY
§3.3) — the process boundary is the scaling unit AND the blast-radius
unit. This module is that boundary for the serving tier, built as a
*reliability* component on ``reliability/`` rather than a dumb proxy:

  * **Admission at the door** — a bounded in-router budget
    (``max_queue_depth``); a full door EDF-sheds an admitted-but-
    undispatched request with a strictly later deadline (mirroring
    ``DynamicBatcher.shed_for``) or answers a typed
    ``ServerOverloadedError``. Overload is a first-class answer, never
    an unbounded queue.
  * **Deadline propagation** — the client stamps ``deadline_s``
    (remaining budget) into the frame; the router re-derives a local
    :class:`~paddle_tpu_torch.reliability.policy.Deadline`, burns queue time
    against it, and forwards the *recomputed* remainder to the worker —
    which refuses already-expired work without executing it
    (``deadline_refused``). Expired requests are deliberately NOT
    dropped at the router: the refusal at the worker is the proof the
    budget made the full trip.
  * **Health-checked workers** — a heartbeat thread pings every worker
    (fault site ``worker.heartbeat``); misses and dispatch failures feed
    a per-worker :class:`~paddle_tpu_torch.reliability.policy.CircuitBreaker`;
    a tripped breaker or dead process marks the worker unhealthy and
    schedules a **respawn** on a
    :class:`~paddle_tpu_torch.reliability.policy.RetryPolicy` backoff
    schedule.
  * **No silent loss** — a request whose dispatch hop fails (connection
    torn, worker SIGKILLed mid-request, injected ``router.dispatch``
    fault) gets exactly ONE cross-worker retry (``rerouted``) and then a
    typed :class:`WorkerFailedError`. Every accepted frame is answered.

Routing is least-loaded by live in-flight count (heartbeat-reported
engine depth breaks ties) or consistent-hash on a caller-supplied
``key`` (md5 ring with virtual nodes — sticky sessions that survive a
respawn); a skipped first choice counts ``rerouted``.

Wire protocol and framing live in :mod:`paddle_tpu_torch.serving.rpc`;
the worker half in :mod:`paddle_tpu_torch.serving.worker`. The router
itself is stdlib + numpy: it never imports torch's CUDA side, and each
worker is a fresh interpreter started through ``subprocess.Popen`` (never a
fork of a process that holds a CUDA context). Each worker serves on
``cuda:0`` unless ``worker_args`` carries ``--device``.

Quickstart::

    router = Router("builtin:fc", num_workers=2,
                    worker_args=["--device", "cpu"])
    router.start()
    client = RouterClient(router.address)
    out = client.predict({"x": np.zeros((1, 8), "float32")},
                         timeout_s=2.0)
    client.close(); router.shutdown()

or standalone::

    python -m paddle_tpu_torch.serving.router --model path/to/model \
        --workers 4 [--device cpu]

The checkpoint verbs (``reload``, and the two-phase ``prepare``,
``commit``, ``abort``) are broadcast to every live worker, each of which
stages the checkpoint directory itself (``checkpoint.load_staged``);
``RouterClient.reload/prepare/commit/abort`` drive them, and
``streaming.RouterTarget`` adapts a client to the publishers.
"""

import argparse
import hashlib
import json
import os
import select
import signal
import socketserver
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..obs import flight, trace
from ..reliability import faults
from ..reliability.policy import CircuitBreaker, Deadline, RetryError, \
    RetryPolicy
from . import rpc
from .admission import DeadlineExceededError, ServerOverloadedError
from .metrics import ServingMetrics
from .worker import EXIT_PREFIX, READY_PREFIX

__all__ = ["Router", "RouterClient", "WorkerFailedError",
           "RouterShutdownError", "main", "reap_procs"]

ROUTER_READY_PREFIX = "PADDLE_TPU_ROUTER_READY "

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def reap_procs(procs, sig=signal.SIGTERM, grace_s=10.0):
    """Signal every live ``Popen`` in ``procs`` and wait it out;
    stragglers get SIGKILL. The one way the router ends a child — never
    orphan the subprocess tree, never wait unboundedly. (The copy of
    ``paddle_tpu/distributed/launch.py``'s; the launcher's port, ROADMAP
    A7, takes it over.)"""
    live = [p for p in procs if p is not None and p.poll() is None]
    for p in live:
        try:
            p.send_signal(sig)
        except OSError:
            pass
    deadline = time.time() + grace_s
    for p in live:
        try:
            p.wait(max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            try:
                p.wait(5.0)
            except subprocess.TimeoutExpired:
                pass


class WorkerFailedError(RuntimeError):
    """The dispatch hop failed and the one cross-worker retry did too
    (or no healthy worker existed) — the typed end of the no-silent-loss
    guarantee, never a hang."""


class RouterShutdownError(RuntimeError):
    """The router is closing; the request was not executed."""


class _Entry:
    """One admitted request's door state, guarded by ``Router._cv``.
    ``deadline_key`` orders EDF shedding (None budget = +inf = most
    sheddable); ``shed`` is flipped by a displacing arrival and observed
    by the owning handler thread."""

    __slots__ = ("deadline", "shed")

    def __init__(self, deadline):
        self.deadline = deadline
        self.shed = False

    def deadline_key(self):
        if self.deadline is None:
            return float("inf")
        return self.deadline.remaining()


class _WorkerHandle:
    """One supervised worker process: its Popen, announced address,
    breaker, live in-flight count, idle-socket pool, a ring buffer of
    its recent stdout for postmortems, the READY and exit reports of
    every process it has run (``ready``, ``exits``: the worker's
    ``PADDLE_TPU_WORKER_READY`` / ``_EXIT`` lines, parsed) and the
    threads draining their pipes."""

    def __init__(self, index, breaker):
        self.index = index
        self.breaker = breaker
        self.proc = None
        self.address = None
        self.pid = None
        self.in_flight = 0
        self.healthy = False
        self.draining = False
        self.respawning = False
        self.restarts = 0
        self.hb_misses = 0
        self.stats = {}
        self.generation = 0
        self.sockets = deque()
        self.sockets_lock = threading.Lock()
        self.tail = deque(maxlen=50)
        self.ready = []
        self.exits = []
        self.drains = []

    def close_sockets(self):
        with self.sockets_lock:
            socks, self.sockets = list(self.sockets), deque()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


class Router:
    """Front-door process manager + request router. ``start()`` spawns
    ``num_workers`` worker processes (each one :class:`ServingEngine`),
    binds the client-facing server on ``(host, port)`` — port 0, the
    default, binds ephemeral; read ``.address`` after ``start()`` — and
    runs the heartbeat/supervision loop until ``shutdown()``.

    ``model`` is passed through to the workers (saved-model dir or
    ``builtin:<name>``); each worker serves on ``cuda:0`` unless
    ``worker_args`` carries ``--device`` (``["--device", "cpu"]``). ``routing`` is ``"least_loaded"`` (default) or
    ``"hash"`` (consistent-hash on the request ``key`` header).
    ``worker_args`` appends raw CLI args to every worker (e.g.
    ``["--replicas", "2"]``); ``worker_env`` overlays the child env
    (e.g. ``{"PADDLE_TPU_FAULTS": "predictor.run:error@1"}`` to chaos
    one whole tier). ``respawn_policy`` is the
    :class:`~paddle_tpu_torch.reliability.policy.RetryPolicy` for restart
    backoff; exhausting it leaves the worker down (the rest of the fleet
    keeps serving)."""

    def __init__(self, model, num_workers=1, host="127.0.0.1", port=0,
                 max_queue_depth=64, inflight_per_worker=32,
                 routing="least_loaded", hash_vnodes=16,
                 heartbeat_interval_s=0.5, heartbeat_timeout_s=2.0,
                 max_heartbeat_misses=3, breaker_threshold=3,
                 respawn_policy=None, worker_args=None, worker_env=None,
                 spawn_timeout_s=120.0, queue_wait_timeout_s=30.0,
                 clock=None):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if routing not in ("least_loaded", "hash"):
            raise ValueError("routing must be 'least_loaded' or 'hash', "
                             "got %r" % (routing,))
        faults.maybe_install_from_env()
        self.model = model
        self.num_workers = int(num_workers)
        self.host = host
        self.port = int(port)
        self.max_queue_depth = int(max_queue_depth)
        self.inflight_per_worker = int(inflight_per_worker)
        self.routing = routing
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_heartbeat_misses = int(max_heartbeat_misses)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.queue_wait_timeout_s = float(queue_wait_timeout_s)
        self.worker_args = list(worker_args or [])
        self.worker_env = dict(worker_env or {})
        self.respawn_policy = respawn_policy or RetryPolicy(
            max_attempts=3, base_delay_s=0.2, max_delay_s=5.0)
        self.clock = clock or time.monotonic
        self.metrics_ = ServingMetrics()

        self._cv = threading.Condition()
        self._entries = set()        # admitted, undispatched (EDF pool)
        self._dispatched = 0
        self._closed = False
        self._workers = [
            _WorkerHandle(i, CircuitBreaker(
                failure_threshold=breaker_threshold,
                reset_timeout_s=self.heartbeat_interval_s,
                clock=self.clock))
            for i in range(self.num_workers)
        ]
        self._ring = self._build_ring(hash_vnodes)
        self._server = None
        self._server_thread = None
        self._health_thread = None
        self._stop = threading.Event()
        self._respawn_threads = []
        self.metrics_.bind_gauges(lambda: len(self._entries),
                                  lambda: self._dispatched)

    # -- process management -------------------------------------------------

    def _spawn_cmd(self):
        return [sys.executable, "-u", "-m",
                "paddle_tpu_torch.serving.worker",
                "--model", str(self.model), "--host", self.host,
                "--port", "0", *self.worker_args]

    def _spawn_env(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep \
            + env.get("PYTHONPATH", "")
        env.update(self.worker_env)
        return env

    def _spawn_worker(self, w):
        """Start one worker process and block until its READY line (or
        raise). Called at start() and from the respawn path."""
        proc = subprocess.Popen(
            self._spawn_cmd(), env=self._spawn_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + self.spawn_timeout_s
        address = None
        while True:
            if proc.poll() is not None:
                reap_procs([proc], grace_s=1.0)
                raise WorkerFailedError(
                    "worker %d exited %s before READY; tail: %s"
                    % (w.index, proc.returncode, list(w.tail)[-5:]))
            budget = deadline - time.monotonic()
            if budget <= 0:
                reap_procs([proc], grace_s=1.0)
                raise WorkerFailedError(
                    "worker %d not READY within %.0fs"
                    % (w.index, self.spawn_timeout_s))
            ready, _, _ = select.select([proc.stdout], [], [],
                                        min(budget, 0.5))
            if not ready:
                continue
            line = proc.stdout.readline()
            if not line:
                continue
            w.tail.append(line.rstrip())
            if line.startswith(READY_PREFIX):
                info = json.loads(line[len(READY_PREFIX):])
                address = (self.host, int(info["port"]))
                w.ready.append(info)
                break
        with self._cv:
            w.proc = proc
            w.address = address
            w.pid = proc.pid
            w.healthy = True
            w.hb_misses = 0
            w.generation += 1
            w.breaker.reset()
            self._cv.notify_all()
        t = threading.Thread(target=self._drain_stdout, args=(w, proc),
                             daemon=True,
                             name="router-stdout-%d" % w.index)
        t.start()
        w.drains.append(t)

    def _drain_stdout(self, w, proc):
        # keep the child's pipe from filling (a full pipe blocks the
        # worker's prints), keep a postmortem tail and the exit report
        try:
            for line in proc.stdout:
                w.tail.append(line.rstrip())
                if line.startswith(EXIT_PREFIX):
                    try:
                        w.exits.append(json.loads(line[len(EXIT_PREFIX):]))
                    except ValueError:
                        pass
        except (OSError, ValueError):
            pass

    def _schedule_respawn(self, w, why):
        """Restart ``w`` on the RetryPolicy schedule, off-thread. The
        worker serves no traffic (``healthy=False``) until READY again;
        its in-flight requests fail their hop and take the cross-worker
        retry path."""
        with self._cv:
            if self._closed or w.respawning:
                return
            w.respawning = True
            w.healthy = False
            self._cv.notify_all()
        w.close_sockets()

        def _run():
            def _attempt():
                if self._closed:
                    raise RouterShutdownError("router closed mid-respawn")
                reap_procs([w.proc], grace_s=2.0)
                self._spawn_worker(w)

            try:
                self.respawn_policy.call(
                    _attempt, retry_on=(WorkerFailedError,))
                with self._cv:
                    w.restarts += 1
                    w.respawning = False
                    self._cv.notify_all()
                self.metrics_.observe_respawn()
                flight.record("worker.respawn", worker=w.index, why=why)
            except (RetryError, RouterShutdownError) as e:
                # budget spent: the worker stays down, the rest of the
                # fleet keeps serving; operators see it in metrics()
                with self._cv:
                    w.respawning = False
                w.tail.append("respawn gave up (%s): %r" % (why, e))
                flight.record("worker.respawn_gave_up", worker=w.index,
                              why=why, error=repr(e)[:200])

        t = threading.Thread(target=_run, daemon=True,
                             name="router-respawn-%d" % w.index)
        t.start()
        self._respawn_threads.append(t)

    # -- health -------------------------------------------------------------

    def _ping_worker(self, w):
        sock = rpc.connect(w.address, timeout=self.heartbeat_timeout_s)
        try:
            rpc.send_msg(sock, {"type": "ping"})
            header, _ = rpc.recv_msg(sock)
            if header.get("type") != "pong":
                raise rpc.RpcError("bad ping reply: %r" % header)
            return header.get("stats", {})
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _health_loop(self):
        while not self._stop.wait(self.heartbeat_interval_s):
            for w in self._workers:
                if self._stop.is_set():
                    return
                with self._cv:
                    if w.respawning:
                        continue
                    proc = w.proc
                if proc is not None and proc.poll() is not None:
                    # the process is DEAD (crash/SIGKILL) — no need to
                    # wait for breaker consensus
                    self._schedule_respawn(
                        w, "process exited %s" % proc.returncode)
                    continue
                try:
                    faults.trip("worker.heartbeat")
                    stats = self._ping_worker(w)
                except (OSError, rpc.RpcError, faults.InjectedFault) as e:
                    self.metrics_.observe_heartbeat_miss()
                    with self._cv:
                        w.hb_misses += 1
                        misses = w.hb_misses
                        tripped = w.breaker.record_failure()
                    if tripped or misses >= self.max_heartbeat_misses:
                        self._schedule_respawn(
                            w, "heartbeat lost (%d misses, last %r)"
                               % (misses, e))
                else:
                    with self._cv:
                        w.hb_misses = 0
                        w.stats = stats
                        w.breaker.record_success()
                        if not w.healthy and not w.respawning:
                            w.healthy = True
                        self._cv.notify_all()

    # -- admission + routing ------------------------------------------------

    def _admit(self, deadline):
        """Door admission under ``_cv``: free slot, EDF displacement, or
        typed overload. Returns the admitted :class:`_Entry`."""
        entry = _Entry(deadline)
        with self._cv:
            if self._closed:
                raise RouterShutdownError("router is shut down")
            if len(self._entries) + self._dispatched \
                    < self.max_queue_depth:
                self._entries.add(entry)
                return entry
            # full door: displace the waiting request with the LATEST
            # deadline, and only if it is strictly later than ours —
            # EDF exactly like DynamicBatcher.shed_for, one layer out
            victim = None
            mine = entry.deadline_key()
            for e in self._entries:
                if e.shed:
                    continue
                if victim is None or e.deadline_key() \
                        > victim.deadline_key():
                    victim = e
            if victim is not None and victim.deadline_key() > mine:
                victim.shed = True
                self._entries.discard(victim)
                self._entries.add(entry)
                self.metrics_.observe_door_shed()
                flight.record("edf.shed", where="router.door")
                self._cv.notify_all()
                return entry
            self.metrics_.observe_rejected()
            raise ServerOverloadedError(
                "router door full (%d in flight)" % self.max_queue_depth)

    def _build_ring(self, vnodes):
        ring = []
        for i in range(self.num_workers):
            for v in range(vnodes):
                h = hashlib.md5(
                    ("%d:%d" % (i, v)).encode()).hexdigest()
                ring.append((h, i))
        ring.sort()
        return ring

    def _hash_order(self, key):
        """Worker indices in consistent-hash preference order for
        ``key``: the ring successor first, then successors of
        successors — a respawn moves no keys, a dead worker only moves
        its own."""
        h = hashlib.md5(str(key).encode()).hexdigest()
        seen, order = set(), []
        start = 0
        while start < len(self._ring) and self._ring[start][0] < h:
            start += 1
        for off in range(len(self._ring)):
            idx = self._ring[(start + off) % len(self._ring)][1]
            if idx not in seen:
                seen.add(idx)
                order.append(idx)
        return order

    def _eligible_locked(self, w, exclude):
        return (w is not exclude and w.healthy and not w.draining
                and not w.respawning
                and w.in_flight < self.inflight_per_worker)

    def _pick_locked(self, key, exclude):
        """Choose a worker (holding ``_cv``) or return None. Counts
        ``rerouted`` when a hash-preferred worker had to be skipped."""
        if self.routing == "hash" and key is not None:
            order = self._hash_order(key)
            for rank, idx in enumerate(order):
                w = self._workers[idx]
                if self._eligible_locked(w, exclude):
                    if rank > 0:
                        self.metrics_.observe_rerouted()
                    return w
            return None
        best = None
        for w in self._workers:
            if not self._eligible_locked(w, exclude):
                continue
            if best is None or w.in_flight < best.in_flight or (
                    w.in_flight == best.in_flight
                    and w.stats.get("queue_depth", 0)
                    < best.stats.get("queue_depth", 0)):
                best = w
        return best

    def _acquire(self, entry, key, exclude=None):
        """Block (bounded) until a worker slot is granted, the entry is
        shed, or the router closes. An EXPIRED deadline does not stop
        the grant — the worker is the one that refuses expired work, and
        ``deadline_refused`` is the proof the budget propagated."""
        t0 = self.clock()
        with self._cv:
            while True:
                if entry.shed:
                    raise ServerOverloadedError(
                        "shed at the door for an earlier deadline")
                if self._closed:
                    self._entries.discard(entry)
                    raise RouterShutdownError("router is shut down")
                w = self._pick_locked(key, exclude)
                if w is not None:
                    w.in_flight += 1
                    self._entries.discard(entry)
                    self._dispatched += 1
                    return w
                if self.clock() - t0 > self.queue_wait_timeout_s:
                    self._entries.discard(entry)
                    raise WorkerFailedError(
                        "no healthy worker within %.1fs"
                        % self.queue_wait_timeout_s)
                self._cv.wait(0.05)

    def _release(self, w):
        with self._cv:
            w.in_flight -= 1
            self._dispatched -= 1
            self._cv.notify_all()

    # -- dispatch -----------------------------------------------------------

    def _send_to_worker(self, w, header, arrays, deadline):
        """One hop: borrow/return a pooled connection, forward the frame
        with the RECOMPUTED remaining budget, read the reply. Raises
        OSError/RpcError/InjectedFault on a torn hop."""
        faults.trip("router.dispatch")
        fwd = dict(header)
        if deadline is not None:
            fwd["deadline_s"] = deadline.remaining()
        # re-parent the propagated trace onto OUR current span (the
        # dispatch span) so the worker's spans nest under this hop; with
        # router tracing off the client's context forwards verbatim,
        # since fwd already carries the original "trace" key
        trace.inject(fwd)
        with w.sockets_lock:
            sock = w.sockets.popleft() if w.sockets else None
        generation = w.generation
        if sock is None:
            sock = rpc.connect(w.address, timeout=self.spawn_timeout_s)
        try:
            rpc.send_msg(sock, fwd, arrays)
            reply = rpc.recv_msg(sock)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        if generation == w.generation:
            with w.sockets_lock:
                w.sockets.append(sock)
        else:
            sock.close()
        return reply

    def _hop_failed(self, w, exc):
        """Breaker bookkeeping for a failed dispatch hop; trips schedule
        a respawn."""
        with self._cv:
            tripped = w.breaker.record_failure()
        if tripped:
            self._schedule_respawn(w, "dispatch failures (%r)" % exc)

    def _dispatch(self, entry, header, arrays, deadline):
        """Admitted request -> reply, with the one cross-worker retry.
        Always returns a reply pair; typed errors, never silence."""
        key = header.get("key")
        with trace.span("router.queue") as sp:
            w = self._acquire(entry, key)
            if sp:
                sp.set(worker=w.index)
        try:
            try:
                reply = self._send_to_worker(w, header, arrays, deadline)
                with self._cv:
                    w.breaker.record_success()
                return reply
            except (OSError, rpc.RpcError, faults.InjectedFault) as e:
                self._hop_failed(w, e)
                first_err = e
        finally:
            self._release(w)
        # the single retry: re-admit against the door (our slot was
        # released), prefer a DIFFERENT worker, count the reroute
        self.metrics_.observe_rerouted()
        with self._cv:
            self._entries.add(entry)
        with trace.span("router.queue") as sp:
            w2 = self._acquire(entry, key, exclude=w
                               if self.num_workers > 1 else None)
            if sp:
                sp.set(worker=w2.index, retry=1)
        try:
            reply = self._send_to_worker(w2, header, arrays, deadline)
            with self._cv:
                w2.breaker.record_success()
            return reply
        except (OSError, rpc.RpcError, faults.InjectedFault) as e:
            self._hop_failed(w2, e)
            raise WorkerFailedError(
                "dispatch failed twice (worker %d: %r; worker %d: %r)"
                % (w.index, first_err, w2.index, e)) from e
        finally:
            self._release(w2)

    def _handle_infer(self, header, arrays):
        t0 = self.clock()
        budget = header.get("deadline_s")
        deadline = None if budget is None \
            else Deadline(budget, clock=self.clock)
        # adopt the client's propagated trace context as this handler
        # thread's ambient parent, so the door/dispatch spans (and the
        # context _send_to_worker re-injects) stitch onto ONE trace
        tracer = trace.active()
        token = None
        if tracer is not None:
            ctx = trace.extract(header)
            if ctx is not None:
                token = tracer.activate(ctx)
        try:
            try:
                with trace.span("router.door") as sp:
                    entry = self._admit(deadline)
                    if sp:
                        sp.set(budget_s=budget)
                with trace.span("router.dispatch"):
                    reply_header, reply_arrays = self._dispatch(
                        entry, header, arrays, deadline)
            except ServerOverloadedError as e:
                flight.record("request.outcome", outcome="ServerOverloaded")
                return {"type": "error", "error": "ServerOverloaded",
                        "message": str(e)}, None
            except RouterShutdownError as e:
                flight.record("request.outcome", outcome="RouterShutdown")
                return {"type": "error", "error": "RouterShutdown",
                        "message": str(e)}, None
            except WorkerFailedError as e:
                self.metrics_.observe_failed()
                flight.record("request.outcome", outcome="WorkerFailed")
                return {"type": "error", "error": "WorkerFailed",
                        "message": str(e)}, None
            if reply_header.get("type") == "error":
                kind = reply_header.get("error")
                if kind == "DeadlineRefused":
                    self.metrics_.observe_deadline_refused()
                    self.metrics_.observe_expired()
                elif kind == "DeadlineExceeded":
                    # budget survived to the worker but died in its engine
                    # queue: a deadline outcome, not a worker failure
                    self.metrics_.observe_expired()
                else:
                    self.metrics_.observe_failed()
                flight.record("request.outcome", outcome=kind)
            else:
                self.metrics_.observe_completed(self.clock() - t0)
                flight.record("request.outcome", outcome="completed")
            return reply_header, reply_arrays
        finally:
            if token is not None:
                tracer.deactivate(token)

    def _worker_states(self):
        with self._cv:
            return [{
                "index": w.index, "pid": w.pid, "healthy": w.healthy,
                "respawning": w.respawning, "restarts": w.restarts,
                "in_flight": w.in_flight, "hb_misses": w.hb_misses,
                "breaker": w.breaker.state, "stats": dict(w.stats),
            } for w in self._workers]

    def _handle_reload(self, header):
        """Broadcast the hot-swap verb to every live worker (the
        streaming publish plane's fleet-wide reload). Each worker stages
        its own CRC-verified load and flips between micro-batches;
        in-flight requests finish on the old weights. Per-worker results
        ride back; the call fails typed only when NO worker swapped."""
        fwd = {"type": "reload", "dir": header.get("dir"),
               "version": header.get("version")}
        results, swapped = self._broadcast_verb("reload", fwd, "reloaded")
        if not swapped:
            flight.record("model.swap_failed", where="router",
                          workers=len(results))
            return {"type": "error", "error": "ReloadFailed",
                    "message": "no worker swapped: %s" % (results,)}, None
        version = min(swapped)
        flight.record("model.swap", where="router", version=version,
                      workers=len(swapped))
        return {"type": "reloaded", "version": version,
                "workers": results}, None

    def _broadcast_verb(self, verb, fwd, ok_type):
        """Drive one swap verb across every live worker; per-worker
        verdicts ride back. Returns (results, versions_that_succeeded)."""
        with self._cv:
            workers = list(self._workers)
        results = []
        for w in workers:
            if not w.healthy:
                results.append({"index": w.index, "error": "unhealthy"})
                continue
            try:
                rh, _ = self._send_to_worker(w, dict(fwd), None, None)
            except Exception as e:  # noqa: BLE001 — per-worker verdicts
                results.append({"index": w.index,
                                "error": "%s: %s" % (type(e).__name__, e)})
                continue
            if rh.get("type") == ok_type:
                results.append({"index": w.index,
                                "version": rh.get("version")})
            else:
                results.append({"index": w.index,
                                "error": rh.get("message",
                                                rh.get("error"))})
        return results, [r["version"] for r in results if "version" in r]

    def _handle_prepare(self, header):
        """Phase 1, router-local all-or-nothing: EVERY worker must stage
        the version or the router aborts its own workers and reports
        typed failure — a router either joins the fleet's swap whole or
        not at all."""
        fwd = {"type": "prepare", "dir": header.get("dir"),
               "version": header.get("version")}
        results, prepared = self._broadcast_verb(
            "prepare", fwd, "prepared")
        if len(prepared) < len(results) or not prepared:
            self._broadcast_verb("abort", {"type": "abort"}, "aborted")
            flight.record("swap.prepare_failed", where="router",
                          prepared=len(prepared), workers=len(results))
            return {"type": "error", "error": "PrepareFailed",
                    "message": "staged %d/%d workers: %s"
                               % (len(prepared), len(results), results)}, \
                None
        flight.record("swap.prepare", where="router",
                      version=min(prepared), workers=len(prepared))
        return {"type": "prepared", "version": min(prepared),
                "workers": results}, None

    def _handle_commit(self, header):
        """Phase 2: all live workers must flip (idempotent per worker,
        so a retried commit converges). A partial worker commit is a typed
        failure — the fleet publisher retries/quarantines the router."""
        fwd = {"type": "commit", "version": header.get("version")}
        results, committed = self._broadcast_verb(
            "commit", fwd, "committed")
        if len(committed) < len(results) or not committed:
            flight.record("swap.commit_failed", where="router",
                          committed=len(committed), workers=len(results))
            return {"type": "error", "error": "CommitFailed",
                    "message": "committed %d/%d workers: %s"
                               % (len(committed), len(results),
                                  results)}, None
        flight.record("swap.commit", where="router",
                      version=min(committed), workers=len(committed))
        return {"type": "committed", "version": min(committed),
                "workers": results}, None

    # -- front server -------------------------------------------------------

    def _make_server(self):
        router = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                while not router._stop.is_set():
                    try:
                        header, arrays = rpc.recv_msg(sock)
                    except rpc.ConnectionClosed:
                        return
                    except rpc.RpcError as e:
                        try:
                            rpc.send_msg(sock, {"type": "error",
                                                "error": "Rpc",
                                                "message": str(e)})
                        except Exception:
                            pass
                        return
                    kind = header.get("type")
                    if kind == "infer":
                        resp, out = router._handle_infer(header, arrays)
                    elif kind == "ping":
                        # the ping path doubles as the scrape endpoint:
                        # Prometheus exposition text rides in the pong
                        resp, out = {
                            "type": "pong",
                            "prometheus": router.metrics_.prometheus_text(),
                        }, None
                    elif kind == "metrics":
                        resp, out = {
                            "type": "metrics",
                            "snapshot": router.metrics_.snapshot(),
                            "workers": router._worker_states(),
                            "prometheus": router.metrics_.prometheus_text(),
                        }, None
                    elif kind == "reload":
                        resp, out = router._handle_reload(header)
                    elif kind == "prepare":
                        resp, out = router._handle_prepare(header)
                    elif kind == "commit":
                        resp, out = router._handle_commit(header)
                    elif kind == "abort":
                        results, _ = router._broadcast_verb(
                            "abort", {"type": "abort"}, "aborted")
                        resp, out = {"type": "aborted",
                                     "workers": results}, None
                    else:
                        resp, out = {"type": "error", "error": "Rpc",
                                     "message": "unknown message type %r"
                                                % kind}, None
                    try:
                        rpc.send_msg(sock, resp, out)
                    except rpc.RpcError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # a burst of new connections (a client's pool, the router's
            # per-worker sockets) must not overflow socketserver's
            # backlog of 5: a dropped SYN is retried after 1 s
            request_queue_size = 128

        return Server((self.host, self.port), Handler)

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        # parallel spawn: worker startup is ~2s each; serial would make
        # a 4-worker router pay 8s at every start
        failures = []

        def _spawn_capture(w):
            try:
                self._spawn_worker(w)
            except Exception as e:
                failures.append(e)

        spawners = [threading.Thread(target=_spawn_capture, args=(w,),
                                     daemon=True)
                    for w in self._workers]
        for t in spawners:
            t.start()
        for t in spawners:
            t.join(self.spawn_timeout_s + 5.0)
        if failures:
            self.shutdown()
            raise failures[0]
        self._server = self._make_server()
        self._server_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True, name="router-server")
        self._server_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="router-health")
        self._health_thread.start()
        return self

    @property
    def address(self):
        if self._server is None:
            raise RuntimeError("router not started")
        return (self.host, self._server.server_address[1])

    def shutdown(self, grace_s=5.0):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._health_thread is not None:
            self._health_thread.join(grace_s)
        for t in self._respawn_threads:
            t.join(grace_s)
        for w in self._workers:
            w.close_sockets()
        reap_procs([w.proc for w in self._workers], grace_s=grace_s)
        for w in self._workers:  # the exit reports reach w.exits
            for t in w.drains:
                t.join(grace_s)
        trace.flush()
        flight.maybe_dump(reason="router-shutdown")

    def __enter__(self):
        if self._server is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


class RouterClient:
    """Client for a :class:`Router`: sync ``predict`` and future-based
    ``submit`` (mirroring ``ServingEngine.submit``), with a small idle
    connection pool. ``submit`` stamps the deadline at CALL time, so
    time spent queued in the client's own thread pool burns the same
    budget everything else does."""

    _ERRORS = {
        "ServerOverloaded": ServerOverloadedError,
        "DeadlineExceeded": DeadlineExceededError,
        "DeadlineRefused": DeadlineExceededError,
        "WorkerFailed": WorkerFailedError,
        "RouterShutdown": RouterShutdownError,
        "ReloadFailed": WorkerFailedError,
        "PrepareFailed": WorkerFailedError,
        "CommitFailed": WorkerFailedError,
        "Rpc": rpc.RpcError,
    }

    def __init__(self, address, pool_size=8, default_timeout_s=None,
                 clock=None):
        self.address = tuple(address)
        self.default_timeout_s = default_timeout_s
        self.clock = clock or time.monotonic
        self._pool = ThreadPoolExecutor(
            max_workers=pool_size, thread_name_prefix="router-client")
        self._idle = deque()
        self._idle_lock = threading.Lock()
        self._closed = False

    def _roundtrip(self, header, arrays):
        with self._idle_lock:
            sock = self._idle.popleft() if self._idle else None
        if sock is None:
            sock = rpc.connect(self.address)
        try:
            rpc.send_msg(sock, header, arrays)
            reply = rpc.recv_msg(sock)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        with self._idle_lock:
            self._idle.append(sock)
        return reply

    def _raise_typed(self, header):
        kind = header.get("error")
        exc_type = self._ERRORS.get(kind, rpc.RpcError)
        exc = exc_type(header.get("message", kind))
        exc.kind = kind
        raise exc

    def _infer(self, feed, deadline, key, extra=None):
        header = {"type": "infer"}
        if key is not None:
            header["key"] = key
        if deadline is not None:
            header["deadline_s"] = deadline.remaining()
        if extra:
            header.update(extra)
        with trace.span("client.predict") as sp:
            # the root of the cross-process trace: inject THIS span's
            # context so every hop downstream stitches onto one trace id
            trace.inject(header)
            reply_header, arrays = self._roundtrip(
                header, {k: np.asarray(v) for k, v in feed.items()})
            if sp and reply_header.get("type") == "error":
                sp.set(error=reply_header.get("error"))
        if reply_header.get("type") == "error":
            self._raise_typed(reply_header)
        n = reply_header.get("n_out", 0)
        return [arrays["o%d" % i] for i in range(n)]

    def predict(self, feed, timeout_s=None, key=None, **decode_kw):
        """Synchronous inference -> list of fetch arrays. Raises the
        same typed errors the in-process engine does
        (:class:`ServerOverloadedError`, :class:`DeadlineExceededError`)
        plus :class:`WorkerFailedError` / :class:`RouterShutdownError`.

        Extra keyword args (``max_new_tokens``, ``eos_id``) ride the
        infer header verbatim — the router forwards unknown header
        fields untouched, and decode workers read them per request."""
        t = timeout_s if timeout_s is not None else self.default_timeout_s
        deadline = None if t is None else Deadline(t, clock=self.clock)
        return self._infer(feed, deadline, key, decode_kw or None)

    def submit(self, feed, timeout_s=None, key=None, **decode_kw):
        """Async inference -> ``concurrent.futures.Future`` resolving to
        the fetch list (or raising the typed error)."""
        if self._closed:
            raise RouterShutdownError("client closed")
        t = timeout_s if timeout_s is not None else self.default_timeout_s
        deadline = None if t is None else Deadline(t, clock=self.clock)
        return self._pool.submit(self._infer, feed, deadline, key,
                                 decode_kw or None)

    def metrics(self):
        """Router-side metrics snapshot + per-worker health states."""
        header, _ = self._roundtrip({"type": "metrics"}, None)
        if header.get("type") == "error":
            self._raise_typed(header)
        return {"snapshot": header["snapshot"],
                "workers": header["workers"]}

    def reload(self, ckpt_dir, version=None):
        """Hot-swap every worker to a published checkpoint version
        (``version=None`` = each worker's newest intact). Returns
        ``{"version": N, "workers": [...]}`` with per-worker verdicts.
        Raises :class:`WorkerFailedError` (``kind`` ``ReloadFailed``)
        only when no worker swapped."""
        header, _ = self._roundtrip(
            {"type": "reload", "dir": ckpt_dir, "version": version}, None)
        if header.get("type") == "error":
            self._raise_typed(header)
        return {"version": header.get("version"),
                "workers": header.get("workers", [])}

    def prepare(self, ckpt_dir, version=None):
        """Phase 1 of the fleet's two-phase swap: CRC-stage ``version``
        on EVERY worker without swapping. All-or-nothing per router — a
        partial stage aborts the router's workers and raises
        :class:`WorkerFailedError` (``kind`` ``PrepareFailed``)."""
        header, _ = self._roundtrip(
            {"type": "prepare", "dir": ckpt_dir, "version": version},
            None)
        if header.get("type") == "error":
            self._raise_typed(header)
        return {"version": header.get("version"),
                "workers": header.get("workers", [])}

    def commit(self, version=None):
        """Phase 2: flip every worker to its staged version (idempotent
        under retry). Raises :class:`WorkerFailedError` (``kind``
        ``CommitFailed``) when any worker failed to flip."""
        header, _ = self._roundtrip(
            {"type": "commit", "version": version}, None)
        if header.get("type") == "error":
            self._raise_typed(header)
        return {"version": header.get("version"),
                "workers": header.get("workers", [])}

    def abort(self):
        """Drop any staged-but-uncommitted version on every worker."""
        header, _ = self._roundtrip({"type": "abort"}, None)
        if header.get("type") == "error":
            self._raise_typed(header)
        return True

    def prometheus(self):
        """Scrape the router's Prometheus exposition text (ping path)."""
        header, _ = self._roundtrip({"type": "ping"}, None)
        if header.get("type") == "error":
            self._raise_typed(header)
        return header.get("prometheus", "")

    def close(self):
        self._closed = True
        self._pool.shutdown(wait=True)
        with self._idle_lock:
            socks, self._idle = list(self._idle), deque()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.router",
        description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--routing", default="least_loaded",
                    choices=["least_loaded", "hash"])
    ap.add_argument("--max-queue-depth", type=int, default=64)
    ap.add_argument("--worker-arg", action="append", default=[],
                    help="extra CLI arg forwarded to every worker "
                         "(repeatable)")
    ap.add_argument("--device", default=None,
                    help="every worker's --device (default: the "
                         "worker's, cuda:0)")
    args = ap.parse_args(argv)
    worker_args = list(args.worker_arg)
    if args.device is not None:
        worker_args += ["--device", args.device]

    trace.maybe_start_from_env()
    flight.install()
    router = Router(args.model, num_workers=args.workers, host=args.host,
                    port=args.port, routing=args.routing,
                    max_queue_depth=args.max_queue_depth,
                    worker_args=worker_args)
    router.start()
    print(ROUTER_READY_PREFIX + json.dumps(
        {"port": router.address[1], "pid": os.getpid(),
         "workers": args.workers}), flush=True)

    done = threading.Event()

    def _on_term(signum, frame):
        done.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
    except ValueError:
        pass
    try:
        done.wait()
    finally:
        router.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
