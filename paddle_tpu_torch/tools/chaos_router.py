#!/usr/bin/env python
"""Chaos drill for the port's multi-process serving front door (the twin of
``tools/chaos_router.py``).

Stands up a router + N worker processes, drives a burst of concurrent
requests, optionally SIGKILLs a worker mid-flight, and audits the
accepted-request ledger: every request must end in a result or a TYPED
error within its bound. A request that does neither is a **silent
loss** — the one failure mode the router is not allowed to have — and
makes this tool exit nonzero.

    python paddle_tpu_torch/tools/chaos_router.py --workers 2 \\
        --requests 24 --kill                       # workers on cuda:0
    python paddle_tpu_torch/tools/chaos_router.py --smoke --device cpu
                                                   # 1 worker, 8 requests

Prints one JSON summary line (counters + verdict). ``--faults`` forwards a
``PADDLE_TPU_FAULTS`` plan to every worker process (e.g.
``predictor.run:error@2``) for wire-level drills.

The drill also audits the **flight recorder**: it runs with
``PADDLE_TPU_FLIGHT`` set, and after shutdown cross-checks the router's
dumped ring against the accepted-request ledger — every request accepted
after warm-up must appear as a ``request.outcome`` event, and a kill drill
must have left ``worker.respawn`` evidence — and the **version field**:
every worker's heartbeat stats must carry ``serve_version`` and the fleet
must agree. ``drill`` and ``audit_flight`` run the same audit on a router
the caller built (``chip_smoke.py``'s ``router_chaos`` phase).
"""

import argparse
import json
import os
import signal
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _typed_errors():
    from paddle_tpu_torch.serving import (DeadlineExceededError,
                                          RouterShutdownError,
                                          ServerOverloadedError,
                                          WorkerFailedError)

    return (WorkerFailedError, ServerOverloadedError, DeadlineExceededError,
            RouterShutdownError)


def kill_in_flight(router, victim, summary, before_kill=None):
    """SIGKILL worker ``victim`` once the router has dispatched it a
    request that has not come back (waiting at most 30 s), so the
    kill hits work in flight; ``before_kill()`` runs just before it.
    Records the victim's in-flight count at the kill
    (``victim_in_flight``) and the router's ``rerouted`` counter then, for
    :func:`count_rerouted`."""
    t0 = time.time()
    while (router._worker_states()[victim]["in_flight"] < 1
           and time.time() - t0 < 30.0):
        time.sleep(0.001)
    if before_kill is not None:
        before_kill()
    summary["rerouted"] = router.metrics_.snapshot()["rerouted"]
    summary["victim_in_flight"] = \
        router._worker_states()[victim]["in_flight"]
    summary["killed_pid"] = router._workers[victim].pid
    os.kill(summary["killed_pid"], signal.SIGKILL)


def count_rerouted(router, summary):
    """After the burst resolved: ``rerouted`` becomes the hops the router
    retried on another worker since the kill: the requests it caught in
    flight, and any sent to the dead worker before the heartbeat marked it
    down."""
    summary["rerouted"] = (router.metrics_.snapshot()["rerouted"]
                           - summary["rerouted"])


def hit_in_flight(summary):
    """A kill drill counts only if the kill caught work: the victim held
    a request in flight and the router retried at least one elsewhere."""
    return not summary["kill"] or (summary["victim_in_flight"] >= 1
                                   and summary["rerouted"] >= 1)


def drill(router, client, feeds, kill, timeout_s, probes=(), victim=0,
          before_kill=None):
    """The audited burst on a started ``router``: clear the flight ring
    (the ledger opens here), submit every feed of ``feeds`` at once,
    SIGKILL worker ``victim`` when ``kill``, as soon as it holds one of
    them in flight (:func:`kill_in_flight`), resolve each future (a
    result, a typed error, or a silent loss), count the reroutes, wait
    for the respawn, then run ``probes`` (feeds) one by one on the healed
    fleet and read every worker's ``serve_version``. Returns ``(summary,
    burst outputs (None where an error came back), probe outputs)``."""
    from paddle_tpu_torch.obs import flight

    typed = _typed_errors()
    summary = {"workers": router.num_workers, "requests": len(feeds),
               "kill": bool(kill), "accepted": 0, "completed": 0,
               "typed_errors": {}, "silent_losses": 0, "respawns": 0,
               "recovered": None, "serve_versions": None,
               "killed_pid": None, "victim_in_flight": None,
               "rerouted": None}
    flight.RECORDER.clear()
    futs = [client.submit(f, timeout_s=timeout_s) for f in feeds]
    summary["accepted"] = len(futs)
    if kill:
        kill_in_flight(router, victim, summary, before_kill)
    outs = []
    for f in futs:
        try:
            outs.append(f.result(timeout_s + 30.0))
            summary["completed"] += 1
        except typed as e:
            kind = type(e).__name__
            summary["typed_errors"][kind] = \
                summary["typed_errors"].get(kind, 0) + 1
            outs.append(None)
        except Exception:
            # an untyped resolution counts as a silent loss: callers can't
            # act on it
            summary["silent_losses"] += 1
            outs.append(None)
    if kill:
        count_rerouted(router, summary)
        t0 = time.time()
        while time.time() - t0 < 120.0:
            snap = router.metrics_.snapshot()
            if snap["respawns"] >= 1 and all(
                    w["healthy"] for w in router._worker_states()):
                break
            time.sleep(0.2)
    probe_outs = []
    try:
        for p in probes:
            probe_outs.append(client.predict(p, timeout_s=timeout_s))
        summary["recovered"] = True
    except Exception:
        summary["recovered"] = False
    summary["respawns"] = router.metrics_.snapshot()["respawns"]
    # version audit: stats refresh on the heartbeat, so give the loop a
    # couple of intervals
    t0 = time.time()
    while time.time() - t0 < 10.0:
        stats = [w["stats"] for w in client.metrics()["workers"]]
        if stats and all("serve_version" in s for s in stats):
            summary["serve_versions"] = [s["serve_version"] for s in stats]
            break
        time.sleep(0.2)
    return summary, outs, probe_outs


def audit_flight(dump, summary, probes, kill):
    """Cross-check the router's shutdown dump against the ledger: each of
    the ``accepted`` burst requests and the ``probes`` after it MUST be a
    ``request.outcome`` event — a missing outcome is a request the
    telemetry lost even though the wire answered it."""
    outcomes = [e for e in dump["events"] if e["kind"] == "request.outcome"]
    completed = sum(1 for e in outcomes if e.get("outcome") == "completed")
    respawn_evs = sum(1 for e in dump["events"]
                      if e["kind"] == "worker.respawn")
    ok = (summary["accepted"] <= len(outcomes)
          <= summary["accepted"] + probes
          and completed >= summary["completed"]
          and (not kill or respawn_evs >= 1))
    return {"audit": "ok" if ok else "FAIL",
            "outcome_events": len(outcomes),
            "completed_events": completed,
            "respawn_events": respawn_evs,
            "counts": dump.get("counts", {})}


def verdict(summary):
    return (summary["silent_losses"] == 0 and summary["completed"] > 0
            and summary["recovered"] is not False
            and summary["serve_versions"] is not None
            and len(set(summary["serve_versions"])) == 1  # no skew
            and summary["flight"]["audit"] == "ok"
            and hit_in_flight(summary))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="chaos_router", description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--model", default="builtin:fc")
    ap.add_argument("--device", default="cuda",
                    help="every worker's --device (cuda = cuda:0, or cpu)")
    ap.add_argument("--kill", action="store_true",
                    help="SIGKILL one worker while the burst is in "
                         "flight, then require a respawn")
    ap.add_argument("--faults", default=None,
                    help="PADDLE_TPU_FAULTS plan injected into every "
                         "worker process")
    ap.add_argument("--timeout-s", type=float, default=60.0)
    ap.add_argument("--flight-dir", default=None,
                    help="where the flight dumps go (default: a new "
                         "temporary directory)")
    ap.add_argument("--smoke", action="store_true",
                    help="preset: 1 worker, 8 requests, no kill")
    args = ap.parse_args(argv)
    if args.smoke:
        args.workers, args.requests, args.kill = 1, 8, False
    sys.path.insert(0, ROOT)

    import numpy as np

    from paddle_tpu_torch.obs import flight
    from paddle_tpu_torch.serving import Router, RouterClient

    # dump destination for this drill: the in-process router dumps at
    # shutdown, worker processes inherit the env and dump on reap
    flight_dir = args.flight_dir or tempfile.mkdtemp(
        prefix="paddle-tpu-torch-flight-")
    os.environ[flight.ENV_FLIGHT_DIR] = flight_dir

    worker_env = {}
    if args.faults:
        worker_env["PADDLE_TPU_FAULTS"] = args.faults
    router = Router(args.model, num_workers=args.workers,
                    heartbeat_interval_s=0.2, worker_env=worker_env,
                    worker_args=["--device", args.device])
    feed = {"x": np.full((1, 8), 0.5, "float32")}
    probes = [feed] if args.kill else []
    try:
        router.start()
        client = RouterClient(router.address, pool_size=8)
        client.predict(feed, timeout_s=args.timeout_s)  # warm the fleet
        summary, _, _ = drill(router, client, [feed] * args.requests,
                              args.kill, args.timeout_s, probes)
        client.close()
    finally:
        router.shutdown()
    summary.update(model=args.model, device=args.device,
                   faults=args.faults)
    path = flight.dump_path()
    try:
        summary["flight"] = dict(
            audit_flight(flight.load(path), summary, len(probes),
                         args.kill), dir=flight_dir)
    except (OSError, ValueError) as e:
        summary["flight"] = {"audit": "FAIL",
                             "error": "no dump at %r: %r" % (path, e)}
    ok = verdict(summary)
    summary["verdict"] = "ok" if ok else "FAIL"
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
