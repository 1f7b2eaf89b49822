"""The port's front door under failure, as the reference's
``tests/test_router.py`` and ``tests/test_obs.py`` drill it, on ``--device
cpu`` workers: a missed heartbeat driving a respawn, door overload with
EDF shedding and a typed rejection, a worker SIGKILLed mid-request with
zero silent loss (and the flight dump accounting for every request), and
one predict yielding one trace stitched across three processes.

Fault sites are process-global, so the heartbeat drill runs first, before
any other router's health loop could consume its invocations (tier-1 runs
files in order, one file per xdist worker)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.obs import flight, trace
from paddle_tpu_torch.reliability import faults
from paddle_tpu_torch.serving import (DeadlineExceededError, Router,
                                      RouterClient, RouterShutdownError,
                                      ServerOverloadedError,
                                      WorkerFailedError)
from paddle_tpu_torch.serving.router import ROUTER_READY_PREFIX

FC_FEED = {"x": np.full((1, 8), 0.5, "float32")}
CPU = ["--device", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_leaked_tracer():
    trace.stop()
    yield
    trace.stop()


def _wait_for(cond, timeout=60.0, what="condition"):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "timed out waiting for " + what
        time.sleep(0.05)


def test_heartbeat_fault_site_drives_a_respawn():
    """worker.heartbeat:error@1-3 fakes three missed pings: each counts a
    heartbeat miss, the third trips the worker's breaker, and the
    (healthy) process is restarted."""
    plan = faults.FaultPlan.from_spec("worker.heartbeat:error@1-3")
    router = Router("builtin:fc", num_workers=1, worker_args=CPU,
                    heartbeat_interval_s=0.15, max_heartbeat_misses=3,
                    breaker_threshold=3)
    try:
        with faults.fault_scope(plan):
            router.start()
            first_pid = router._workers[0].pid
            _wait_for(lambda: router.metrics_.snapshot()["respawns"] >= 1,
                      what="heartbeat-driven respawn")
        assert router.metrics_.snapshot()["heartbeat_misses"] == 3
        assert router._workers[0].pid != first_pid
        client = RouterClient(router.address)
        (o,) = client.predict(FC_FEED, timeout_s=60.0)
        assert o.shape == (1, 4)
        client.close()
    finally:
        router.shutdown()
    # the respawn reaped the first process with SIGTERM: both processes
    # drained and printed their exit reports
    w = router._workers[0]
    assert [r["pid"] for r in w.ready] == [e["pid"] for e in w.exits]
    assert len(w.exits) == 2 and w.exits[1]["served"] == 1


def test_door_overload_edf_shed_and_typed_rejection():
    """One worker whose every batch hangs 0.3 s, a 2-deep door: a third
    concurrent request EDF-sheds the waiting one with the later deadline;
    later arrivals get the typed rejection. Every future resolves."""
    router = Router(
        "builtin:fc", num_workers=1, max_queue_depth=2,
        inflight_per_worker=1, heartbeat_interval_s=10.0,
        queue_wait_timeout_s=20.0, worker_args=CPU,
        worker_env={"PADDLE_TPU_FAULTS": "predictor.run:hang(0.3)@1-99"})
    try:
        router.start()
        client = RouterClient(router.address, pool_size=8)
        f1 = client.submit(FC_FEED, timeout_s=60.0)
        _wait_for(lambda: router._dispatched == 1, what="f1 dispatched")
        f2 = client.submit(FC_FEED, timeout_s=50.0)
        _wait_for(lambda: len(router._entries) == 1, what="f2 waiting")
        f3 = client.submit(FC_FEED, timeout_s=10.0)  # displaces f2
        with pytest.raises(ServerOverloadedError):
            f2.result(30.0)
        assert len(f1.result(60.0)) == 1 and len(f3.result(60.0)) == 1
        assert router.metrics_.snapshot()["door_shed"] == 1
        g1 = client.submit(FC_FEED, timeout_s=40.0)
        _wait_for(lambda: router._dispatched + len(router._entries) >= 1,
                  what="g1 admitted")
        results, errors = [], []
        for f in [client.submit(FC_FEED, timeout_s=30.0)
                  for _ in range(6)] + [g1]:
            try:
                results.append(f.result(60.0))
            except (ServerOverloadedError, DeadlineExceededError) as e:
                errors.append(e)
        assert len(results) + len(errors) == 7
        assert router.metrics_.snapshot()["requests_rejected"] >= 1
        client.close()
    finally:
        router.shutdown()


def test_sigkill_mid_request_zero_silent_loss_and_the_flight_dump(
        tmp_path, monkeypatch):
    """SIGKILL one of two workers while a burst is in flight: every
    accepted request ends in a result or a typed error, the worker
    respawns, the fleet serves afterwards, and the router's shutdown dump
    holds one request.outcome per request and the respawn."""
    monkeypatch.setenv(flight.ENV_FLIGHT_DIR, str(tmp_path))
    router = Router("builtin:fc", num_workers=2, worker_args=CPU,
                    heartbeat_interval_s=0.2)
    try:
        router.start()
        client = RouterClient(router.address, pool_size=8)
        for _ in range(4):
            client.predict(FC_FEED, timeout_s=60.0)
        flight.RECORDER.clear()  # the audited ledger starts here
        victim = router._workers[0].pid
        futs = [client.submit(FC_FEED, timeout_s=60.0) for _ in range(12)]
        os.kill(victim, signal.SIGKILL)
        resolved = typed = 0
        for f in futs:
            try:
                (o,) = f.result(60.0)
                assert o.shape == (1, 4)
                resolved += 1
            except (WorkerFailedError, ServerOverloadedError,
                    DeadlineExceededError):
                typed += 1
        assert resolved + typed == 12 and resolved >= 1
        _wait_for(lambda: router.metrics_.snapshot()["respawns"] >= 1
                  and all(w["healthy"] for w in router._worker_states()),
                  what="respawn")
        assert router._workers[0].pid != victim
        (o,) = client.predict(FC_FEED, timeout_s=60.0)
        assert o.shape == (1, 4)
        client.close()
    finally:
        router.shutdown()
    dump = flight.load(flight.dump_path())
    assert dump["reason"] == "router-shutdown"
    outcomes = [e for e in dump["events"] if e["kind"] == "request.outcome"]
    assert len(outcomes) == 13
    assert sum(e["outcome"] == "completed" for e in outcomes) == resolved + 1
    assert dump["counts"].get("worker.respawn", 0) >= 1
    # each worker process that was shut down dumped its own ring
    pids = {d["pid"] for d in flight.load_dir(str(tmp_path))}
    assert {w.pid for w in router._workers} <= pids


def _read_ready_line(proc, timeout=120.0):
    out = {}

    def reader():
        for line in proc.stdout:
            if line.startswith(ROUTER_READY_PREFIX):
                out["info"] = json.loads(line[len(ROUTER_READY_PREFIX):])
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    return out.get("info")


def test_one_predict_one_trace_across_three_processes(tmp_path):
    """One RouterClient.predict against a 2-worker router subprocess
    (``python -m paddle_tpu_torch.serving.router --device cpu``) yields one
    trace, stitched by the propagated id across client, router and worker:
    door, dispatch, worker queue, engine batch and executor run."""
    trace_dir = str(tmp_path / "traces")
    env = dict(os.environ, PADDLE_TPU_TRACE=trace_dir,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.router",
         "--model", "builtin:fc", "--workers", "2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=REPO)
    try:
        info = _read_ready_line(proc)
        assert info, "router never announced READY"
        trace.start(trace_dir=trace_dir)
        try:
            client = RouterClient(("127.0.0.1", info["port"]))
            (o,) = client.predict(FC_FEED, timeout_s=60.0)
            assert o.shape == (1, 4)
            client.close()
        finally:
            trace.stop()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    spans = trace.load_dir(trace_dir)
    roots = [s for s in spans if s["name"] == "client.predict"]
    assert len(roots) == 1
    tid = roots[0]["trace_id"]
    tspans = [s for s in spans if s["trace_id"] == tid]
    assert {"client.predict", "router.door", "router.dispatch",
            "worker.queue", "engine.batch", "executor.run"} <= {
                s["name"] for s in tspans}
    assert len({s["pid"] for s in tspans}) >= 3
    ids = {s["span_id"] for s in tspans}
    for s in tspans:
        if s["parent_id"] is not None:
            assert s["parent_id"] in ids, s
    chrome = trace.chrome_trace(tspans)
    assert len(chrome["traceEvents"]) == len(tspans)


@pytest.mark.slow
def test_router_soak_kill_respawn_under_sustained_load():
    """Sustained load with a SIGKILL every ~2 s; after each kill the fleet
    recovers and no request is lost silently."""
    router = Router("builtin:fc", num_workers=2, worker_args=CPU,
                    heartbeat_interval_s=0.2)
    try:
        router.start()
        client = RouterClient(router.address, pool_size=8)
        stop = threading.Event()
        resolved, typed = [], []

        def load():
            while not stop.is_set():
                try:
                    client.predict(FC_FEED, timeout_s=30.0)
                    resolved.append(1)
                except (WorkerFailedError, ServerOverloadedError,
                        DeadlineExceededError):
                    typed.append(1)
                except RouterShutdownError:
                    return

        threads = [threading.Thread(target=load) for _ in range(4)]
        for t in threads:
            t.start()
        for round_no in range(3):
            time.sleep(2.0)
            os.kill(router._workers[round_no % 2].pid, signal.SIGKILL)
            _wait_for(lambda: all(w["healthy"]
                                  for w in router._worker_states()),
                      timeout=60.0, what="soak respawn")
        stop.set()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
        assert len(resolved) > 0
        assert router.metrics_.snapshot()["respawns"] >= 3
        client.close()
    finally:
        router.shutdown()
