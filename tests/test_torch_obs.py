"""The port's telemetry plane (``obs/``) against ``paddle_tpu.obs``: span
nesting and rpc-header propagation, ``chrome_trace`` output equal to the
reference's for the same spans under a fake clock (ids from the same
seeded stream), flight dumps that each package reads from the other, and
Prometheus text equal for the same observations. On the CPU an
``Executor.run`` span nests under the engine's ``engine.batch``."""

import json
import random
import threading

import numpy as np
import pytest

from paddle_tpu.obs import flight as ref_flight
from paddle_tpu.obs import registry as ref_registry
from paddle_tpu.obs import trace as ref_trace
from paddle_tpu.serving.metrics import ServingMetrics as RefMetrics
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.obs import flight as t_flight
from paddle_tpu_torch.obs import registry as t_registry
from paddle_tpu_torch.obs import trace as t_trace
from paddle_tpu_torch.serving import rpc as t_rpc
from paddle_tpu_torch.serving.metrics import ServingMetrics as TMetrics


@pytest.fixture(autouse=True)
def no_leaked_tracer():
    for mod in (ref_trace, t_trace):
        mod.stop()
    yield
    for mod in (ref_trace, t_trace):
        mod.stop()


@pytest.fixture
def port_programs():
    """Fresh default programs, scope and name generator for the port."""
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


def _traced_sequence(mod, seed=3):
    """One client -> router -> worker hop sequence under a fake clock, the
    ids drawn from ``random`` seeded with ``seed``: returns the drained
    spans."""
    random.seed(seed)
    clk = {"t": 50.0}
    tracer = mod.Tracer(clock=lambda: clk["t"])
    with tracer.span("client.predict") as c:
        clk["t"] += 0.5
        header = {"type": "infer", "deadline_s": 2.0}
        mod.inject(header, ctx=c.context())
    token = tracer.activate(mod.extract(header))
    try:
        with tracer.span("router.door") as sp:
            sp.set(budget_s=2.0)
            clk["t"] += 0.25
        with tracer.span("router.dispatch"):
            clk["t"] += 0.125
            fwd = dict(header)
            mod.inject(fwd, ctx=tracer.current())
            with tracer.span("engine.batch", parent=mod.extract(fwd)) as b:
                b.set(n=3, rung=4)
                with tracer.span("executor.run"):
                    clk["t"] += 1.0
    finally:
        tracer.deactivate(token)
    with pytest.raises(KeyError):
        with tracer.span("boom"):
            clk["t"] += 2.0
            raise KeyError("x")
    return tracer.drain()


def test_span_nesting_and_propagation_alike():
    ref = _traced_sequence(ref_trace)
    port = _traced_sequence(t_trace)
    assert port == ref
    by = {s["name"]: s for s in port}
    root = by["client.predict"]
    assert root["parent_id"] is None
    for name in ("router.door", "router.dispatch", "engine.batch",
                 "executor.run"):
        assert by[name]["trace_id"] == root["trace_id"], name
    assert by["router.door"]["parent_id"] == root["span_id"]
    assert by["engine.batch"]["parent_id"] == by["router.dispatch"]["span_id"]
    assert by["executor.run"]["parent_id"] == by["engine.batch"]["span_id"]
    assert by["boom"]["tags"] == {"error": "KeyError"}
    assert by["executor.run"]["t0"] == 50.875 and \
        by["executor.run"]["dur"] == 1.0


def test_chrome_trace_equals_the_reference():
    ref = ref_trace.chrome_trace(_traced_sequence(ref_trace, seed=11))
    port = t_trace.chrome_trace(_traced_sequence(t_trace, seed=11))
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert port["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in port["traceEvents"]} == {"X"}


def test_inject_extract_round_trip_through_a_port_frame():
    ctx = ("00ab" * 4, "11cd" * 4)
    header = t_trace.inject({"type": "infer", "deadline_s": 1.5}, ctx=ctx)
    got, _ = t_rpc.decode_msg(t_rpc.encode_msg(header,
                                               {"x": np.ones(3, "f4")}))
    assert got["deadline_s"] == 1.5
    assert t_trace.extract(got) == ref_trace.extract(got) == ctx
    assert t_trace.extract({"type": "infer"}) is None
    assert t_trace.extract({"trace": "garbage"}) is None
    assert t_trace.inject({"type": "infer"}) == {"type": "infer"}


def test_disabled_tracing_is_the_falsy_singleton():
    assert t_trace.active() is None
    sp = t_trace.span("x")
    assert sp is t_trace.span("y") and not sp
    assert sp.set(a=1) is sp and sp.context() is None
    assert t_trace.current() is None and t_trace.flush() is None


def test_flush_and_load_dir(tmp_path):
    tracer = t_trace.start(clock=lambda: 1.0, trace_dir=str(tmp_path))
    with t_trace.span("a"):
        with t_trace.span("b"):
            pass
    path = t_trace.flush()
    assert t_trace.flush() == path  # nothing new: not written twice
    assert t_trace.stop() is tracer
    spans = t_trace.load_dir(str(tmp_path))
    assert [s["name"] for s in spans] == ["b", "a"]
    assert spans == ref_trace.load_dir(str(tmp_path))
    assert t_trace.load_dir(str(tmp_path / "missing")) == []


def test_explicit_parent_crosses_threads():
    tracer = t_trace.Tracer(clock=lambda: 0.0)
    with tracer.span("submit") as sub:
        ctx = tracer.current()
    done = threading.Event()

    def worker():
        with tracer.span("batch", parent=ctx):
            pass
        done.set()

    threading.Thread(target=worker).start()
    assert done.wait(10.0)
    spans = {s["name"]: s for s in tracer.drain()}
    assert spans["batch"]["trace_id"] == sub.trace_id
    assert spans["batch"]["parent_id"] == sub.span_id


# -- flight recorder ----------------------------------------------------------

def test_flight_ring_bounds_and_dumps_cross_read(tmp_path, monkeypatch):
    dumps = {}
    for name, mod in (("ref", ref_flight), ("port", t_flight)):
        rec = mod.FlightRecorder(capacity=4, clock=lambda: 1.0)
        for i in range(10):
            rec.record("edf.shed", n=i)
        assert len(rec.events()) == 4
        assert rec.counts() == {"edf.shed": 10}
        assert [e["n"] for e in rec.events()] == [6, 7, 8, 9]
        dumps[name] = rec.dump(str(tmp_path / (name + ".json")),
                               reason="test")
    # each package reads the other's dump
    a, b = t_flight.load(dumps["ref"]), ref_flight.load(dumps["port"])
    assert set(a) == set(b)
    for d in (a, b):
        assert d["reason"] == "test" and d["counts"] == {"edf.shed": 10}
        assert [e["n"] for e in d["events"]] == [6, 7, 8, 9]
    assert [e["kind"] for e in a["events"]] == [e["kind"]
                                                for e in b["events"]]
    monkeypatch.delenv(t_flight.ENV_FLIGHT_DIR, raising=False)
    assert t_flight.maybe_dump() is None
    monkeypatch.setenv(t_flight.ENV_FLIGHT_DIR, str(tmp_path / "fl"))
    t_flight.record("test.event")
    out = t_flight.maybe_dump(reason="unit")
    assert out == t_flight.dump_path()
    got = ref_flight.load_dir(str(tmp_path / "fl"))
    assert len(got) == 1 and any(e["kind"] == "test.event"
                                 for e in got[0]["events"])


def test_fault_trips_and_breaker_opens_reach_the_ring():
    from paddle_tpu_torch.reliability import faults, policy

    t_flight.RECORDER.clear()
    with faults.fault_scope(faults.FaultPlan.from_spec("rpc.send:error@1")):
        with pytest.raises(faults.InjectedFault):
            faults.trip("rpc.send")
    b = policy.CircuitBreaker(failure_threshold=1, name="w1")
    assert b.record_failure()
    b.record_success()
    kinds = [e["kind"] for e in t_flight.RECORDER.events()]
    assert kinds == ["fault.trip", "breaker.open", "breaker.close"]


# -- registry and the serving metrics' exposition -----------------------------

def _observe(m):
    m.observe_completed(0.010)
    m.observe_completed(0.020)
    m.observe_completed(0.0375)
    m.observe_failed(2)
    m.observe_rejected()
    m.observe_expired(3)
    m.observe_shed()
    m.observe_retried()
    m.observe_evicted()
    m.observe_respawned()
    m.observe_door_shed()
    m.observe_rerouted(2)
    m.observe_respawn()
    m.observe_heartbeat_miss(4)
    m.observe_deadline_refused()
    m.observe_batch(actual=4, bucket=8, cache_hit=False)
    m.observe_batch(actual=3, bucket=4, cache_hit=True)
    m.observe_decode_step(live=3, bucket=4, generated=3)
    m.observe_prefix_hit(16)
    m.observe_prefix_eviction()
    m.observe_prefill_chunk(rows=2, tokens=24)
    m.observe_spec(accepted=5, rejected=3)
    m.observe_ttft(0.004)
    m.observe_tpot(0.002)
    m.bind_gauges(lambda: 2, lambda: 5)
    m.bind_prefix_bytes(lambda: 4096)


def test_serving_metrics_prometheus_text_equals_the_reference():
    ref_registry.MFU.reset()
    ref, port = RefMetrics(), TMetrics()
    _observe(ref)
    _observe(port)
    text = port.prometheus_text()
    assert text == ref.prometheus_text()
    assert "paddle_tpu_serving_requests_completed 3" in text
    assert 'paddle_tpu_serving_latency_seconds{quantile="0.5"} 0.02' in text
    assert "paddle_tpu_serving_compile_cache_hits 1" in text
    snap, want = port.snapshot(), ref.snapshot()
    assert snap == want
    assert port.report() == ref.report()
    assert t_registry.MFU.snapshot() == {"steps": 0}


def test_registry_alike_and_checked():
    out = []
    for mod in (ref_registry, t_registry):
        r = mod.Registry()
        c = r.counter("jobs_total", help="jobs")
        c.inc(3)
        g = r.gauge("depth", fn=lambda: 7)
        r.gauge("temp").set(1.5)
        with pytest.raises(ValueError):
            r.counter("0bad")
        with pytest.raises(TypeError):
            r.gauge("jobs_total")
        assert r.counter("jobs_total") is c and g.value == 7
        out.append((r.prometheus_text(), r.values()))
    assert out[0] == out[1]


def test_executor_run_span_nests_under_engine_batch(port_programs):
    import paddle_tpu_torch as fluid

    x = fluid.layers.data("x", shape=[8])
    prob = fluid.layers.softmax(fluid.layers.fc(x, size=4))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program(), scope=scope)
    pred = fluid.inference.ProgramPredictor(
        fluid.default_main_program(), ["x"], [prob], scope=scope,
        place=fluid.CPUPlace())
    eng = fluid.serving.ServingEngine(pred, ladder=(1, 2), max_wait_ms=0)
    tracer = t_trace.start()
    try:
        with t_trace.span("client") as root:
            out, = eng.predict({"x": np.ones((2, 8), "f4")}, timeout_s=30)
        assert out.shape == (2, 4)
    finally:
        eng.shutdown()
        t_trace.stop()
    spans = tracer.drain()
    by = {s["name"]: s for s in spans}
    assert by["engine.batch"]["trace_id"] == root.trace_id
    assert by["engine.batch"]["parent_id"] == root.span_id
    assert by["engine.batch"]["tags"] == {"n": 2, "rung": 2, "requests": 1,
                                          "replica": 0}
    assert by["executor.run"]["parent_id"] == by["engine.batch"]["span_id"]
    assert by["executor.run"]["trace_id"] == root.trace_id
    # with no tracer, a run opens no span
    assert not t_trace.span("executor.run")
