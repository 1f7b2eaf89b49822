"""The port's one-shot ``ServingEngine`` options against the reference's:
sequence bucketing, EDF shedding, the one cross-replica retry, breaker
eviction and rebuild, the supervisor, ``compiled_shape_counts``, hot-swap
from an update list, ``per_device`` placement, and the metrics they leave.

Engine behaviour is driven through both packages' engines with the same
fake predictor and the same ``PADDLE_TPU_FAULTS`` plans (each package's
own fault harness), and held equal; the model tests load weights the
reference initialised and saved, and compare answers within 1e-5."""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.reliability import faults as ref_faults
from paddle_tpu.serving import batcher as ref_batcher
from paddle_tpu.serving import buckets as ref_buckets
from paddle_tpu.serving import engine as ref_engine
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.reliability import faults as t_faults
from paddle_tpu_torch.serving import batcher as t_batcher
from paddle_tpu_torch.serving import buckets as t_buckets
from paddle_tpu_torch.serving import engine as t_engine
from paddle_tpu_torch.serving.admission import ServerOverloadedError

PKGS = {"ref": (ref_engine, ref_faults), "port": (t_engine, t_faults)}


@pytest.fixture(autouse=True)
def fresh_port_programs():
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


class FakePredictor:
    """Doubles its input; an optional gate holds the worker mid-run; counts
    the ``close()`` calls an eviction makes."""

    feed_names = ["x"]

    def __init__(self, gate=None, closed=None):
        self.gate = gate
        self.closed = closed if closed is not None else []

    def run(self, feed, return_numpy=True):
        if self.gate is not None:
            assert self.gate.wait(10.0), "test gate never opened"
        return [np.asarray(feed["x"]) * 2.0]

    def clone(self, device=None):
        return FakePredictor(self.gate, self.closed)

    def close(self):
        self.closed.append(self)


def _drain_queue(eng, timeout=10.0):
    t0 = time.time()
    while eng._batcher.depth() > 0:
        assert time.time() - t0 < timeout, "queue never drained"
        time.sleep(0.001)


_COUNTERS = ("requests_completed", "requests_failed", "requests_rejected",
             "requests_expired", "requests_shed", "requests_retried",
             "replicas_evicted", "workers_respawned", "batches",
             "compile_cache_hits", "compile_cache_misses")


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in _COUNTERS}


def _counter_lines(text):
    return [line for line in text.splitlines()
            if "latency" not in line and "ttft" not in line
            and "tpot" not in line]


# -- buckets and the batcher's shed_for ---------------------------------------

@pytest.mark.parametrize("case", [
    ({"x": (3, 5)}, (4,), (8, 16)),
    ({"x": (1, 9), "y": (1,)}, (1, 2), (8, 16)),
    ({"x": (2, 16, 3), "s": ()}, (2, 4), (16,)),
    ({"x": (2, 3)}, (1, 2, 4), None),
])
def test_pad_to_bucket_with_a_seq_ladder_alike(case):
    shapes, ladder, seq_ladder = case
    rng = np.random.RandomState(0)
    feed = {k: np.asarray(rng.randn(*s), "f4") for k, s in shapes.items()}
    want, wn = ref_buckets.pad_to_bucket(feed, ladder, seq_ladder=seq_ladder)
    got, n = t_buckets.pad_to_bucket(feed, ladder, seq_ladder=seq_ladder)
    assert n == wn and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(t_buckets.BucketError):
        t_buckets.pad_to_bucket({"x": np.ones((1, 40))}, (1,),
                                seq_ladder=(8, 16))


def test_shed_for_picks_the_same_victims():
    """The same queue of deadlines, the same arrivals: the same victims
    (latest deadline first, deadline-less first of all, the youngest on a
    tie) and the same refusals where too little is sheddable."""
    deadlines = [5.0, None, 3.0, 9.0, 9.0, None, 1.0]
    sizes = [1, 2, 1, 1, 3, 1, 2]
    arrivals = [(0.5, 1), (4.0, 2), (2.0, 6), (8.0, 1), (0.1, 1),
                (None, 1), (0.1, 9), (0.1, 1), (0.1, 1)]
    picked = {}
    for name, mod in (("ref", ref_batcher), ("port", t_batcher)):
        b = mod.DynamicBatcher(16)
        for i, (d, n) in enumerate(zip(deadlines, sizes)):
            b.put(mod.Request({"i": i}, n, None, 0.0, deadline=d))
        got = []
        for d, short in arrivals:
            v = b.shed_for(d, short)
            got.append(None if v is None else v.feed["i"])
        picked[name] = (got, b.depth())
    assert picked["port"] == picked["ref"]
    assert any(v is not None for v in picked["port"][0])
    assert None in picked["port"][0]


# -- the engine's reliability paths, both packages ----------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_breaker_evicts_three_times_and_rebuilds(pkg):
    """predictor.run fails on its first 9 invocations: with one retry a
    request and a breaker of 3, the replica is evicted three times, each
    evicted predictor closed (the port's), and serving recovers; the two
    packages resolve every request the same way."""
    engine_mod, faults = PKGS[pkg]
    closed = []
    plan = faults.FaultPlan.from_spec("predictor.run:error@1-9")
    outcomes = []
    with faults.fault_scope(plan):
        eng = engine_mod.ServingEngine(
            FakePredictor(closed=closed), num_replicas=1, ladder=(1, 2),
            max_wait_ms=0, max_queue_depth=64, max_replica_failures=3)
        try:
            for i in range(8):
                f = eng.submit({"x": np.full((1, 2), float(i), "f4")})
                try:
                    out, = f.result(10.0)
                    np.testing.assert_array_equal(
                        out, np.full((1, 2), 2.0 * i))
                    outcomes.append("ok")
                except faults.InjectedFault:
                    outcomes.append("fault")
            counters = _counters(eng)
        finally:
            eng.shutdown()
    assert outcomes == ["fault"] * 4 + ["ok"] * 4
    assert counters["replicas_evicted"] == 3
    assert counters["requests_retried"] == 5
    assert eng._admission.in_flight == 0
    if pkg == "port":
        assert len(closed) == 3
        assert eng._workers[0].predictor not in closed


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_one_cross_replica_retry_masks_one_failure(pkg):
    engine_mod, faults = PKGS[pkg]
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "predictor.run:error@1")):
        eng = engine_mod.ServingEngine(FakePredictor(), num_replicas=2,
                                       ladder=(1, 2), max_wait_ms=0)
        try:
            out, = eng.submit({"x": np.full((1, 2), 3.0, "f4")}).result(10)
            np.testing.assert_array_equal(out, np.full((1, 2), 6.0))
            m = eng.metrics()
            assert m["requests_retried"] == 1 and m["requests_failed"] == 0
        finally:
            eng.shutdown()
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "predictor.run:error@1")):
        eng = engine_mod.ServingEngine(FakePredictor(), ladder=(1,),
                                       max_wait_ms=0,
                                       cross_replica_retry=False)
        try:
            with pytest.raises(faults.InjectedFault):
                eng.submit({"x": np.ones((1, 2), "f4")}).result(10)
            assert eng.metrics()["requests_retried"] == 0
        finally:
            eng.shutdown()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_edf_shedding_under_overload(pkg):
    """A full queue sheds its latest-deadline entry for a more urgent
    arrival; a deadline-less arrival can displace nothing; an infeasible
    shortfall kills nobody."""
    engine_mod, _ = PKGS[pkg]
    gate = threading.Event()
    eng = engine_mod.ServingEngine(FakePredictor(gate), ladder=(1, 2),
                                   max_wait_ms=0, max_queue_depth=3)
    try:
        blocker = eng.submit({"x": np.ones((1, 2), "f4")})
        _drain_queue(eng)  # the worker holds `blocker` at the gate
        lazy = [eng.submit({"x": np.ones((1, 2), "f4")}, timeout_s=100.0)
                for _ in range(2)]
        urgent = eng.submit({"x": np.full((1, 2), 7.0, "f4")},
                            timeout_s=5.0)
        shed = [f for f in lazy if f.done()]
        assert len(shed) == 1
        with pytest.raises(ServerOverloadedError if pkg == "port" else
                           Exception, match="shed"):
            shed[0].result(0.0)
        with pytest.raises(Exception, match="full|overload"):
            eng.submit({"x": np.ones((1, 2), "f4")})
        # two short, but only the lazy request's one example is queued
        # on a later deadline: infeasible, so nobody is shed
        with pytest.raises(Exception, match="full|overload"):
            eng.submit({"x": np.ones((2, 2), "f4")}, timeout_s=10.0)
        assert not any(f.done() for f in lazy if f is not shed[0])
        m = eng.metrics()
        assert m["requests_shed"] == 1 and m["requests_rejected"] == 2
        gate.set()
        assert blocker.result(10.0) and urgent.result(10.0)
    finally:
        gate.set()
        eng.shutdown()
    assert eng._admission.in_flight == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_supervisor_respawns_dead_worker_threads(pkg):
    engine_mod, faults = PKGS[pkg]
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "serving.worker:error@1-2")):
        eng = engine_mod.ServingEngine(FakePredictor(), num_replicas=2,
                                       ladder=(1, 2), max_wait_ms=0,
                                       supervisor_interval_s=0.01)
        try:
            t0 = time.time()
            while eng.metrics()["workers_respawned"] < 2:
                assert time.time() - t0 < 10.0, "supervisor never respawned"
                time.sleep(0.005)
            out, = eng.submit({"x": np.full((1, 2), 4.0, "f4")}).result(10)
            np.testing.assert_array_equal(out, np.full((1, 2), 8.0))
        finally:
            eng.shutdown()
        w = eng._workers[0]
        w.thread.join(10.0)
        assert eng._maybe_respawn(w) is False  # refused after shutdown


def test_compiled_shape_counts_over_ladder_and_seq_ladder():
    """Warmup touches every (batch rung x seq rung) the example fits;
    traffic of mixed batch sizes and lengths adds no signature beyond
    them; the two packages count alike, signature for signature, and
    mixed lengths in one batch are edge-padded to the longest's rung."""
    rng = np.random.RandomState(5)
    reqs = [(int(rng.randint(1, 5)), int(rng.randint(2, 17)))
            for _ in range(24)]
    seen = {}
    for name, (engine_mod, _) in sorted(PKGS.items()):
        eng = engine_mod.ServingEngine(FakePredictor(), ladder=(1, 2, 4),
                                       seq_ladder=(4, 8, 16),
                                       max_wait_ms=0)
        try:
            assert eng.warmup({"x": np.ones((1, 3), "f4")}) == 9
            assert eng.compiled_shape_counts() == [9]
            for n, s in reqs:
                x = rng.randn(n, s).astype("f4")
                got, = eng.submit({"x": x}).result(10.0)
                rung = ref_buckets.bucket_for(s, (4, 8, 16))
                assert got.shape == (n, rung)
                np.testing.assert_array_equal(got[:, :s], 2.0 * x)
            assert eng.compiled_shape_counts() == [9]
            seen[name] = (sorted(eng._workers[0].seen_signatures),
                          _counters(eng)["compile_cache_misses"])
        finally:
            eng.shutdown()
    assert seen["port"] == seen["ref"]


# -- a real model: hot-swap and per-device placement --------------------------

def _fc_model_dirs(tmp_path):
    """A two-layer classifier saved by the reference (its initialisation)
    and the port's copy of it, loaded from the reference's params.npz."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[8])
        h = pkg.layers.fc(x, size=16, act="relu")
        return pkg.layers.softmax(pkg.layers.fc(h, size=4))

    prob = build(fluid)
    fluid.default_startup_program().random_seed = 11
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    ref_dir = str(tmp_path / "ref")
    fluid.io.save_inference_model(ref_dir, ["x"], [prob], exe)

    tprob = build(tfluid)
    scope = tfluid.Scope()
    tfluid.bridge.load_reference_params(
        ref_dir, scope, "cpu", program=tfluid.default_main_program())
    port_dir = str(tmp_path / "port")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(port_dir, ["x"], [tprob],
                                       tfluid.Executor(tfluid.CPUPlace()))
    names = [p.name for p in tfluid.default_main_program().all_parameters()]
    return ref_dir, port_dir, names


def test_reload_from_an_update_list_answers_as_the_reference(tmp_path):
    ref_dir, port_dir, names = _fc_model_dirs(tmp_path)
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(3, 8).astype("f4")}
    with np.load(ref_dir + "/params.npz") as z:
        old = {n: z[n] for n in z.files}
    updates = [(n, (old[n] + rng.randn(*old[n].shape) * 0.5).astype("f4"))
               for n in names] + [("not_a_param", np.zeros(2, "f4"))]
    ref_eng = fluid.serving.ServingEngine(ref_dir, num_replicas=2,
                                          ladder=(1, 2, 4), max_wait_ms=0)
    port_eng = tfluid.serving.ServingEngine(port_dir, num_replicas=2,
                                            ladder=(1, 2, 4), max_wait_ms=0,
                                            device="cpu")
    try:
        before = [e.predict(feed, timeout_s=30)[0]
                  for e in (ref_eng, port_eng)]
        np.testing.assert_allclose(before[1], before[0], atol=1e-5, rtol=0)
        scopes = {id(w.predictor._scope) for w in port_eng._workers}
        assert port_eng.reload(updates, version=7) == 7
        assert ref_eng.reload(updates, version=7) == 7
        assert port_eng.serve_version == 7 and port_eng.swap_count == 1
        # one copied scope, shared by every replica, none of the old ones
        new_scopes = {id(w.predictor._scope) for w in port_eng._workers}
        assert len(new_scopes) == 1 and not new_scopes & scopes
        after = [e.predict(feed, timeout_s=30)[0]
                 for e in (ref_eng, port_eng)]
        np.testing.assert_allclose(after[1], after[0], atol=1e-5, rtol=0)
        assert np.abs(after[1] - before[1]).max() > 1e-3
        # two-phase: prepare stages without swapping, abort drops it,
        # commit applies and is idempotent for the version it landed
        back = [(n, old[n]) for n in names]
        assert port_eng.prepare(back, version=8) == 8
        np.testing.assert_array_equal(
            port_eng.predict(feed, timeout_s=30)[0], after[1])
        assert port_eng.abort_swap() and not port_eng.abort_swap()
        with pytest.raises(RuntimeError, match="no staged"):
            port_eng.commit(8)
        port_eng.prepare(back, version=8)
        assert port_eng.commit(8) == 8 and port_eng.commit(8) == 8
        np.testing.assert_allclose(port_eng.predict(feed, timeout_s=30)[0],
                                   before[1], atol=1e-6, rtol=0)
        with pytest.raises(ValueError, match="no staged parameter"):
            port_eng.reload([("nothing", np.zeros(1))])
        with t_faults.fault_scope(t_faults.FaultPlan.from_spec(
                "swap.prepare:corrupt@1;swap.commit:error@1")):
            with pytest.raises(IOError):
                port_eng.prepare(back, version=9)
            port_eng.prepare(back, version=9)
            with pytest.raises(t_faults.InjectedFault):
                port_eng.commit(9)
        kinds = [e["kind"] for e in tfluid.obs.flight.RECORDER.events()]
        for k in ("model.swap", "swap.prepare", "swap.abort", "swap.commit"):
            assert k in kinds
    finally:
        ref_eng.shutdown()
        port_eng.shutdown()


def test_per_device_placement_over_two_cpu_devices(tmp_path):
    _, port_dir, names = _fc_model_dirs(tmp_path)
    feed = {"x": np.random.RandomState(4).randn(4, 8).astype("f4")}
    single = tfluid.serving.ServingEngine(port_dir, ladder=(1, 2, 4),
                                          max_wait_ms=0, device="cpu")
    placed = tfluid.serving.ServingEngine(
        port_dir, num_replicas=3, ladder=(1, 2, 4), max_wait_ms=0,
        device="cpu", placement="per_device", devices=["cpu", "cpu"])
    try:
        want, = single.predict(feed, timeout_s=30)
        preds = [w.predictor for w in placed._workers]
        # two parents, one weight copy each (their own scopes), the third
        # replica a clone of the first parent sharing its scope
        assert preds[0]._scope is not preds[1]._scope
        assert preds[2]._scope is preds[0]._scope
        assert preds[0]._scope is not single._workers[0].predictor._scope
        for p in preds:
            assert str(p.device) == "cpu"
        for n in names:  # on one device the copy keeps the tensors
            t0, t1 = preds[0]._scope.get(n), preds[1]._scope.get(n)
            assert t1.device.type == "cpu" and torch.equal(t0, t1)
        outs = [placed.submit(feed).result(30)[0] for _ in range(6)]
        for o in outs:
            np.testing.assert_array_equal(o, want)
    finally:
        single.shutdown()
        placed.shutdown()
    with pytest.raises(NotImplementedError, match="A7"):
        tfluid.serving.ServingEngine(port_dir, device="cpu", mp=2)


def test_per_device_evicted_replica_is_rebuilt_from_its_own_parent(
        tmp_path):
    """Under ``per_device`` each replica is rebuilt from the parent it was
    cloned from, on that parent's device. Each round one request hangs in
    ``predictor.run`` on one replica while the next one faults twice on
    the other (a breaker of one evicts it each time), until replica 1 has
    been rebuilt; afterwards every replica shares its own parent's weight
    copy (not the first parent's) and serves the single-device answer."""
    _, port_dir, _ = _fc_model_dirs(tmp_path)
    feed = {"x": np.random.RandomState(5).randn(2, 8).astype("f4")}
    single = tfluid.serving.ServingEngine(port_dir, ladder=(1, 2, 4),
                                          max_wait_ms=0, device="cpu")
    placed = tfluid.serving.ServingEngine(
        port_dir, num_replicas=2, ladder=(1, 2, 4), max_wait_ms=0,
        device="cpu", placement="per_device", devices=["cpu", "cpu"],
        max_replica_failures=1)
    rounds = 6
    plan = "predictor.run:hang(0.5)@%s;predictor.run:error@%s" % (
        ",".join(str(3 * r + 1) for r in range(rounds)),
        ",".join("%d,%d" % (3 * r + 2, 3 * r + 3) for r in range(rounds)))
    try:
        want, = single.predict(feed, timeout_s=30)
        first = [w.predictor for w in placed._workers]
        with t_faults.fault_scope(t_faults.FaultPlan.from_spec(plan)):
            for _ in range(rounds):
                held = placed.submit(feed)
                _drain_queue(placed)
                time.sleep(0.05)  # the holder is inside its hang
                with pytest.raises(t_faults.InjectedFault):
                    placed.predict(feed, timeout_s=30)
                np.testing.assert_array_equal(held.result(30)[0], want)
                if placed._workers[1].predictor is not first[1]:
                    break
        evicted = placed.metrics()["replicas_evicted"]
        parents = placed._parents
        assert placed._workers[1].predictor is not first[1] and evicted >= 2
        assert parents[0]._scope is not parents[1]._scope
        for w in placed._workers:
            assert w.parent is parents[w.index]
            assert w.predictor._scope is parents[w.index]._scope
            assert str(w.predictor.device) == "cpu"
        for _ in range(4):
            np.testing.assert_array_equal(
                placed.predict(feed, timeout_s=30)[0], want)
    finally:
        single.shutdown()
        placed.shutdown()


def test_combined_file_config_and_default_timeout(tmp_path):
    _, port_dir, _ = _fc_model_dirs(tmp_path)
    config = tfluid.inference.AnalysisConfig(
        prog_file=port_dir + "/__model__",
        params_file=port_dir + "/params.npz")
    config.disable_gpu()
    pred = tfluid.inference.Predictor(config)
    feed = {"x": np.ones((2, 8), "f4")}
    want, = tfluid.inference.Predictor(
        _cpu_config(port_dir)).run(feed)
    np.testing.assert_array_equal(pred.run(feed)[0], want)
    with pytest.raises(ValueError, match="not inside"):
        tfluid.inference.Predictor(tfluid.inference.AnalysisConfig(
            str(tmp_path), prog_file=port_dir + "/__model__"))
    eng = tfluid.serving.ServingEngine(pred, ladder=(1, 2),
                                       default_timeout_s=30.0,
                                       latency_window=16)
    try:
        req = eng.submit(feed)
        assert req.result(30)[0].shape == (2, 4)
        assert eng.metrics_.latency._samples.maxlen == 16
    finally:
        eng.shutdown()


def _cpu_config(model_dir):
    config = tfluid.inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    return config


def test_engine_metrics_alike_under_one_fault_sequence():
    """The same plan through both engines leaves the same counters and
    the same Prometheus text (latency samples aside)."""
    texts = {}
    for name, (engine_mod, faults) in sorted(PKGS.items()):
        plan = faults.FaultPlan.from_spec("predictor.run:error@2-4,7")
        with faults.fault_scope(plan):
            eng = engine_mod.ServingEngine(FakePredictor(), ladder=(1, 2),
                                           max_wait_ms=0,
                                           max_replica_failures=2)
            try:
                for i in range(8):
                    try:
                        eng.submit({"x": np.full((1 + i % 2, 2), 1.0,
                                                 "f4")}).result(10)
                    except faults.InjectedFault:
                        pass
                texts[name] = _counter_lines(eng.metrics_.prometheus_text())
            finally:
                eng.shutdown()
    assert texts["port"] == texts["ref"]
    assert any("replicas_evicted 1" in line or "replicas_evicted 2" in line
               for line in texts["port"])
