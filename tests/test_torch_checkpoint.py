"""The port's checkpoints (``paddle_tpu_torch/checkpoint.py``) against
``paddle_tpu``'s, on the CPU.

* A checkpoint of each package loads in the other, every array bitwise
  (the same npz and manifest layout): the reference's sharded pieces (a
  4-device mesh) reassemble in the port; the port writes ``"rng": null``
  and its generator states under ``torch_rng``, so the reference reads the
  arrays and keeps its key, and the port keeps its generator, with one
  warning, when a reference checkpoint holds a threefry key.
* An async save followed by one more captured step (the step writes into
  the scope's tensors) still writes step k's values: the snapshot owns its
  bytes.
* A load replaces scope tensors, so a captured key interprets once and
  captures again; a restored generator is ``set_state`` into the scope's
  generator, so a captured dropout step stays bound and draws what the
  uninterrupted run drew (bitwise), and a resumed training run's losses
  equal the uninterrupted run's (bitwise).
* Corrupt newest version -> fallback; pins survive ``_trim``;
  ``load_staged``/``load_extra``; multi-process saves raise (ROADMAP A7).

The CPU capture path is the captured-step tests' ``EagerGraph`` stand-in
(``tests/test_torch_captured_step.py``)."""

import contextlib
import json
import os
import time
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import checkpoint as t_ckpt
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.reliability import faults

CPU = tfluid.CPUPlace


@pytest.fixture(autouse=True)
def fresh_port_programs():
    prev = (t_framework.switch_main_program(t_framework.Program()),
            t_framework.switch_startup_program(t_framework.Program()))
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev[0])
    t_framework.switch_startup_program(prev[1])


class EagerGraph:
    """CPU stand-in for a captured graph (as in the captured-step tests):
    a replay runs the step body eagerly and writes the fetches into the
    same tensors every time."""

    def __init__(self, step):
        self.step = step
        self.outs = None

    def replay(self):
        outs = self.step.body()
        if self.outs is None:
            self.outs = [o.clone() for o in outs]
        else:
            for held, new in zip(self.outs, outs):
                held.copy_(new)
        self.step.fetches = self.outs


@pytest.fixture
def cpu_capture(monkeypatch):
    rule = t_executor.capture_rule

    def as_card(ops, writes=(), **kw):
        kw["cuda"] = True
        return rule(ops, writes, **kw)

    def capture(step, stream):
        step.graph = EagerGraph(step)
        step.entry.pool_bytes = 0

    monkeypatch.setattr(t_executor, "capture_rule", as_card)
    monkeypatch.setattr(t_executor.CapturedStep, "capture", capture)
    monkeypatch.setattr(t_executor.Executor, "_side_stream",
                        lambda self: None)
    monkeypatch.setattr(t_executor.Executor, "_warm_up",
                        lambda self: contextlib.nullcontext())


def _build(pkg, sharded=False, dropout=0.0):
    pkg.unique_name.switch()
    x = pkg.layers.data("x", shape=[16])
    y = pkg.layers.data("y", shape=[1])
    attr = (pkg.ParamAttr(name="w1", sharding=(None, "mp")) if sharded
            else pkg.ParamAttr(name="w1"))
    h = pkg.layers.fc(x, size=32, act="relu", param_attr=attr)
    if dropout:
        h = pkg.layers.dropout(h, dropout_prob=dropout)
    pred = pkg.layers.fc(h, size=1, name="head")
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def _feed(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 16).astype("f4"),
            "y": rng.randn(n, 1).astype("f4")}


def _port_trainer(seed=7, dropout=0.0):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    scope = tfluid.Scope()
    with tfluid.program_guard(main, startup):
        loss = _build(tfluid, dropout=dropout)
    exe = tfluid.Executor(CPU())
    exe.run(startup, scope=scope)
    return main, startup, scope, exe, loss


def _persist(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def _port_arrays(scope, names):
    return {n: scope.numpy(n) for n in names}


def test_port_checkpoint_loads_in_the_reference_bitwise(tmp_path):
    main, _startup, scope, exe, loss = _port_trainer()
    for _ in range(3):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    w = tfluid.io.save_checkpoint(exe, str(tmp_path), main_program=main,
                                  scope=scope, async_write=False,
                                  extra_meta={"step": 3})
    with open(os.path.join(w.path, "checkpoint_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["rng"] is None
    assert list(manifest["torch_rng"]) == ["@RNG@"]
    assert manifest["torch_rng"]["@RNG@"]["device"] == "cpu"
    want = _port_arrays(scope, _persist(main))
    assert set(manifest["vars"]) == set(want)

    rmain, rstartup = fluid.Program(), fluid.Program()
    rscope = fluid.Scope()
    with fluid.program_guard(rmain, rstartup), fluid.scope_guard(rscope):
        _build(fluid)
        rexe = fluid.Executor(fluid.CPUPlace())
        rexe.run(rstartup)
        assert _persist(rmain) == _persist(main)
        extra = fluid.io.load_checkpoint(rexe, str(tmp_path),
                                         main_program=rmain)
    assert extra == {"step": 3}
    for n, a in want.items():
        got = np.asarray(rscope.get(n))
        assert got.dtype == a.dtype and got.shape == a.shape, n
        np.testing.assert_array_equal(got, a, err_msg=n)


@pytest.mark.parametrize("sharded", [False, True])
def test_reference_checkpoint_loads_in_the_port_bitwise(tmp_path, sharded,
                                                        monkeypatch):
    rmain, rstartup = fluid.Program(), fluid.Program()
    rmain.random_seed = rstartup.random_seed = 7
    rscope = fluid.Scope()
    with fluid.program_guard(rmain, rstartup), fluid.scope_guard(rscope):
        loss = _build(fluid, sharded=sharded, dropout=0.25)
        rexe = fluid.Executor(fluid.CPUPlace())
        rexe.run(rstartup)
        prog = rmain
        if sharded:
            devs = np.array(jax.devices()[:4])
            prog = fluid.CompiledProgram(rmain).with_data_parallel(
                loss_name=loss.name, mesh=Mesh(devs, ("mp",)), dp_axis=None)
        rexe.run(prog, feed=_feed(), fetch_list=[loss])
        w = fluid.io.save_checkpoint(rexe, str(tmp_path),
                                     main_program=rmain, async_write=False)
        want = {n: np.asarray(rscope.get(n)) for n in _persist(rmain)}
    with open(os.path.join(w.path, "checkpoint_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["rng"] is not None  # the threefry key rides along
    assert (manifest["vars"]["w1"]["kind"] == "sharded") == sharded

    main, _startup, scope, exe, _loss = _port_trainer(dropout=0.25)
    gen = scope.get("@RNG@")
    before = gen.get_state().clone()
    monkeypatch.setattr(t_ckpt, "_warned_reference_rng", [])
    with pytest.warns(RuntimeWarning, match="threefry"):
        extra = tfluid.io.load_checkpoint(exe, str(tmp_path),
                                          main_program=main, scope=scope)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one warning, not one per load
        tfluid.io.load_checkpoint(exe, str(tmp_path), main_program=main,
                                  scope=scope)
    assert extra == {}
    assert scope.get("@RNG@") is gen
    assert torch.equal(gen.get_state(), before)
    for n, a in want.items():
        t = scope.get(n)
        assert t.device.type == "cpu", n
        got = scope.numpy(n)
        assert got.dtype == a.dtype and got.shape == a.shape, n
        np.testing.assert_array_equal(got, a, err_msg=n)


def test_async_save_then_a_captured_step_writes_step_k(tmp_path,
                                                       cpu_capture):
    main, _startup, scope, exe, loss = _port_trainer()
    for _ in range(3):  # interpret, capture, replay: state written in place
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert exe.step_report(main)["captures"] == 1
    names = _persist(main)
    held = {n: scope.get(n) for n in names}
    want = _port_arrays(scope, names)
    plan = faults.FaultPlan.from_spec("checkpoint.write:hang(0.4)@1")
    with faults.fault_scope(plan):
        w = t_ckpt.save_checkpoint(exe, str(tmp_path), main_program=main,
                                   scope=scope, async_write=True)
        exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
        assert not w.done()  # the writer still sleeps: step k+1 ran first
        w.wait()
    assert all(scope.get(n) is held[n] for n in names)  # written in place
    moved = [n for n in names if not np.array_equal(scope.numpy(n), want[n])]
    assert "w1" in moved
    assert w.snapshot_s > 0 and w.write_s > 0
    with np.load(os.path.join(w.path, "replicated.npz")) as data:
        for n in names:
            np.testing.assert_array_equal(data[n], want[n], err_msg=n)


def test_a_load_makes_the_captured_key_bind_again(tmp_path, cpu_capture):
    main, _startup, scope, exe, loss = _port_trainer()
    for _ in range(3):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    t_ckpt.save_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope, async_write=False)
    r = exe.step_report(main)
    assert (r["interpreted"], r["captures"], r["replays"]) == (1, 1, 1)
    t_ckpt.load_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    r = exe.step_report(main)
    assert (r["interpreted"], r["captures"]) == (2, 1)  # interpreted again
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    r = exe.step_report(main)
    assert (r["interpreted"], r["captures"]) == (2, 2)  # captured again


def _dropout_program():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup):
        tfluid.unique_name.switch()
        x = tfluid.layers.data("x", shape=[64])
        y = tfluid.layers.dropout(x, dropout_prob=0.5)
    return main, startup, y


def test_restored_generator_under_a_captured_dropout_step(tmp_path,
                                                          cpu_capture):
    main, startup, y = _dropout_program()
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU())
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((4, 64), "f4")}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    assert exe.step_report(main)["captures"] == 1
    t_ckpt.save_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope, async_write=False)
    gen = scope.get("@RNG@")
    want = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
            for _ in range(3)]
    t_ckpt.load_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope)
    assert scope.get("@RNG@") is gen
    got = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
           for _ in range(3)]
    r = exe.step_report(main)
    assert (r["captures"], r["replays"]) == (1, 7)  # still bound: replays
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(want[0], want[1])


def test_resume_draws_what_the_uninterrupted_run_drew(tmp_path):
    feed = _feed(2)
    main, _s, scope, exe, loss = _port_trainer(dropout=0.3)
    full = [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(6)]

    main, startup, scope, exe, loss = _port_trainer(dropout=0.3)
    head = [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(3)]
    t_ckpt.save_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope).wait()
    exe.run(startup, scope=scope)  # clobber the weights ...
    scope.get("@RNG@").manual_seed(123)  # ... and the stream
    extra = t_ckpt.resume_or_init(exe, startup, str(tmp_path),
                                  main_program=main, scope=scope)
    assert extra == {}
    tail = [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(3)]
    assert head + tail == full


def test_versioning_trim_pins_and_staged_fallback(tmp_path):
    main, _s, scope, exe, loss = _port_trainer()
    d = str(tmp_path)
    ws = []
    for i in range(4):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
        ws.append(t_ckpt.save_checkpoint(
            exe, d, main_program=main, scope=scope, max_versions=2,
            extra_meta={"step": i + 1, "cursor": {"rows": 10 * i}}))
        if i == 0:
            ws[0].wait()
            t_ckpt.pin_version(d, 0, owner="serving")
        time.sleep(0.02)  # distinct mtimes
    ws[-1].wait()
    assert sorted(os.listdir(d)) == ["checkpoint_0", "checkpoint_2",
                                     "checkpoint_3", "latest"]
    assert t_ckpt.pinned_versions(d) == {0}
    assert t_ckpt.candidate_versions(d)[0] == 3
    assert t_ckpt.load_extra(d) == (3, {"step": 4, "cursor": {"rows": 30}})
    # the newest lands corrupt: staged loads and load_checkpoint fall back
    t_ckpt._flip_byte(os.path.join(d, "checkpoint_3", "replicated.npz"))
    with pytest.warns(UserWarning, match="falling back"):
        v, updates, extra = t_ckpt.load_staged(d, main)
    assert v == 2 and extra["step"] == 3
    assert {n for n, _ in updates} >= set(_persist(main))
    with pytest.raises((IOError, zipfile.BadZipFile)):
        t_ckpt.load_staged(d, main, version=3)  # explicit: no fallback
    with pytest.warns(UserWarning, match="falling back"):
        assert t_ckpt.load_checkpoint(exe, d, main_program=main,
                                      scope=scope)["step"] == 3
    with np.load(os.path.join(d, "checkpoint_2", "replicated.npz")) as z:
        np.testing.assert_array_equal(scope.numpy("w1"), z["w1"])
    t_ckpt.unpin_version(d, 0, owner="serving")
    assert t_ckpt.pinned_versions(d) == set()


def test_torn_version_is_invisible_and_cold_start(tmp_path):
    main, startup, scope, exe, _loss = _port_trainer()
    d = str(tmp_path)
    assert t_ckpt.resume_or_init(exe, startup, d, main_program=main,
                                 scope=scope) is None
    with pytest.raises(t_ckpt.NoCheckpointError):
        t_ckpt.load_staged(d, main)
    w = t_ckpt.save_checkpoint(exe, d, main_program=main, scope=scope)
    w.wait()
    os.makedirs(os.path.join(d, "checkpoint_1"))  # killed before its files
    open(os.path.join(d, "checkpoint_1", "replicated.npz"), "wb").close()
    assert t_ckpt.candidate_versions(d) == [0]
    assert t_ckpt.load_extra(d) == (0, {})


def test_write_fault_surfaces_at_wait_and_autocheckpoint(tmp_path):
    main, _s, scope, exe, loss = _port_trainer()
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "checkpoint.write:error@1")):
        w = t_ckpt.save_checkpoint(exe, str(tmp_path / "a"),
                                   main_program=main, scope=scope)
        with pytest.raises(faults.InjectedFault):
            w.wait()
    ac = t_ckpt.AutoCheckpoint(exe, str(tmp_path / "b"), main_program=main,
                               scope=scope, every_steps=2)
    started = []
    for i in range(5):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
        started.append(ac.step({"step": i + 1}) is not None)
    ac.close()
    assert started == [False, True, False, True, False]
    assert t_ckpt.load_extra(str(tmp_path / "b")) == (1, {"step": 4})


def test_multi_process_save_waits_for_a7(tmp_path, monkeypatch):
    main, _s, scope, exe, _loss = _port_trainer()
    monkeypatch.setattr(t_ckpt, "_process_index", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="A7"):
        t_ckpt.save_checkpoint(exe, str(tmp_path), main_program=main,
                               scope=scope)
    assert t_ckpt._process_index.__module__ != "torch.distributed"


def test_loaded_arrays_take_the_replaced_tensors_dtype(tmp_path):
    main, _s, scope, exe, _loss = _port_trainer()
    t_ckpt.save_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope, async_write=False)
    scope.set("w1", scope.get("w1").to(torch.bfloat16))
    t_ckpt.load_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope)
    assert scope.get("w1").dtype == torch.bfloat16
    # a var missing from the scope comes back on the executor's place
    scope.drop("head.b_0_0")
    t_ckpt.load_checkpoint(exe, str(tmp_path), main_program=main,
                           scope=scope)
    assert scope.get("head.b_0_0").device == exe.device


def test_scope_numpy_owns_its_bytes_on_the_cpu():
    # a captured step writes the next state into the scope's tensors, so
    # a host read must not share them
    scope = tfluid.Scope()
    scope.set("w", torch.zeros(4))
    got = scope.numpy("w")
    scope.get("w").add_(1.0)
    np.testing.assert_array_equal(got, np.zeros(4, "f4"))
    scope.set("h", torch.ones(3, dtype=torch.bfloat16))
    np.testing.assert_array_equal(scope.numpy("h"), np.ones(3, "f4"))
