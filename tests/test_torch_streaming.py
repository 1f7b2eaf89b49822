"""The port's streaming plane (``paddle_tpu_torch/streaming``,
``async_executor.py``, the serving tiers' checkpoint verbs) against
``paddle_tpu``'s, on the CPU.

* Tail-follow: both packages' ``TailReader`` parse the same growing file
  to the same records and offsets (partial trailing chunk awaited, torn
  tail on a sealed file counted, corrupt chunk skipped); the cursor is the
  delivered chunk boundary.
* ``AsyncExecutor.run`` (the C++ prefetch queue, one reader thread so the
  order is the file's) and ``run_from_stream`` give the reference's losses
  on the same files from copied weights: rtol 1e-5, atol 1e-6 (the same
  f32 arithmetic summed in other orders).
* ``StreamingTrainer`` at its defaults (tiny DeepFM, Adam(0.05)), weights
  copied from the reference trainer, gives the reference's losses (rtol
  1e-5, atol 1e-6) and published arrays (atol 5e-6, rtol 1e-5: an Adam
  step moves an element by about lr * sign(g)) over the same stream, and
  the same ``replayed_rows`` on resume.
* The cursor fault, the publisher's zero-drop hot swap and corrupt-version
  fallback, ``FleetPublisher`` over two engines, the coordinator's lease
  takeover (fake clock), the router's four verbs through two ``--device
  cpu`` workers, and the trainer CLI killed mid-publish (its torn version
  invisible, the restart resuming past it)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import checkpoint as ref_checkpoint
from paddle_tpu import streaming as ref_streaming
from paddle_tpu.streaming.stream import TailReader as RefTailReader
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import bridge, checkpoint, serving, streaming
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.obs import flight
from paddle_tpu_torch.reliability import faults
from paddle_tpu_torch.reliability.policy import RetryPolicy
from paddle_tpu_torch.streaming.stream import TailReader, encode_chunk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tfluid.CPUPlace
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
ARRAY_TOL = dict(rtol=1e-5, atol=5e-6)


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


def _drained(pkg, data_dir, **kw):
    s = pkg.RecordStream(data_dir, poll_interval_s=0.0,
                         sleep=lambda _t: None, **kw)
    s.close()
    return s


def _rows(n, start=0):
    return [("row-%06d" % (start + i)).encode() for i in range(n)]


def _write_chunks(path, rows, per=8):
    for k in range(0, len(rows), per):
        streaming.write_records(path, rows[k:k + per])


# -- tail-follow ---------------------------------------------------------------

def test_tail_readers_agree_on_a_growing_file(tmp_path):
    path = str(tmp_path / "part-00000.recordio")
    c1, c2 = encode_chunk(_rows(5)), encode_chunk(_rows(7, 100))
    bad = bytearray(encode_chunk(_rows(3, 200)))
    bad[len(bad) // 2] ^= 0xFF
    tr, rr = TailReader(path), RefTailReader(path)
    steps = [(c1 + c2[:10], False), (c2[10:], False),
             (bytes(bad) + c1, False), (c2[:20], True)]
    with open(path, "wb"):
        pass
    for data, final in steps:
        with open(path, "ab") as f:
            f.write(data)
        got, want = tr.poll(final=final), rr.poll(final=final)
        assert got == want
        assert (tr.offset, tr.records_read, tr.bad_chunks, tr.last_chunks) \
            == (rr.offset, rr.records_read, rr.bad_chunks, rr.last_chunks)
    assert tr.bad_chunks == 2 and tr.records_read == 5 + 7 + 5


def test_cursor_is_the_delivered_boundary_and_seeks(tmp_path):
    rows = _rows(48)
    _write_chunks(str(tmp_path / "part-00000.recordio"), rows)
    s = _drained(streaming, str(tmp_path))
    it = s.records()
    got = [next(it) for _ in range(20)]
    cur = s.cursor()
    assert cur["rows"] == 16
    s2 = _drained(streaming, str(tmp_path))
    s2.seek(json.loads(json.dumps(cur)))
    rest = list(s2.records())
    assert rest[0] == rows[16] and s2.rows_total == 48
    assert set(got) | set(rest) == set(rows)


def test_stream_tail_fault_and_bounded_bad_records(tmp_path):
    desc = tfluid.DataFeedDesc([("x", (2,), "float32")], batch_size=4)
    recs = [desc.serialize({"x": [i, i]}) for i in range(16)]
    streaming.write_records(str(tmp_path / "part-00000.recordio"), recs)
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "recordio.read:corrupt@3")):
        ing = streaming.StreamIngester(_drained(streaming, str(tmp_path)),
                                       desc, max_bad_records=1)
        with pytest.warns(RuntimeWarning, match="skipped 1"):
            batches = list(ing.batches())
    assert len(batches) == 3 and ing.bad_records == 1
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "stream.tail:error@1")):
        with pytest.raises(faults.InjectedFault):
            list(_drained(streaming, str(tmp_path)).records())


# -- AsyncExecutor against the reference ---------------------------------------

def _clf(pkg):
    pkg.unique_name.switch()
    x = pkg.layers.data("x", shape=[8])
    y = pkg.layers.data("y", shape=[1], dtype="int64")
    h = pkg.layers.fc(x, size=32, act="relu")
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
        pkg.layers.fc(h, size=3), y))
    pkg.optimizer.Adam(learning_rate=0.02).minimize(loss)
    return loss


def _clf_files(data, n=320):
    desc = tfluid.DataFeedDesc([("x", (8,), "float32"),
                                ("y", (1,), "int64")], batch_size=16)
    rng = np.random.RandomState(0)
    w = rng.normal(0, 1, (8, 3)).astype("f4")
    rows = []
    for _ in range(n):
        x = rng.normal(0, 1, 8).astype("f4")
        rows.append(desc.serialize({"x": x, "y": [np.argmax(x @ w)]}))
    os.makedirs(data, exist_ok=True)
    path = os.path.join(data, "part-00000.recordio")
    with tfluid.native.RecordIOWriter(path, max_chunk_records=32) as wr:
        for r in rows:
            wr.write(r)
    return desc, path


def _both_clf():
    """The classifier in both packages, the port's weights the
    reference's."""
    rmain, rstart = fluid.Program(), fluid.Program()
    rmain.random_seed = rstart.random_seed = 5
    rscope = fluid.Scope()
    with fluid.program_guard(rmain, rstart), fluid.scope_guard(rscope):
        rloss = _clf(fluid)
        fluid.Executor(fluid.CPUPlace()).run(rstart)
    main, start = tfluid.Program(), tfluid.Program()
    scope = tfluid.Scope()
    with tfluid.program_guard(main, start):
        loss = _clf(tfluid)
    tfluid.Executor(CPU()).run(start, scope=scope)
    bridge.load_program_params(
        scope, {p.name: np.asarray(rscope.get(p.name))
                for p in rmain.all_parameters()}, main, "cpu")
    return (rmain, rscope, rloss), (main, scope, loss)


def test_async_executor_run_matches_the_reference(tmp_path):
    desc, path = _clf_files(str(tmp_path))
    (rmain, rscope, rloss), (main, scope, loss) = _both_clf()
    ref = fluid.AsyncExecutor().run(rmain, desc, [path], thread_num=1,
                                    fetch=[rloss], scope=rscope)
    aexe = tfluid.AsyncExecutor(CPU())
    got = aexe.run(main, desc, [path], thread_num=1, fetch=[loss],
                   scope=scope)
    assert aexe.last_run == {"queue": "native", "records": 320,
                             "steps": 20, "bad_records": 0}
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), **LOSS_TOL)
    for p in main.all_parameters():
        np.testing.assert_allclose(scope.numpy(p.name),
                                   np.asarray(rscope.get(p.name)),
                                   **ARRAY_TOL)


def test_run_from_stream_matches_the_reference(tmp_path):
    _desc, _path = _clf_files(str(tmp_path))
    desc = tfluid.DataFeedDesc(_desc.slots, batch_size=16)
    (rmain, rscope, rloss), (main, scope, loss) = _both_clf()
    want, got = [], []
    steps = fluid.AsyncExecutor().run_from_stream(
        rmain, fluid.DataFeedDesc(_desc.slots, batch_size=16),
        _drained(ref_streaming, str(tmp_path)), fetch=[rloss],
        scope=rscope,
        on_step=lambda _s, v: want.append(float(np.asarray(v[0]))))
    assert tfluid.AsyncExecutor(CPU()).run_from_stream(
        main, desc, _drained(streaming, str(tmp_path)), fetch=[loss],
        scope=scope,
        on_step=lambda _s, v: got.append(float(v[0].detach()))) == steps == 20
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got[-1] < got[0]


# -- the streaming trainer against the reference -------------------------------

def _copy_trainer_state(ref, port):
    """Every persistable of the reference trainer into the port's."""
    names = [v.name for v in ref.main.list_vars() if v.persistable]
    bridge.load_numpy_params(port.scope,
                             {n: np.asarray(ref.scope.get(n))
                              for n in names if n in ref.scope},
                             "cpu", port.main)


def _npz(path):
    with np.load(os.path.join(path, "replicated.npz")) as z:
        return {n: z[n] for n in z.files if not n.startswith("@")}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A reference trainer and the port's, from one state, over one
    stream: 15 steps publishing every 5, at the trainer's defaults."""
    tmp = tmp_path_factory.mktemp("stream")
    data = str(tmp / "data")
    ref_streaming.synthesize_stream_files(data, n_files=2,
                                          rows_per_file=200, seed=3)
    prev = (t_framework.switch_main_program(t_framework.Program()),
            t_framework.switch_startup_program(t_framework.Program()))
    ref = ref_streaming.StreamingTrainer(str(tmp / "ref"),
                                         publish_every_steps=5)
    port = streaming.StreamingTrainer(str(tmp / "port"),
                                      publish_every_steps=5, place=CPU())
    _copy_trainer_state(ref, port)
    losses = {"ref": [], "port": []}
    ref.run(_drained(ref_streaming, data), max_steps=15,
            on_step=lambda t: losses["ref"].append(t.last_train_loss))
    port.run(_drained(streaming, data), max_steps=15,
             on_step=lambda t: losses["port"].append(t.last_train_loss))
    ref.close()
    port.close()
    t_framework.switch_main_program(prev[0])
    t_framework.switch_startup_program(prev[1])
    return ref, port, losses, data


def test_trainer_losses_and_published_arrays_match_the_reference(trained):
    ref, port, losses, _data = trained
    assert len(losses["port"]) == 15
    np.testing.assert_allclose(losses["port"], losses["ref"], **LOSS_TOL)
    np.testing.assert_allclose(port.last_eval_loss, ref.last_eval_loss,
                               **LOSS_TOL)
    assert port.publishes == ref.publishes == 3
    versions = checkpoint.candidate_versions(port.ckpt_dir)
    assert versions == ref_checkpoint.candidate_versions(ref.ckpt_dir)
    for v in versions:
        got = _npz(os.path.join(port.ckpt_dir, "checkpoint_%d" % v))
        want = _npz(os.path.join(ref.ckpt_dir, "checkpoint_%d" % v))
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], err_msg=n,
                                       **ARRAY_TOL)
        _, extra = checkpoint.load_extra(port.ckpt_dir, v)
        _, rextra = checkpoint.load_extra(ref.ckpt_dir, v)
        assert extra["step"] == rextra["step"]
        assert extra["cursor"] == rextra["cursor"]


def test_resume_counts_the_reference_replay(trained):
    ref, port, _losses, data = trained
    kw = dict(publish_every_steps=5)
    t2 = streaming.StreamingTrainer(port.ckpt_dir, place=CPU(), **kw)
    r2 = ref_streaming.StreamingTrainer(ref.ckpt_dir, **kw)
    s2, rs2 = _drained(streaming, data), _drained(ref_streaming, data)
    assert t2.resume(s2) == r2.resume(rs2) == t2.resumed_version
    assert t2.step == r2.step == 15
    assert t2.replayed_rows == r2.replayed_rows > 0
    assert s2.cursor() == rs2.cursor()
    for name, _ in checkpoint.load_staged(port.ckpt_dir, port.main)[1]:
        if not name.startswith("@"):
            np.testing.assert_array_equal(t2.scope.numpy(name),
                                          port.scope.numpy(name))


def test_cursor_fault_never_lands_a_cursorless_version(trained):
    port = trained[1]
    before_v = checkpoint.candidate_versions(port.ckpt_dir)[0]
    before_f = port.publish_failures
    port._stream = _drained(streaming, trained[3])
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "cursor.write:error@1")):
        assert port.publish() is None
    assert port.publish_failures == before_f + 1
    assert checkpoint.candidate_versions(port.ckpt_dir)[0] == before_v
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "cursor.write:corrupt@1")):
        w = port.publish()
    assert w.wait() and w.error is None
    v, extra = checkpoint.load_extra(port.ckpt_dir)
    assert v != before_v and extra["cursor"] == {"rows": 0, "files": {}}


def _predictor_at(trainer, version):
    """A CPU predictor of the trainer's serve dir with ``version``'s
    weights applied in process."""
    cfg = tfluid.inference.AnalysisConfig(trainer.serve_dir)
    cfg.disable_gpu()
    pred = tfluid.inference.Predictor(cfg)
    _, updates, _ = checkpoint.load_staged(trainer.ckpt_dir, trainer.main,
                                           version=version)
    checkpoint.apply_updates(
        pred._scope, [(n, a) for n, a in updates if n in pred._scope])
    return pred


def _ctr_feed(n=1, fields=4, dense=4):
    return {"feat_ids": np.arange(n * fields, dtype="int64").reshape(
        n, fields) % 64, "dense_value": np.full((n, dense), 0.5, "f4")}


def test_publisher_hot_swaps_with_zero_drops_and_falls_back(trained):
    port = trained[1]
    d = port.ckpt_dir
    eng = serving.ServingEngine(port.serve_dir, num_replicas=2,
                                max_batch_size=4, device="cpu")
    feed = _ctr_feed()
    before = eng.predict(feed, timeout_s=30.0)[0]
    errors, stop, served = [], threading.Event(), [0]

    def driver():
        while not stop.is_set():
            try:
                out, = eng.predict(feed, timeout_s=30.0)
                assert np.isfinite(out).all()
                served[0] += 1
            except Exception as e:  # noqa: BLE001 — the assertion below
                errors.append(e)

    threads = [threading.Thread(target=driver) for _ in range(3)]
    for t in threads:
        t.start()
    pub = streaming.ModelPublisher(d, eng, poll_interval_s=0.01)
    try:
        newest = checkpoint.candidate_versions(d)[0]
        assert pub.poll_once() == newest and pub.version_lag() == 0
        assert newest in checkpoint.pinned_versions(d)
        # a fresh publish lands corrupt: serving stays on the intact one
        w = checkpoint.save_checkpoint(None, d, main_program=port.main,
                                       scope=port.scope, max_versions=8)
        w.wait()
        checkpoint._flip_byte(os.path.join(w.path, "replicated.npz"))
        with pytest.warns(RuntimeWarning, match="falling back"):
            assert pub.poll_once() is None
        assert pub.served_version == newest and pub.bad_publishes == 1
        assert pub.version_lag() >= 1
    finally:
        stop.set()
        for t in threads:
            t.join(30.0)
        pub.stop(unpin=True)
    after = eng.predict(feed, timeout_s=30.0)[0]
    eng.shutdown()
    assert not errors and served[0] > 0
    assert eng.serve_version == newest and eng.swap_count == 1
    assert not np.array_equal(before, after)
    pred = _predictor_at(port, newest)
    np.testing.assert_array_equal(pred.run(feed)[0], after)


def test_fleet_publisher_two_phase_over_two_engines(trained):
    port = trained[1]
    d = port.ckpt_dir
    e1 = serving.ServingEngine(port.serve_dir, device="cpu")
    e2 = serving.ServingEngine(port.serve_dir, device="cpu")
    fp = streaming.FleetPublisher(
        d, {"a": e1, "b": e2},
        retry=RetryPolicy(max_attempts=2, base_delay_s=0.0,
                          sleep=lambda _s: None))
    try:
        for _ in range(2):  # two clean rounds
            w = port.publish()
            assert w.wait() and w.error is None
            v = checkpoint.candidate_versions(d)[0]
            assert fp.poll_once() == v and fp.version_skew() == 0
            assert e1.serve_version == e2.serve_version == v
        good = v
        # a corrupt version: both refuse it at prepare, nothing swaps,
        # the fleet stays on the intact one
        w = port.publish()
        w.wait()
        bad = checkpoint.candidate_versions(d)[0]
        checkpoint._flip_byte(os.path.join(w.path, "replicated.npz"))
        with pytest.raises(Exception):
            e1.prepare(d, version=bad)
        assert e1._staged_swap is None
        with pytest.warns(RuntimeWarning, match="failed prepare"):
            assert fp.poll_once() is None
        assert fp.prepare_failures >= 1 and fp.fleet_version == good
        assert e1.serve_version == e2.serve_version == good
        feed = _ctr_feed(2)
        want = _predictor_at(port, good).run(feed)[0]
        np.testing.assert_array_equal(e1.predict(feed, timeout_s=30)[0],
                                      want)
        np.testing.assert_array_equal(e2.predict(feed, timeout_s=30)[0],
                                      want)
        # a commit straggler is quarantined, then readmitted
        w = port.publish()
        w.wait()
        v3 = checkpoint.candidate_versions(d)[0]
        fp.breaker.reset()
        with faults.fault_scope(faults.FaultPlan.from_spec(
                "swap.commit:error@2-3")), pytest.warns(RuntimeWarning):
            assert fp.poll_once() == v3
        assert fp.quarantined == {"b"} and fp.version_skew() == 1
        fp.readmit("b")
        assert fp.poll_once() == v3 and fp.version_skew() == 0
    finally:
        fp.release()
        e1.shutdown()
        e2.shutdown()


# -- the coordinator -----------------------------------------------------------

def test_lease_takeover_split_brain_and_torn_lease(tmp_path):
    clk = [1000.0]

    def mk(host, d=str(tmp_path)):
        return streaming.PartitionCoordinator(
            d, host, num_partitions=4, ttl_s=5.0, target_share=2,
            clock=lambda: clk[0])

    a, b = mk("a"), mk("b")
    a.poll()
    b.poll()
    assert len(a.owned) == len(b.owned) == 2
    assert a.owned | b.owned == {0, 1, 2, 3}
    dead = set(a.owned)
    clk[0] += 6.0
    assert b.poll() == dead and b.reassigned == 2
    a.renew()
    assert a.owned == set() and a.lost == 2
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "lease.renew:corrupt@1")):
        b.renew()
    c = mk("c")
    assert len(c.poll()) >= 1 and c.reassigned >= 1
    assert flight.RECORDER.events(kind="lease.reassign")[-1]["torn"]
    assert streaming.partition_of("x/part-00003.recordio", 7) \
        == ref_streaming.partition_of("part-00003.recordio", 7)


# -- the router's checkpoint verbs ---------------------------------------------

def test_router_checkpoint_verbs_over_cpu_workers(tmp_path):
    from paddle_tpu_torch.serving.worker import build_model

    pred = build_model("builtin:fc", device="cpu")
    scope, prog = pred._scope, pred._program
    for name in scope.var_names():
        if ".w_" in name:
            scope.set(name, scope.get(name) * 3.0)
    d = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(None, d, main_program=prog, scope=scope,
                               async_write=False)
    router = serving.Router("builtin:fc", num_workers=2,
                            worker_args=["--device", "cpu"],
                            spawn_timeout_s=120.0)
    with router:
        client = serving.RouterClient(router.address,
                                      default_timeout_s=60.0)
        feed = {"x": np.ones((1, 8), "f4")}
        before = client.predict(feed)[0]
        got = client.reload(d)
        assert got["version"] == 0
        assert sorted(r["index"] for r in got["workers"]) == [0, 1]
        after = client.predict(feed)[0]
        np.testing.assert_array_equal(after, pred.run(feed)[0])
        assert not np.array_equal(before, after)
        with pytest.raises(serving.WorkerFailedError):
            client.reload(str(tmp_path / "nope"))
        assert client.prepare(d, version=0)["version"] == 0
        assert client.commit(version=0)["version"] == 0
        client.prepare(d, version=0)
        assert client.abort() is True
        np.testing.assert_array_equal(client.predict(feed)[0], after)
        with pytest.raises(serving.WorkerFailedError):
            client.prepare(str(tmp_path / "nope"))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            stats = [w["stats"] for w in client.metrics()["workers"]]
            if all(s.get("serve_version") == 0 for s in stats):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("serve_version never surfaced")
        client.close()


# -- the kill drill ------------------------------------------------------------

def test_trainer_cli_killed_mid_publish_resumes_past_the_wreck(tmp_path):
    from paddle_tpu_torch.streaming.trainer import TRAINER_READY_PREFIX

    data, ck = str(tmp_path / "data"), str(tmp_path / "ckpt")
    streaming.synthesize_stream_files(data, n_files=2, rows_per_file=256,
                                      seed=3, chunk_rows=16)

    def spawn(steps, env_extra=None):
        env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
        return subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.streaming.trainer",
             "--data-dir", data, "--ckpt-dir", ck, "--device", "cpu",
             "--steps", str(steps), "--publish-every", "3",
             "--poll-interval", "0.02"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env, cwd=REPO)

    # the third publish's write hangs: the trainer is killed inside it
    p = spawn(999, {"PADDLE_TPU_FAULTS": "checkpoint.write:hang(120)@3"})
    try:
        torn = os.path.join(ck, "checkpoint_2")
        deadline = time.monotonic() + 120.0
        while not os.path.isdir(torn):
            assert p.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        p.send_signal(signal.SIGKILL)
        p.wait(30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert checkpoint.candidate_versions(ck) == [1, 0]
    _, extra = checkpoint.load_extra(ck)
    with open(os.path.join(ck, "progress.json")) as f:
        ledger = json.load(f)
    q = spawn(12)
    out, _ = q.communicate(timeout=120)
    assert q.returncode == 0, out
    lines = out.strip().splitlines()
    ready = json.loads(lines[0][len(TRAINER_READY_PREFIX):])
    result = json.loads(lines[-1])
    assert ready["resumed_version"] == 1
    assert ready["replayed_rows"] == ledger["rows"] \
        - extra["cursor"]["rows"]
    assert result["steps"] == 12 and result["publish_failures"] == 0
    assert checkpoint.candidate_versions(ck)[0] > 2  # published past it
