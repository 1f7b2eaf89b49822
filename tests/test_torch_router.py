"""The port's multi-process front door against the reference: rpc frames
that each package decodes from the other, torn and insane frames and the
two wire fault sites, the consistent-hash ring (the same worker index for
the same key), and a router over two ``--device cpu`` workers serving a
tiny BERT classifier the reference initialised and saved, whose answers
equal the JAX ``Predictor``'s within 1e-5; then routing, the dispatch
fault's one retry and deadline propagation on that fleet.

Every router binds port 0 and reaps its worker processes in a
``finally``."""

import socket
import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models.bert import bert_encoder as jax_bert_encoder
from paddle_tpu.serving import Router as RefRouter
from paddle_tpu.serving import rpc as ref_rpc
from paddle_tpu_torch.reliability import faults
from paddle_tpu_torch.serving import (DeadlineExceededError, Router,
                                      RouterClient, RouterShutdownError,
                                      WorkerFailedError)
from paddle_tpu_torch.serving import rpc

SEQ, VOCAB, D_MODEL, D_FF, HEADS, LAYERS = 16, 100, 32, 64, 4, 2
FEEDS = ["input_ids", "segment_ids", "input_len"]
CPU = ["--device", "cpu"]


def _wait_for(cond, timeout=60.0, what="condition"):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "timed out waiting for " + what
        time.sleep(0.05)


def _settled_served(router):
    """Per-worker served counts once two heartbeat cycles agree."""
    prev = None
    t0 = time.time()
    while time.time() - t0 < 30.0:
        cur = [w["stats"].get("served", 0)
               for w in router._worker_states()]
        if cur == prev:
            return cur
        prev = cur
        time.sleep(max(0.3, 1.5 * router.heartbeat_interval_s))
    raise AssertionError("worker served counts never settled")


# -- rpc framing, both ways ---------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


FRAMES = [
    ({"type": "infer", "deadline_s": 1.5, "key": "s1",
      "trace": {"tid": "00ab" * 4, "sid": "11cd" * 4}},
     {"x": np.arange(6, dtype="int64").reshape(2, 3),
      "y": np.float32(2.5), "z": np.ones((2, 0), "f4")}),
    ({"type": "result", "n_out": 0}, None),
    ({"type": "pong", "stats": {"queue_depth": 0, "served": 3}},
     {"o0": np.random.RandomState(0).randn(4, 2).astype("f4")}),
]


@pytest.mark.parametrize("frame", range(len(FRAMES)))
@pytest.mark.parametrize("way", ["ref_to_port", "port_to_ref"])
def test_frames_decode_in_the_other_package(frame, way):
    header, arrays = FRAMES[frame]
    enc, dec = (ref_rpc, rpc) if way == "ref_to_port" else (rpc, ref_rpc)
    payload = enc.encode_msg(header, arrays)
    assert payload == dec.encode_msg(header, arrays)  # byte for byte
    a, b = _pair()
    try:
        enc.send_msg(a, header, arrays)
        got, got_arrays = dec.recv_msg(b)
    finally:
        a.close()
        b.close()
    assert got == header
    assert set(got_arrays) == set(arrays or {})
    for k, v in (arrays or {}).items():
        np.testing.assert_array_equal(got_arrays[k], v)
        assert got_arrays[k].dtype == np.asarray(v).dtype


def test_clean_close_torn_and_insane_frames():
    a, b = _pair()
    a.close()
    with pytest.raises(rpc.ConnectionClosed):
        rpc.recv_msg(b)
    b.close()
    a, b = _pair()
    try:
        a.sendall(b"\x00\x00\x00\x00\x00\x00\x00\x10partial")
        a.close()
        with pytest.raises(rpc.RpcError) as ei:
            rpc.recv_msg(b)
        assert not isinstance(ei.value, rpc.ConnectionClosed)
    finally:
        b.close()
    a, b = _pair()
    try:
        a.sendall((rpc.MAX_FRAME_BYTES + 1).to_bytes(8, "big"))
        with pytest.raises(rpc.RpcError, match="MAX_FRAME_BYTES"):
            rpc.recv_msg(b)
    finally:
        a.close()
        b.close()
    with pytest.raises(rpc.RpcError, match="bad frame"):
        rpc.decode_msg(b"\x00\x00\x00\x05{}")


def test_rpc_send_and_recv_fault_sites():
    with faults.fault_scope(faults.FaultPlan.from_spec("rpc.send:error@1")):
        a, b = _pair()
        try:
            with pytest.raises(faults.InjectedFault):
                rpc.send_msg(a, {"type": "ping"})
            rpc.send_msg(a, {"type": "ping"})  # invocation 2: clean
            assert rpc.recv_msg(b)[0] == {"type": "ping"}
        finally:
            a.close()
            b.close()
    for spec in ("rpc.send:corrupt@1", "rpc.recv:corrupt@1"):
        with faults.fault_scope(faults.FaultPlan.from_spec(spec)):
            a, b = _pair()
            try:
                rpc.send_msg(a, {"type": "ping"}, {"x": np.ones(4, "f4")})
                # a damaged frame sent by the port is refused by the
                # reference's reader too
                if "send" in spec:
                    with pytest.raises(ref_rpc.RpcError):
                        ref_rpc.recv_msg(b)
                else:
                    with pytest.raises(rpc.RpcError):
                        rpc.recv_msg(b)
            finally:
                a.close()
                b.close()


@pytest.mark.parametrize("workers,vnodes", [(2, 16), (3, 16), (4, 5)])
def test_hash_ring_picks_the_reference_worker(workers, vnodes):
    keys = ["session-%d" % i for i in range(64)] + [0, 17, "abc"]
    port = Router("builtin:fc", num_workers=workers, hash_vnodes=vnodes)
    ref = RefRouter("builtin:fc", num_workers=workers, hash_vnodes=vnodes)
    assert port._ring == ref._ring
    for k in keys:
        assert port._hash_order(k) == ref._hash_order(k), k
    firsts = {port._hash_order(k)[0] for k in keys}
    assert firsts == set(range(workers))


# -- a two-worker fleet serving the reference's tiny BERT ---------------------

def _classifier(pkg, encoder):
    L = pkg.layers
    input_ids = L.data("input_ids", shape=[SEQ], dtype="int64")
    segment_ids = L.data("segment_ids", shape=[SEQ], dtype="int64")
    input_len = L.data("input_len", shape=[], dtype="int64")
    x = encoder(input_ids, segment_ids, input_len, SEQ, VOCAB, D_MODEL, D_FF,
                HEADS, LAYERS, dropout_rate=0.0)
    cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    pooled = L.fc(cls, size=D_MODEL, act="tanh", name="pooler")
    return L.softmax(L.fc(pooled, size=2, name="cls_out"))


def save_tiny_bert(root):
    """The reference initialises and saves the classifier; the port loads
    its params.npz into its own copy of the program and saves its model
    directory. Returns (reference dir, port dir)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        prob = _classifier(fluid, jax_bert_encoder)
    startup.random_seed = 11
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    ref_dir = str(root / "ref_bert")
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(ref_dir, FEEDS, [prob], exe,
                                      main_program=main)
    tmain, tstart = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(tmain, tstart), tfluid.unique_name.guard():
        tprob = _classifier(tfluid, tfluid.models.bert.bert_encoder)
    tscope = tfluid.Scope()
    tfluid.bridge.load_reference_params(ref_dir, tscope, "cpu",
                                        program=tmain)
    port_dir = str(root / "port_bert")
    with tfluid.scope_guard(tscope):
        tfluid.io.save_inference_model(port_dir, FEEDS, [tprob],
                                       tfluid.Executor(tfluid.CPUPlace()),
                                       main_program=tmain)
    return ref_dir, port_dir


def bert_feed(rng, n):
    return {"input_ids": rng.randint(0, VOCAB, (n, SEQ)).astype("int64"),
            "segment_ids": rng.randint(0, 2, (n, SEQ)).astype("int64"),
            "input_len": rng.randint(1, SEQ + 1, (n,)).astype("int64")}


@pytest.fixture(scope="module")
def bert_fleet(tmp_path_factory):
    ref_dir, port_dir = save_tiny_bert(tmp_path_factory.mktemp("bert"))
    router = Router(port_dir, num_workers=2, routing="hash",
                    heartbeat_interval_s=0.25, worker_args=CPU)
    try:
        router.start()
        client = RouterClient(router.address, pool_size=8,
                              default_timeout_s=60.0)
        yield router, client, ref_dir
        client.close()
    finally:
        router.shutdown()


def test_router_answers_equal_the_jax_predictor(bert_fleet):
    router, client, ref_dir = bert_fleet
    jax_pred = fluid.inference.Predictor(ref_dir)
    rng = np.random.RandomState(7)
    feeds = [bert_feed(rng, n) for n in (1, 3, 2, 4, 1, 2, 3, 4)]
    feeds[0]["input_len"][:] = SEQ
    futs = [client.submit(f) for f in feeds]
    for f, fut in zip(feeds, futs):
        got, = fut.result(60.0)
        want, = jax_pred.run(f)
        assert got.shape == want.shape == (f["input_len"].shape[0], 2)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for w in router._worker_states():
        assert w["healthy"] and w["breaker"] == "closed"
    assert {info["device"] for w in router._workers
            for info in w.ready} == {"cpu"}


def test_router_metrics_and_prometheus(bert_fleet):
    router, client, _ = bert_fleet
    client.predict(bert_feed(np.random.RandomState(1), 2))
    m = client.metrics()
    snap = m["snapshot"]
    for key in ("door_shed", "rerouted", "respawns", "heartbeat_misses",
                "deadline_refused", "requests_completed", "latency_s"):
        assert key in snap
    assert snap["requests_completed"] >= 1 and len(m["workers"]) == 2
    _wait_for(lambda: all("served" in w["stats"]
                          for w in client.metrics()["workers"]),
              what="heartbeat stats")
    text = client.prometheus()
    assert "paddle_tpu_serving_requests_completed" in text
    assert text.endswith("\n")


def test_router_hash_routing_is_sticky(bert_fleet):
    router, client, _ = bert_fleet
    order = router._hash_order("session-abc")
    before = _settled_served(router)
    feed = bert_feed(np.random.RandomState(2), 1)
    for _ in range(5):
        client.predict(feed, key="session-abc")
    after = _settled_served(router)
    assert after[order[0]] == before[order[0]] + 5
    assert after[order[1]] == before[order[1]]


def test_router_dispatch_fault_takes_one_retry(bert_fleet):
    router, client, _ = bert_fleet
    before = router.metrics_.snapshot()
    feed = bert_feed(np.random.RandomState(3), 1)
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "router.dispatch:error@1")):
        out, = client.predict(feed)
    assert out.shape == (1, 2)
    after = router.metrics_.snapshot()
    assert after["rerouted"] >= before["rerouted"] + 1
    assert after["requests_completed"] == before["requests_completed"] + 1


def test_deadline_spent_in_the_router_is_refused_at_the_worker(bert_fleet):
    """Burn the budget inside the router (an injected dispatch hang): the
    worker, not the router, refuses the request without running it."""
    router, client, _ = bert_fleet
    before = router.metrics_.snapshot()
    served = _settled_served(router)
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "router.dispatch:hang(0.4)@1")):
        with pytest.raises(DeadlineExceededError) as ei:
            client.predict(bert_feed(np.random.RandomState(4), 1),
                           timeout_s=0.15)
    assert ei.value.kind == "DeadlineRefused"
    after = router.metrics_.snapshot()
    assert after["deadline_refused"] == before["deadline_refused"] + 1
    assert _settled_served(router) == served


def test_checkpoint_verbs_wait_for_a6_and_closed_client_raises(bert_fleet):
    router, client, _ = bert_fleet
    # the checkpoint verbs came with A6: a directory holding no
    # checkpoint is a typed failure of every worker, not an unknown verb
    with pytest.raises(WorkerFailedError, match="no worker swapped"):
        client.reload("x")
    c = RouterClient(router.address)
    c.close()
    with pytest.raises(RouterShutdownError):
        c.submit(bert_feed(np.random.RandomState(5), 1))
