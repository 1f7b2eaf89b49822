"""The port's serving control flow on the CPU: the shape ladder and the
micro-batcher against ``paddle_tpu``'s on the same inputs, and the one-shot
engine's admission, deadline, failure and shutdown paths on a fake
predictor (deterministic, no model)."""

import threading
import time

import numpy as np
import pytest

import paddle_tpu.serving.batcher as jax_batcher
import paddle_tpu.serving.buckets as jax_buckets
import paddle_tpu_torch.serving.batcher as t_batcher
import paddle_tpu_torch.serving.buckets as t_buckets
from paddle_tpu_torch.serving import (BucketError, DeadlineExceededError,
                                      ServerOverloadedError, ServingEngine)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_buckets_match_reference(n):
    rng = np.random.RandomState(n)
    feed = {"x": rng.normal(size=(n, 3, 2)).astype("f4"),
            "ids": rng.randint(0, 9, (n, 5)), "s": np.float32(0.5)}
    for ladder in ((1, 2, 4, 8), (2, 8), (5, 8)):
        want, wn = jax_buckets.pad_to_bucket(feed, ladder)
        got, gn = t_buckets.pad_to_bucket(feed, ladder)
        assert gn == wn == n and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        outs = [got["x"], np.arange(7)]
        rung = t_buckets.bucket_for(n, ladder)
        for a, b in zip(t_buckets.unpad_fetch(outs, n, padded_to=rung),
                        jax_buckets.unpad_fetch(outs, n, padded_to=rung)):
            np.testing.assert_array_equal(a, b)
    assert t_buckets.pow2_ladder(n) == jax_buckets.pow2_ladder(n)


def _cuts(mod, sizes, max_batch, advance):
    """Sizes of the batches ``mod``'s batcher cuts from ``sizes``."""
    clock = FakeClock()
    b = mod.DynamicBatcher(max_batch_size=max_batch, max_wait_ms=5,
                           clock=clock)
    for n in sizes:
        b.put(mod.Request({}, n, None, clock()))
    clock.advance(advance)
    b.close()
    cuts = []
    while (batch := b.get_batch()) is not None:
        cuts.append([r.n for r in batch])
    return cuts


@pytest.mark.parametrize("sizes,max_batch", [
    ([1, 1, 1, 1], 4), ([3, 2, 1, 4, 4], 4), ([6, 1], 4), ([1, 2], 8)])
def test_batcher_cuts_match_reference(sizes, max_batch):
    for advance in (0.0, 0.01):
        want = _cuts(jax_batcher, sizes, max_batch, advance)
        assert _cuts(t_batcher, sizes, max_batch, advance) == want


def test_batcher_waits_for_size_or_deadline():
    clock = FakeClock()
    b = t_batcher.DynamicBatcher(max_batch_size=8, max_wait_ms=5,
                                 clock=clock)
    b.put(t_batcher.Request({}, 2, None, clock()))
    got = []
    t = threading.Thread(target=lambda: got.append(b.get_batch()))
    t.start()
    time.sleep(0.05)
    assert not got  # neither full nor past the deadline: still waiting
    clock.advance(0.006)
    b.put(t_batcher.Request({}, 1, None, clock()))  # wakes the waiter
    t.join(5.0)
    assert not t.is_alive() and [r.n for r in got[0]] == [2, 1]


class FakePredictor:
    """Doubles its input; an optional gate holds the worker mid-run and
    the value -777 raises (a failing batch)."""
    feed_names = ["x"]

    def __init__(self, gate=None):
        self.gate = gate

    def run(self, feed, return_numpy=True):
        if self.gate is not None:
            assert self.gate.wait(5.0), "test gate never opened"
        x = np.asarray(feed["x"])
        if np.any(x == -777):
            raise RuntimeError("poisoned batch")
        return [x * 2.0]

    def clone(self):
        return FakePredictor(self.gate)


def _drain_queue(eng, timeout=5.0):
    t0 = time.time()
    while eng._batcher.depth() > 0:
        assert time.time() - t0 < timeout, "queue never drained"
        time.sleep(0.001)


def test_engine_overload_fast_fails_while_in_flight_completes():
    gate = threading.Event()
    eng = ServingEngine(FakePredictor(gate), ladder=(1, 2, 4),
                        max_wait_ms=0, max_queue_depth=4)
    try:
        first = eng.submit({"x": np.full((1, 2), 3.0, "f4")})
        _drain_queue(eng)  # the worker holds `first` at the gate
        backlog = [eng.submit({"x": np.full((1, 2), float(i), "f4")})
                   for i in range(3)]  # in flight now at the depth limit
        with pytest.raises(ServerOverloadedError):
            eng.submit({"x": np.zeros((1, 2), "f4")})
        assert eng.metrics()["requests_rejected"] == 1
        gate.set()
        np.testing.assert_array_equal(first.result(5.0)[0],
                                      np.full((1, 2), 6.0))
        for i, f in enumerate(backlog):
            np.testing.assert_array_equal(f.result(5.0)[0],
                                          np.full((1, 2), 2.0 * i))
    finally:
        gate.set()
        eng.shutdown()
    assert eng.metrics()["requests_completed"] == 4
    assert eng._admission.in_flight == 0


def test_engine_failed_batch_fails_only_its_requests():
    eng = ServingEngine(FakePredictor(), ladder=(1, 2), max_wait_ms=0)
    try:
        bad = eng.submit({"x": np.full((1, 2), -777.0, "f4")})
        with pytest.raises(RuntimeError, match="poisoned"):
            bad.result(5.0)
        good = eng.submit({"x": np.ones((1, 2), "f4")})
        np.testing.assert_array_equal(good.result(5.0)[0],
                                      np.full((1, 2), 2.0))
        m = eng.metrics()
        assert m["requests_failed"] == 1 and m["requests_completed"] == 1
    finally:
        eng.shutdown()
    assert eng._admission.in_flight == 0


def test_engine_deadline_expires_queued_request():
    clock = FakeClock()
    gate = threading.Event()
    eng = ServingEngine(FakePredictor(gate), ladder=(1, 2), max_wait_ms=0,
                        clock=clock)
    try:
        blocker = eng.submit({"x": np.ones((1, 2), "f4")})
        _drain_queue(eng)
        doomed = eng.submit({"x": np.ones((1, 2), "f4")}, timeout_s=5.0)
        clock.advance(10.0)  # past the deadline while still queued
        gate.set()
        with pytest.raises(DeadlineExceededError):
            doomed.result(5.0)
        assert blocker.result(5.0)
        assert eng.metrics()["requests_expired"] == 1
    finally:
        gate.set()
        eng.shutdown()


def test_engine_rejects_oversize_and_submit_after_shutdown():
    eng = ServingEngine(FakePredictor(), ladder=(1, 2, 4), max_wait_ms=0)
    with pytest.raises(BucketError):
        eng.submit({"x": np.ones((5, 2), "f4")})
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit({"x": np.ones((1, 2), "f4")})


def test_engine_shutdown_without_drain_cancels_queued():
    gate = threading.Event()
    eng = ServingEngine(FakePredictor(gate), ladder=(1,), max_wait_ms=0)
    running = eng.submit({"x": np.ones((1, 2), "f4")})
    _drain_queue(eng)  # the worker holds `running` at the gate
    queued = eng.submit({"x": np.ones((1, 2), "f4")})
    eng.shutdown(drain=False, timeout_s=0.2)
    assert queued.cancelled()
    gate.set()
    assert running.result(5.0)
    for t in eng._threads:
        t.join(5.0)
        assert not t.is_alive()
    assert eng._admission.in_flight == 0


def test_engine_coalesces_riders_into_one_batch():
    """Requests queued behind a busy worker ride one batch and each gets
    its own rows back."""
    gate = threading.Event()
    eng = ServingEngine(FakePredictor(gate), ladder=(1, 2, 4, 8),
                        max_wait_ms=50)
    try:
        hold = eng.submit({"x": np.zeros((1, 2), "f4")})
        _drain_queue(eng)
        futs = [eng.submit({"x": np.full((n, 2), float(n), "f4")})
                for n in (1, 2, 3)]
        gate.set()
        assert hold.result(5.0)
        for n, f in zip((1, 2, 3), futs):
            np.testing.assert_array_equal(f.result(5.0)[0],
                                          np.full((n, 2), 2.0 * n))
        assert eng.metrics()["batches"] == 2  # the held one + all three
    finally:
        gate.set()
        eng.shutdown()
