"""Gradient accumulation in the port (``minimize(accumulate_steps=k)``)
against ``paddle_tpu``: k = 2 over 4 micro-steps under Adam at an
``exponential_decay`` rate that halves every effective step, so the
counter rescale (the schedule reads ``counter // k``) shows in every
apply. Dense and sparse (``embedding(is_sparse=True)``: the micro-steps'
(rows, values) grads scatter into a dense buffer) programs.

The port's steps run through the executor's capture path on the CPU
stand-in (``cpu_capture``: the rule judged as on a card, the graph an
eager replay): the apply/keep decision is a ``_switch_cond`` blend on the
device, so the accumulating step is captured (``step_report``), and its
replays agree with the reference. Parameters stay bitwise frozen between
applies; the loss of each micro-step and the parameters after each agree
within rtol 2e-5 / atol 2e-6 (the same f32 arithmetic, summed in other
orders)."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_captured_step import cpu_capture  # noqa: F401
from test_torch_optimizers import fresh_port_programs  # noqa: F401

K, MICRO, BATCH, VOCAB = 2, 4, 6, 30
RTOL, ATOL = 2e-5, 2e-6


def _build(pkg, is_sparse):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    L = pkg.layers
    with pkg.program_guard(main, startup):
        ids = L.data("ids", shape=[1], dtype="int64")
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[VOCAB, 5], is_sparse=is_sparse)
        h = L.fc(L.concat([L.reshape(emb, [-1, 5]), x], axis=1), size=8,
                 act="relu")
        loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
        lr = L.exponential_decay(learning_rate=0.05, decay_steps=1,
                                 decay_rate=0.5, staircase=True)
        pkg.optimizer.Adam(lr).minimize(loss, accumulate_steps=K)
    return main, startup, loss


def _feeds():
    rng = np.random.RandomState(0)
    return [{"ids": rng.randint(0, 10, (BATCH, 1)).astype("int64"),
             "x": rng.randn(BATCH, 4).astype("float32"),
             "y": rng.randn(BATCH, 1).astype("float32")}
            for _ in range(MICRO)]


@pytest.mark.parametrize("is_sparse", [False, True], ids=["dense", "sparse"])
def test_accumulated_steps_match_reference_captured(is_sparse, cpu_capture):
    jmain, jstartup, jloss = _build(fluid, is_sparse)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    want = []
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        params = {p.name: np.asarray(jscope.get(p.name))
                  for p in jmain.all_parameters()}
        for feed in _feeds():
            loss = float(jexe.run(jmain, feed=feed, fetch_list=[jloss])[0])
            want.append((loss, {n: np.asarray(jscope.get(n))
                                for n in params}))

    main, startup, loss = _build(tfluid, is_sparse)
    assert any(op.type == "scatter" for op in main.global_block().ops) \
        == is_sparse
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.bridge.load_program_params(scope, params, main, "cpu")
    prev = params
    for i, (feed, (wloss, wparams)) in enumerate(zip(_feeds(), want)):
        got = float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0])
        np.testing.assert_allclose(got, wloss, rtol=RTOL, atol=ATOL)
        now = {n: scope.numpy(n).copy() for n in params}
        for n in params:
            np.testing.assert_allclose(now[n], wparams[n], rtol=RTOL,
                                       atol=ATOL, err_msg="%s @%d" % (n, i))
            if (i + 1) % K:  # a micro-step that only accumulates
                np.testing.assert_array_equal(now[n], prev[n])
            else:
                assert np.abs(now[n] - prev[n]).max() > 0, n
        prev = now
    report = exe.step_report(main)
    assert report["captured"], report["reason"]
    assert (report["interpreted"], report["captures"],
            report["replays"]) == (1, 1, MICRO - 2)


def test_scatter_op_drops_out_of_range_ids():
    """The ``scatter`` op: negative ids count from the end, others out of
    range drop, duplicates add (overwrite=False) as ``paddle_tpu``'s XLA
    scatter does."""
    x = np.arange(12, dtype="float32").reshape(4, 3)
    ids = np.array([1, -1, 4, 1, -6], dtype="int64")
    upd = np.ones((5, 3), "float32") * np.arange(1, 6)[:, None]
    outs = []
    for pkg in (fluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            xs = [pkg.layers.data(n, shape=s, dtype=d,
                                  append_batch_size=False)
                  for n, s, d in (("x", [4, 3], "float32"),
                                  ("ids", [5], "int64"),
                                  ("u", [5, 3], "float32"))]
            gb = main.global_block()
            res = []
            for overwrite in (False, True):
                out = gb.create_var(name="out%d" % overwrite, shape=(4, 3),
                                    dtype="float32")
                gb.append_op("scatter", {"X": xs[0], "Ids": xs[1],
                                         "Updates": xs[2]},
                             {"Out": out}, {"overwrite": overwrite})
                res.append(out)
        exe = pkg.Executor(pkg.CPUPlace())
        outs.append(exe.run(main, feed={"x": x, "ids": ids, "u": upd},
                            fetch_list=res))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    want = x.copy()
    want[1] += 1 + 4
    want[3] += 2
    np.testing.assert_array_equal(outs[1][0], want)
    # overwrite: the duplicate id 1 takes one of its two rows
    assert outs[1][1][1, 0] in (1.0, 4.0)
    np.testing.assert_array_equal(np.delete(outs[1][1], 1, 0),
                                  np.delete(outs[0][1], 1, 0))
