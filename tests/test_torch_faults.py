"""Faults of the port against ``paddle_tpu``, repaired, each held to the
reference on the CPU.

* A training run that reads state a grad-free run left behind (the port's
  own startup run makes inference tensors) and does not differentiate it:
  a parameter left out of ``parameter_list``, one in ``no_grad_set``, a
  frozen layer between two trained ones, ``calc_gradient`` w.r.t. the
  input. The weights come from constant initializers, so both packages'
  startup runs make the same ones; two SGD steps, f32, atol 1e-6 / rtol
  1e-5 (the two sides sum in different orders).
* A 0-d value keeps its shape () through the feed, ``load_persistables``
  and a bridge load.
* ``sequence_mask`` without ``maxlen``: the reference declares its output
  (n, -1) and reads maxlen from that shape, so it returns an [N, 0] mask
  (Fluid 1.3 takes max(x)). That is the reference's fault; the port
  matches it, since ``paddle_tpu`` stays as it is.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid

TOL = dict(atol=1e-6, rtol=1e-5)
LR = 0.1


def _fc(pkg, x, size, name, w, b, act="tanh", trainable=True):
    const = pkg.initializer.ConstantInitializer
    return pkg.layers.fc(
        x, size=size, act=act,
        param_attr=pkg.ParamAttr(name=name + ".w", initializer=const(w),
                                 trainable=trainable),
        bias_attr=pkg.ParamAttr(name=name + ".b", initializer=const(b),
                                trainable=trainable))


def _mlp(pkg, frozen_mid=False):
    x = pkg.layers.data("x", shape=[6])
    y = pkg.layers.data("y", shape=[3])
    h = _fc(pkg, x, 5, "w0", 0.3, 0.1)
    h = _fc(pkg, h, 4, "w1", -0.2, 0.05, trainable=not frozen_mid)
    o = _fc(pkg, h, 3, "w2", 0.25, -0.1, act=None)
    d = pkg.layers.elementwise_sub(o, y)
    return pkg.layers.mean(pkg.layers.elementwise_mul(d, d))


def _feed(step):
    rng = np.random.RandomState(5 + step)
    return {"x": rng.normal(size=(4, 6)).astype("f4"),
            "y": rng.normal(size=(4, 3)).astype("f4")}


def _train(pkg, build, steps=2):
    """``build(pkg) -> (loss, extra fetches)`` in fresh programs, the
    package's own startup run, then ``steps`` steps: the fetches of each
    step and every parameter after it, as numpy."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        loss, extra = build(pkg)
    scope = pkg.Scope()
    out = []
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        for step in range(steps):
            got = exe.run(main, feed=_feed(step), fetch_list=[loss] + extra)
            params = {p.name: np.asarray(
                scope.get(p.name).numpy() if pkg is tfluid
                else scope.get(p.name)) for p in main.all_parameters()}
            out.append(([np.asarray(g) for g in got], params))
    return out


def _check_parity(build):
    want = _train(fluid, build)
    got = _train(tfluid, build)
    for (gf, gp), (wf, wp) in zip(got, want):
        for g, w in zip(gf, wf):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **TOL)
        assert sorted(gp) == sorted(wp)
        for n in wp:
            np.testing.assert_allclose(gp[n], wp[n], err_msg=n, **TOL)
    return want


def _moved(runs):
    """The parameters the last step left away from their constant init."""
    start = {"w0.w": 0.3, "w0.b": 0.1, "w1.w": -0.2, "w1.b": 0.05,
             "w2.w": 0.25, "w2.b": -0.1}
    params = runs[-1][1]
    return sorted(n for n in params if not np.all(params[n] == start[n]))


def test_parameter_list_trains_one_parameter():
    def build(pkg):
        loss = _mlp(pkg)
        pkg.optimizer.SGD(LR).minimize(loss, parameter_list=["w0.w"])
        return loss, []

    assert _moved(_check_parity(build)) == ["w0.w"]


def test_no_grad_set_keeps_a_parameter():
    def build(pkg):
        loss = _mlp(pkg)
        pkg.optimizer.SGD(LR).minimize(loss, no_grad_set={"w2.w"})
        return loss, []

    assert _moved(_check_parity(build)) == ["w0.b", "w0.w", "w1.b", "w1.w",
                                             "w2.b"]


def test_frozen_layer_between_trained_ones():
    def build(pkg):
        loss = _mlp(pkg, frozen_mid=True)
        pkg.optimizer.SGD(LR).minimize(loss)
        return loss, []

    assert _moved(_check_parity(build)) == ["w0.b", "w0.w", "w2.b", "w2.w"]


def test_calc_gradient_after_the_startup_run():
    def build(pkg):
        x = pkg.layers.data("x", shape=[6])
        pkg.layers.data("y", shape=[3])
        loss = pkg.layers.mean(_fc(pkg, x, 5, "w0", 0.3, 0.1))
        dx, = pkg.calc_gradient(loss, [x])
        return loss, [dx]

    runs = _check_parity(build)
    assert runs[0][0][1].shape == (4, 6)


def _zero_d(pkg):
    s = pkg.layers.data("s", shape=[], dtype="float32",
                        append_batch_size=False)
    f = pkg.layers.data("f", shape=[4])
    loss = pkg.layers.mean(pkg.layers.fc(f, size=2))
    pkg.optimizer.SGD(LR).minimize(loss)
    return pkg.layers.scale(s, scale=2.0)


def test_zero_d_feed_fetches_back_as_a_scalar():
    got = []
    for pkg in (fluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            out = _zero_d(pkg)
        with pkg.scope_guard(pkg.Scope()):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            got.append(exe.run(main, feed={
                "s": np.asarray(3.0, "f4"), "f": np.ones((2, 4), "f4")},
                fetch_list=[out])[0])
    assert [np.shape(g) for g in got] == [(), ()]
    assert float(got[0]) == float(got[1]) == 6.0


def test_zero_d_state_survives_save_load_and_bridge(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        _zero_d(tfluid)
    lr, = [v for v in main.list_vars()
           if v.persistable and v.name.startswith("learning_rate")]
    assert tuple(lr.shape) == ()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        assert tuple(scope.get(lr.name).shape) == ()
        tfluid.io.save_persistables(exe, str(tmp_path), main)
    loaded = tfluid.Scope()
    with tfluid.scope_guard(loaded):
        tfluid.io.load_persistables(exe, str(tmp_path), main)
    assert tuple(loaded.get(lr.name).shape) == ()
    assert float(loaded.get(lr.name)) == pytest.approx(LR)
    bridged = tfluid.Scope()
    tfluid.bridge.load_numpy_params(
        bridged, {lr.name: np.asarray(LR, "f4")}, "cpu", main)
    assert tuple(bridged.get(lr.name).shape) == ()


def test_sequence_mask_without_maxlen_is_empty_as_the_reference():
    got = []
    for pkg in (fluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[1], dtype="int64")
            m = pkg.layers.sequence_mask(x)
        with pkg.scope_guard(pkg.Scope()):
            got.append(pkg.Executor(pkg.CPUPlace()).run(
                main, feed={"x": np.array([[3], [1], [2]], "int64")},
                fetch_list=[m])[0])
    assert [g.shape for g in got] == [(3, 0), (3, 0)]
