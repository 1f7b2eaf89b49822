"""``Print`` and ``py_func`` in the port (``layers/debug_ops.py``) against
``paddle_tpu`` on the CPU.

``Print``: the same program in both packages prints the same text
(captured with ``capfd``: message, name, dtype, shape and data, the
forward value as ``fwd`` and the gradient as ``bwd-grad``), in each
print phase; ``first_n`` caps the lines over runs; training goes on
through it. The printed values are exact in f32 (multiples of 1/8 and a
mean over 8), so the text is equal character for character.
``py_func``: outputs and the gradients its ``backward_func`` gives equal
the reference's within rtol 1e-6 (the same numpy functions on the same
values), with one and with two inputs and outputs, and with no input
(equal, and made on the executor's device). Both op types are
refused by the captured step's rule, with their reasons."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from test_torch_optimizers import fresh_port_programs  # noqa: F401

X = (np.arange(8, dtype="f4").reshape(2, 4) - 3.0) / 8.0


def _print_run(pkg, phase, runs=1, first_n=-1):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        x = pkg.layers.data("x", shape=[4], stop_gradient=False)
        h = pkg.layers.Print(x, message="act:", summarize=5,
                             print_phase=phase, first_n=first_n)
        loss = pkg.layers.mean(pkg.layers.square(h))
        g, = pkg.gradients(loss, [x])
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        for _ in range(runs):
            got = exe.run(main, feed={"x": X}, fetch_list=[loss, g])
    return got, main


@pytest.mark.parametrize("phase", ["both", "forward", "backward"])
def test_print_text_matches_reference(capfd, phase):
    capfd.readouterr()
    want, _ = _print_run(fluid, phase)
    ref = capfd.readouterr().out
    got, _ = _print_run(tfluid, phase)
    out = capfd.readouterr().out
    assert out == ref
    lines = out.strip().split("\n")
    tags = {"both": ["fwd", "bwd-grad"], "forward": ["fwd"],
            "backward": ["bwd-grad"]}[phase]
    assert len(lines) == len(tags)
    for line, tag in zip(lines, tags):
        assert line.startswith("act:  %s x  dtype: float32  shape: (2, 4)"
                               % tag), line
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_print_first_n_counts_both_phases(capfd):
    """``first_n`` counts every line the op printed, over runs."""
    capfd.readouterr()
    _print_run(fluid, "both", runs=3, first_n=3)
    ref = capfd.readouterr().out
    _print_run(tfluid, "both", runs=3, first_n=3)
    out = capfd.readouterr().out
    assert out == ref and out.count("act:") == 3


def test_training_goes_on_through_print(capfd):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        h = tfluid.layers.fc(x, size=4, act=None)
        h = tfluid.layers.Print(h, message="act:", summarize=3)
        loss = tfluid.layers.mean(tfluid.layers.square(h))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        xs = np.ones((2, 4), "f4")
        l1, = exe.run(main, feed={"x": xs}, fetch_list=[loss])
        l2, = exe.run(main, feed={"x": xs}, fetch_list=[loss])
    assert float(l2) < float(l1)
    out = capfd.readouterr().out
    assert out.count("fwd") == 2 and out.count("bwd-grad") == 2
    assert "shape: (2, 4)" in out


def _py_func_run(pkg, two):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        a = pkg.layers.data("a", shape=[3], stop_gradient=False)
        b = pkg.layers.data("b", shape=[3], stop_gradient=False)
        gb = main.global_block()
        if two:
            outs = [gb.create_var(name="o%d" % i, shape=(-1, 3),
                                  dtype="float32") for i in range(2)]
            pkg.layers.py_func(
                func=lambda x, y: (x * y, np.sin(x) + y), x=[a, b], out=outs,
                backward_func=lambda x, y, o1, o2, d1, d2: (
                    d1 * y + d2 * np.cos(x), d1 * x + d2))
            ins = [a, b]
        else:
            outs = [gb.create_var(name="o0", shape=(-1, 3), dtype="float32")]
            pkg.layers.py_func(func=lambda x: np.sin(x), x=a, out=outs[0],
                               backward_func=lambda x, o, do: np.cos(x) * do)
            ins = [a]
        c = pkg.layers.data("c", shape=[3])
        total = pkg.layers.sums([pkg.layers.reduce_sum(
            pkg.layers.elementwise_mul(o, c)) for o in outs])
        grads = pkg.gradients(total, ins)
    exe = pkg.Executor(pkg.CPUPlace())
    rng = np.random.RandomState(0)
    feed = {k: rng.randn(2, 3).astype("f4") for k in "abc"}
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        return exe.run(main, feed=feed, fetch_list=outs + grads), feed


@pytest.mark.parametrize("two", [False, True], ids=["one", "two"])
def test_py_func_forward_and_backward_match_reference(two):
    got, feed = _py_func_run(tfluid, two)
    want, _ = _py_func_run(fluid, two)
    assert len(got) == len(want) == (4 if two else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    a, b, c = feed["a"], feed["b"], feed["c"]
    if two:
        np.testing.assert_allclose(got[0], a * b, rtol=1e-6)
        np.testing.assert_allclose(got[2], c * b + c * np.cos(a), rtol=1e-5)
    else:
        np.testing.assert_allclose(got[1], np.cos(a) * c, rtol=1e-6)


def test_py_func_without_backward_runs_in_inference():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[3])
        out = main.global_block().create_var(name="pyout", shape=(-1, 3),
                                             dtype="float32")
        tfluid.layers.py_func(func=lambda a: a * a, x=x, out=out)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        xs = np.array([[1.0, -2.0, 3.0]], "f4")
        got, = exe.run(main, feed={"x": xs}, fetch_list=[out])
    np.testing.assert_allclose(got, xs * xs, rtol=1e-6)


def _py_func_no_inputs(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        x = pkg.layers.data("x", shape=[2, 3], append_batch_size=False)
        out = main.global_block().create_var(name="made", shape=(2, 3),
                                             dtype="float32")
        pkg.layers.py_func(func=lambda: np.arange(6.0).reshape(2, 3) / 4,
                           x=[], out=out)
        total = pkg.layers.elementwise_add(out, x)
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        got = exe.run(main, feed={"x": X[:, :3]}, fetch_list=[out, total])
    return got, main


def test_py_func_without_inputs_makes_its_outputs_on_the_run_device():
    """``x=[]`` is valid: the outputs equal the reference's, and they are
    made on the executor's device, not where an input lies (a meta device
    stands in for the card)."""
    import torch

    from paddle_tpu_torch.core.op_registry import DEVICE_KEY, run_op

    got, main = _py_func_no_inputs(tfluid)
    want, _ = _py_func_no_inputs(fluid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    op = next(o for o in main.global_block().ops if o.type == "py_func")
    env = {DEVICE_KEY: torch.device("meta")}
    run_op(env, op)
    assert env["made"].device.type == "meta"
    assert tuple(env["made"].shape) == (2, 3)


@pytest.mark.parametrize("op_type", ["print", "py_func"])
def test_capture_rule_refuses_host_ops(op_type):
    """A program holding either op is interpreted on the card; the rule
    names the op and why."""
    if op_type == "print":
        _, main = _print_run(tfluid, "both")
    else:
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            x = tfluid.layers.data("x", shape=[3])
            out = main.global_block().create_var(name="o", shape=(-1, 3),
                                                 dtype="float32")
            tfluid.layers.py_func(func=np.sin, x=x, out=out)
    captured, reason = t_executor.capture_rule(main.global_block().ops)
    assert not captured
    assert reason.startswith("op '%s': " % op_type)
    assert "host" in reason
