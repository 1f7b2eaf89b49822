"""Learning-rate schedules, the step counter and Switch on the CPU, against
``paddle_tpu``:

* each schedule of ``layers/learning_rate_scheduler.py`` over 12 steps of
  the same program in both packages (rtol 1e-6: the two sides' pow, exp
  and cos differ in the last bits);
* a piecewise schedule written with ``Switch`` and a Switch-guarded
  assignment of a fed value: equal to the reference's;
* a captured Adam step (the CPU stand-in for the graph) under
  ``exponential_decay`` and under a Switch schedule equals the interpreted
  step bitwise, its counter written in place;
* the reference's refusal to fuse a Switch-guarded conv -> BN chain."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import epilogue_fusion as jef
from paddle_tpu_torch.core import epilogue_fusion as tef

from test_torch_captured_step import (_mlp_feed, _persist,  # noqa: F401
                                      cpu_capture)

STEPS = 12
SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.7,
                                                   staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 8, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 5, 0.01,
                                                     power=0.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 5, 9], [1.0, 0.5, 0.25,
                                                         0.125]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
    "noam": lambda L: L.noam_decay(64, 4),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "linear_warmup_over_decay": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.2, 2, 0.9), 4, 0.01, 0.2),
}


def _run_steps(pkg, build, feed=None, steps=STEPS):
    """The values of ``build(pkg.layers)``'s fetches at each of ``steps``
    runs of a fresh program (its own names, scope and executor)."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        pkg.unique_name.switch()
        fetch = build(pkg.layers)
    fetch = fetch if isinstance(fetch, (list, tuple)) else [fetch]
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(start)
        return [[np.asarray(v, np.float64).reshape(-1) for v in
                 exe.run(main, feed=feed or {}, fetch_list=fetch)]
                for _ in range(steps)]


def _assert_steps(got, want, rtol=1e-6):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0,
                                       err_msg="step %d" % i)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    def build(L):
        lr = SCHEDULES[name](L)
        counter = L.autoincreased_step_counter(
            counter_name="@LR_DECAY_COUNTER@", begin=0, step=1)
        return [lr, counter]

    want = _run_steps(fluid, build)
    got = _run_steps(tfluid, build)
    _assert_steps(got, want)
    assert [int(s[1][0]) for s in got] == list(range(STEPS))


def _switch_lr(L):
    """piecewise_decay([2, 5, 9], [1, .5, .25, .125]) written with Switch
    over a persistable rate."""
    step = L.autoincreased_step_counter(counter_name="@LR_DECAY_COUNTER@",
                                        begin=0, step=1)
    lr = L.create_global_var([1], 0.0, "float32", persistable=True,
                             name="switch_lr")
    bounds = [L.fill_constant([1], "int64", b) for b in (2, 5, 9)]
    with L.Switch() as switch:
        for b, v in zip(bounds, (1.0, 0.5, 0.25)):
            with switch.case(L.less_than(step, b)):
                L.fill_constant([1], "float32", v, out=lr)
        with switch.default():
            L.fill_constant([1], "float32", 0.125, out=lr)
    return lr


def test_switch_schedule_matches_reference():
    want = _run_steps(fluid, lambda L: [_switch_lr(L)])
    got = _run_steps(tfluid, lambda L: [_switch_lr(L)])
    _assert_steps(got, want, rtol=0)
    piecewise = _run_steps(tfluid, SCHEDULES["piecewise"])
    _assert_steps(got, piecewise, rtol=0)


def test_switch_guarded_assign_matches_reference():
    """A case assigns a fed value only where the fed flag is set; the
    default adds one; a var the cases never wrote keeps its value."""
    rng = np.random.RandomState(0)

    def build(L):
        x = L.data("x", shape=[3], append_batch_size=False)
        flag = L.data("flag", shape=[1], dtype="float32",
                      append_batch_size=False)
        out = L.fill_constant([3], "float32", -1.0)
        kept = L.fill_constant([3], "float32", 7.0)
        half = L.fill_constant([1], "float32", 0.5)
        with L.Switch() as switch:
            with switch.case(L.less_than(half, flag)):
                L.assign(x, out)
            with switch.default():
                L.assign(L.scale(x, scale=1.0, bias=1.0), out)
        return [out, kept]

    for flag in (0.0, 1.0):
        feed = {"x": rng.normal(size=3).astype("f4"),
                "flag": np.array([flag], "f4")}
        want = _run_steps(fluid, build, feed, steps=1)
        got = _run_steps(tfluid, build, feed, steps=1)
        _assert_steps(got, want, rtol=0)
        np.testing.assert_array_equal(
            got[0][0], feed["x"] + (0.0 if flag else 1.0))


def _trained(schedule):
    """An MLP under Adam at ``schedule``'s rate: (main, startup, loss,
    lr)."""
    main, start = tfluid.Program(), tfluid.Program()
    main.random_seed = start.random_seed = 7
    with tfluid.program_guard(main, start):
        tfluid.unique_name.switch()
        L = tfluid.layers
        x = L.data("x", shape=[12])
        y = L.data("y", shape=[3])
        h = L.fc(L.fc(x, size=16, act="relu"), size=3)
        d = L.elementwise_sub(h, y)
        loss = L.mean(L.elementwise_mul(d, d))
        lr = schedule(L)
        tfluid.optimizer.Adam(lr).minimize(loss)
    return main, start, loss, lr


@pytest.mark.parametrize("schedule", ["exponential", "switch"])
def test_captured_scheduled_step_equals_interpreted(schedule, cpu_capture):  # noqa: F811
    build = SCHEDULES["exponential"] if schedule == "exponential" \
        else _switch_lr
    main, start, loss, lr = _trained(build)
    out = {}
    for mode in ("captured", "interpreted"):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(start, scope=scope)
        steps = [exe.run(main, feed=_mlp_feed(seed=i), fetch_list=[loss, lr],
                         scope=scope,
                         use_program_cache=mode == "captured")
                 for i in range(7)]
        state = {n: scope.numpy(n) for n in sorted(_persist(main))}
        out[mode] = (steps, state, exe.step_report(main))
    (cs, cst, report), (is_, ist, _r) = out["captured"], out["interpreted"]
    assert report["captured"] and report["reason"] == "admitted", report
    assert (report["interpreted"], report["captures"],
            report["replays"]) == (1, 1, 5), report
    for c, i in zip(cs, is_):
        for a, b in zip(c, i):
            np.testing.assert_array_equal(a, b)
    for n in cst:
        np.testing.assert_array_equal(cst[n], ist[n], err_msg=n)
    assert int(cst["@LR_DECAY_COUNTER@"][0]) == 6
    rates = [float(np.asarray(s[1]).reshape(-1)[0]) for s in cs]
    assert len(set(rates)) > 1   # the schedule moved under the replays


def _guarded_chain(pkg):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        pkg.unique_name.switch()
        L = pkg.layers
        img = L.data("img", shape=[8, 8, 8], dtype="float32")
        flag = L.data("flag", shape=[1], dtype="float32",
                      append_batch_size=False)
        base = L.conv2d(img, 8, 1, bias_attr=False)
        out = L.batch_norm(base, act="relu")    # fuses
        with L.Switch() as switch:
            with switch.case(L.less_than(flag, 0.5)):
                y = L.batch_norm(L.conv2d(out, 8, 3, padding=1,
                                          bias_attr=False))
                L.assign(y, out)
        loss = L.mean(out)
    return main, [loss.name]


def test_switch_guarded_chain_is_not_fused():
    reports = {}
    for pkg, ef in ((fluid, jef), (tfluid, tef)):
        main, fetch = _guarded_chain(pkg)
        _ops, report = ef.fuse_ops(main.global_block().ops,
                                   protected=set(fetch))
        reports[pkg.__name__] = report
        guarded = [op for op in main.global_block().ops
                   if op.attrs.get("_switch_cond")]
        assert {op.type for op in guarded} >= {"conv2d", "batch_norm"}
    j, t = reports["paddle_tpu"], reports["paddle_tpu_torch"]
    assert len(j.fused) == len(t.fused) == 1
    assert [s.kinds for s in t.fused] == [s.kinds for s in j.fused]
    assert sorted(r.reason for r in t.refused) \
        == sorted(r.reason for r in j.refused)
    # unguarded, the second chain fuses: the guard is what refuses it
    main, fetch = _guarded_chain(tfluid)
    for op in main.global_block().ops:
        if op.type in ("conv2d", "batch_norm"):
            op.attrs.pop("_switch_cond", None)
    _ops, report = tef.fuse_ops(main.global_block().ops,
                                protected=set(fetch))
    assert len(report.fused) == 2
