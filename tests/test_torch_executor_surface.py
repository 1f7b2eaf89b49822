"""The rest of ``Executor.run``'s surface and the release of dead cache
entries, on the CPU against ``paddle_tpu``:

* an entry whose program or scope is collected is released with its graph
  (the CPU stand-in), and ``step_report`` counts the releases: evaluating a
  fresh ``clone(for_test=True)`` each epoch keeps one entry per program
  alive, not one per epoch;
* ``check_nan_inf=True`` and ``FLAGS_check_nan_inf=1`` raise in both
  packages with the same message (op type, var, shape) at the first op
  that makes a NaN or an Inf, and a checked run is never cached;
* ``Scope.find_var``, ``drop`` and ``numpy`` behave as the reference's; a
  dropped name releases the captured step bound to it, which interprets
  and captures again;
* ``feed_var_name`` and ``fetch_var_name`` are accepted and change
  nothing; ``verify=`` raises ``NotImplementedError`` naming A10."""

import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor

from test_torch_captured_step import (_mlp, _mlp_feed, cpu_capture,  # noqa: F401
                                      fresh_port_programs)


def _mlp_main():
    loss, h = _mlp(tfluid)
    main = tfluid.default_main_program()
    tfluid.Executor(tfluid.CPUPlace()).run(
        tfluid.default_startup_program())
    return main, loss, h


@pytest.mark.parametrize("owner", ["program", "scope"])
def test_collected_entry_releases_its_graph(owner, cpu_capture):  # noqa: F811
    main, loss, _h = _mlp_main()
    feed = _mlp_feed()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.global_scope()
    exe.run(main, feed=feed, fetch_list=[loss])
    for epoch in range(4):
        test = main.clone(for_test=True)
        run_scope = scope
        if owner == "scope":   # the eval reads a copy of the weights
            test = main.clone(for_test=True) if epoch == 0 else test_keep
            test_keep = test
            run_scope = tfluid.Scope()
            for n in scope.var_names():
                run_scope.set(n, scope.get(n))
        for _ in range(3):   # interpreted, captured, replayed
            exe.run(test, feed=feed, fetch_list=[loss.name],
                    scope=run_scope)
        report = exe.step_report(test)
        assert report["graph"] and report["entries"] == 2, report
        assert report["released"] == epoch, report
        step = next(e.step for e in exe._cache.values()
                    if e.step is not None)
        held = weakref.ref(test if owner == "program" else run_scope)
        del run_scope
        if owner == "program":
            del test
        gc.collect()
        assert held() is None
    report = exe.step_report(main)
    assert report["entries"] == 1 and report["released"] == 4, report
    assert step.graph is None   # the last eval's graph went too


def _nan_program(pkg, bias=-1.0):
    """mean(sqrt(0 * fc(x) + bias)): NaN from the sqrt where bias < 0."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.scope_guard(pkg.Scope()):
        pkg.unique_name.switch()
        x = pkg.layers.data("x", shape=[4])
        h = pkg.layers.fc(x, size=3)
        r = pkg.layers.sqrt(pkg.layers.scale(h, scale=0.0, bias=bias))
        out = pkg.layers.mean(r)
    return main, start, out


@pytest.mark.parametrize("how", ["argument", "flag"])
def test_check_nan_inf_names_op_and_var(how, monkeypatch):
    feed = {"x": np.ones((2, 4), "float32")}
    messages = {}
    for pkg in (fluid, tfluid):
        main, start, out = _nan_program(pkg)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(start)
            # unchecked: the NaN reaches the fetch
            got, = exe.run(main, feed=feed, fetch_list=[out])
            assert np.isnan(got)
            kw = {}
            if how == "flag":
                monkeypatch.setenv("FLAGS_check_nan_inf", "1")
            else:
                kw["check_nan_inf"] = True
            with pytest.raises(RuntimeError, match="check_nan_inf") as e:
                exe.run(main, feed=feed, fetch_list=[out], **kw)
            monkeypatch.delenv("FLAGS_check_nan_inf", raising=False)
        messages[pkg.__name__] = str(e.value).splitlines()[0]
        if pkg is tfluid:
            # the checked run keeps no cache entry of its own
            assert len(exe._cache) == 2
    assert messages["paddle_tpu_torch"] == messages["paddle_tpu"]
    assert "op 'sqrt' produced nan" in messages["paddle_tpu"]


def test_check_nan_inf_passes_a_finite_program():
    main, start, out = _nan_program(tfluid, bias=4.0)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(start, scope=scope)
    feed = {"x": np.ones((2, 4), "float32")}
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope,
                   check_nan_inf=True)
    assert got == 2.0


def test_scope_find_drop_numpy_match_reference():
    values = {"a": np.arange(6, dtype="float32").reshape(2, 3),
              "b": np.array(3, "int32")}
    scopes = {}
    for pkg, as_value in ((fluid, np.asarray),
                          (tfluid, torch.from_numpy)):
        scope = pkg.Scope()
        for n, v in values.items():
            scope.set(n, as_value(v))
        assert scope.find_var("missing") is None
        assert scope.find_var("a") is scope.get("a")
        scope.drop("b")
        scope.drop("missing")   # dropping what is not there is a no-op
        assert "b" not in scope and scope.find_var("b") is None
        scopes[pkg.__name__] = scope
    np.testing.assert_array_equal(scopes["paddle_tpu_torch"].numpy("a"),
                                  scopes["paddle_tpu"].numpy("a"))
    assert sorted(scopes["paddle_tpu_torch"].var_names()) \
        == sorted(scopes["paddle_tpu"].var_names())
    s = tfluid.Scope()
    s.set("h", torch.tensor([1.5, -2.25], dtype=torch.bfloat16))
    got = s.numpy("h")
    assert got.dtype == np.float32 and got.tolist() == [1.5, -2.25]


def test_drop_releases_the_bound_step(cpu_capture):  # noqa: F811
    main, loss, _h = _mlp_main()
    feed = _mlp_feed()
    scope = tfluid.global_scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    assert exe.step_report(main)["graph"]
    w = main.all_parameters()[0].name
    kept = scope.get(w)
    scope.drop(w)
    assert not exe.step_report(main)["graph"]
    scope.set(w, kept.clone())
    for _ in range(3):   # interpreted again, captured again, replayed
        exe.run(main, feed=feed, fetch_list=[loss])
    report = exe.step_report(main)
    assert (report["interpreted"], report["captures"],
            report["replays"]) == (2, 2, 2), report
    # a name no bound step reads releases nothing
    scope.set("unrelated", torch.zeros(1))
    scope.drop("unrelated")
    assert exe.step_report(main)["graph"]


def test_feed_and_fetch_var_names_are_accepted():
    main, loss, _h = _mlp_main()
    feed = _mlp_feed()
    scope = tfluid.global_scope()
    start = {n: scope.get(n).clone() for n in scope.var_names()
             if isinstance(scope.get(n), torch.Tensor)}
    gen = scope.get(t_executor.RNG_KEY).get_state()
    exe = tfluid.Executor(tfluid.CPUPlace())
    want, = exe.run(main, feed=feed, fetch_list=[loss])
    for n, t in start.items():
        scope.set(n, t.clone())
    scope.get(t_executor.RNG_KEY).set_state(gen)
    got, = exe.run(main, feed=feed, fetch_list=[loss],
                   feed_var_name="my_feed", fetch_var_name="my_fetch")
    np.testing.assert_array_equal(got, want)


def test_verify_waits_for_the_analysis_passes():
    main, loss, _h = _mlp_main()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="A10"):
        exe.run(main, feed=_mlp_feed(), fetch_list=[loss], verify=True)
    exe.run(main, feed=_mlp_feed(), fetch_list=[loss], verify=False)


def test_capture_follows_call_1_on_its_own_thread(cpu_capture):  # noqa: F811
    """A key whose call 1 ran on another thread runs interpreted once more
    on the thread that will capture it (a capture needs that thread's own
    lazy state, its cuBLAS handle on the card), then captures."""
    import threading

    main, loss, _h = _mlp_main()
    feed = _mlp_feed()
    exe = tfluid.Executor(tfluid.CPUPlace())
    t = threading.Thread(target=lambda: exe.run(main, feed=feed,
                                                fetch_list=[loss]))
    t.start()
    t.join(30)
    assert not t.is_alive()
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    report = exe.step_report(main)
    assert (report["interpreted"], report["captures"],
            report["replays"]) == (2, 1, 1), report
