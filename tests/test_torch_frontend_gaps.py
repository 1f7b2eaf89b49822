"""Small front-end names of ``paddle_tpu`` that the port now carries:
``Variable.grad_name`` / ``astype``, ``io.save_params`` /
``load_params``, ``load_inference_model``'s file names,
``inference.create_paddle_predictor``, ``models.ModelSpec``, ``serving``'s
``DecodeRequest`` / ``PrefixEntry`` / ``PrefixMatch``,
``CPUPlace(device_id)`` and the ``metrics`` module, each held to the
reference: the same signatures and, on the same inputs, the same results
(the metrics exactly: both are the same numpy arithmetic)."""

import inspect
import os

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401


def _signature(fn):
    return str(inspect.signature(fn))


@pytest.mark.parametrize("path", [
    "io.save_params", "io.load_params", "io.load_inference_model",
    "inference.create_paddle_predictor", "Variable.astype",
    "layers.detection_map", "layers.psroi_pool"])
def test_signatures_match_reference(path):
    def resolve(pkg):
        obj = pkg
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    assert _signature(resolve(tfluid)) == _signature(resolve(fluid))


def test_exports_match_reference():
    for name in ("DecodeRequest", "PrefixEntry", "PrefixMatch"):
        assert name in tfluid.serving.__all__ and name in fluid.serving.__all__
        assert getattr(tfluid.serving, name).__name__ == name
    assert tfluid.models.ModelSpec is tfluid.models.common.ModelSpec
    assert {"save_params", "load_params"} <= set(tfluid.io.__all__)
    assert "create_paddle_predictor" in tfluid.inference.__all__
    assert set(tfluid.metrics.__all__) == set(fluid.metrics.__all__)
    assert set(tfluid.layers.extras.__all__) == set(
        fluid.layers.extras.__all__)


def _build(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        x = pkg.layers.data("x", shape=[4])
        h = pkg.layers.fc(x, size=3)
        as_int = h.astype("int32")
        loss = pkg.layers.mean(h)
        pkg.optimizer.Adam(0.1).minimize(loss)
    return main, startup, x, h, as_int, loss


def test_variable_grad_name_and_astype():
    """``astype`` appends the reference's ``cast`` op; both packages run
    it on the same weights (the port's startup state) to the same ints."""
    import jax.numpy as jnp

    feed = {"x": np.random.RandomState(0).randn(2, 4).astype("float32") * 9}
    tmain, tstartup, tx, th, tint, _ = _build(tfluid)
    jmain, _, jx, jh, jint, _ = _build(fluid)
    for x, h, as_int, main in ((tx, th, tint, tmain), (jx, jh, jint, jmain)):
        assert x.grad_name == "x@GRAD" and h.grad_name == h.name + "@GRAD"
        assert str(as_int.dtype) == "int32"
        cast = [op for op in main.global_block().ops if op.type == "cast"]
        assert [op.output("Out").name for op in cast] == [as_int.name]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tstartup, scope=scope)
    jscope = fluid.Scope()
    for v in tstartup.list_vars():
        if v.persistable:
            jscope.set(v.name, jnp.asarray(scope.numpy(v.name)))
    got = exe.run(tmain, feed=feed, fetch_list=[th, tint], scope=scope)
    with fluid.scope_guard(jscope):
        want = fluid.Executor(fluid.CPUPlace()).run(
            jmain, feed=feed, fetch_list=[jh, jint])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32


def test_cpu_place_takes_a_device_id():
    assert tfluid.CPUPlace(0).device_id == 0
    assert tfluid.CPUPlace(device_id=1).torch_device().type == "cpu"
    assert tfluid.Executor(tfluid.CPUPlace(0)).device.type == "cpu"


def test_save_and_load_params_select_parameters(tmp_path):
    """``save_params`` writes the Parameters only (Adam's moments and the
    step counter stay out), as the reference's does; ``load_params`` puts
    them back over a second startup run."""
    main, startup, x, h, as_int, loss = _build(tfluid)
    jmain, _, _, _, _, _ = _build(fluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.ones((2, 4), "float32")}
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        scope = tfluid.global_scope()
        saved = {p.name: scope.numpy(p.name).copy()
                 for p in main.all_parameters()}
        path = tfluid.io.save_params(exe, str(tmp_path), main)
        with np.load(path) as f:
            names = sorted(f.files)
        assert names == sorted(p.name for p in jmain.all_parameters())
        exe.run(startup)  # clobber
        assert any(not np.array_equal(scope.numpy(n), v)
                   for n, v in saved.items())
        tfluid.io.load_params(exe, str(tmp_path), main)
        for n, v in saved.items():
            np.testing.assert_array_equal(scope.numpy(n), v)


def test_load_inference_model_file_names_and_create_paddle_predictor(
        tmp_path):
    """A model saved by ``save_inference_model`` with its files renamed
    loads through ``load_inference_model(model_filename=,
    params_filename=)``, and ``create_paddle_predictor`` serves it on the
    CPU with the executor's outputs."""
    main, startup, x, h, as_int, loss = _build(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.random.RandomState(1).randn(3, 4).astype("float32")}
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        want, = exe.run(main.clone(for_test=True), feed=feed,
                        fetch_list=[h])
        tfluid.io.save_inference_model(str(tmp_path), ["x"], [h], exe, main)
    os.rename(tmp_path / "__model__", tmp_path / "model.pkl")
    os.rename(tmp_path / "params.npz", tmp_path / "weights.npz")
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feeds, fetches = tfluid.io.load_inference_model(
            str(tmp_path), exe, model_filename="model.pkl",
            params_filename="weights.npz")
        got, = exe.run(prog, feed=feed, fetch_list=fetches)
    assert feeds == ["x"]
    np.testing.assert_array_equal(got, want)
    os.rename(tmp_path / "model.pkl", tmp_path / "__model__")
    os.rename(tmp_path / "weights.npz", tmp_path / "params.npz")
    config = tfluid.inference.AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    pred = tfluid.inference.create_paddle_predictor(config)
    assert isinstance(pred, tfluid.inference.Predictor)
    got, = pred.run(feed)
    np.testing.assert_array_equal(got, want)


def _updates(rng):
    preds = rng.uniform(0, 1, (40, 2))
    labels = rng.randint(0, 2, (40, 1))
    return {
        "Precision": [((preds[:, 1], labels), {})],
        "Recall": [((preds[:, 1], labels), {})],
        "Accuracy": [((0.5,), {"weight": 4}), ((0.75,), {"weight": 2})],
        "EditDistance": [((np.array([0.0, 2.0, 1.0]), 3), {}),
                         ((np.array([0.0]), 1), {})],
        "Auc": [((preds, labels), {}), ((preds[::-1], labels), {})],
        "ChunkEvaluator": [((7, 9, 5), {}), ((3, 2, 2), {})],
        "DetectionMAP": [((0.5,), {"weight": 2}), ((0.2,), {})],
    }


@pytest.mark.parametrize("name", sorted(_updates(np.random.RandomState(0))))
def test_metric_matches_reference(name):
    """Each streaming metric updated with the same values gives the
    reference's result, before and after ``reset``."""
    results = []
    for pkg in (tfluid, fluid):
        m = getattr(pkg.metrics, name)()
        out = []
        for args, kw in _updates(np.random.RandomState(5))[name]:
            m.update(*args, **kw)
            out.append(m.eval())
        m.reset()
        args, kw = _updates(np.random.RandomState(6))[name][0]
        m.update(*args, **kw)
        out.append(m.eval())
        results.append(out)
    assert results[0] == results[1]


def test_composite_metric_matches_reference():
    rng = np.random.RandomState(2)
    preds, labels = rng.uniform(0, 1, 30), rng.randint(0, 2, 30)
    results = []
    for pkg in (tfluid, fluid):
        c = pkg.metrics.CompositeMetric()
        c.add_metric(pkg.metrics.Precision())
        c.add_metric(pkg.metrics.Recall())
        c.update(preds, labels)
        results.append(c.eval())
    assert results[0] == results[1]
