"""QAT and slim in the port (``contrib/quantize``, ``contrib/slim``, the
four fake-quant ops) against ``paddle_tpu`` on the CPU.

Twins of ``tests/test_quantize.py``, each holding the port to the
reference: the fake-quant ops ``training_transpile`` inserts and their
order; 15 Adam steps of the QAT network from the reference's weights
(losses within rtol 1e-4: a fake-quant rounds to a 255-level grid, so the
f32 noise of two summation orders moves a value across a rounding edge
only rarely); ``freeze_program`` puts the weights on the int8 grid, as
the reference's frozen ones (atol 1e-4), and drops the weight quant ops;
the int8 export round-trips, and loads in the reference (and the
reference's in the port) to the same weights; pruning and the
distillation loss. Beyond them: each fake-quant op's output and its
straight-through gradient against the reference's, the moving-average
state's update, int8 serving through ``Predictor``, and the epilogue
fusion's decisions on QAT conv -> BN programs (a bottleneck block and
ResNet-50 at 32 x 32), which equal the reference's site for site."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu.contrib.quantize import QuantizeTranspiler as JQT
from paddle_tpu.contrib.slim import Pruner as JPruner
from paddle_tpu.contrib.slim import soft_label_loss as j_soft_label_loss
from paddle_tpu.core import epilogue_fusion as jef
from paddle_tpu.core import op_registry as jreg
from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler as TQT
from paddle_tpu_torch.contrib.slim import Pruner as TPruner
from paddle_tpu_torch.contrib.slim import soft_label_loss as t_soft_label_loss
from paddle_tpu_torch.core import epilogue_fusion as tef
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import op_registry as treg
from paddle_tpu_torch.core import unique_name as t_unique_name

STEP_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


def _net(pkg):
    img = pkg.layers.data("img", shape=[1, 8, 8])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    x = pkg.layers.conv2d(img, num_filters=4, filter_size=3, act="relu",
                          name="qconv")
    x = pkg.layers.pool2d(x, pool_size=2, pool_stride=2)
    logits = pkg.layers.fc(x, size=3, name="qfc")
    loss = pkg.layers.mean(
        pkg.layers.softmax_with_cross_entropy(logits, label))
    return logits, loss


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 1, 8, 8).astype("f4"),
            rng.randint(0, 3, (16, 1)).astype("int64"))


def _qat_run(pkg, qt_cls, params=None, steps=15):
    """Build, transpile, train ``steps`` Adam steps, freeze a pruned eval
    clone. Returns a dict of what the twins compare."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 31
    scope = pkg.Scope()
    xs, ys = _data()
    with pkg.program_guard(main, startup), pkg.scope_guard(scope):
        logits, loss = _net(pkg)
        qt = qt_cls()
        qt.training_transpile(main, startup)
        types = [op.type for op in main.global_block().ops]
        pkg.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        names = [p.name for p in main.all_parameters()]
        if params is None:
            params = {n: np.array(scope.get(n)) for n in names}
        else:
            pkg.bridge.load_program_params(scope, params, main, "cpu")
        losses = [float(exe.run(main, feed={"img": xs, "label": ys},
                                fetch_list=[loss])[0]) for _ in range(steps)]
        trained = {n: np.array(scope.numpy(n)) for n in names}
        states = {n: float(np.asarray(scope.numpy(n)))
                  for n in scope.var_names() if n.endswith(".quant_state")}
        infer = main.clone(for_test=True)
        infer = infer.prune([infer.global_block().var(logits.name)])
        qt.freeze_program(infer, scope=scope)
        itypes = [op.type for op in infer.global_block().ops]
        frozen = {n: np.array(scope.numpy(n)) for n in names}
        out, = exe.run(infer, feed={"img": xs}, fetch_list=[logits])
        bundle = qt.convert_to_int8(main, scope=scope)
    return dict(types=types, params=params, losses=losses, trained=trained,
                states=states, itypes=itypes, frozen=frozen, out=out,
                bundle=bundle, qt=qt, scope=scope, infer=infer,
                logits=logits)


@pytest.fixture(scope="module")
def qat_runs():
    fluid.unique_name.switch()
    j = _qat_run(fluid, JQT)
    t_unique_name.switch()
    t = _qat_run(tfluid, TQT, params=j["params"])
    return j, t


def test_qat_train_freeze_int8(qat_runs):
    j, t = qat_runs
    # the inserted ops and their order
    assert t["types"] == j["types"]
    assert t["types"].count("fake_channel_wise_quantize_abs_max") == 2
    assert t["types"].count("fake_quantize_moving_average_abs_max") == 2
    # 15 QAT steps from one state
    assert t["losses"][-1] < t["losses"][0] and np.isfinite(t["losses"]).all()
    np.testing.assert_allclose(t["losses"], j["losses"], **STEP_TOL)
    for n in j["states"]:
        np.testing.assert_allclose(t["states"][n], j["states"][n],
                                   rtol=1e-5, err_msg=n)
    # freeze: weights on the int8 grid, the weight quant ops gone
    assert t["itypes"] == j["itypes"]
    assert "fake_channel_wise_quantize_abs_max" not in t["itypes"]
    w = t["frozen"]["qconv.w_0_0"]
    scale = np.max(np.abs(w), axis=(1, 2, 3), keepdims=True)
    grid = w / np.maximum(scale, 1e-8) * 127.0
    np.testing.assert_allclose(grid, np.round(grid), atol=1e-3)
    for n, v in j["frozen"].items():
        np.testing.assert_allclose(t["frozen"][n], v, atol=1e-4, err_msg=n)
    assert np.isfinite(t["out"]).all()
    np.testing.assert_allclose(t["out"], j["out"], atol=1e-3, rtol=1e-3)
    # int8 export within one quantization step
    i8, scales = t["bundle"]["qconv.w_0_0"]
    assert i8.dtype == np.int8
    deq = i8.astype("f4") * scales.reshape(-1, 1, 1, 1) / 127.0
    np.testing.assert_allclose(deq, w, atol=np.max(scales) / 127.0 + 1e-6)
    ji8, _ = j["bundle"]["qconv.w_0_0"]
    assert np.abs(i8.astype(int) - ji8.astype(int)).max() <= 1


def test_int8_export_round_trips_across_packages(qat_runs, tmp_path):
    """The port's export loads back onto its frozen weights exactly, in
    the port and in the reference; the reference's export loads in the
    port as the reference loads it."""
    from paddle_tpu.contrib.quantize import load_int8_params as j_load
    from paddle_tpu_torch.contrib.quantize import load_int8_params as t_load

    j, t = qat_runs
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    t["qt"].export_int8(tdir, scope=t["scope"])
    j["qt"].export_int8(jdir, scope=j["scope"])
    for d, want in ((tdir, t["frozen"]), (jdir, j["frozen"])):
        tscope, jscope = tfluid.Scope(), fluid.Scope()
        got_t = t_load(d, tscope, require=True, device="cpu")
        got_j = j_load(d, jscope, require=True)
        assert sorted(got_t) == sorted(got_j) == ["qconv.w_0_0", "qfc.w_0_0"]
        for n in got_t:
            a = tscope.get(n).numpy()
            np.testing.assert_array_equal(a, np.asarray(jscope.get(n)))
            np.testing.assert_allclose(a, want[n], atol=1e-6)
    assert t_load(str(tmp_path / "none"), tfluid.Scope()) == []
    with pytest.raises(ValueError):
        t_load(str(tmp_path / "none"), tfluid.Scope(), require=True)


def test_int8_serving_through_the_predictor(qat_runs, tmp_path):
    """``save_inference_model`` of the frozen clone plus the int8 export:
    ``Predictor`` on the CPU detects the export (``int8``) and answers as
    the frozen program."""
    _, t = qat_runs
    d = str(tmp_path / "m")
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(t["scope"]):
        tfluid.io.save_inference_model(d, ["img"], [t["logits"]], exe,
                                       main_program=t["infer"])
    t["qt"].export_int8(d, scope=t["scope"])
    cfg = tfluid.inference.AnalysisConfig(d)
    cfg.disable_gpu()
    pred = tfluid.inference.Predictor(cfg)
    assert pred.int8
    out, = pred.run({"img": _data()[0]})
    np.testing.assert_allclose(np.asarray(out), t["out"], atol=1e-5)


def test_pruner_and_distill_loss():
    xs = np.random.RandomState(0).randn(4, 16).astype("f4")
    res = []
    for pkg, loss_fn, pruner in ((fluid, j_soft_label_loss, JPruner),
                                 (tfluid, t_soft_label_loss, TPruner)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        scope = pkg.Scope()
        with pkg.program_guard(main, startup), pkg.scope_guard(scope):
            x = pkg.layers.data("x", shape=[16])
            s_logits = pkg.layers.fc(x, size=4, name="student")
            t_logits = pkg.layers.fc(x, size=4, name="teacher")
            dloss = loss_fn(s_logits, t_logits, temperature=3.0)
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            if res:  # the reference's weights
                pkg.bridge.load_program_params(scope, res[0]["w"], main,
                                               "cpu")
            w = {p.name: np.array(scope.numpy(p.name))
                 for p in main.all_parameters()}
            v, = exe.run(main, feed={"x": xs}, fetch_list=[dloss])
            before = np.array(scope.numpy("student.w_0_0"))
            masks = pruner({"student.w_0_0": 0.5}).prune(scope)
            after = np.array(scope.numpy("student.w_0_0"))
            res.append(dict(w=w, v=float(v), before=before, after=after,
                            mask=masks["student.w_0_0"]))
    j, t = res
    assert np.isfinite(t["v"]) and t["v"] > 0
    np.testing.assert_allclose(t["v"], j["v"], rtol=1e-5)
    frac = float((t["after"] == 0).mean())
    assert 0.4 <= frac <= 0.6, frac
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_array_equal(t["after"], j["after"])
    assert t["mask"].shape == t["before"].shape


# -- the four ops -------------------------------------------------------------

QUANT_OPS = {
    "fake_quantize_abs_max": ({"bit_length": 8}, False),
    "fake_quantize_abs_max_4bit": ({"bit_length": 4}, False),
    "fake_channel_wise_quantize_abs_max": ({"bit_length": 8,
                                            "quant_axis": 0}, False),
    "fake_channel_wise_quantize_abs_max_axis1": ({"bit_length": 8,
                                                  "quant_axis": 1}, False),
    "fake_quantize_moving_average_abs_max": ({"bit_length": 8,
                                              "moving_rate": 0.9}, True),
    "fake_quantize_moving_average_abs_max_seeded": (
        {"bit_length": 8, "moving_rate": 0.9}, True),
    "fake_quantize_moving_average_abs_max_is_test": (
        {"bit_length": 8, "moving_rate": 0.9, "is_test": True}, True),
}


class _Var:
    def __init__(self, name):
        self.name = name


class _Op:
    def __init__(self, type, inputs, outputs, attrs):
        self.type, self.attrs = type, attrs
        self._in = {k: _Var(v) for k, v in inputs.items()}
        self._out = {k: _Var(v) for k, v in outputs.items()}

    def input(self, slot):
        return self._in.get(slot)

    def output(self, slot):
        return self._out.get(slot)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


@pytest.mark.parametrize("case", sorted(QUANT_OPS))
def test_fake_quant_op_matches_reference(case, rng):
    """Out, OutScale and the straight-through gradient of X (the
    identity's) against the reference op on the same input."""
    import jax
    import jax.numpy as jnp

    attrs, stateful = QUANT_OPS[case]
    op_type = [k for k in ("fake_quantize_moving_average_abs_max",
                           "fake_channel_wise_quantize_abs_max",
                           "fake_quantize_abs_max") if case.startswith(k)][0]
    x = (rng.randn(4, 3, 5) * 2).astype("f4")
    state = np.float32(0.0 if not case.endswith(("seeded", "is_test"))
                       else 1.5)
    ins = {"X": "x"}
    if stateful:
        ins["InScale"] = "s"
    op = _Op(op_type, ins, {"Out": "out", "OutScale": "scale"}, attrs)
    ct = rng.randn(*x.shape).astype("f4")

    def jrun(xv):
        env = {"x": xv, "s": jnp.asarray(state)}
        jreg.OP_IMPLS[op_type](env, op)
        return env["out"], env["scale"]

    (jout, jscale), vjp = jax.vjp(jrun, jnp.asarray(x))
    jgrad, = vjp((jnp.asarray(ct), jnp.zeros_like(jscale)))
    tx = torch.tensor(x, requires_grad=True)
    env = {"x": tx, "s": torch.tensor(state)}
    treg.OP_IMPLS[op_type](env, op)
    tgrad, = torch.autograd.grad(env["out"], tx, torch.tensor(ct))
    np.testing.assert_allclose(env["out"].detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    np.testing.assert_allclose(env["scale"].numpy(), np.asarray(jscale),
                               rtol=1e-6)
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(tgrad.numpy(), ct)  # straight through


def test_fake_dequantize_matches_reference(rng):
    x = rng.randint(-127, 128, (3, 4)).astype("f4")
    op = _Op("fake_dequantize_max_abs", {"X": "x", "Scale": "s"},
             {"Out": "out"}, {"bit_length": 8})
    jenv = {"x": x, "s": np.float32(0.7)}
    jreg.OP_IMPLS[op.type](jenv, op)
    tenv = {"x": torch.tensor(x), "s": torch.tensor(np.float32(0.7))}
    treg.OP_IMPLS[op.type](tenv, op)
    np.testing.assert_allclose(tenv["out"].numpy(), np.asarray(jenv["out"]),
                               rtol=1e-6)


def test_the_op_library_counts():
    """The port registers 287 of the reference's 289 op types: only A7's
    two are missing."""
    assert len(jreg.OP_IMPLS) == 289 and len(treg.OP_IMPLS) == 287
    assert set(jreg.OP_IMPLS) - set(treg.OP_IMPLS) == {
        "moe_ffn", "sharded_lookup_table"}


# -- epilogue fusion on QAT programs ------------------------------------------

def _bottleneck(pkg, qt_cls):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", shape=[8, 8, 8], dtype="float32")
        label = pkg.layers.data("label", shape=[1], dtype="int32")
        xx = pkg.layers.conv2d(img, 16, 1, bias_attr=False)
        xx = pkg.layers.batch_norm(xx, act="relu")
        y = pkg.layers.batch_norm(
            pkg.layers.conv2d(xx, 16, 3, padding=1, bias_attr=False))
        out = pkg.layers.elementwise_add(xx, y, act="relu")
        out = pkg.layers.pool2d(out, pool_type="avg", global_pooling=True)
        logits = pkg.layers.fc(out, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        qt_cls().training_transpile(main, startup)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, [loss.name]


def _resnet(pkg, qt_cls):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        models = jmodels if pkg is fluid else tfluid.models
        spec = models.resnet.resnet_imagenet(
            depth=50, class_num=10, image_shape=(3, 32, 32))
        qt_cls().training_transpile(main, startup)
        pkg.optimizer.Adam(learning_rate=1e-4).minimize(spec.loss)
    return main, [spec.loss.name]


def _names(slots):
    return sorted((s, tuple(v.name for v in vs)) for s, vs in slots.items())


def _sig(op):
    sig = (op.type, _names(op.inputs), _names(op.outputs))
    if op.type == "fused_conv2d":
        attrs = {k: v for k, v in op.attrs.items() if k != "orig_ops"}
        return sig + (sorted(attrs.items()),
                      [(o.type, _names(o.inputs)) for o in
                       op.attr("orig_ops")])
    return sig


@pytest.mark.parametrize("build,n_fused", [(_bottleneck, 2), (_resnet, 53)],
                         ids=["bottleneck", "resnet50"])
def test_qat_fusion_decisions_match_reference(build, n_fused):
    fluid.unique_name.switch()
    jmain, jfetch = build(fluid, JQT)
    t_unique_name.switch()
    tmain, tfetch = build(tfluid, TQT)
    jops, jrep = jef.fuse_ops(jmain.global_block().ops, set(jfetch))
    tops, trep = tef.fuse_ops(tmain.global_block().ops, set(tfetch))
    assert len(trep.fused) == len(jrep.fused) == n_fused
    assert [s.kinds for s in trep.fused] == [s.kinds for s in jrep.fused]
    assert [str(r.reason) for r in trep.refused] == \
        [str(r.reason) for r in jrep.refused]
    fused = [op for op in tops if op.type == "fused_conv2d"]
    # every fused conv reads its weight's fake-quant output as Filter
    assert all(op.input("Filter").name.endswith(".quantized")
               for op in fused)
    assert [_sig(op) for op in tops if op.type != "autodiff"] == \
        [_sig(op) for op in jops if op.type != "autodiff"]
