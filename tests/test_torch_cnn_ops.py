"""The ops of the ResNet-50 slice against ``paddle_tpu``'s on the CPU:
``conv2d``, ``pool2d`` (max 3/2/1, global max and average, padded and
ceil-mode averages), ``batch_norm`` (training and test), ``top_k``,
``accuracy`` and ``softmax_with_cross_entropy``, each built in both
packages, initialised by the JAX package and carried across with
``bridge``. Tolerance atol 1e-5 / rtol 1e-5 (f32, single ops). The whole
slice is in ``test_torch_resnet.py``."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.layers import metric_op as jmetric
from paddle_tpu_torch.core import unique_name as t_unique_name

OP_TOL = dict(atol=1e-5, rtol=1e-5)



def _run_both(build, feed):
    """Build ``build(pkg, layers, metric)`` -> fetch vars in both packages,
    initialise with the JAX package, carry the weights across, run each
    once on the CPU; returns (want, got)."""
    outs = []
    params = None
    for pkg in (fluid, tfluid):
        gen_mod = fluid.unique_name if pkg is fluid else t_unique_name
        old = gen_mod.switch()
        main, startup = pkg.Program(), pkg.Program()
        try:
            with pkg.program_guard(main, startup):
                metric = jmetric if pkg is fluid else tfluid.layers.metric_op
                fetch = build(pkg, pkg.layers, metric)
        finally:
            gen_mod.switch(old)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            if pkg is fluid:
                params = {p.name: np.asarray(scope.get(p.name))
                          for p in main.all_parameters()}
            else:
                tfluid.bridge.load_program_params(scope, params, main, "cpu")
            outs.append(exe.run(main, feed=feed, fetch_list=fetch))
    return outs


def _img(rng, n=2, c=4, hw=8):
    return {"x": rng.randn(n, c, hw, hw).astype("f4")}


def _x(layers, c=4, hw=8):
    return layers.data("x", shape=[c, hw, hw], dtype="float32")


@pytest.mark.parametrize("kw", [
    dict(num_filters=6, filter_size=3, stride=2, padding=1),
    dict(num_filters=6, filter_size=1, bias_attr=False, act="relu"),
    dict(num_filters=4, filter_size=3, padding=1, groups=2),
    dict(num_filters=6, filter_size=3, padding=2, dilation=2),
])
def test_conv2d_op_matches_jax(rng, kw):
    want, got = _run_both(lambda pkg, L, M: [L.conv2d(_x(L), **kw)],
                          _img(rng))
    np.testing.assert_allclose(got[0], want[0], **OP_TOL)


@pytest.mark.parametrize("kw", [
    dict(pool_size=3, pool_stride=2, pool_padding=1, pool_type="max"),
    dict(pool_type="avg", global_pooling=True),
    dict(pool_type="max", global_pooling=True),
    dict(pool_size=3, pool_stride=2, pool_padding=1, pool_type="avg"),
    dict(pool_size=3, pool_stride=2, pool_padding=1, pool_type="avg",
         exclusive=False),
    dict(pool_size=2, pool_stride=2, pool_type="avg", ceil_mode=True),
])
def test_pool2d_op_matches_jax(rng, kw):
    feed = {"x": rng.randn(2, 4, 7, 7).astype("f4")}
    want, got = _run_both(
        lambda pkg, L, M: [L.pool2d(_x(L, hw=7), **kw)], feed)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], **OP_TOL)


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_op_matches_jax(rng, is_test):
    def build(pkg, L, M):
        y = L.batch_norm(_x(L), is_test=is_test, act="relu")
        gb = pkg.default_main_program().global_block()
        bn = [op for op in gb.ops if op.type == "batch_norm"][0]
        return [y, bn.output("MeanOut"), bn.output("VarianceOut")]

    feed = {"x": (rng.randn(2, 4, 8, 8) * 2 + 1).astype("f4")}
    want, got = _run_both(build, feed)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o, w, **OP_TOL)


def test_top_k_and_accuracy_ops_match_jax(rng):
    def build(pkg, L, M):
        x = L.data("x", shape=[10], dtype="float32")
        label = L.data("label", shape=[1], dtype="int32")
        vals, idx = L.topk(x, 3)
        return [vals, idx, M.accuracy(x, label, k=2),
                M.accuracy(x, label, k=1)]

    feed = {"x": rng.randn(6, 10).astype("f4"),
            "label": rng.randint(0, 10, (6, 1)).astype("i4")}
    feed["label"][:3, 0] = np.argsort(-feed["x"][:3], axis=1)[:, 1]
    want, got = _run_both(build, feed)
    assert got[1].dtype == np.int32
    for w, o in zip(want, got):
        np.testing.assert_allclose(o, w, **OP_TOL)


def test_softmax_with_cross_entropy_op_matches_jax(rng):
    def build(pkg, L, M):
        logits = L.data("logits", shape=[7], dtype="float32")
        label = L.data("label", shape=[1], dtype="int32")
        loss, sm = L.softmax_with_cross_entropy(logits, label,
                                                return_softmax=True)
        return [loss, sm]

    feed = {"logits": (rng.randn(5, 7) * 3).astype("f4"),
            "label": rng.randint(0, 7, (5, 1)).astype("i4")}
    want, got = _run_both(build, feed)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o, w, **OP_TOL)
