"""The tensor and math ops and layers of the port (``tensor_ops.py``,
``math_ops.py``, ``layers/tensor.py``, ``layers/ops.py``, the basics of
``layers/nn.py`` and the ``Variable`` operators of
``layers/math_op_patch.py``) against ``paddle_tpu`` on the CPU, one case
per op type or layer.

Each case builds the same program in both packages (by its layer, or by
the raw op where the reference has no layer or a broken one: its
``unstack`` layer calls its own ``range`` layer for the builtin) on the
same numpy inputs (seed 0), and fetches every output and the gradient of
sum(out * c) (c a fed random cotangent) w.r.t. every float input the op
differentiates: they agree within rtol 1e-5 / atol 1e-6 (the same f32
formulas in two libraries), integer and bool outputs exactly. The random
ops draw from different generators in the two packages, so their
outputs are held to the same statistics: shape, dtype, range and mean
and standard deviation over 40,000 draws within 5 standard errors of
the reference's."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    return {
        "x": f(3, 4), "y": f(3, 4), "z": f(4, 5), "w": f(3, 4),
        "pos": rng.uniform(0.5, 2.0, (3, 4)).astype("float32"),
        "row": f(1, 4), "t": f(2, 3, 4), "img": f(2, 4, 3, 3),
        "big": f(6, 5), "ids": rng.randint(0, 5, (4, 1)).astype("int64"),
        "idx": np.array([2, 0, 2, 1], "int64"),
        "nd_idx": np.array([[0, 1], [2, 3], [1, 0], [0, 3]], "int64"),
        "inf": np.array([[1.0, np.inf], [0.5, 2.0]], "float32"),
    }


def raw(pkg, op_type, inputs, outs, attrs):
    """A raw op of ``op_type``; ``outs``: {slot: [(dtype, shape), ...]}.
    Returns the output vars in slot order."""
    block = pkg.default_main_program().current_block()
    made = {s: [block.create_var(dtype=d, shape=sh) for d, sh in specs]
            for s, specs in outs.items()}
    block.append_op(op_type, inputs, made, attrs)
    return [v for vs in made.values() for v in vs]


def _shaped(var, shape):
    """``var`` with its declared shape set (a layer that declares none)."""
    var.shape = shape
    return var


def _ops(name, **kw):
    return lambda pkg, v: [getattr(pkg.layers, name)(v["x"], **kw)]


def _pos(name):
    return lambda pkg, v: [getattr(pkg.layers, name)(v["pos"])]


# case -> (float inputs differentiated, other inputs, build(pkg, v) ->
# output vars)
CASES = {
    # ---- tensor_ops
    "fill_constant_batch_size_like": ([], ["x"], lambda pkg, v: [
        pkg.layers.fill_constant_batch_size_like(v["x"], [-1, 2], "float32",
                                                 2.5)]),
    "expand": (["x"], [], lambda pkg, v: [pkg.layers.expand(v["x"],
                                                            [2, 1])]),
    "expand_as": (["row"], ["x"], lambda pkg, v: [
        pkg.layers.expand_as(v["row"], v["x"])]),
    "one_hot": ([], ["ids"], lambda pkg, v: [pkg.layers.one_hot(v["ids"],
                                                                5)]),
    "fill_zeros_like": ([], ["x"], lambda pkg, v: [
        pkg.layers.zeros_like(v["x"])]),
    "flatten": (["t"], [], lambda pkg, v: [pkg.layers.flatten(v["t"],
                                                              axis=2)]),
    "flatten2": (["t"], [], lambda pkg, v: raw(
        pkg, "flatten2", {"X": v["t"]}, {"Out": [("float32", (2, 12))]},
        {"axis": 1})),
    "gather": (["z"], ["idx"], lambda pkg, v: [pkg.layers.gather(
        v["z"], v["idx"])]),
    "gather_nd": (["t"], ["nd_idx"], lambda pkg, v: [_shaped(
        pkg.layers.gather_nd(pkg.layers.transpose(v["t"], [0, 2, 1]),
                             v["nd_idx"]), (4, 3))]),
    "pad": (["x"], [], lambda pkg, v: [pkg.layers.pad(
        v["x"], [1, 0, 0, 2], pad_value=0.5)]),
    "pad2d_constant": (["img"], [], lambda pkg, v: [pkg.layers.pad2d(
        v["img"], [1, 0, 2, 1], pad_value=-1.0)]),
    "pad2d_reflect": (["img"], [], lambda pkg, v: [pkg.layers.pad2d(
        v["img"], [1, 2, 2, 1], mode="reflect")]),
    "pad2d_edge": (["img"], [], lambda pkg, v: [pkg.layers.pad2d(
        v["img"], [2, 0, 0, 1], mode="edge")]),
    "reverse": (["t"], [], lambda pkg, v: [pkg.layers.reverse(v["t"],
                                                              [0, 2])]),
    "roll": (["x"], [], lambda pkg, v: raw(
        pkg, "roll", {"X": v["x"]}, {"Out": [("float32", (3, 4))]},
        {"shifts": [1, -2], "axis": [0, 1]})),
    "shape": ([], ["t"], lambda pkg, v: [pkg.layers.shape(v["t"])]),
    "split_sections": (["x"], [], lambda pkg, v: pkg.layers.split(
        v["x"], [1, 3], dim=1)),
    "split_num": (["big"], [], lambda pkg, v: pkg.layers.split(
        v["big"], 3, dim=0)),
    "stack": (["x", "y"], [], lambda pkg, v: [pkg.layers.stack(
        [v["x"], v["y"]], axis=1)]),
    "unstack": (["t"], [], lambda pkg, v: (
        pkg.layers.unstack(v["t"], axis=1) if pkg is tfluid else raw(
            pkg, "unstack", {"X": v["t"]},
            {"Y": [("float32", (2, 4))] * 3}, {"axis": 1}))),
    "strided_slice": (["big"], [], lambda pkg, v: [_shaped(
        pkg.layers.strided_slice(v["big"], [0, 1], [5, 0], [0, 5], [-2, 2]),
        (3, 3))]),
    "transpose": (["t"], [], lambda pkg, v: [pkg.layers.transpose(
        v["t"], [2, 0, 1])]),
    "transpose2": (["t"], [], lambda pkg, v: raw(
        pkg, "transpose2", {"X": v["t"]}, {"Out": [("float32", (3, 2, 4))]},
        {"axis": [1, 0, 2]})),
    "where": (["x", "y"], ["w"], lambda pkg, v: [pkg.layers.where(
        pkg.layers.less_than(v["w"], v["x"]), v["x"], v["y"])]),
    # ---- math_ops: the generated unaries
    "abs": (["x"], [], _ops("abs")),
    "ceil": (["x"], [], _ops("ceil")),
    "floor": (["x"], [], _ops("floor")),
    "round": (["x"], [], _ops("round")),
    "cos": (["x"], [], _ops("cos")),
    "sin": (["x"], [], _ops("sin")),
    "exp": (["x"], [], _ops("exp")),
    "log": (["pos"], [], _pos("log")),
    "reciprocal": (["pos"], [], _pos("reciprocal")),
    "rsqrt": (["pos"], [], _pos("rsqrt")),
    "square": (["x"], [], _ops("square")),
    "softplus": (["x"], [], _ops("softplus")),
    "softsign": (["x"], [], _ops("softsign")),
    "logsigmoid": (["x"], [], _ops("logsigmoid")),
    "tanh_shrink": (["x"], [], _ops("tanh_shrink")),
    "erf": (["x"], [], _ops("erf")),
    "hard_shrink": (["x"], [], _ops("hard_shrink")),
    "soft_shrink": (["x"], [], _ops("soft_shrink")),
    "thresholded_relu": (["x"], [], _ops("thresholded_relu")),
    # the activations with attributes
    "elu": (["x"], [], _ops("elu", alpha=0.7)),
    "leaky_relu": (["x"], [], _ops("leaky_relu", alpha=0.1)),
    "relu6": (["x"], [], lambda pkg, v: [pkg.layers.relu6(
        pkg.layers.scale(v["x"], 4.0), threshold=5.0)]),
    "swish": (["x"], [], _ops("swish", beta=1.5)),
    "hard_sigmoid": (["x"], [], _ops("hard_sigmoid", slope=0.3)),
    "brelu": (["x"], [], _ops("brelu", t_min=-0.5, t_max=0.8)),
    "stanh": (["x"], [], _ops("stanh", scale_a=0.5, scale_b=2.0)),
    "maxout": (["img"], [], lambda pkg, v: [pkg.layers.maxout(v["img"],
                                                              2)]),
    "prelu": (["img"], [], lambda pkg, v: [pkg.layers.prelu(
        v["img"], mode="channel")]),
    # reductions, search, scans
    "reduce_mean": (["t"], [], lambda pkg, v: [pkg.layers.reduce_mean(
        v["t"], dim=[0, 2])]),
    "reduce_max": (["t"], [], lambda pkg, v: [pkg.layers.reduce_max(
        v["t"], dim=1, keep_dim=True)]),
    "reduce_min": (["t"], [], lambda pkg, v: [pkg.layers.reduce_min(
        v["t"])]),
    "reduce_prod": (["pos"], [], lambda pkg, v: [pkg.layers.reduce_prod(
        v["pos"], dim=[1])]),
    "argmax": ([], ["x"], lambda pkg, v: [pkg.layers.argmax(v["x"],
                                                            axis=1)]),
    "argmin": ([], ["t"], lambda pkg, v: [pkg.layers.argmin(v["t"],
                                                            axis=0)]),
    "argsort": (["x"], [], lambda pkg, v: list(pkg.layers.argsort(
        v["x"], axis=0))),
    "cumsum": (["x"], [], lambda pkg, v: [pkg.layers.cumsum(
        v["x"], axis=1, exclusive=True, reverse=True)]),
    "norm": (["x"], [], lambda pkg, v: [pkg.layers.l2_normalize(v["x"],
                                                                axis=1)]),
    "isfinite": ([], ["inf", "x"], lambda pkg, v: [
        pkg.layers.isfinite(v["inf"]), pkg.layers.isfinite(v["x"]),
        pkg.layers.has_inf(v["inf"])]),
    # layers over ops the port had before
    "layer_relu": (["x"], [], _ops("relu")),
    "layer_gelu": (["x"], [], _ops("gelu")),
    "layer_mul": (["t", "z"], [], lambda pkg, v: [pkg.layers.mul(
        v["t"], v["z"], x_num_col_dims=2)]),
    "layer_matmul": (["x", "y"], [], lambda pkg, v: [pkg.layers.matmul(
        v["x"], v["y"], transpose_y=True, alpha=0.5)]),
    "layer_clip": (["x"], [], _ops("clip", min=-0.5, max=0.7)),
    "layer_clip_by_norm": (["x"], [], _ops("clip_by_norm",
                                           max_norm=1.0)),
    "layer_cos_sim": (["x", "y"], [], lambda pkg, v: [pkg.layers.cos_sim(
        v["x"], v["y"])]),
    "layer_scatter": (["z", "big"], [], lambda pkg, v: [pkg.layers.scatter(
        v["big"], pkg.layers.assign(np.array([4, 1, 3, 0], "int64")),
        v["z"])]),
    "layer_consts": ([], ["x"], lambda pkg, v: [
        pkg.layers.zeros([2, 3], "float32"), pkg.layers.ones([3], "int64"),
        pkg.layers.ones_like(v["x"]),
        pkg.layers.linspace(0.0, 1.0, 5)]),
    "layer_sums": (["x", "y", "w"], [], lambda pkg, v: [pkg.layers.sums(
        [v["x"], v["y"], v["w"]])]),
    # the Variable operators
    "var_arith": (["x", "y"], [], lambda pkg, v: [
        v["x"] + v["y"], 2.0 - v["x"], v["y"] * 3.0, v["x"] / v["y"],
        1.5 / v["y"], -v["x"], v["x"] ** 2.0, 0.5 + v["y"]]),
    "var_compare": ([], ["x", "y"], lambda pkg, v: [
        v["x"] < v["y"], v["x"] <= 0.1, v["x"] > v["y"], v["y"] >= -0.2]),
}

def _run(pkg, name, feed):
    floats, _, build = CASES[name]
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        v = {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False) for k, a in feed.items()}
        outs = build(pkg, v)
        terms, cots = [], {}
        for i, o in enumerate(outs):
            if str(o.dtype) != "float32" or not floats:
                continue
            c = L.data("cot%d" % i, shape=list(o.shape), dtype="float32",
                       append_batch_size=False)
            cots[c.name] = np.asarray(np.random.RandomState(i).randn(
                *o.shape), "float32")
            terms.append(L.reduce_sum(L.elementwise_mul(o, c)))
        grads = []
        if terms:
            total = terms[0] if len(terms) == 1 else L.sums(terms)
            grads = pkg.gradients(total, [v[k] for k in floats])
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        return exe.run(main, feed=dict(feed, **cots),
                       fetch_list=list(outs) + list(grads))


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(name):
    floats, others, _ = CASES[name]
    feed = {k: a for k, a in _inputs().items() if k in floats + others}
    want = _run(fluid, name, feed)
    got = _run(tfluid, name, feed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if w.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind, (name, i)
            np.testing.assert_array_equal(g, w, err_msg="%s %d" % (name, i))
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg="%s %d" % (name, i))


# the 63 op types of the reference's tensor_ops.py and math_ops.py that
# this slice of the port added
NEW_OPS = (
    "expand", "expand_as", "fill_constant_batch_size_like",
    "fill_zeros_like", "flatten", "flatten2", "gather", "gather_nd",
    "gaussian_random_batch_size_like", "one_hot", "pad", "pad2d", "randint",
    "reverse", "roll", "shape", "split", "stack", "strided_slice",
    "transpose", "transpose2", "truncated_gaussian_random",
    "uniform_random_batch_size_like", "unstack", "where",
    "abs", "argmax", "argmin", "argsort", "brelu", "ceil", "cos", "cumsum",
    "elu", "erf", "exp", "floor", "hard_shrink", "hard_sigmoid", "isfinite",
    "leaky_relu", "log", "logsigmoid", "maxout", "norm", "prelu",
    "reciprocal", "reduce_max", "reduce_mean", "reduce_min", "reduce_prod",
    "relu6", "round", "rsqrt", "sin", "soft_shrink", "softplus", "softsign",
    "square", "stanh", "swish", "tanh_shrink", "thresholded_relu")


def test_every_tensor_and_math_op_has_a_case():
    """The reference's tensor and math op types are all registered in the
    port, and each one this slice added appears in some case's program."""
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch.core.op_registry as treg

    ops = {n for n, f in jreg.OP_IMPLS.items()
           if f.__module__.endswith((".tensor_ops", ".math_ops"))}
    assert len(set(NEW_OPS)) == 63 and set(NEW_OPS) <= ops
    assert ops <= set(treg.OP_IMPLS)
    seen = set(RANDOM)
    for name in CASES:
        floats, others, build = CASES[name]
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            v = {k: tfluid.layers.data(k, shape=list(a.shape),
                                       dtype=str(a.dtype),
                                       append_batch_size=False)
                 for k, a in _inputs().items() if k in floats + others}
            build(tfluid, v)
        seen |= {op.type for op in main.global_block().ops}
    assert set(NEW_OPS) - seen == set()


# random ops: (build(pkg) -> var, check(a) on its values)
N_DRAW = (200, 200)


def _batch_ref(pkg):
    return pkg.layers.data("ref", shape=[200, 3], dtype="float32",
                           append_batch_size=False)


RANDOM = {
    "uniform_random_batch_size_like": lambda pkg: (
        pkg.layers.uniform_random_batch_size_like(
            _batch_ref(pkg), [-1, 200], min=-2.0, max=3.0), (-2.0, 3.0)),
    "gaussian_random_batch_size_like": lambda pkg: (
        pkg.layers.gaussian_random_batch_size_like(
            _batch_ref(pkg), [-1, 200], mean=1.0, std=2.0), None),
    "truncated_gaussian_random": lambda pkg: (raw(
        pkg, "truncated_gaussian_random", {},
        {"Out": [("float32", N_DRAW)]},
        {"shape": N_DRAW, "mean": 0.5, "std": 2.0})[0], (-3.5, 4.5)),
    "randint": lambda pkg: (raw(
        pkg, "randint", {}, {"Out": [("int64", N_DRAW)]},
        {"shape": N_DRAW, "low": -3, "high": 7})[0], (-3, 6)),
}


def _draw(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 7
    with pkg.program_guard(main, startup):
        out, bounds = RANDOM[name](pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        got, = exe.run(main, feed={"ref": np.zeros((200, 3), "float32")},
                       fetch_list=[out])
    return np.asarray(got), bounds


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_op_statistics(name):
    got, bounds = _draw(tfluid, name)
    want, _ = _draw(fluid, name)
    assert got.shape == want.shape == N_DRAW
    assert got.dtype == want.dtype
    if bounds is not None:
        assert got.min() >= bounds[0] and got.max() <= bounds[1]
        assert want.min() >= bounds[0] and want.max() <= bounds[1]
    if name == "randint":  # every value of the range drawn
        assert set(np.unique(got)) == set(np.unique(want)) == set(
            range(-3, 7))
    n = got.size
    se = want.std() / np.sqrt(n)
    assert abs(got.mean() - want.mean()) < 5 * np.sqrt(2) * se, name
    # the standard deviation's standard error is about std / sqrt(2n)
    assert abs(got.std() / want.std() - 1) < 5 * np.sqrt(2) / np.sqrt(2 * n)
