"""The 13 op types of ``paddle_tpu/core/opimpl/nn_ops.py`` that the port
gained last (``depthwise_conv2d``, ``conv3d``, ``conv2d_transpose``,
``pool3d``, ``conv3d_transpose``, ``depthwise_conv2d_transpose``,
``group_norm``, ``lrn``, ``bilinear_interp``, ``nearest_interp``,
``im2sequence``, ``grid_sampler``, ``pixel_shuffle``) and ``pool2d``'s
adaptive form, against ``paddle_tpu`` on the CPU.

Each case is a raw op over fed inputs (filters, scales and biases fed,
so both packages see the same numbers) built in both packages on seeded
numpy inputs; it fetches every output and, for the float inputs, the
gradient of sum(out * c) for a fed random cotangent c. Tolerances as in
``test_torch_misc_ops.py``: rtol 1e-5 and atol 1e-6 times the
reference's largest magnitude. The transposed convs (``F.conv_transpose*d``
in the port, a fractionally strided ``lax`` conv in the reference) run
with groups, dilation and depthwise; the interpolations shrink and grow
in both modes, with and without ``align_corners`` (the reference's
``jax.image.resize`` anti-aliases a shrink); ``grid_sampler``'s grid
reaches past the image, where the corners are clamped."""

import numpy as np
import pytest

from test_torch_misc_ops import assert_matches, raw
from test_torch_optimizers import fresh_port_programs  # noqa: F401


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    return {
        "x4": f(2, 4, 6, 6), "wdw": f(4, 1, 3, 3),
        "v": f(1, 2, 5, 6, 6), "w3": f(4, 2, 3, 3, 3),
        "w3g": f(4, 1, 3, 3, 3),
        "t": f(2, 4, 5, 5), "wt": f(4, 3, 4, 4), "wtg": f(4, 3, 3, 3),
        "td": f(2, 3, 4, 4), "wtd": f(3, 1, 3, 3),
        "tv": f(1, 4, 3, 4, 4), "wt3": f(4, 2, 3, 3, 3),
        "p3": f(2, 3, 5, 6, 7), "p3d": f(1, 2, 4, 6, 6),
        "gn": f(2, 6, 4, 4), "s6": f(6), "b6": f(6),
        "lrn": f(2, 7, 4, 4),
        "img": f(2, 3, 8, 8), "img3": f(2, 3, 3, 3),
        "seq": f(2, 3, 5, 6), "gs": f(2, 3, 5, 6),
        "grid": rng.uniform(-1.2, 1.2, (2, 4, 3, 2)).astype("float32"),
        "ps": f(2, 8, 3, 3), "ap": f(2, 3, 6, 6),
    }


def _op(op_type, ins, shape, attrs=None, slot="Output"):
    return lambda pkg, v: raw(pkg, op_type, {k: v[n] for k, n in ins},
                              {slot: [("float32", shape)]}, attrs)


def _conv(op_type, x, w, shape, **attrs):
    return _op(op_type, [("Input", x), ("Filter", w)], shape, attrs)


def _interp(op_type, x, shape, out_h, out_w, align=True):
    return _op(op_type, [("X", x)], shape,
               {"out_h": out_h, "out_w": out_w, "align_corners": align},
               slot="Out")


def _pool3d(shape, **attrs):
    return _op("pool3d", [("X", "p3")], shape, attrs, slot="Out")


# case -> (float inputs differentiated, build(pkg, v))
CASES = {
    "depthwise_conv2d": (["x4", "wdw"], _conv(
        "depthwise_conv2d", "x4", "wdw", (2, 4, 3, 3), strides=[2, 2],
        paddings=[1, 1])),
    "conv3d": (["v", "w3"], _conv(
        "conv3d", "v", "w3", (1, 4, 5, 3, 3), strides=[1, 2, 2],
        paddings=[1, 1, 1])),
    "conv3d_groups": (["v", "w3g"], _conv(
        "conv3d", "v", "w3g", (1, 4, 3, 2, 2), groups=2,
        dilations=[1, 2, 2])),
    "conv2d_transpose": (["t", "wt"], _conv(
        "conv2d_transpose", "t", "wt", (2, 3, 10, 10), strides=[2, 2],
        paddings=[1, 1])),
    "conv2d_transpose_groups": (["t", "wtg"], _conv(
        "conv2d_transpose", "t", "wtg", (2, 6, 11, 11), strides=[2, 2],
        groups=2)),
    "conv2d_transpose_dilated": (["t", "wtg"], _conv(
        "conv2d_transpose", "t", "wtg", (2, 6, 7, 7), groups=2,
        dilations=[2, 2], paddings=[1, 1])),
    "depthwise_conv2d_transpose": (["td", "wtd"], _conv(
        "depthwise_conv2d_transpose", "td", "wtd", (2, 3, 9, 9),
        strides=[2, 2])),
    "conv3d_transpose": (["tv", "wt3"], _conv(
        "conv3d_transpose", "tv", "wt3", (1, 4, 5, 7, 7), strides=[2, 2, 2],
        paddings=[1, 1, 1], groups=2)),
    "pool3d_max": (["p3"], _pool3d(None, pooling_type="max",
                                   ksize=[2, 3, 3], strides=[2, 2, 2],
                                   paddings=[1, 1, 1])),
    "pool3d_avg_exclusive": (["p3"], _pool3d(None, pooling_type="avg",
                                             ksize=[3, 3, 3],
                                             strides=[2, 2, 2],
                                             paddings=[1, 1, 1])),
    "pool3d_avg_inclusive": (["p3"], _pool3d(None, pooling_type="avg",
                                             ksize=[3, 3, 3],
                                             strides=[2, 2, 2],
                                             paddings=[1, 1, 1],
                                             exclusive=False)),
    "pool3d_ceil": (["p3"], _pool3d(None, pooling_type="max",
                                    ksize=[2, 2, 2], strides=[2, 2, 2],
                                    ceil_mode=True)),
    "pool3d_avg_ceil": (["p3"], _pool3d(None, pooling_type="avg",
                                        ksize=[2, 2, 2], strides=[2, 2, 2],
                                        ceil_mode=True)),
    "pool3d_global": (["p3"], _pool3d(None, pooling_type="avg",
                                      ksize=[1, 1, 1], global_pooling=True)),
    "pool3d_adaptive": (["p3d"], _op(
        "pool3d", [("X", "p3d")], None,
        {"pooling_type": "max", "ksize": [2, 3, 2], "adaptive": True},
        slot="Out")),
    "group_norm": (["gn", "s6", "b6"], lambda pkg, v: raw(
        pkg, "group_norm", {"X": v["gn"], "Scale": v["s6"],
                            "Bias": v["b6"]},
        {"Y": [("float32", (2, 6, 4, 4))]}, {"groups": 3, "epsilon": 1e-5})),
    "lrn": (["lrn"], _op("lrn", [("X", "lrn")], (2, 7, 4, 4),
                         {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75},
                         slot="Out")),
    "bilinear_grow_aligned": (["img3"], _interp(
        "bilinear_interp", "img3", (2, 3, 7, 5), 7, 5)),
    "bilinear_shrink_aligned": (["img"], _interp(
        "bilinear_interp", "img", (2, 3, 3, 5), 3, 5)),
    "bilinear_grow": (["img3"], _interp(
        "bilinear_interp", "img3", (2, 3, 7, 5), 7, 5, align=False)),
    "bilinear_shrink": (["img"], _interp(
        "bilinear_interp", "img", (2, 3, 3, 5), 3, 5, align=False)),
    "bilinear_one_row": (["img"], _interp(
        "bilinear_interp", "img", (2, 3, 1, 6), 1, 6)),
    "nearest_grow": (["img3"], _interp(
        "nearest_interp", "img3", (2, 3, 7, 5), 7, 5)),
    "nearest_shrink": (["img"], _interp(
        "nearest_interp", "img", (2, 3, 3, 5), 3, 5, align=False)),
    "nearest_scale": (["img3"], _op(
        "nearest_interp", [("X", "img3")], (2, 3, 6, 6),
        {"out_h": 0, "out_w": 0, "scale": 2.0}, slot="Out")),
    "im2sequence": (["seq"], _op(
        "im2sequence", [("X", "seq")], None,
        {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 1, 1]},
        slot="Out")),
    "grid_sampler": (["gs", "grid"], _op(
        "grid_sampler", [("X", "gs"), ("Grid", "grid")], (2, 3, 4, 3))),
    "pixel_shuffle": (["ps"], _op("pixel_shuffle", [("X", "ps")],
                                  (2, 2, 6, 6), {"upscale_factor": 2},
                                  slot="Out")),
    "adaptive_pool2d_max": (["ap"], lambda pkg, v: [
        pkg.layers.adaptive_pool2d(v["ap"], [3, 2])]),
    "adaptive_pool2d_avg": (["ap"], lambda pkg, v: [
        pkg.layers.adaptive_pool2d(v["ap"], 3, pool_type="avg")]),
    "adaptive_pool2d_one": (["ap"], lambda pkg, v: [
        pkg.layers.adaptive_pool2d(v["ap"], 1, pool_type="avg")]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_nn_op_matches_reference(name):
    floats, build = CASES[name]
    feed = {k: a for k, a in _inputs().items() if k in floats}
    assert_matches(build, feed, floats, name)


def test_every_new_nn_op_has_a_case():
    """The port registers every op type of the reference's ``nn_ops`` but
    ``moe_ffn``, and the cases above run the 13 of this group."""
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch as tfluid
    import paddle_tpu_torch.core.op_registry as treg

    ref = {n for n, f in jreg.OP_IMPLS.items()
           if f.__module__.endswith(".nn_ops")} - {"moe_ffn"}
    assert ref <= set(treg.OP_IMPLS) and "moe_ffn" not in treg.OP_IMPLS
    group = {"depthwise_conv2d", "conv3d", "conv2d_transpose", "pool3d",
             "conv3d_transpose", "depthwise_conv2d_transpose", "group_norm",
             "lrn", "bilinear_interp", "nearest_interp", "im2sequence",
             "grid_sampler", "pixel_shuffle"}
    assert group <= ref
    seen = set()
    inputs = _inputs()
    for floats, build in CASES.values():
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            v = {k: tfluid.layers.data(k, shape=list(inputs[k].shape),
                                       append_batch_size=False)
                 for k in floats}
            build(tfluid, v)
        seen |= {op.type for op in main.global_block().ops}
    assert group <= seen, sorted(group - seen)
