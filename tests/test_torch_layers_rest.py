"""The last ``fluid.layers`` callables of the port (``layers/nn.py``'s 15,
``layers/extras.py``'s 28, ``Print`` and ``py_func``), the four
initializers of ``core/initializer.py`` and ``clip.ErrorClipByValue``
against ``paddle_tpu`` on the CPU.

- Every new callable has the reference's signature (names, kinds and
  defaults) and appends the same op types, with the same parameter and
  output shapes and dtypes.
- The layers that make parameters run in both packages from the
  reference's startup values (``bridge``): outputs within rtol 1e-5 and
  atol 1e-6 times the largest magnitude.
- ``Bilinear`` and ``NumpyArray`` give the reference's values exactly;
  ``TruncatedNormal`` and ``MSRA`` are held by their statistics over
  40,000 draws (range, and mean and standard deviation within 5 standard
  errors of the reference's draws).
- The port registers 287 of the reference's 289 op types (not
  ``moe_ffn`` and ``sharded_lookup_table``) and
  its ``layers`` has every public name of the reference's but
  ``moe_ffn``."""

import importlib
import inspect

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import unique_name as t_unique_name
from test_torch_misc_ops import assert_close
from test_torch_optimizers import fresh_port_programs  # noqa: F401

NN_NEW = ["depthwise_conv2d", "conv3d", "conv2d_transpose",
          "adaptive_pool2d", "group_norm", "lrn", "lod_reset",
          "image_resize", "resize_bilinear", "resize_nearest",
          "grid_sampler", "pixel_shuffle", "im2sequence", "row_conv",
          "scaled_dot_product_attention"]
EXTRAS_NEW = [
    "rank_loss", "mean_iou", "multiplex", "affine_channel", "affine_grid",
    "space_to_depth", "shuffle_channel", "crop", "pad_constant_like",
    "similarity_focus", "hash", "selu", "add_position_encoding",
    "bilinear_tensor_product", "edit_distance", "spectral_norm",
    "modified_huber_loss", "teacher_student_sigmoid_loss",
    "squared_l2_distance", "unpool", "max_pool2d_with_index", "spp",
    "sequence_expand_as", "sequence_reshape", "sequence_scatter",
    "random_crop", "chunk_eval", "ctc_greedy_decoder"]
NEW = NN_NEW + EXTRAS_NEW + ["Print", "py_func"]


def test_the_port_covers_the_reference():
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch.core.op_registry as treg

    assert len(jreg.OP_IMPLS) == 289 and len(treg.OP_IMPLS) == 287
    assert set(treg.OP_IMPLS) <= set(jreg.OP_IMPLS)
    assert set(jreg.OP_IMPLS) - set(treg.OP_IMPLS) == {
        "moe_ffn", "sharded_lookup_table"}

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    assert public(fluid.layers) - public(tfluid.layers) == {"moe_ffn"}
    assert len(NEW) == 45 and set(NEW) <= public(tfluid.layers)
    assert "debug_ops" in public(tfluid.layers)
    assert public(fluid.initializer) <= public(tfluid.initializer)
    assert set(fluid.clip.__all__) == set(tfluid.clip.__all__)
    e = tfluid.clip.ErrorClipByValue(2.0)
    assert (e.max, e.min) == (2.0, -2.0)


@pytest.mark.parametrize("name", NEW)
def test_signature_matches_reference(name):
    def sig(f):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(f).parameters.values()]

    assert sig(getattr(tfluid.layers, name)) == sig(
        getattr(fluid.layers, name))


def _specs(rng):
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    return {"img": f(2, 4, 6, 6), "vol": f(1, 2, 4, 6, 6),
            "seq": f(2, 5, 8), "grid": f(2, 3, 4, 2) * 0.5,
            "v6": f(3, 6), "v5": f(3, 5),
            "ids": rng.randint(0, 4, (3, 5)).astype("int32"),
            "len": np.array([5, 3, 0], "int32")}


def _data(L, feed):
    return {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                      append_batch_size=False) for k, a in feed.items()}


# callable -> build(L, v) -> output vars, for the callables whose ops the
# op tests do not build through the layer
BUILDS = {
    "depthwise_conv2d": lambda L, v: [L.depthwise_conv2d(
        v["img"], 4, 3, padding=1, act="relu")],
    "conv3d": lambda L, v: [L.conv3d(v["vol"], 3, 3, stride=[1, 2, 2],
                                     padding=1)],
    "conv2d_transpose": lambda L, v: [L.conv2d_transpose(
        v["img"], 6, filter_size=4, stride=2, padding=1, groups=2)],
    "conv2d_transpose_output_size": lambda L, v: [L.conv2d_transpose(
        v["img"], 3, output_size=[13, 13], stride=2, bias_attr=False)],
    "adaptive_pool2d": lambda L, v: [L.adaptive_pool2d(v["img"], 3)],
    "group_norm": lambda L, v: [L.group_norm(v["img"], 2, act="relu")],
    "lrn": lambda L, v: [L.lrn(v["img"], n=3)],
    "lod_reset": lambda L, v: [L.lod_reset(v["seq"])],
    "image_resize": lambda L, v: [L.image_resize(v["img"], scale=1.5)],
    "resize_bilinear": lambda L, v: [L.resize_bilinear(
        v["img"], [4, 9], align_corners=False)],
    "resize_nearest": lambda L, v: [L.resize_nearest(v["img"], [9, 4])],
    "grid_sampler": lambda L, v: [L.grid_sampler(v["img"], v["grid"])],
    "pixel_shuffle": lambda L, v: [L.pixel_shuffle(v["img"], 2)],
    "im2sequence": lambda L, v: [L.im2sequence(v["img"], [2, 3], [2, 1],
                                               [1, 0, 1, 0])],
    "row_conv": lambda L, v: [L.row_conv(v["seq"], 2, act="tanh")],
    "scaled_dot_product_attention": lambda L, v: [
        L.scaled_dot_product_attention(v["seq"], v["seq"], v["seq"],
                                       num_heads=2)],
    "bilinear_tensor_product": lambda L, v: [L.bilinear_tensor_product(
        v["v6"], v["v5"], 4, act="sigmoid")],
    "spectral_norm": lambda L, v: [L.spectral_norm(v["img"], dim=1,
                                                   power_iters=2)],
    "Print": lambda L, v: [L.Print(v["v6"], print_phase="forward",
                                   first_n=0)],
    "edit_distance": lambda L, v: list(L.edit_distance(
        v["ids"], v["ids"], input_length=v["len"], label_length=v["len"])),
    "chunk_eval": lambda L, v: list(L.chunk_eval(
        v["ids"], v["ids"], "IOB", 2, v["len"])),
}


def _build(pkg, name, feed):
    gen = fluid.unique_name if pkg is fluid else t_unique_name
    old = gen.switch()
    main, startup = pkg.Program(), pkg.Program()
    try:
        with pkg.program_guard(main, startup):
            outs = BUILDS[name](pkg.layers, _data(pkg.layers, feed))
    finally:
        gen.switch(old)
    return main, startup, outs


def _program_facts(main, outs):
    gb = main.global_block()
    return ([op.type for op in gb.ops],
            sorted((p.name, tuple(p.shape), str(p.dtype))
                   for p in main.all_parameters()),
            [(o.name, tuple(o.shape) if o.shape is not None else None,
              str(o.dtype)) for o in outs])


@pytest.mark.parametrize("name", list(BUILDS))
def test_layer_appends_the_reference_ops(name):
    """The same ops, parameters and outputs; the layers run in both
    packages from the reference's initial values and agree."""
    feed = _specs(np.random.RandomState(0))
    jmain, jstartup, jouts = _build(fluid, name, feed)
    tmain, tstartup, touts = _build(tfluid, name, feed)
    assert _program_facts(tmain, touts) == _program_facts(jmain, jouts)
    results = []
    for pkg, main, startup, outs in ((fluid, jmain, jstartup, jouts),
                                     (tfluid, tmain, tstartup, touts)):
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            if pkg is fluid:
                params = {p.name: np.asarray(scope.get(p.name))
                          for p in main.all_parameters()}
            else:
                tfluid.bridge.load_program_params(scope, params, main,
                                                  "cpu")
            results.append(exe.run(main, feed=feed, fetch_list=outs))
    for w, g in zip(*results):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            assert_close(g, w, name)


def test_every_new_layer_is_built():
    """Each new callable runs in this file or through the op tests'
    layer builds (``test_torch_misc_ops.py``, ``test_torch_debug_ops.py``)."""
    import test_torch_misc_ops as misc

    src = inspect.getsource(misc) + inspect.getsource(
        __import__("test_torch_debug_ops"))
    for name in NEW:
        assert name in BUILDS or ("layers.%s(" % name) in src, name


def _init_values(pkg, init, shape):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        helper = importlib.import_module(
            pkg.__name__ + ".core.layer_helper").LayerHelper("init_probe")
        p = helper.create_parameter(
            pkg.ParamAttr(initializer=init(pkg.initializer)),
            shape=list(shape), dtype="float32")
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        pkg.Executor(pkg.CPUPlace()).run(startup)
        return np.asarray(scope.get(p.name))


@pytest.mark.parametrize("init,shape", [
    (lambda m: m.Bilinear(), (3, 2, 4, 4)),
    (lambda m: m.BilinearInitializer(), (2, 1, 5, 5)),
    (lambda m: m.NumpyArrayInitializer(
        np.arange(12, dtype="f4").reshape(3, 4) / 7), (3, 4)),
], ids=["bilinear", "bilinear_odd", "numpy_array"])
def test_exact_initializers_match_reference(init, shape):
    np.testing.assert_array_equal(_init_values(tfluid, init, shape),
                                  _init_values(fluid, init, shape))


@pytest.mark.parametrize("init,bound", [
    (lambda m: m.TruncatedNormal(0.5, 2.0), (0.5 - 4.0, 0.5 + 4.0)),
    (lambda m: m.MSRA(), (-np.sqrt(6.0 / 200), np.sqrt(6.0 / 200))),
    (lambda m: m.MSRAInitializer(uniform=False), None),
    (lambda m: m.TruncatedNormalInitializer(), (-2.0, 2.0)),
], ids=["truncated_normal", "msra_uniform", "msra_normal",
        "truncated_normal_default"])
def test_random_initializers_match_reference_statistics(init, bound):
    got = _init_values(tfluid, init, (200, 200)).ravel()
    want = _init_values(fluid, init, (200, 200)).ravel()
    n = got.size
    if bound is not None:
        for v in (got, want):
            assert v.min() >= bound[0] - 1e-6 and v.max() <= bound[1] + 1e-6
    sd = want.std()
    assert abs(got.mean() - want.mean()) < 5 * sd * np.sqrt(2.0 / n)
    # the standard error of a sample standard deviation: sd / sqrt(2n)
    assert abs(got.std() - sd) < 5 * sd * np.sqrt(2.0 / (2 * n))
