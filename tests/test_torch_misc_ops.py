"""The 39 ops of the port's ``core/opimpl/misc_ops.py`` besides the two
detection ops (losses and metrics, image and tensor ops, sequence
utilities, the proximal updates, ``sample_logits``, ``lstm_unit``,
``ctc_align``) and their layers (``layers/extras.py``) against
``paddle_tpu`` on the CPU.

Each case builds the same program in both packages (by its layer, or by
the raw op where the layer makes parameters or the reference has none)
on the same numpy inputs (seed 0), and fetches every output and, for the
float inputs the op differentiates, the gradient of sum(out * c) (c a
fed random cotangent). Float outputs and gradients agree within rtol
1e-5 and atol 1e-6 times the reference's largest magnitude (at least
1e-6); integer and boolean outputs (hash ids, pooling indices,
``ctc_align``, ``edit_distance``, ``chunk_eval``'s counts) are equal.
``edit_distance`` and ``chunk_eval`` run every normalisation and scheme.
The random ops (``random_crop``, ``sample_logits``) draw from different
generators in the two packages: what is deterministic given the draw is
held exactly, and the draws by their statistics."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def raw(pkg, op_type, inputs, outs, attrs=None):
    """A raw op of ``op_type``; ``outs``: {slot: [(dtype, shape), ...]}.
    Returns the output vars in slot order."""
    block = pkg.default_main_program().current_block()
    made = {s: [block.create_var(dtype=d, shape=sh) for d, sh in specs]
            for s, specs in outs.items()}
    block.append_op(op_type, inputs, made, attrs or {})
    return [v for vs in made.values() for v in vs]


def run_case(pkg, build, feed, floats, shapes=None):
    """Build ``build(pkg, vars)`` over data vars of ``feed``, fetch its
    outputs, then, where ``floats`` names inputs, the gradients of the sum
    over the float outputs of out * c w.r.t. them (c a fed random
    cotangent of each output's shape in ``shapes``)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        v = {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False, stop_gradient=k not in floats)
             for k, a in feed.items()}
        outs = list(build(pkg, v))
        cots, grads = {}, []
        if floats:
            terms = []
            for i, o in enumerate(outs):
                if str(o.dtype) != "float32":
                    continue
                c = L.data("cot%d" % i, shape=list(shapes[i]),
                           dtype="float32", append_batch_size=False)
                cots[c.name] = np.asarray(np.random.RandomState(i).randn(
                    *shapes[i]), "float32")
                terms.append(L.reduce_sum(L.elementwise_mul(o, c)))
            total = terms[0] if len(terms) == 1 else L.sums(terms)
            grads = pkg.gradients(total, [v[k] for k in floats])
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        return exe.run(main, feed=dict(feed, **cots),
                       fetch_list=outs + list(grads)), len(outs)


def assert_close(g, w, msg):
    w = np.asarray(w)
    atol = ATOL * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=msg)


def assert_matches(build, feed, floats, name):
    """The port against the reference: outputs, then gradients."""
    shapes = None
    if floats:
        shapes = [np.shape(o) for o in run_case(tfluid, build, feed,
                                                [])[0]]
    got, n_out = run_case(tfluid, build, feed, floats, shapes)
    want, _ = run_case(fluid, build, feed, floats, shapes)
    assert len(got) == len(want) == n_out + len(floats)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if w.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind, (name, i, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg="%s %d" % (name, i))
        else:
            if i >= n_out:
                assert np.abs(w).max() > 0, (name, i)
            assert_close(g, w, "%s %d" % (name, i))
    return got


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    i32 = lambda lo, hi, *s: rng.randint(lo, hi, s).astype("int32")  # noqa
    return {
        "a": f(4, 1), "b": f(4, 1), "lbl01": i32(0, 2, 4, 1).astype("f4"),
        "x6": (f(6, 1) * 2).astype("f4"),
        "y6": i32(0, 2, 6, 1).astype("f4"),
        "ts_lbl": np.array([[-1.0], [0.0], [0.3], [0.7], [1.0], [2.0]],
                           "f4"),
        "m34": f(3, 4), "n34": f(3, 4),
        "pred": i32(0, 4, 12), "lab": i32(0, 4, 12),
        "in_w": i32(0, 3, 4), "in_c": i32(0, 3, 4),
        "score": np.round(f(10) * 2) / 2, "rank": i32(0, 3, 10).astype("f4"),
        "qid": i32(0, 3, 10),
        "img": f(2, 3, 4, 4), "ch3": f(3), "ch3b": f(3),
        "theta": f(2, 2, 3), "img6": f(2, 6, 3, 3),
        "t356": f(3, 5, 6), "small": f(2, 3),
        "pool": f(2, 3, 6, 6),
        "tie": (np.round(f(2, 3, 6, 6)) / 2).astype("f4"),
        "vol": f(1, 2, 4, 6, 6),
        "vol_tie": (np.round(f(1, 2, 4, 6, 6))).astype("f4"),
        "spp": f(2, 3, 7, 7), "focus": f(2, 3, 4, 5),
        "w64": f(6, 4), "u6": f(6), "v4": f(4),
        "w4d": f(5, 3, 2, 2), "u3": f(3), "v20": f(20),
        "mx_a": f(4, 3), "mx_b": f(4, 3), "mx_ids": i32(0, 2, 4, 1),
        "bx": f(3, 6), "by": f(3, 5), "bw": f(4, 6, 5), "bb": f(4),
        "seq": f(2, 5, 8), "cx": f(2, 7), "cy": f(2, 3),
        "ids": np.array([[0], [1], [7], [2 ** 31 - 1], [123456789],
                         [-5]], "int32"),
        "dn_x": f(5, 3), "dn_size": np.full(3, 10.0, "f4"),
        "dn_sum": f(3), "dn_sq": np.abs(f(3)) * 10 + 5,
        "ex_x": f(3, 4), "ex_len": np.array([2, 5, 0], "int32"),
        "rs_x": f(2, 6, 4),
        "sc_x": f(3, 6), "sc_ids": np.array(
            [[0, 2, 2, 5], [1, 1, 1, 3], [4, 0, 5, 4]], "int32"),
        "sc_upd": f(3, 4), "sc_mask": i32(0, 2, 3, 4).astype("f4"),
        "pg_p": f(3, 4), "pg_g": f(3, 4),
        "pg_m": np.abs(f(3, 4)), "lr": np.array([0.3], "f4"),
        "lstm_x": f(3, 8), "lstm_c": f(3, 2),
        "ctc_probs": np.abs(f(3, 8, 5)),
        "ctc_ids": np.array([[0, 1, 1, 0, 2, 2, 3, 0],
                             [3, 3, 3, 0, 0, 1, 0, 1],
                             [0, 0, 0, 0, 2, 0, 2, 2]], "int32"),
        "ctc_len": np.array([8, 6, 0], "int32"),
    }


def _mean_iou_acc(pkg, v):
    return raw(pkg, "mean_iou", {"Predictions": v["pred"],
                                 "Labels": v["lab"],
                                 "InWrongs": [v["in_w"]],
                                 "InCorrects": [v["in_c"]]},
               {"OutMeanIou": [("float32", ())],
                "OutWrong": [("int32", (4,))],
                "OutCorrect": [("int32", (4,))]}, {"num_classes": 4})


def _pool_idx(name, **kw):
    return lambda pkg, v: list(pkg.layers.max_pool2d_with_index(v[name],
                                                                **kw))


def _pool3d_idx(name, **attrs):
    return lambda pkg, v: raw(pkg, "max_pool3d_with_index", {"X": v[name]},
                              {"Out": [("float32", None)],
                               "Mask": [("int32", None)]}, attrs)


def _unpool(pkg, v):
    o, m = pkg.layers.max_pool2d_with_index(v["pool"], [2, 2])
    return [pkg.layers.unpool(o, m, 6, 6), m]


def _spectral(w, u, v_, **attrs):
    return lambda pkg, v: raw(pkg, "spectral_norm",
                              {"Weight": v[w], "U": v[u], "V": v[v_]},
                              {"Out": [("float32", None)]}, attrs)


def _data_norm(pkg, v):
    return raw(pkg, "data_norm",
               {"X": v["dn_x"], "BatchSize": v["dn_size"],
                "BatchSum": v["dn_sum"], "BatchSquareSum": v["dn_sq"]},
               {"Y": [("float32", (5, 3))], "Means": [("float32", (3,))],
                "Scales": [("float32", (3,))],
                "BatchSizeOut": [("float32", (3,))],
                "BatchSumOut": [("float32", (3,))],
                "BatchSquareSumOut": [("float32", (3,))]})


def _f(shape=None):
    return {"Out": [("float32", shape)]}


# case -> (float inputs differentiated, other inputs, build(pkg, v))
CASES = {
    # ---- losses
    "rank_loss": (["a", "b"], ["lbl01"], lambda pkg, v: [
        pkg.layers.rank_loss(v["lbl01"], v["a"], v["b"])]),
    "modified_huber_loss": (["x6"], ["y6"], lambda pkg, v: [
        pkg.layers.modified_huber_loss(v["x6"], v["y6"])]),
    "squared_l2_distance": (["m34", "n34"], [], lambda pkg, v: [
        pkg.layers.squared_l2_distance(v["m34"], v["n34"])]),
    "l1_norm": (["m34"], [], lambda pkg, v: raw(
        pkg, "l1_norm", {"X": v["m34"]}, _f(()))),
    "teacher_student_sigmoid_loss": (["x6"], ["ts_lbl"], lambda pkg, v: [
        pkg.layers.teacher_student_sigmoid_loss(v["x6"], v["ts_lbl"],
                                                soft_max_up_bound=1.5)]),
    # ---- metrics
    "mean_iou": ([], ["pred", "lab"], lambda pkg, v: list(
        pkg.layers.mean_iou(v["pred"], v["lab"], 4))),
    "mean_iou_accumulated": ([], ["pred", "lab", "in_w", "in_c"],
                             _mean_iou_acc),
    "positive_negative_pair": ([], ["score", "rank", "qid"],
                               lambda pkg, v: raw(
        pkg, "positive_negative_pair",
        {"Score": v["score"], "Label": v["rank"], "QueryID": v["qid"]},
        {"PositivePair": [("float32", ())], "NegativePair": [("float32", ())],
         "NeutralPair": [("float32", ())]})),
    # ---- image / feature
    "affine_channel": (["img", "ch3", "ch3b"], [], lambda pkg, v: [
        pkg.layers.affine_channel(v["img"], v["ch3"], v["ch3b"])]),
    "affine_grid": (["theta"], [], lambda pkg, v: [
        pkg.layers.affine_grid(v["theta"], [2, 3, 5, 4])]),
    "space_to_depth": (["img"], [], lambda pkg, v: [
        pkg.layers.space_to_depth(v["img"], 2)]),
    "shuffle_channel": (["img6"], [], lambda pkg, v: [
        pkg.layers.shuffle_channel(v["img6"], 3)]),
    "crop": (["t356"], [], lambda pkg, v: [
        pkg.layers.crop(v["t356"], [2, 3, 4], [1, 1, 2])]),
    "pad_constant_like": (["small"], ["m34"], lambda pkg, v: [
        pkg.layers.pad_constant_like(v["m34"], v["small"], 0.5)]),
    "pool_with_index": (["pool"], [], _pool_idx("pool", ksize=[3, 3],
                                                strides=[2, 2],
                                                paddings=[1, 1])),
    "pool_with_index_ties": ([], ["tie"], _pool_idx("tie", ksize=[2, 2])),
    "pool_with_index_global": ([], ["tie"], _pool_idx(
        "tie", ksize=[2, 2], global_pooling=True)),
    "pool_with_index_adaptive": (["pool"], [], lambda pkg, v: raw(
        pkg, "pool_with_index", {"X": v["pool"]},
        {"Out": [("float32", None)], "Mask": [("int32", None)]},
        {"ksize": [2, 3], "adaptive": True})),
    "max_pool3d_with_index": (["vol"], [], _pool3d_idx(
        "vol", ksize=[2, 3, 3], strides=[2, 2, 2], paddings=[0, 1, 1])),
    "max_pool3d_with_index_ties": ([], ["vol_tie"], _pool3d_idx(
        "vol_tie", ksize=[2, 2, 2])),
    "max_pool3d_with_index_adaptive": ([], ["vol_tie"], _pool3d_idx(
        "vol_tie", ksize=[2, 3, 2], adaptive=True)),
    "unpool": (["pool"], [], _unpool),
    "spp_max": (["spp"], [], lambda pkg, v: [pkg.layers.spp(v["spp"], 3)]),
    "spp_avg": (["spp"], [], lambda pkg, v: [
        pkg.layers.spp(v["spp"], 2, pool_type="avg")]),
    "similarity_focus_1": ([], ["focus"], lambda pkg, v: [
        pkg.layers.similarity_focus(v["focus"], 1, [0, 2])]),
    "similarity_focus_3": ([], ["focus"], lambda pkg, v: [
        pkg.layers.similarity_focus(v["focus"], 3, [1])]),
    "spectral_norm": (["w64"], ["u6", "v4"], _spectral("w64", "u6", "v4")),
    "spectral_norm_dim1": (["w4d"], ["u3", "v20"], _spectral(
        "w4d", "u3", "v20", dim=1, power_iters=3)),
    # ---- misc tensor
    "multiplex": (["mx_a", "mx_b"], ["mx_ids"], lambda pkg, v: [
        pkg.layers.multiplex([v["mx_a"], v["mx_b"]], v["mx_ids"])]),
    "is_empty": ([], ["m34"], lambda pkg, v: raw(
        pkg, "is_empty", {"X": v["m34"]}, {"Out": [("bool", ())]})),
    "minus": (["m34", "n34"], [], lambda pkg, v: raw(
        pkg, "minus", {"X": v["m34"], "Y": v["n34"]}, _f((3, 4)))),
    "selu": (["m34"], [], lambda pkg, v: [pkg.layers.selu(v["m34"])]),
    "bilinear_tensor_product": (["bx", "by", "bw", "bb"], [],
                                lambda pkg, v: raw(
        pkg, "bilinear_tensor_product",
        {"X": v["bx"], "Y": v["by"], "Weight": v["bw"], "Bias": v["bb"]},
        _f((3, 4)))),
    "add_position_encoding": (["seq"], [], lambda pkg, v: [
        pkg.layers.add_position_encoding(v["seq"], alpha=0.5, beta=2.0)]),
    "conv_shift": (["cx", "cy"], [], lambda pkg, v: raw(
        pkg, "conv_shift", {"X": v["cx"], "Y": v["cy"]}, _f((2, 7)))),
    "hash": ([], ["ids"], lambda pkg, v: [
        pkg.layers.hash(v["ids"], hash_size=1000003, num_hash=4)]),
    "data_norm": (["dn_x"], ["dn_size", "dn_sum", "dn_sq"], _data_norm),
    # ---- sequences
    "sequence_expand_as": (["ex_x"], ["ex_len"], lambda pkg, v: [
        pkg.layers.sequence_expand_as(v["ex_x"], v["ex_len"], 5)]),
    "sequence_reshape": (["rs_x"], [], lambda pkg, v: [
        pkg.layers.sequence_reshape(v["rs_x"], 8)]),
    "sequence_scatter": (["sc_x", "sc_upd"], ["sc_ids", "sc_mask"],
                         lambda pkg, v: [pkg.layers.sequence_scatter(
                             v["sc_x"], v["sc_ids"], v["sc_upd"],
                             v["sc_mask"])]),
    # ---- updates
    "proximal_gd": ([], ["pg_p", "pg_g", "lr"], lambda pkg, v: raw(
        pkg, "proximal_gd", {"Param": v["pg_p"], "Grad": v["pg_g"],
                             "LearningRate": v["lr"]},
        {"ParamOut": [("float32", (3, 4))]}, {"l1": 0.5, "l2": 0.2})),
    "proximal_adagrad": ([], ["pg_p", "pg_g", "pg_m", "lr"],
                         lambda pkg, v: raw(
        pkg, "proximal_adagrad",
        {"Param": v["pg_p"], "Grad": v["pg_g"], "Moment": v["pg_m"],
         "LearningRate": v["lr"]},
        {"ParamOut": [("float32", (3, 4))],
         "MomentOut": [("float32", (3, 4))]}, {"l1": 0.3, "l2": 0.1})),
    # ---- recurrent and CTC
    "lstm_unit": (["lstm_x", "lstm_c"], [], lambda pkg, v: raw(
        pkg, "lstm_unit", {"X": v["lstm_x"], "C_prev": v["lstm_c"]},
        {"C": [("float32", (3, 2))], "H": [("float32", (3, 2))]},
        {"forget_bias": 0.5})),
    "ctc_align": ([], ["ctc_ids", "ctc_len"], lambda pkg, v: raw(
        pkg, "ctc_align", {"Input": v["ctc_ids"],
                           "InputLength": v["ctc_len"]},
        {"Output": [("int32", (3, 8))], "OutputLength": [("int32", (3,))]},
        {"blank": 0, "padding_value": -1})),
    "ctc_align_no_length": ([], ["ctc_ids"], lambda pkg, v: raw(
        pkg, "ctc_align", {"Input": v["ctc_ids"]},
        {"Output": [("int32", (3, 8))], "OutputLength": [("int32", (3,))]},
        {"blank": 3})),
    "ctc_greedy_decoder": ([], ["ctc_probs", "ctc_len"], lambda pkg, v: list(
        pkg.layers.ctc_greedy_decoder(v["ctc_probs"], blank=0,
                                      input_length=v["ctc_len"]))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_misc_op_matches_reference(name):
    floats, others, build = CASES[name]
    feed = {k: a for k, a in _inputs().items() if k in floats + others}
    assert_matches(build, feed, floats, name)


def _edit_feed(rng, b=6, th=7, tr=6, vocab=3):
    feed = {"h": rng.randint(0, vocab, (b, th)).astype("int32"),
            "r": rng.randint(0, vocab, (b, tr)).astype("int32"),
            "hl": rng.randint(0, th + 1, (b,)).astype("int32"),
            "rl": rng.randint(0, tr + 1, (b,)).astype("int32")}
    feed["hl"][0], feed["rl"][0] = th, tr
    feed["hl"][1], feed["rl"][1] = 0, 3
    return feed


def _levenshtein(a, b):
    d = np.arange(len(b) + 1, dtype=float)
    for i, ca in enumerate(a):
        prev, d[0] = d.copy(), i + 1
        for j, cb in enumerate(b):
            d[j + 1] = min(prev[j + 1] + 1, d[j] + 1, prev[j] + (ca != cb))
    return d[len(b)]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_matches_reference(normalized):
    """Every distance equals the reference's and a plain Levenshtein."""
    feed = _edit_feed(np.random.RandomState(1))

    def build(pkg, v):
        return list(pkg.layers.edit_distance(
            v["h"], v["r"], normalized=normalized, input_length=v["hl"],
            label_length=v["rl"]))

    got = assert_matches(build, feed, [], "edit_distance")
    for i in range(feed["h"].shape[0]):
        rl = feed["rl"][i]
        want = _levenshtein(feed["h"][i, :feed["hl"][i]],
                            feed["r"][i, :rl])
        if normalized:
            want = np.float32(want) / np.float32(max(rl, 1))
        assert got[0][i, 0] == np.float32(want)
    assert got[1] == feed["h"].shape[0]


@pytest.mark.parametrize("scheme,excluded", [
    ("plain", None), ("IOB", None), ("IOE", None), ("IOBES", None),
    ("IOB", [1]), ("IOBES", [0, 2])])
def test_chunk_eval_matches_reference(scheme, excluded):
    n_tags = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    rng = np.random.RandomState(2)
    hi = 3 * n_tags + 1  # one tag past the last type: "other"
    lbl = rng.randint(0, hi, (4, 12)).astype("int32")
    inf = np.where(rng.rand(4, 12) < 0.7, lbl,
                   rng.randint(0, hi, (4, 12))).astype("int32")
    feed = {"inf": inf, "lbl": lbl,
            "len": np.array([12, 7, 1, 0], "int32")}

    def build(pkg, v):
        return list(pkg.layers.chunk_eval(
            v["inf"], v["lbl"], scheme, 3, v["len"],
            excluded_chunk_types=excluded))

    got = assert_matches(build, feed, [], "chunk_eval_" + scheme)
    assert got[5] > 0 and got[3] >= got[5] and got[4] >= got[5]


def test_every_misc_op_has_a_case():
    """The port registers every op type of the reference's ``misc_ops``,
    and the cases above run each one but ``edit_distance`` and
    ``chunk_eval`` (their own tests), the random ops (below) and the
    detection ops (``test_torch_detection_ops.py``)."""
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch.core.op_registry as treg

    ref = {n for n, f in jreg.OP_IMPLS.items()
           if f.__module__.endswith(".misc_ops")}
    assert len(ref) == 41 and ref <= set(treg.OP_IMPLS)
    seen = {"edit_distance", "chunk_eval", "random_crop", "sample_logits",
            "psroi_pool", "detection_map"}
    inputs = _inputs()
    for name, (floats, others, build) in CASES.items():
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            v = {k: tfluid.layers.data(k, shape=list(inputs[k].shape),
                                       dtype=str(inputs[k].dtype),
                                       append_batch_size=False)
                 for k in floats + others}
            build(tfluid, v)
        seen |= {op.type for op in main.global_block().ops}
    assert ref <= seen, sorted(ref - seen)


# ---------------- the random ops ----------------

def _crops(pkg, n, seed=None):
    """``n`` random crops of width 3 from the rows 0..9 and 100..109 in one
    run of one program (each op draws its own offset), the run made
    twice."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        x = pkg.layers.data("x", shape=[2, 10], append_batch_size=False)
        outs = [pkg.layers.random_crop(x, [3], seed=seed) for _ in range(n)]
    exe = pkg.Executor(pkg.CPUPlace())
    feed = {"x": np.stack([np.arange(10), np.arange(10) + 100]).astype(
        "f4")}
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        return [np.stack(exe.run(main, feed=feed, fetch_list=outs))
                for _ in range(2)]


def _assert_windows(run):
    """Each crop is the window of x at its offset, both rows at one."""
    off = run[:, 0, 0]
    want = off[:, None] + np.arange(3)[None]
    np.testing.assert_array_equal(run[:, 0], want)
    np.testing.assert_array_equal(run[:, 1], want + 100)
    return off.astype(int)


@pytest.mark.parametrize("pkg,n", [(fluid, 8), (tfluid, 200)],
                         ids=["jax", "torch"])
def test_random_crop_is_a_uniform_window(pkg, n):
    """Every crop is a window of x at an offset in 0..7 and two runs draw
    anew; in the port, over 200 draws, every offset is drawn and their
    mean is within 5 standard errors of 3.5 (the reference's trace grows
    with the op count, so it draws 8)."""
    run1, run2 = _crops(pkg, n)
    for run in (run1, run2):
        off = _assert_windows(run)
        assert off.min() >= 0 and off.max() <= 7
        if n >= 200:
            assert set(off) == set(range(8))
            assert abs(off.mean() - 3.5) < 5 * np.sqrt(5.25 / n)
    assert (run1 != run2).any()


@pytest.mark.parametrize("pkg", [fluid, tfluid], ids=["jax", "torch"])
def test_random_crop_with_a_seed_repeats(pkg):
    """A fixed seed crops at the same offset in every op and every run."""
    run1, run2 = _crops(pkg, 2, seed=7)
    _assert_windows(run1)
    np.testing.assert_array_equal(run1, run2)
    np.testing.assert_array_equal(run1[0], run1[1])


def _sample_logits(pkg, logits, labels, cot):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        L = pkg.layers
        x = L.data("x", shape=list(logits.shape), append_batch_size=False,
                   stop_gradient=False)
        y = L.data("y", shape=list(labels.shape), dtype="int32",
                   append_batch_size=False)
        c = L.data("c", shape=list(cot.shape), append_batch_size=False)
        outs = raw(pkg, "sample_logits", {"Logits": x, "Labels": y},
                   {"SampledLogits": [("float32", cot.shape)],
                    "Samples": [("int32", cot.shape)],
                    "SampledLabels": [("int32", (cot.shape[0],))]},
                   {"num_samples": cot.shape[1] - 1})
        g, = pkg.gradients(L.reduce_sum(L.elementwise_mul(outs[0], c)), [x])
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        return exe.run(main, feed={"x": logits, "y": labels, "c": cot},
                       fetch_list=outs + [g])


@pytest.mark.parametrize("pkg", [fluid, tfluid], ids=["jax", "torch"])
def test_sample_logits_gathers_its_draws(pkg):
    """SampledLogits is the gather at Samples less log q (q = num / C),
    column 0 the label; its gradient scatters the cotangent back to
    Samples; the draws are uniform over the classes (mean within 5
    standard errors)."""
    rng = np.random.RandomState(3)
    b, c, num = 64, 50, 20
    logits = rng.randn(b, c).astype("f4")
    labels = rng.randint(0, c, (b, 1)).astype("int32")
    cot = rng.randn(b, num + 1).astype("f4")
    out, samples, slabels, g = _sample_logits(pkg, logits, labels, cot)
    assert samples.dtype == np.int32 and slabels.dtype == np.int32
    np.testing.assert_array_equal(samples[:, 0], labels[:, 0])
    np.testing.assert_array_equal(slabels, np.zeros(b, "int32"))
    logq = np.float32(np.log(num / float(c)))
    np.testing.assert_allclose(
        out, np.take_along_axis(logits, samples, 1) - logq, rtol=RTOL,
        atol=ATOL)
    want = np.zeros_like(logits)
    np.add.at(want, (np.arange(b)[:, None], samples), cot)
    np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)
    draws = samples[:, 1:]
    assert draws.min() >= 0 and draws.max() < c
    se = np.sqrt((c * c - 1) / 12.0 / draws.size)
    assert abs(draws.mean() - (c - 1) / 2.0) < 5 * se
