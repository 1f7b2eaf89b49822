"""The loss ops and layers the port added (``log_softmax``,
``cross_entropy``, ``smooth_softmax_ce``, ``square_error_cost``,
``smooth_l1_loss``, ``huber_loss``, ``label_smooth``, ``kldiv_loss``,
``bpr_loss``, ``hinge_loss``, ``log_loss``, ``margin_rank_loss``,
``mse_loss``) and the metric ops ``auc`` (streaming, over two batches)
and ``precision_recall``, against ``paddle_tpu``.

Each loss is built by its layer in both packages on the same numpy
inputs (seed 0); the loss and its gradient w.r.t. every float input
(``fluid.gradients`` of sum(loss * c), c a fed random cotangent) agree
within rtol 1e-5 / atol 1e-6: the same f32 formulas, evaluated by two
libraries. The metrics agree within the same bounds, AUC's histograms
exactly."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N, C = 4, 5


def _inputs(rng):
    logits = rng.randn(N, C).astype("float32")
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ids = rng.randint(0, C, (N, 1)).astype("int64")
    return {
        "logits": logits, "prob": p.astype("float32"), "ids": ids,
        "onehot": np.eye(C, dtype="float32")[ids[:, 0]],
        "a": rng.randn(N, C).astype("float32"),
        "b": rng.randn(N, C).astype("float32"),
        "w": rng.uniform(0.5, 1.5, (N, C)).astype("float32"),
        "s": rng.randn(N, 1).astype("float32"),
        "t": rng.randn(N, 1).astype("float32"),
        "p1": rng.uniform(0.05, 0.95, (N, 1)).astype("float32"),
        "bin": rng.randint(0, 2, (N, 1)).astype("float32"),
        "sign": np.where(rng.rand(N, 1) > 0.5, 1.0, -1.0).astype("float32"),
        "logp": np.log(p).astype("float32"),
        "target": (np.exp(rng.randn(N, C)) / np.exp(rng.randn(N, C)).sum(
            1, keepdims=True)).astype("float32"),
    }


# name -> (inputs differentiated, other inputs, build(L, v) -> loss)
CASES = {
    "log_softmax": (["logits"], [], lambda L, v: L.log_softmax(v["logits"])),
    "cross_entropy": (["prob"], ["ids"],
                      lambda L, v: L.cross_entropy(v["prob"], v["ids"])),
    "cross_entropy_soft": (["prob", "target"], [], lambda L, v:
                           L.cross_entropy(v["prob"], v["target"],
                                           soft_label=True)),
    "smooth_softmax_ce": (["logits"], ["ids"], lambda L, v:
                          L.smooth_softmax_with_cross_entropy(
                              v["logits"], v["ids"], epsilon=0.1)),
    "square_error_cost": (["a", "b"], [], lambda L, v:
                          L.square_error_cost(v["a"], v["b"])),
    "smooth_l1_loss": (["a", "b"], ["w"], lambda L, v: L.smooth_l1(
        v["a"], v["b"], inside_weight=v["w"], outside_weight=v["w"],
        sigma=2.0)),
    "huber_loss": (["a", "b"], [], lambda L, v: L.huber_loss(v["a"], v["b"],
                                                             0.5)),
    "label_smooth": (["onehot"], [], lambda L, v: L.label_smooth(
        v["onehot"], epsilon=0.1)),
    "kldiv_loss": (["logp"], ["target"], lambda L, v: L.kldiv_loss(
        v["logp"], v["target"], reduction="batchmean")),
    "bpr_loss": (["logits"], ["ids"], lambda L, v: L.bpr_loss(v["logits"],
                                                              v["ids"])),
    "hinge_loss": (["s"], ["bin"], lambda L, v: L.hinge_loss(v["s"],
                                                             v["bin"])),
    "log_loss": (["p1"], ["bin"], lambda L, v: L.log_loss(v["p1"],
                                                          v["bin"])),
    "margin_rank_loss": (["s", "t"], ["sign"], lambda L, v:
                         L.margin_rank_loss(v["sign"], v["s"], v["t"],
                                            margin=0.3)),
    "mse_loss": (["a", "b"], [], lambda L, v: L.mse_loss(v["a"], v["b"])),
}


def _run_case(pkg, name, feed):
    floats, _, build = CASES[name]
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        v = {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False) for k, a in feed.items()}
        loss = build(L, v)
        cot = L.data("cot", shape=list(loss.shape), dtype="float32",
                     append_batch_size=False)
        total = L.reduce_sum(L.elementwise_mul(loss, cot))
        grads = pkg.gradients(total, [v[k] for k in floats])
    rng = np.random.RandomState(1)
    feed = dict(feed, cot=np.asarray(rng.randn(*loss.shape), "float32"))
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is fluid:
        with fluid.scope_guard(fluid.Scope()):
            return exe.run(main, feed=feed, fetch_list=[loss] + grads)
    return exe.run(main, feed=feed, fetch_list=[loss] + grads,
                   scope=pkg.Scope())


@pytest.mark.parametrize("name", list(CASES) + ["auc", "precision_recall"])
def test_matches_reference(name):
    feed = _inputs(np.random.RandomState(0))
    if name == "auc":
        return _check_auc()
    if name == "precision_recall":
        return _check_precision_recall()
    floats, others, _ = CASES[name]
    feed = {k: feed[k] for k in floats + others}
    want = _run_case(fluid, name, feed)
    got = _run_case(tfluid, name, feed)
    assert len(got) == len(want) == 1 + len(floats)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g).reshape(np.shape(w)), w,
                                   rtol=RTOL, atol=ATOL,
                                   err_msg="%s output %d" % (name, i))


def _check_auc():
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(2):
        p = rng.uniform(0, 1, (16, 1)).astype("float32")
        batches.append({"pred": np.concatenate([1 - p, p], 1),
                        "label": (rng.rand(16, 1) < p).astype("int64")})
    outs = []
    for pkg in (fluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            pred = pkg.layers.data("pred", shape=[2], dtype="float32")
            label = pkg.layers.data("label", shape=[1], dtype="int64")
            auc, _, stats = pkg.layers.auc(pred, label, num_thresholds=63)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe.run(startup)
            outs.append([exe.run(main, feed=b, fetch_list=[auc] + stats)
                         for b in batches])
    for (ja, jp, jn), (ta, tp, tn) in zip(*outs):
        np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tn, jn)
    assert outs[1][1][1].sum() + outs[1][1][2].sum() == 32


def _check_precision_recall():
    rng = np.random.RandomState(3)
    feed = {"idx": rng.randint(0, 4, (20, 1)).astype("int64"),
            "lab": rng.randint(0, 4, (20, 1)).astype("int64")}
    outs = []
    for pkg in (fluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            idx = pkg.layers.data("idx", shape=[1], dtype="int64")
            lab = pkg.layers.data("lab", shape=[1], dtype="int64")
            gb = main.global_block()
            metrics = gb.create_var(name="pr_metrics", shape=(6,),
                                    dtype="float32")
            states = gb.create_var(name="pr_states", shape=(4, 3),
                                   dtype="float32")
            gb.append_op("precision_recall", {"Indices": idx, "Labels": lab},
                         {"BatchMetrics": metrics,
                          "AccumStatesInfo": states}, {"class_number": 4})
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            outs.append(exe.run(main, feed=feed,
                                fetch_list=[metrics, states]))
    for t, j in zip(outs[1], outs[0]):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
