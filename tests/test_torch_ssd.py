"""SSD in the port (``layers.ssd_loss``, ``layers.detection_output``,
``layers.detection_map``, ``models.ssd.ssd_lite``) against ``paddle_tpu``
on the CPU, at ``tests/test_detection.py``'s and ``tests/test_models.py``'s
sizes.

Each builds the same program in both packages, var for var and name for
name, and steps it with Adam from the same initial state (the port's
startup run, set into the reference's scope): the loss within atol 2e-5 /
rtol 1e-4, every gradient within 1e-4 relative L2, every parameter after
the step within atol 1e-4 / rtol 1e-4 (f32 sums in other orders), and the
discrete intermediates (the bipartite match, the mined indices) equal.
The ``for_test`` clone's detections then agree on the same weights: the
labels and counts equal, scores and boxes within 1e-5, and the mAP of
``detection_map`` over them within 1e-6. The gt boxes are drawn as
``tests/test_detection.py`` draws them: sorted corners, 1-4 real boxes an
image, zero rows as padding."""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from test_torch_optimizers import (assert_same_startup,  # noqa: F401
                                   fresh_port_programs)
from test_torch_rnn_ops import rel_l2
from test_torch_training import _signature

TOL = dict(atol=2e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
DET_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_L2 = 1e-4


def gt_feed(rng, batch, max_boxes, num_classes):
    """gt_box [B, max_boxes, 4] (sorted corners in [0.05, 0.95], 1 to
    max_boxes real rows, the rest zero) and gt_label [B, max_boxes, 1]
    (1..num_classes-1 on real rows, 0 on padding)."""
    c = np.sort(rng.uniform(0.05, 0.95, (batch, max_boxes, 2, 2)), axis=2)
    box = c.reshape(batch, max_boxes, 4).astype("float32")
    lbl = rng.randint(1, num_classes, (batch, max_boxes, 1)).astype("int64")
    real = np.arange(max_boxes)[None] < rng.randint(1, max_boxes + 1,
                                                    batch)[:, None]
    return box * real[..., None], lbl * real[..., None]


def _ops_out(prog, op_type, slot):
    return [op.output(slot).name for op in prog.global_block().ops
            if op.type == op_type]


def _state(tscope, tstartup):
    return {v.name: tscope.numpy(v.name).copy()
            for v in tstartup.list_vars() if v.persistable}


def _reference_run(jmain, state, feed, fetch, params):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
        out = exe.run(jmain, feed=feed, fetch_list=fetch)
        return out, {n: np.asarray(scope.get(n)) for n in params}


def _assert_step(got, want, names, n_grads, params, tscope, want_params):
    """[loss] + grads + discrete fetches of one step, then the params."""
    np.testing.assert_allclose(got[0], want[0], err_msg="loss", **TOL)
    for n, g, w in zip(names[1:1 + n_grads], got[1:1 + n_grads],
                       want[1:1 + n_grads]):
        if not np.abs(w).max() > 0:  # no prior of the head was selected
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        assert rel_l2(g, w) <= GRAD_REL_L2, (n, rel_l2(g, w))
    for n, g, w in zip(names[1 + n_grads:], got[1 + n_grads:],
                       want[1 + n_grads:]):
        np.testing.assert_array_equal(g, w, err_msg=n)
    for n in params:
        np.testing.assert_allclose(tscope.numpy(n), want_params[n],
                                   err_msg=n, **PARAM_TOL)


def _build_head(pkg, n, p, c, b):
    """``tests/test_detection.py``'s SSD head: an fc trunk over a feature
    feed, ``ssd_loss`` under Adam(5e-3), and ``detection_output`` over the
    same head in the same program."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 41
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        feat = L.data("feat", shape=[16])
        gtb = L.data("gtb", shape=[b, 4])
        gtl = L.data("gtl", shape=[b, 1], dtype="int32")
        pb = L.data("pb", shape=[4], append_batch_size=False)
        pbv = L.data("pbv", shape=[4], append_batch_size=False)
        h = L.fc(feat, size=64, act="relu")
        loc = L.reshape(L.fc(h, size=p * 4), [-1, p, 4])
        conf = L.reshape(L.fc(h, size=p * c), [-1, p, c])
        loss = L.ssd_loss(loc, conf, gtb, gtl, pb, prior_box_var=pbv)
        dets, cnt = L.detection_output(loc, L.softmax(conf), pb, pbv,
                                       keep_top_k=5, nms_top_k=10,
                                       score_threshold=0.01)
        pkg.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return main, startup, loss, dets, cnt


def test_ssd_loss_and_detection_output_match_reference():
    """Three Adam steps of the composed SSD loss (bipartite match, target
    encode, smooth-L1, softmax CE, hard-negative mining) and the decoded,
    NMSed detections of the same head."""
    n, p, c, b = 2, 12, 4, 3
    rng = np.random.RandomState(7)
    prior = np.sort(rng.uniform(0.05, 0.95, (p, 2, 2)), axis=1)
    prior = prior.reshape(p, 4).astype("float32")
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], "float32"), (p, 1))
    gtb, gtl = gt_feed(rng, n, b, c)
    feed = {"feat": rng.randn(n, 16).astype("float32"), "gtb": gtb,
            "gtl": gtl.astype("int32"), "pb": prior, "pbv": pvar}
    jmain, jstartup, jloss, jdets, jcnt = _build_head(fluid, n, p, c, b)
    tmain, tstartup, tloss, tdets, tcnt = _build_head(tfluid, n, p, c, b)
    assert _signature(tmain) == _signature(jmain)
    assert_same_startup(jstartup, tstartup)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    state = _state(tscope, tstartup)
    params = sorted(v.name for v in jmain.all_parameters())
    fetch = [jloss.name, jdets.name, jcnt.name] + _ops_out(
        jmain, "bipartite_match", "ColToRowMatchIndices") + _ops_out(
        jmain, "mine_hard_examples", "UpdatedMatchIndices")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        for k, v in state.items():
            scope.set(k, jnp.asarray(v))
        for step in range(3):
            want = exe.run(jmain, feed=feed, fetch_list=fetch)
            got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
            np.testing.assert_allclose(got[0], want[0], err_msg=str(step),
                                       **TOL)
            for name, g, w in zip(fetch[2:], got[2:], want[2:]):
                np.testing.assert_array_equal(g, w, err_msg=name)
            np.testing.assert_array_equal(got[1][..., 0], want[1][..., 0])
            np.testing.assert_allclose(got[1], want[1], **DET_TOL)
            assert (want[3] >= 0).any() and (want[4] == -2).any()
        for k in params:
            np.testing.assert_allclose(tscope.numpy(k),
                                       np.asarray(scope.get(k)), err_msg=k,
                                       **PARAM_TOL)


def _build_ssd(pkg, models):
    """``ssd_lite`` at its defaults under Adam(2e-3) (the reference test's
    rate), and its ``for_test`` clone with a ``detection_map`` over the
    clone's detections and the gt feeds."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        spec = models.ssd.ssd_lite()
        pkg.optimizer.Adam(2e-3).minimize(spec.loss)
    test = main.clone(for_test=True)
    with pkg.program_guard(test, pkg.Program()):
        gb = test.global_block()
        m_ap = pkg.layers.detection_map(
            gb.var(spec.fetches["detections"].name),
            pkg.layers.reshape(gb.var("gt_label"), [-1, 4]),
            gb.var("gt_box"), class_num=5)
    return main, startup, spec, m_ap, test


@pytest.mark.parametrize("batch", [2])
def test_ssd_lite_step_and_eval_match_reference(batch):
    """One Adam step of ``ssd_lite`` from one startup state (loss, every
    gradient, the updated parameters, the match and the mined indices),
    then the clone's detections and mAP on the stepped weights."""
    jmain, jstartup, jspec, jmap, jtest = _build_ssd(fluid, jmodels)
    tmain, tstartup, tspec, tmap, ttest = _build_ssd(tfluid, tfluid.models)
    assert _signature(tmain) == _signature(jmain)
    assert _signature(ttest) == _signature(jtest)
    assert_same_startup(jstartup, tstartup)
    rng = np.random.RandomState(4)
    feed = jspec.sample_batch(batch, rng)
    feed["gt_box"], feed["gt_label"] = gt_feed(rng, batch, 4, 5)
    params = sorted(p.name for p in jmain.all_parameters())
    gb = jmain.global_block()
    grads = [k + "@GRAD" for k in params if gb.has_var(k + "@GRAD")]
    fetch = [jspec.loss.name] + grads + _ops_out(
        jmain, "bipartite_match", "ColToRowMatchIndices") + _ops_out(
        jmain, "mine_hard_examples", "UpdatedMatchIndices")

    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    state = _state(tscope, tstartup)
    want, want_params = _reference_run(jmain, state, feed, fetch, params)
    got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
    _assert_step(got, want, fetch, len(grads), params, tscope, want_params)
    assert (want[-2] >= 0).any() and (want[-1] == -2).any()

    # the clone on the stepped weights: decode + NMS, then the mAP
    stepped = _state(tscope, tstartup)
    dfetch = [jspec.fetches["detections"].name,
              jspec.fetches["det_count"].name, jmap.name]
    want, _ = _reference_run(jtest, stepped, feed, dfetch, [])
    got = texe.run(ttest, feed=feed, fetch_list=dfetch, scope=tscope)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][..., 0], want[0][..., 0])
    np.testing.assert_allclose(got[0], want[0], **DET_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    assert want[0].shape == (batch, 10, 6) and (want[1] > 0).all()


def test_ssd_lite_fusion_declines_its_four_trunk_convs():
    """The executor fuses the trunk's four conv -> BN -> relu chains, and
    the fused-conv gate declines each (3x3 stride 2: outside the kernels'
    1x1 and 3x3 s1 geometries), replaying it unfused; the heads are biased
    convs with no BN. So an SSD step launches none of the port's
    kernels."""
    from paddle_tpu_torch.core.executor import fused_ops

    tmain, tstartup, tspec, _, _ = _build_ssd(tfluid, tfluid.models)
    feed = tspec.sample_batch(2, np.random.RandomState(0))
    feed["gt_box"], feed["gt_label"] = gt_feed(np.random.RandomState(1), 2,
                                               4, 5)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tstartup, scope=scope)
    exe.run(tmain, feed=feed, fetch_list=[tspec.loss], scope=scope)
    ops, report = fused_ops(tmain, [tspec.loss.name])
    assert len(report.fused) == 4 and not report.refused
    choices = [op.attr("_kernel_choice") for op in ops
               if op.type == "fused_conv2d"]
    assert [c["kernel"] for c in choices] == ["unfused_replay"] * 4
    assert all("strides [2, 2]" in c["reason"] for c in choices)
