"""The detection ops of the port (``core/opimpl/detection_ops.py``: the
24 op types of ``paddle_tpu/core/opimpl/detection_ops.py``; and
``core/opimpl/misc_ops.py``: ``psroi_pool`` and ``detection_map``) with
their layers (``layers/detection.py``, ``layers/extras.py``) against
``paddle_tpu`` on the CPU.

Each case builds the same program in both packages on the same seeded
numpy inputs and fetches every output, and, for an op the reference
differentiates (``roi_align``, ``roi_pool``, ``psroi_pool``,
``yolov3_loss`` and ``ssd_smooth_l1`` w.r.t. X, ``box_coder``'s decode
w.r.t. TargetBox, ``roi_perspective_transform`` w.r.t. X), the gradient
of sum(out * c) for a fed random cotangent c. Discrete outputs (matches,
mined indices, labels, NMS keeps, counts) are equal; float outputs agree
within 1e-5 absolute + 1e-5 relative (f32 sums in other orders), and
gradients within 1e-4 relative L2. Boxes are drawn with sorted corners,
a RoI's bins each hold a pixel (an empty ``roi_pool`` bin is -inf in both
packages), and scores are distinct, so no case rests on a tie."""

import importlib

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401
from test_torch_rnn_ops import rel_l2

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_L2 = 1e-4


def _boxes(rng, shape, lo=0.0, hi=1.0):
    """Boxes [*shape, 4] with sorted corners (x1 < x2, y1 < y2)."""
    c = np.sort(rng.uniform(lo, hi, tuple(shape) + (2, 2)), axis=-2)
    return c.reshape(tuple(shape) + (4,)).astype("float32")


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    gt = np.zeros((2, 4, 4), "float32")
    gt[:, :3] = _boxes(rng, (2, 3), 0.05, 0.95)
    gt_lbl = np.array([[[1], [2], [1], [0]], [[3], [1], [2], [0]]], "int64")
    priors = _boxes(rng, (24,), 0.0, 1.0)
    match = np.array([[0, -1, 2, -1, 1, -1], [3, -1, -1, 0, -1, -1]],
                     "int32")
    mined = np.array([[0, -1, 2, -2, 1, -1], [-2, -1, -1, 0, -2, 1]],
                     "int32")
    yolo_gt = np.zeros((2, 5, 4), "float32")
    yolo_gt[:, 0] = [0.4, 0.4, 0.2, 0.3]
    # a second gt in the SAME cell with the same best anchor: one wins
    yolo_gt[:, 1] = [0.41, 0.39, 0.21, 0.31]
    yolo_gt[:, 2] = [0.8, 0.15, 0.5, 0.6]
    yolo_gt[1, 3] = [0.1, 0.9, 0.05, 0.07]
    yolo_lbl = np.array([[2, 1, 0, 0, 0], [2, 1, 3, 1, 0]], "int32")
    # RPN: anchors on a 4 x 4 map, 3 per cell; 2 images of 64 x 64
    anchors = _boxes(rng, (4, 4, 3), 0.0, 48.0)
    anchors[..., 2:] += 8.0
    # RoIs inside the 8 x 9 map, 2.5 x 2.5 pixels at least
    lo = rng.uniform(0.0, 4.0, (6, 2))
    rois = np.concatenate([lo, lo + rng.uniform(2.5, 3.4, (6, 2))],
                          1).astype("float32")
    quads = np.array([[1, 1, 6, 1, 6, 6, 1, 6],
                      [0.5, 1.2, 7.1, 0.3, 6.6, 6.9, 1.1, 5.8],
                      [2.0, 0.4, 8.3, 2.2, 7.0, 7.5, 0.2, 6.1]], "float32")
    segms = np.zeros((2, 3, 2, 4, 2), "float32")
    for i in range(2):
        for g in range(3):
            x0, y0 = rng.uniform(4, 30, 2)
            w, h = rng.uniform(6, 20, 2)
            segms[i, g, 0] = [[x0, y0], [x0 + w, y0], [x0 + w, y0 + h],
                              [x0, y0 + h]]
            segms[i, g, 1] = [[x0 + 1, y0 + 1], [x0 + w / 2, y0 + 1],
                              [x0 + 1, y0 + h / 2], [x0 + 1, y0 + h / 2]]
    prop_gt = np.concatenate([_boxes(rng, (2, 2), 0.0, 56.0),
                              np.zeros((2, 1, 4), "float32")], 1)
    prop_rois = _boxes(rng, (2, 10), 0.0, 56.0)
    # four RoIs near a gt each: foreground above the threshold
    prop_rois[:, :4] = prop_gt[:, [0, 1, 0, 1]] + rng.uniform(
        -1.5, 1.5, (2, 4, 4)).astype("float32")
    det = np.full((2, 6, 6), -1.0, "float32")
    det[:, :5, 0] = [[1, 2, 1, 3, 1], [2, 1, 1, 3, 2]]
    det[:, :5, 1] = rng.permutation(10)[:10].reshape(2, 5) / 10.0 + 0.05
    det[:, :5, 2:] = gt[:, [0, 1, 0, 2, 0]] + rng.uniform(
        -0.03, 0.03, (2, 5, 4)).astype("float32")
    det[1, :, 2:] = np.sort(det[1, :, 2:].reshape(6, 2, 2), axis=1) \
        .reshape(6, 4)
    return {
        "x": _boxes(rng, (5,)), "y": _boxes(rng, (7,)),
        "xb": _boxes(rng, (2, 5)),
        "prior": priors[:6], "pvar": np.tile(np.array(
            [0.1, 0.1, 0.2, 0.2], "float32"), (6, 1)),
        "priors": priors, "pvars": np.tile(np.array(
            [0.1, 0.1, 0.2, 0.2], "float32"), (24, 1)),
        "target": _boxes(rng, (5,)),
        "pix_prior": _boxes(rng, (6,), 0.0, 40.0),
        "pix_target": _boxes(rng, (5,), 0.0, 40.0),
        "deltas": (0.3 * f(2, 6, 4)),
        "feat": f(1, 8, 4, 4), "img": f(1, 3, 32, 32),
        "feat2": f(1, 4, 4, 5),
        "clip_boxes": rng.uniform(-20, 120, (2, 6, 4)).astype("float32"),
        "im_info": np.array([[60, 80, 1.0], [100, 50, 2.0]], "float32"),
        "quad_in": f(2, 8, 3, 4),
        "dist": rng.uniform(0, 1, (2, 5, 8)).astype("float32"),
        "ta_x": f(2, 4, 3), "match": match,
        "cls_loss": rng.permutation(12).reshape(2, 6).astype("float32"),
        "gt": gt, "gt_lbl": gt_lbl, "loc": 0.5 * f(2, 24, 4),
        "mined": mined,
        "nms_boxes": _boxes(rng, (2, 24)),
        "nms_scores": rng.permutation(144).reshape(2, 3, 24)
        .astype("float32") / 144.0,
        "rpn_scores": rng.permutation(96).reshape(2, 3, 4, 4)
        .astype("float32") / 96.0,
        "rpn_deltas": (0.1 * f(2, 12, 4, 4)),
        "rpn_info": np.array([[64, 64, 1.0], [56, 60, 1.0]], "float32"),
        "anchors": anchors, "anchor_var": np.ones((4, 4, 3, 4), "float32"),
        "fmap": f(2, 3, 8, 9), "rois": rois,
        "pix_rois": rois * 2.0, "quads": quads,
        "rpn_gt": np.concatenate([_boxes(rng, (2, 2), 0.0, 56.0),
                                  np.zeros((2, 1, 4), "float32")], 1),
        "flat_anchors": anchors.reshape(-1, 4),
        "prop_rois": prop_rois, "prop_gt": prop_gt,
        "prop_cls": np.array([[3, 1, 0], [2, 2, 0]], "int32"),
        "mask_info": np.array([[64, 64, 1.0], [80, 80, 2.0]], "float32"),
        "mask_cls": np.array([[1, 3, 2], [2, 0, 1]], "int32"),
        "crowd": np.array([[0, 0, 1], [0, 0, 0]], "int32"),
        "segms": segms,
        "mask_rois": _boxes(rng, (2, 5), 0.0, 40.0) * np.array(
            [[[1.0]], [[2.0]]], "float32"),
        "mask_labels": np.array([[1, 0, 3, 2, 1], [0, 2, 1, 1, 0]],
                                "int32"),
        "yolo_x": (0.5 * f(2, 2 * 9, 4, 4)), "yolo_gt": yolo_gt,
        "yolo_lbl": yolo_lbl,
        "ps_x": f(1, 2 * 3 * 3, 8, 8),
        "det": det, "map_gt_lbl": gt_lbl[..., 0][:, :4].astype("int32"),
        "map_gt": gt,
    }


def _raw(pkg, op_type, inputs, outputs, attrs=None):
    """Append one op with fresh outputs ({slot: dtype}) through the
    package's LayerHelper; returns the outputs in slot order."""
    helper = importlib.import_module(
        pkg.__name__ + ".core.layer_helper").LayerHelper(op_type)
    outs = {s: helper.create_variable_for_type_inference(dtype=d)
            for s, d in outputs.items()}
    helper.append_op(op_type, inputs, outs, attrs or {})
    return list(outs.values())


def _L(pkg):
    return pkg.layers


# name -> (float inputs the gradient is taken w.r.t., other inputs, build)
CASES = {
    "iou_similarity": ([], ["x", "y"], lambda p, v: [
        _L(p).iou_similarity(v["x"], v["y"])]),
    "batched_iou_similarity": ([], ["xb", "y"], lambda p, v: _raw(
        p, "batched_iou_similarity", {"X": v["xb"], "Y": v["y"]},
        {"Out": "float32"})),
    "box_coder_encode": ([], ["prior", "pvar", "target"], lambda p, v: [
        _L(p).box_coder(v["prior"], v["pvar"], v["target"])]),
    "box_coder_encode_pixels_no_var": ([], ["pix_prior", "pix_target"],
                                       lambda p, v: [_L(p).box_coder(
                                           v["pix_prior"], None,
                                           v["pix_target"],
                                           box_normalized=False)]),
    "box_coder_decode": (["deltas"], ["prior", "pvar"], lambda p, v: [
        _L(p).box_coder(v["prior"], v["pvar"], v["deltas"],
                        code_type="decode_center_size")]),
    "prior_box": ([], ["feat", "img"], lambda p, v: list(_L(p).prior_box(
        v["feat"], v["img"], min_sizes=[8.0, 16.0], max_sizes=[12.0, 24.0],
        aspect_ratios=[2.0, 3.0], flip=True, clip=True))),
    "prior_box_steps": ([], ["feat", "img"], lambda p, v: list(
        _L(p).prior_box(v["feat"], v["img"], min_sizes=[10.0],
                        aspect_ratios=[1.0, 2.0], steps=(7.0, 9.0),
                        offset=0.3))),
    "density_prior_box": ([], ["feat", "img"], lambda p, v: list(
        _L(p).density_prior_box(v["feat"], v["img"], densities=[2, 1],
                                fixed_sizes=[8.0, 16.0],
                                fixed_ratios=[1.0, 2.0], clip=True))),
    "anchor_generator": ([], ["feat2"], lambda p, v: list(
        _L(p).anchor_generator(v["feat2"], anchor_sizes=[32.0, 64.0],
                               aspect_ratios=[0.5, 1.0, 2.0],
                               stride=[16.0, 16.0]))),
    "box_clip": ([], ["clip_boxes", "im_info"], lambda p, v: [
        _L(p).box_clip(v["clip_boxes"], v["im_info"])]),
    "polygon_box_transform": ([], ["quad_in"], lambda p, v: [
        _L(p).polygon_box_transform(v["quad_in"])]),
    "bipartite_match": ([], ["dist"], lambda p, v: list(
        _L(p).bipartite_match(v["dist"]))),
    "bipartite_match_per_prediction": ([], ["dist"], lambda p, v: list(
        _L(p).bipartite_match(v["dist"], match_type="per_prediction",
                              dist_threshold=0.6))),
    "target_assign": ([], ["ta_x", "match"], lambda p, v: list(
        _L(p).target_assign(v["ta_x"], v["match"], mismatch_value=-3))),
    "mine_hard_examples": ([], ["cls_loss", "match"], lambda p, v: [
        _L(p).mine_hard_examples(v["cls_loss"], v["match"],
                                 neg_pos_ratio=1.5)]),
    "ssd_encode_matched": ([], ["gt", "match", "prior", "pvar"],
                           lambda p, v: _raw(
                               p, "ssd_encode_matched",
                               {"GTBox": v["gt"], "MatchIndices": v["match"],
                                "PriorBox": v["prior"],
                                "PriorBoxVar": v["pvar"]},
                               {"Out": "float32"})),
    "ssd_gather_labels": ([], ["gt_lbl", "match"], lambda p, v: _raw(
        p, "ssd_gather_labels", {"GTLabel": v["gt_lbl"],
                                 "MatchIndices": v["match"]},
        {"Out": "int32"}, {"background_label": 0})),
    "ssd_mining_masks": ([], ["mined"], lambda p, v: _raw(
        p, "ssd_mining_masks", {"Mined": v["mined"]},
        {"Selected": "float32", "Positive": "float32"})),
    "ssd_smooth_l1": (["loc"], ["pvars"], lambda p, v: _raw(
        p, "ssd_smooth_l1", {"X": v["loc"], "Y": v["pvars"]},
        {"Out": "float32"})),
    "multiclass_nms": ([], ["nms_boxes", "nms_scores"], lambda p, v: list(
        _L(p).multiclass_nms(v["nms_boxes"], v["nms_scores"],
                             score_threshold=0.3, nms_top_k=10,
                             keep_top_k=30, nms_threshold=0.4))),
    "multiclass_nms_eta_pixels": ([], ["nms_boxes", "nms_scores"],
                                  lambda p, v: list(_L(p).multiclass_nms(
                                      v["nms_boxes"], v["nms_scores"],
                                      score_threshold=0.05, nms_top_k=-1,
                                      keep_top_k=-1, nms_threshold=0.7,
                                      normalized=False, nms_eta=0.8,
                                      background_label=-1))),
    "generate_proposals": ([], ["rpn_scores", "rpn_deltas", "rpn_info",
                                "anchors", "anchor_var"], lambda p, v: list(
        _L(p).generate_proposals(
            v["rpn_scores"], v["rpn_deltas"], v["rpn_info"], v["anchors"],
            v["anchor_var"], pre_nms_top_n=20, post_nms_top_n=10,
            nms_thresh=0.5, min_size=1.0, eta=0.9))),
    "roi_align": (["fmap"], ["rois"], lambda p, v: [
        _L(p).roi_align(v["fmap"], v["rois"], pooled_height=3,
                        pooled_width=2)]),
    "roi_pool": (["fmap"], ["rois"], lambda p, v: [
        _L(p).roi_pool(v["fmap"], v["rois"], pooled_height=2,
                       pooled_width=2)]),
    "roi_pool_scaled": (["fmap"], ["pix_rois"], lambda p, v: [
        _L(p).roi_pool(v["fmap"], v["pix_rois"], pooled_height=3,
                       pooled_width=2, spatial_scale=0.5)]),
    "roi_perspective_transform": (["fmap"], ["quads"], lambda p, v: _raw(
        p, "roi_perspective_transform", {"X": v["fmap"], "ROIs": v["quads"]},
        {"Out": "float32"}, {"transformed_height": 6,
                             "transformed_width": 5})),
    "rpn_target_assign": ([], ["flat_anchors", "rpn_gt"], lambda p, v: _raw(
        p, "rpn_target_assign", {"Anchor": v["flat_anchors"],
                                 "GtBoxes": v["rpn_gt"]},
        {"ScoreLabel": "int32", "LocTarget": "float32"},
        {"rpn_batch_size_per_im": 12, "rpn_positive_overlap": 0.5,
         "rpn_negative_overlap": 0.2})),
    "generate_proposal_labels": ([], ["prop_rois", "prop_cls", "prop_gt"],
                                 lambda p, v: _raw(
                                     p, "generate_proposal_labels",
                                     {"RpnRois": v["prop_rois"],
                                      "GtClasses": v["prop_cls"],
                                      "GtBoxes": v["prop_gt"]},
                                     {"LabelsInt32": "int32",
                                      "BboxTargets": "float32",
                                      "BboxInsideWeights": "float32"},
                                     {"batch_size_per_im": 6,
                                      "fg_thresh": 0.3,
                                      "bg_thresh_hi": 0.3})),
    "generate_mask_labels": ([], ["mask_info", "mask_cls", "crowd", "segms",
                                  "mask_rois", "mask_labels"],
                             lambda p, v: _raw(
                                 p, "generate_mask_labels",
                                 {"ImInfo": v["mask_info"],
                                  "GtClasses": v["mask_cls"],
                                  "IsCrowd": v["crowd"],
                                  "GtSegms": v["segms"],
                                  "Rois": v["mask_rois"],
                                  "LabelsInt32": v["mask_labels"]},
                                 {"MaskRois": "float32",
                                  "RoiHasMaskInt32": "int32",
                                  "MaskInt32": "int32"},
                                 {"num_classes": 4, "resolution": 7})),
    "yolov3_loss": (["yolo_x"], ["yolo_gt", "yolo_lbl"], lambda p, v: [
        _L(p).yolov3_loss(v["yolo_x"], v["yolo_gt"], v["yolo_lbl"],
                          [10, 14, 23, 27, 37, 58], [0, 1], 4,
                          ignore_thresh=0.5, downsample_ratio=32)]),
    "yolov3_loss_off_scale": (["yolo_x"], ["yolo_gt", "yolo_lbl"],
                              lambda p, v: [_L(p).yolov3_loss(
                                  v["yolo_x"], v["yolo_gt"], v["yolo_lbl"],
                                  [10, 14, 23, 27, 37, 58, 81, 82],
                                  [2, 3], 4, ignore_thresh=0.7,
                                  downsample_ratio=16)]),
    "psroi_pool": (["ps_x"], ["rois"], lambda p, v: [
        _L(p).psroi_pool(v["ps_x"], v["rois"], 2, 1.0, 3, 3)]),
    "detection_map": ([], ["det", "map_gt_lbl", "map_gt"], lambda p, v: [
        _L(p).detection_map(v["det"], v["map_gt_lbl"], v["map_gt"], 4,
                            overlap_threshold=0.5)]),
    "detection_map_11point": ([], ["det", "map_gt_lbl", "map_gt"],
                              lambda p, v: [_L(p).detection_map(
                                  v["det"], v["map_gt_lbl"], v["map_gt"], 4,
                                  background_label=-1,
                                  overlap_threshold=0.3,
                                  ap_version="11point")]),
}


def run_op_case(pkg, build, feed, floats, shapes=None):
    """Build ``build(pkg, vars)`` over data vars of ``feed`` and fetch its
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
                cots[c.name] = np.random.RandomState(i).randn(
                    *shapes[i]).astype("float32")
                terms.append(L.reduce_sum(L.elementwise_mul(o, c)))
            total = terms[0] if len(terms) == 1 else L.sums(terms)
            grads = pkg.gradients(total, [v[k] for k in floats])
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        return exe.run(main, feed=dict(feed, **cots),
                       fetch_list=outs + list(grads)), len(outs)


def assert_matches(build, feed, floats, name):
    shapes = None
    if floats:
        shapes = [np.shape(o) for o in run_op_case(tfluid, build, feed,
                                                   [])[0]]
    got, n_out = run_op_case(tfluid, build, feed, floats, shapes)
    want, _ = run_op_case(fluid, build, feed, floats, shapes)
    assert len(got) == len(want) == n_out + len(floats)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg="%s %d" % (name, i))
        elif i < n_out:
            assert np.isfinite(w).all(), (name, i)
            np.testing.assert_allclose(g, w, err_msg="%s %d" % (name, i),
                                       **OUT_TOL)
        else:
            assert np.abs(w).max() > 0, (name, i)
            assert rel_l2(g, w) <= GRAD_REL_L2, (name, i, rel_l2(g, w))
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_detection_op_matches_reference(name):
    floats, others, build = CASES[name]
    feed = {k: a for k, a in _inputs().items() if k in floats + others}
    got = assert_matches(build, feed, floats, name)
    if name.startswith("multiclass_nms"):
        assert 0 < got[1].min() and (got[0][..., 0] == -1).any()


def test_every_detection_op_has_a_case():
    """The port registers every op type of the reference's
    ``detection_ops`` and its two detection ops of ``misc_ops``, and the
    cases above run each of them."""
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch.core.op_registry as treg

    ref = {n for n, f in jreg.OP_IMPLS.items()
           if f.__module__.endswith(".detection_ops")}
    ref |= {"detection_map", "psroi_pool"}
    assert len(ref) == 26 and ref <= set(treg.OP_IMPLS)
    seen = set()
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


def test_multiclass_nms_shares_one_iou_matrix_per_image(monkeypatch):
    """The port's NMS builds one [M, M] IoU an image for all its classes
    (the reference's class ``vmap`` builds one a class): a 3-class batch
    of 2 images makes one [2, M, M] matrix."""
    from paddle_tpu_torch.core.opimpl import detection_ops as d

    shapes = []
    real = d._nms_iou

    def spy(boxes, norm=True):
        out = real(boxes, norm)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(d, "_nms_iou", spy)
    inputs = _inputs()
    feed = {k: inputs[k] for k in ("nms_boxes", "nms_scores")}
    run_op_case(tfluid, CASES["multiclass_nms"][2], feed, [])
    assert shapes == [(2, 24, 24)]


def test_roi_pool_range_max_equals_masked_max():
    """The sparse-table rectangle max of ``roi_pool`` against a masked max
    over every rectangle of a 5 x 7 map (bitwise: max is exact)."""
    import torch

    from paddle_tpu_torch.core.opimpl import detection_ops as d

    img = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(0))
    table, lh, lw = d._range_max_table(img)
    flat = table.reshape(-1, 3)
    for a in range(5):
        for b in range(a + 1, 6):
            for c in range(7):
                for e in range(c + 1, 8):
                    kh = (b - a).bit_length() - 1
                    kw = (e - c).bit_length() - 1
                    got = None
                    for y in (a, b - (1 << kh)):
                        for x in (c, e - (1 << kw)):
                            v = flat[((kh * lw + kw) * 5 + y) * 7 + x]
                            got = v if got is None else torch.maximum(got, v)
                    want = img[:, a:b, c:e].amax(dim=(1, 2))
                    assert torch.equal(got, want), (a, b, c, e)
