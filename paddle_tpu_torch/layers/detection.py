"""Detection layers (the port's ``paddle_tpu/layers/detection.py``; ref
``python/paddle/fluid/layers/detection.py``).

Fixed-shape re-designs of the LoD-output ops: NMS-style layers return
padded tensors (pad marker -1) plus a valid count, instead of LoD levels:
the static-shape convention used framework-wide.
"""

from ..core.layer_helper import LayerHelper

__all__ = [
    "prior_box", "density_prior_box", "box_coder", "iou_similarity",
    "roi_pool", "roi_align", "anchor_generator", "multiclass_nms",
    "box_clip", "generate_proposals", "bipartite_match", "target_assign",
    "mine_hard_examples", "polygon_box_transform", "yolov3_loss",
    "ssd_loss", "detection_output",
]


def _dtype(x):
    return str(x.dtype)


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(x), shape=(x.shape[0], y.shape[0]))
    helper.append_op("iou_similarity", {"X": x, "Y": y}, {"Out": out})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", name=name)
    if code_type == "encode_center_size":
        shape = (target_box.shape[0], prior_box.shape[0], 4)
    else:
        shape = tuple(target_box.shape)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(target_box), shape=shape)
    inputs = {"PriorBox": prior_box, "TargetBox": target_box}
    if prior_box_var is not None and hasattr(prior_box_var, "name"):
        inputs["PriorBoxVar"] = prior_box_var
    helper.append_op("box_coder", inputs, {"OutputBox": out},
                     {"code_type": code_type,
                      "box_normalized": box_normalized})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    # shape inference mirrors the op: ars = dedup(1.0 + ratios (+flips)),
    # boxes per cell = len(min)*len(ars) + len(min)*len(max)
    ars = [1.0]
    for r in aspect_ratios:
        if all(abs(r - a) > 1e-6 for a in ars):
            ars.append(r)
            if flip:
                ars.append(1.0 / r)
    k = len(min_sizes) * len(ars) + len(min_sizes) * len(max_sizes or [])
    h, w = input.shape[2], input.shape[3]
    boxes = helper.create_variable_for_type_inference(
        dtype="float32", shape=(h, w, k, 4))
    var = helper.create_variable_for_type_inference(
        dtype="float32", shape=(h, w, k, 4))
    helper.append_op(
        "prior_box", {"Input": input, "Image": image},
        {"Boxes": boxes, "Variances": var},
        {"min_sizes": list(min_sizes), "max_sizes": list(max_sizes or []),
         "aspect_ratios": list(aspect_ratios), "variances": list(variance),
         "flip": flip, "clip": clip, "step_w": steps[0], "step_h": steps[1],
         "offset": offset})
    return boxes, var


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    # mirror the op: sizes zip with densities
    k = sum(int(d) ** 2 * len(fixed_ratios or [1.0])
            for _, d in zip(fixed_sizes or [], densities or []))
    h, w = input.shape[2], input.shape[3]
    boxes = helper.create_variable_for_type_inference(
        dtype="float32", shape=(h, w, k, 4))
    var = helper.create_variable_for_type_inference(
        dtype="float32", shape=(h, w, k, 4))
    helper.append_op(
        "density_prior_box", {"Input": input, "Image": image},
        {"Boxes": boxes, "Variances": var},
        {"densities": list(densities or []),
         "fixed_sizes": list(fixed_sizes or []),
         "fixed_ratios": list(fixed_ratios or []),
         "variances": list(variance), "clip": clip,
         "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, var


def anchor_generator(input, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset=0.5, name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference(dtype="float32")
    var = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        "anchor_generator", {"Input": input},
        {"Anchors": anchors, "Variances": var},
        {"anchor_sizes": list(anchor_sizes),
         "aspect_ratios": list(aspect_ratios), "stride": list(stride),
         "variances": list(variance), "offset": offset})
    return anchors, var


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    helper = LayerHelper("roi_pool")
    out = helper.create_variable_for_type_inference(dtype=_dtype(input))
    helper.append_op("roi_pool", {"X": input, "ROIs": rois}, {"Out": out},
                     {"pooled_height": pooled_height,
                      "pooled_width": pooled_width,
                      "spatial_scale": spatial_scale})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(input))
    helper.append_op("roi_align", {"X": input, "ROIs": rois}, {"Out": out},
                     {"pooled_height": pooled_height,
                      "pooled_width": pooled_width,
                      "spatial_scale": spatial_scale})
    return out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_count=True):
    """[N, M, 4] boxes + [N, C, M] scores -> ([N, keep_top_k, 6] padded
    detections, [N] counts). Ref ``multiclass_nms`` (LoD out there)."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(bboxes), shape=(bboxes.shape[0], keep_top_k, 6))
    count = helper.create_variable_for_type_inference(
        dtype="int32", shape=(bboxes.shape[0],))
    helper.append_op(
        "multiclass_nms", {"BBoxes": bboxes, "Scores": scores},
        {"Out": out, "Count": count},
        {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
         "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
         "normalized": normalized, "nms_eta": nms_eta,
         "background_label": background_label})
    return (out, count) if return_count else out


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=tuple(input.shape))
    helper.append_op("box_clip", {"Input": input, "ImInfo": im_info},
                     {"Output": out})
    return out


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(
        dtype="float32", shape=(scores.shape[0], post_nms_top_n, 4))
    probs = helper.create_variable_for_type_inference(
        dtype="float32", shape=(scores.shape[0], post_nms_top_n))
    count = helper.create_variable_for_type_inference(
        dtype="int32", shape=(scores.shape[0],))
    helper.append_op(
        "generate_proposals",
        {"Scores": scores, "BboxDeltas": bbox_deltas, "ImInfo": im_info,
         "Anchors": anchors, "Variances": variances},
        {"RpnRois": rois, "RpnRoiProbs": probs, "Count": count},
        {"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
         "nms_thresh": nms_thresh, "min_size": min_size, "eta": eta})
    return rois, probs, count


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference(
        dtype="int32", shape=(dist_matrix.shape[0], dist_matrix.shape[2]))
    dist = helper.create_variable_for_type_inference(
        dtype=_dtype(dist_matrix),
        shape=(dist_matrix.shape[0], dist_matrix.shape[2]))
    helper.append_op(
        "bipartite_match", {"DistMat": dist_matrix},
        {"ColToRowMatchIndices": idx, "ColToRowMatchDist": dist},
        {"match_type": match_type, "dist_threshold": dist_threshold})
    return idx, dist


def target_assign(input, matched_indices, mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(input))
    weight = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        "target_assign",
        {"X": input, "MatchIndices": matched_indices},
        {"Out": out, "OutWeight": weight},
        {"mismatch_value": mismatch_value})
    return out, weight


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    out = helper.create_variable_for_type_inference(
        dtype="int32", shape=tuple(match_indices.shape))
    helper.append_op(
        "mine_hard_examples",
        {"ClsLoss": cls_loss, "MatchIndices": match_indices},
        {"UpdatedMatchIndices": out},
        {"neg_pos_ratio": neg_pos_ratio})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=tuple(input.shape))
    helper.append_op("polygon_box_transform", {"Input": input},
                     {"Output": out})
    return out


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(
        dtype="float32", shape=(x.shape[0],))
    helper.append_op(
        "yolov3_loss",
        {"X": x, "GTBox": gt_box, "GTLabel": gt_label},
        {"Loss": loss},
        {"anchors": list(anchors), "anchor_mask": list(anchor_mask),
         "class_num": class_num, "ignore_thresh": ignore_thresh,
         "downsample_ratio": downsample_ratio})
    return loss


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, neg_pos_ratio=3.0, background_label=0,
             loc_loss_weight=1.0, conf_loss_weight=1.0):
    """SSD multibox loss composed from the matching/assignment layers
    (ref ``layers/detection.py:ssd_loss``, itself a composition):
    bipartite match + per-prediction fill -> targets -> smooth-L1 loc loss
    + softmax conf loss with hard negative mining.

    location [N, P, 4], confidence [N, P, C], gt_box [N, B, 4] (normalized
    corners, zero-area rows are padding), gt_label [N, B, 1] int."""
    from . import nn, tensor  # noqa: F401 (tensor: fill_constant)

    n, p = location.shape[0], location.shape[1]

    helper = LayerHelper("ssd_loss")
    # [N, B, P] IoU of gt rows vs priors
    iou = helper.create_variable_for_type_inference(
        dtype="float32", shape=(n, gt_box.shape[1], p))
    helper.append_op("batched_iou_similarity",
                     {"X": gt_box, "Y": prior_box},
                     {"Out": iou})
    match_idx, _ = bipartite_match(iou, match_type="per_prediction")

    # regression targets: encoded matched gt vs priors
    enc = helper.create_variable_for_type_inference(
        dtype="float32", shape=(n, p, 4))
    helper.append_op(
        "ssd_encode_matched",
        {"GTBox": gt_box, "MatchIndices": match_idx,
         "PriorBox": prior_box,
         **({"PriorBoxVar": prior_box_var}
            if prior_box_var is not None else {})},
        {"Out": enc})
    loc_l = helper.create_variable_for_type_inference(
        dtype="float32", shape=(n, p))
    helper.append_op("ssd_smooth_l1", {"X": location, "Y": enc},
                     {"Out": loc_l})

    # classification target: matched gt label else background
    lbl = helper.create_variable_for_type_inference(
        dtype="int64", shape=(n, p))
    helper.append_op(
        "ssd_gather_labels",
        {"GTLabel": gt_label, "MatchIndices": match_idx},
        {"Out": lbl}, {"background_label": background_label})
    conf_l = nn.smooth_softmax_with_cross_entropy(confidence, lbl)

    mined = mine_hard_examples(conf_l, match_idx,
                               neg_pos_ratio=neg_pos_ratio)
    # selection masks from the mined indices: pos >= 0, kept negs == -1
    sel = helper.create_variable_for_type_inference(
        dtype="float32", shape=(n, p))
    posm = helper.create_variable_for_type_inference(
        dtype="float32", shape=(n, p))
    helper.append_op("ssd_mining_masks", {"Mined": mined},
                     {"Selected": sel, "Positive": posm})
    loc_loss = nn.reduce_sum(nn.elementwise_mul(loc_l, posm))
    conf_loss = nn.reduce_sum(nn.elementwise_mul(conf_l, sel))
    npos = nn.elementwise_max(
        nn.reduce_sum(posm),
        tensor.fill_constant([], "float32", 1.0))
    return nn.elementwise_div(
        nn.elementwise_add(
            nn.scale(loc_loss, scale=loc_loss_weight),
            nn.scale(conf_loss, scale=conf_loss_weight)), npos)


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode + NMS (ref ``layers/detection.py:detection_output``):
    loc [N, P, 4] offsets, scores [N, P, C] post-softmax."""
    from . import tensor

    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    sc = tensor.transpose(scores, perm=[0, 2, 1])  # [N, C, P]
    return multiclass_nms(decoded, sc, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold=nms_threshold,
                          nms_eta=nms_eta, background_label=background_label)
