"""SSD single-shot detector (the port's ``paddle_tpu/models/ssd.py``; ref
``benchmark`` / PaddleCV SSD configs built
on ``layers/detection.py:ssd_loss`` + ``prior_box`` + ``multiclass_nms``;
in-tree capability anchors: ``operators/detection/*``).

Small MobileNet-ish trunk with two detection heads; demonstrates the full
training (prior match -> target assign -> mined multibox loss) and
inference (decode -> NMS) pipelines end-to-end on fixed shapes."""

from .. import layers
from .common import FeedSpec, ModelSpec

__all__ = ["ssd_lite"]


def _conv_bn(x, ch, stride):
    x = layers.conv2d(x, ch, 3, stride=stride, padding=1, bias_attr=False)
    return layers.batch_norm(x, act="relu")


def ssd_lite(num_classes=5, image_shape=(3, 64, 64), max_boxes=4):
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    gt_box = layers.data("gt_box", shape=[max_boxes, 4], dtype="float32")
    gt_label = layers.data("gt_label", shape=[max_boxes, 1], dtype="int64")

    x = _conv_bn(img, 16, 2)
    x = _conv_bn(x, 32, 2)
    c1 = _conv_bn(x, 64, 2)   # 8x8
    c2 = _conv_bn(c1, 64, 2)  # 4x4

    locs, confs, priors, pvars = [], [], [], []
    for feat, sizes in ((c1, [16.0]), (c2, [32.0])):
        h, w = feat.shape[2], feat.shape[3]
        boxes, vars_ = layers.prior_box(
            feat, img, min_sizes=sizes, aspect_ratios=[1.0, 2.0],
            flip=True, clip=True)
        n_priors = boxes.shape[2]
        loc = layers.conv2d(feat, n_priors * 4, 3, padding=1)
        conf = layers.conv2d(feat, n_priors * num_classes, 3, padding=1)
        # [B, K*4, H, W] -> [B, H*W*K, 4]
        locs.append(layers.reshape(
            layers.transpose(loc, [0, 2, 3, 1]), [-1, h * w * n_priors, 4]))
        confs.append(layers.reshape(
            layers.transpose(conf, [0, 2, 3, 1]),
            [-1, h * w * n_priors, num_classes]))
        priors.append(layers.reshape(boxes, [h * w * n_priors, 4]))
        pvars.append(layers.reshape(vars_, [h * w * n_priors, 4]))

    loc = layers.concat(locs, axis=1)
    conf = layers.concat(confs, axis=1)
    prior = layers.concat(priors, axis=0)
    pvar = layers.concat(pvars, axis=0)

    loss = layers.ssd_loss(loc, conf, gt_box, gt_label, prior,
                           prior_box_var=pvar)
    dets, count = layers.detection_output(
        loc, layers.softmax(conf), prior, pvar, keep_top_k=10,
        nms_top_k=40, score_threshold=0.01)
    return ModelSpec(
        loss,
        feeds={"img": FeedSpec(list(image_shape), "float32", -1.0, 1.0),
               "gt_box": FeedSpec([max_boxes, 4], "float32", 0.05, 0.95),
               "gt_label": FeedSpec([max_boxes, 1], "int64", 1, num_classes)},
        fetches={"detections": dets, "det_count": count})
