"""SE-ResNeXt-50 (``paddle_tpu/models/se_resnext.py``; ref
``benchmark/fluid/models/se_resnext.py``: grouped bottlenecks and
squeeze-excitation gating).

The executor's epilogue fusion takes its 1x1 conv -> BN (+ relu) chains
to the fused-conv kernels; the grouped 3x3 convs fail the fusion gate
(groups 1 only) and run as ``F.conv2d`` + ``batch_norm``."""

from .. import layers
from ..layers import metric_op
from .common import FeedSpec, ModelSpec

__all__ = ["se_resnext50"]


def _conv_bn(x, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(x, num_filters=num_filters, filter_size=filter_size,
                         stride=stride, padding=(filter_size - 1) // 2,
                         groups=groups, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _squeeze_excitation(x, num_channels, reduction_ratio=16):
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=num_channels // reduction_ratio,
                        act="relu")
    excitation = layers.fc(squeeze, size=num_channels, act="sigmoid")
    # the gate: [B, C] broadcast over [B, C, H, W]
    excitation = layers.reshape(excitation, [-1, num_channels, 1, 1])
    return layers.elementwise_mul(x, excitation)


def _shortcut(x, ch_out, stride):
    if x.shape[1] != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride)
    return x


def _block(x, num_filters, stride, cardinality, reduction_ratio):
    y = _conv_bn(x, num_filters, 1, act="relu")
    y = _conv_bn(y, num_filters, 3, stride, groups=cardinality, act="relu")
    y = _conv_bn(y, num_filters * 2, 1)
    y = _squeeze_excitation(y, num_filters * 2, reduction_ratio)
    short = _shortcut(x, num_filters * 2, stride)
    return layers.elementwise_add(short, y, act="relu")


def se_resnext50(image_shape=(3, 224, 224), class_num=1000, cardinality=32,
                 reduction_ratio=16):
    depths = [3, 4, 6, 3]
    num_filters = [128, 256, 512, 1024]
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = _conv_bn(img, 64, 7, 2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for i, d in enumerate(depths):
        for j in range(d):
            x = _block(x, num_filters[i], 2 if (i > 0 and j == 0) else 1,
                       cardinality, reduction_ratio)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    x = layers.dropout(x, 0.5)
    logits = layers.fc(x, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = metric_op.accuracy(layers.softmax(logits), label)
    return ModelSpec(
        loss,
        feeds={"img": FeedSpec(list(image_shape), "float32", -1.0, 1.0),
               "label": FeedSpec([1], "int64", 0, class_num)},
        fetches={"acc": acc})
