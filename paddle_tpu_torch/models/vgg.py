"""VGG-16 (``paddle_tpu/models/vgg.py``; ref
``benchmark/fluid/models/vgg.py``: conv groups, batch norm, fc)."""

from .. import layers
from ..layers import metric_op
from .common import FeedSpec, ModelSpec

__all__ = ["vgg16"]


def _conv_block(x, num_filter, dropouts):
    for rate in dropouts:
        x = layers.conv2d(x, num_filters=num_filter, filter_size=3,
                          stride=1, padding=1, act="relu")
        if rate:
            x = layers.dropout(x, rate)
    return layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")


def vgg16(image_shape=(3, 32, 32), class_num=10):
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = _conv_block(img, 64, [0.3, 0])
    x = _conv_block(x, 128, [0.4, 0])
    x = _conv_block(x, 256, [0.4, 0.4, 0])
    x = _conv_block(x, 512, [0.4, 0.4, 0])
    x = _conv_block(x, 512, [0.4, 0.4, 0])
    x = layers.dropout(x, 0.5)
    x = layers.fc(x, size=512, act=None)
    x = layers.batch_norm(x, act="relu")
    x = layers.dropout(x, 0.5)
    x = layers.fc(x, size=512, act=None)
    logits = layers.fc(x, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = metric_op.accuracy(layers.softmax(logits), label)
    return ModelSpec(
        loss,
        feeds={"img": FeedSpec(list(image_shape), "float32", -1.0, 1.0),
               "label": FeedSpec([1], "int64", 0, class_num)},
        fetches={"acc": acc})
