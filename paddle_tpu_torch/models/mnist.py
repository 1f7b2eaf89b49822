"""MNIST models (``paddle_tpu/models/mnist.py``; ref
``benchmark/fluid/models/mnist.py``, the conv net, and the MLP of
``tests/book/test_recognize_digits.py``). BASELINE config 1."""

from .. import layers
from ..layers import metric_op
from .common import FeedSpec, ModelSpec

__all__ = ["mlp", "cnn"]


def _head(logits, label, class_num, image_shape):
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = metric_op.accuracy(layers.softmax(logits), label)
    return ModelSpec(
        loss,
        feeds={"img": FeedSpec(image_shape, "float32", 0.0, 1.0),
               "label": FeedSpec([1], "int64", 0, class_num)},
        fetches={"acc": acc})


def mlp(hidden_sizes=(128, 64), class_num=10):
    """784 -> fc stack -> softmax; the 'recognize_digits' MLP."""
    img = layers.data("img", shape=[784], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = img
    for i, h in enumerate(hidden_sizes):
        x = layers.fc(x, size=h, act="relu", name="mlp_fc%d" % i)
    logits = layers.fc(x, size=class_num, name="mlp_out")
    return _head(logits, label, class_num, [784])


def cnn(class_num=10):
    """conv-pool x2 + fc, the benchmark/fluid mnist net."""
    img = layers.data("img", shape=[1, 28, 28], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    x = layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    x = layers.conv2d(x, num_filters=50, filter_size=5, act="relu")
    x = layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    logits = layers.fc(x, size=class_num)
    return _head(logits, label, class_num, [1, 28, 28])
