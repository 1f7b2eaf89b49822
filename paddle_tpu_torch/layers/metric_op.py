"""Metric layers (the ``accuracy`` of ``paddle_tpu/layers/metric_op.py``;
ref ``python/paddle/fluid/layers/metric_op.py``)."""

from ..core.layer_helper import LayerHelper
from . import nn

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    _, indices = nn.topk(input, k=k)
    acc = helper.create_variable_for_type_inference(dtype="float32", shape=())
    correct = correct or helper.create_variable_for_type_inference(
        dtype="int32", shape=(1,))
    total = total or helper.create_variable_for_type_inference(
        dtype="int32", shape=(1,))
    helper.append_op("accuracy",
                     {"Indices": indices, "Label": label},
                     {"Accuracy": acc, "Correct": correct, "Total": total},
                     {})
    return acc
