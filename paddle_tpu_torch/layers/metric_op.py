"""Metric layers (``paddle_tpu/layers/metric_op.py``; ref
``python/paddle/fluid/layers/metric_op.py``)."""

from ..core.layer_helper import LayerHelper
from . import nn

__all__ = ["accuracy", "auc"]


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


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC (``paddle_tpu/layers/metric_op.py:24``): two
    persistable [num_thresholds + 1] histograms, zero at startup, that the
    ``auc`` op adds each batch to. Returns (auc, batch auc, [stat_pos,
    stat_neg]); the batch auc is the streaming one, as in the
    reference."""
    from . import tensor

    helper = LayerHelper("auc")
    stats = [tensor.create_global_var(
        shape=(num_thresholds + 1,), value=0.0, dtype="float32",
        persistable=True, name=helper.name + suffix)
        for suffix in (".stat_pos", ".stat_neg")]
    auc_out = helper.create_variable_for_type_inference(dtype="float32",
                                                        shape=())
    helper.append_op(
        "auc",
        {"Predict": input, "Label": label, "StatPos": stats[0],
         "StatNeg": stats[1]},
        {"AUC": auc_out, "StatPosOut": stats[0], "StatNegOut": stats[1]},
        {"num_thresholds": num_thresholds, "curve": curve})
    return auc_out, auc_out, stats
