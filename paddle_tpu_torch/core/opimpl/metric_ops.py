"""Metric ops (the ``accuracy`` of ``paddle_tpu/core/opimpl/metric_ops.py``;
ref ``paddle/fluid/operators/metrics/accuracy_op``)."""

import torch

from ..op_registry import register, get, put


@register("accuracy")
def _accuracy(env, op):
    """Share of rows whose label is among the top-k ``Indices``; int32
    counts, as in ``paddle_tpu``."""
    pred_idx = get(env, op.input("Indices")).to(torch.int32)  # [N, k]
    label = get(env, op.input("Label")).to(torch.int32)
    if label.dim() == 1:
        label = label[:, None]
    num_correct = (pred_idx == label).any(dim=1).float().sum()
    total = pred_idx.shape[0]
    put(env, op.output("Accuracy"), (num_correct / total).reshape(()))
    put(env, op.output("Correct"), num_correct.to(torch.int32).reshape(1))
    put(env, op.output("Total"), torch.tensor(
        [total], dtype=torch.int32, device=pred_idx.device))
