"""Metric ops (``paddle_tpu/core/opimpl/metric_ops.py``: accuracy, auc,
precision_recall; ref ``paddle/fluid/operators/metrics/``). AUC keeps its
threshold histograms in persistable state the op reads and writes, so a
step that computes it is captured like any other: the buckets are counted
by a scatter-add on the device."""

import torch
import torch.nn.functional as F

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
    # a fill on the device, not a host copy: a captured step may not wait
    # on the host
    put(env, op.output("Total"), torch.full(
        (1,), total, dtype=torch.int32, device=pred_idx.device))


@register("auc")
def _auc(env, op):
    """Streaming ROC AUC over ``num_thresholds + 1`` buckets (ref
    ``auc_op.cc``): this batch's positive and negative counts per bucket
    of the positive-class probability are added to the state, and the
    area is the trapezoid sum over descending thresholds."""
    preds = get(env, op.input("Predict"))  # [N, 2] binary probabilities
    labels = get(env, op.input("Label")).reshape(-1).to(torch.int32)
    stat_pos = get(env, op.input("StatPos"))
    stat_neg = get(env, op.input("StatNeg"))
    nt = op.attr("num_thresholds", 4095)
    bucket = torch.clamp((preds[:, -1] * nt).to(torch.int32), 0, nt).long()
    pos = labels.to(stat_pos.dtype)
    new_pos = stat_pos.index_add(0, bucket, pos)
    new_neg = stat_neg.index_add(0, bucket, 1 - pos)
    tp = torch.cumsum(new_pos.flip(0), 0)
    fp = torch.cumsum(new_neg.flip(0), 0)
    tp_prev = F.pad(tp[:-1], (1, 0))
    fp_prev = F.pad(fp[:-1], (1, 0))
    area = ((fp - fp_prev) * (tp + tp_prev) / 2.0).sum()
    tot = tp[-1] * fp[-1]
    auc = torch.where(tot > 0, area / (tot + 1e-12), torch.zeros_like(area))
    put(env, op.output("AUC"), auc.reshape(()))
    put(env, op.output("StatPosOut"), new_pos)
    put(env, op.output("StatNegOut"), new_neg)


@register("precision_recall")
def _precision_recall(env, op):
    """Per-class true and false positives and false negatives of a batch
    (``AccumStatesInfo``, [C, 3]) and its macro and micro precision,
    recall and F1 (``BatchMetrics``, [6])."""
    cls_num = op.attr("class_number")
    pred = get(env, op.input("Indices")).reshape(-1).long()
    label = get(env, op.input("Labels")).reshape(-1).long()
    onehot_p = F.one_hot(pred, cls_num).float()
    onehot_l = F.one_hot(label, cls_num).float()
    tp = (onehot_p * onehot_l).sum(0)
    fp = (onehot_p * (1 - onehot_l)).sum(0)
    fn = ((1 - onehot_p) * onehot_l).sum(0)

    def prf(t, f_p, f_n):
        p = t / torch.clamp_min(t + f_p, 1e-12)
        r = t / torch.clamp_min(t + f_n, 1e-12)
        return p, r, 2 * p * r / torch.clamp_min(p + r, 1e-12)

    precision, recall, f1 = prf(tp, fp, fn)
    macro = torch.stack([precision.mean(), recall.mean(), f1.mean()])
    micro = torch.stack(prf(tp.sum(), fp.sum(), fn.sum()))
    put(env, op.output("BatchMetrics"), torch.cat([macro, micro]))
    put(env, op.output("AccumStatesInfo"), torch.stack([tp, fp, fn], dim=1))
