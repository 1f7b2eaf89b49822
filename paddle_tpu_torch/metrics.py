"""Streaming host-side metrics (the port's ``paddle_tpu/metrics.py``; ref
``python/paddle/fluid/metrics.py``:
MetricBase, CompositeMetric, Precision, Recall, Accuracy, ChunkEvaluator,
EditDistance, Auc, DetectionMAP)."""

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall",
           "Accuracy", "EditDistance", "Auc", "ChunkEvaluator",
           "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if isinstance(v, (int, float)):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)
            elif isinstance(v, list) and k != "_metrics":
                setattr(self, k, [])

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        return self.value / self.weight if self.weight else 0.0


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances, dtype=float)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(d > 0))

    def eval(self):
        avg = self.total_distance / self.seq_num if self.seq_num else 0.0
        rate = self.instance_error / self.seq_num if self.seq_num else 0.0
        return avg, rate


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._n = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1).astype(int)
        pos_prob = preds[:, -1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip((pos_prob * self._n).astype(int), 0, self._n)
        np.add.at(self._stat_pos, bucket, labels)
        np.add.at(self._stat_neg, bucket, 1 - labels)

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp_prev = np.concatenate([[0.0], tp[:-1]])
        fp_prev = np.concatenate([[0.0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (tot_pos * tot_neg))


class ChunkEvaluator(MetricBase):
    """Streaming chunk P/R/F1 (ref ``metrics.py`` ChunkEvaluator): feed the
    three counts emitted by ``layers.chunk_eval`` each batch."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks /
                     self.num_infer_chunks) if self.num_infer_chunks else 0.0
        recall = (self.num_correct_chunks /
                  self.num_label_chunks) if self.num_label_chunks else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return precision, recall, f1


class DetectionMAP(MetricBase):
    """Streaming mean of per-batch mAP values from the ``detection_map``
    op (ref ``metrics.py`` DetectionMAP's accumulate mode)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total = 0.0
        self.weight = 0

    def update(self, value, weight=1):
        self.total += float(value) * int(weight)
        self.weight += int(weight)

    def eval(self):
        return self.total / self.weight if self.weight else 0.0
