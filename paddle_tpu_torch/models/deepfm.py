"""DeepFM CTR model (the port's copy of ``paddle_tpu/models/deepfm.py``;
BASELINE config 5, high-dimensional sparse features).

The first-order scalar weights and the K-dim FM embeddings live in ONE
fused ``[V, W]`` table: embeddings in columns 0..K-1, the first-order
weight in column K, and zero padding up to W, the next power of two (W =
32 at K = 16). One lookup gathers both terms and one sparse (rows, values)
gradient updates both: its backward is one row scatter-add, the port's
``scatter_add`` kernel (``ops/scatter.py``), when Adam densifies it. The
padding columns start at zero and get zero gradient, so they stay zero.

The reference's per-row latency floors (``row_op_floors``,
``row_latency_s_per_example``) are TPU measurements and are not carried
over; the bound of the port's scatter is in ``PERF.md``."""

import math

from .. import layers
from ..core.initializer import Initializer
from ..core.param_attr import ParamAttr
from .common import FeedSpec, ModelSpec

__all__ = ["deepfm"]


class _PaddedTableInitializer(Initializer):
    """Xavier-uniform over the used columns, exact ZEROS in the padding
    columns (the padding also gets zero gradient, so it stays zero)."""

    def __init__(self, used_cols):
        self.used_cols = used_cols

    def __call__(self, var, block):
        v, w = var.shape
        limit = math.sqrt(6.0 / (v + self.used_cols))
        block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": var.shape, "dtype": str(var.dtype),
                   "min": -limit, "max": limit, "seed": 0})
        mask = block.create_var(shape=(w,), dtype=str(var.dtype))
        block.append_op(
            "assign_value", outputs={"Out": mask},
            attrs={"shape": (w,), "dtype": str(var.dtype),
                   "values": [1.0] * self.used_cols
                   + [0.0] * (w - self.used_cols)})
        block.append_op("elementwise_mul", {"X": var, "Y": mask},
                        {"Out": var}, {})


def deepfm(sparse_feature_dim=100000, num_fields=26, embedding_size=16,
           dense_dim=13, hidden_sizes=(400, 400, 400)):
    feat_ids = layers.data("feat_ids", shape=[num_fields], dtype="int64")
    dense = layers.data("dense_value", shape=[dense_dim], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")

    # fused table width: the next power of two >= K + 1
    width = 1
    while width < embedding_size + 1:
        width *= 2
    if width > 128:
        width = embedding_size + 1

    table = layers.embedding(
        feat_ids, size=[sparse_feature_dim, width],
        is_sparse=True, is_distributed=True,
        param_attr=ParamAttr(
            name="fm_table",
            initializer=_PaddedTableInitializer(embedding_size + 1)))
    # emb: [B, F, K]; w1: [B, F, 1]: one gather, one backward scatter
    emb = layers.slice(table, axes=[2], starts=[0], ends=[embedding_size])
    w1 = layers.slice(table, axes=[2], starts=[embedding_size],
                      ends=[embedding_size + 1])

    # first-order term: per-feature scalar weights
    first_order = layers.reduce_sum(layers.squeeze(w1, [2]), dim=1,
                                    keep_dim=True)

    # second-order FM term over the field embeddings [B, F, K]
    sum_sq = layers.pow(layers.reduce_sum(emb, dim=1), factor=2.0)
    sq_sum = layers.reduce_sum(layers.pow(emb, factor=2.0), dim=1)
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True), scale=0.5)

    # deep part: flattened embeddings + dense features -> MLP
    deep = layers.concat(
        [layers.reshape(emb, [-1, num_fields * embedding_size]), dense],
        axis=1)
    for i, h in enumerate(hidden_sizes):
        deep = layers.fc(deep, size=h, act="relu", name="deep_fc%d" % i)
    deep_out = layers.fc(deep, size=1, name="deep_out")

    logits = layers.elementwise_add(
        layers.elementwise_add(first_order, second_order), deep_out)
    label_f = layers.cast(label, "float32")
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logits, label_f))
    prob = layers.ops.sigmoid(logits)

    # forward + backward FLOPs of the MLP per example (the FM terms and the
    # embedding traffic are small beside it)
    dims = [num_fields * embedding_size + dense_dim] + list(hidden_sizes) \
        + [1]
    mlp_flops = 6 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return ModelSpec(
        loss,
        feeds={"feat_ids": FeedSpec([num_fields], "int64", 0,
                                    sparse_feature_dim),
               "dense_value": FeedSpec([dense_dim], "float32", 0.0, 1.0),
               "label": FeedSpec([1], "int64", 0, 2)},
        fetches={"prob": prob},
        flops_per_example=mlp_flops,
        # the fused-table geometry, so that consumers need not re-derive
        # it: width is the padded power of two, NOT embedding_size
        extras={"fused_table": {"vocab": sparse_feature_dim,
                                "width": width,
                                "num_fields": num_fields}})
