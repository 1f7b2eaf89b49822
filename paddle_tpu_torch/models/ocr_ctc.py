"""CRNN-style OCR with a CTC loss (the port's copy of
``paddle_tpu/models/ocr_ctc.py``; ref the OCR CTC configuration over
``warpctc_op``): a conv feature extractor over the image -> the columns
as a sequence -> bi-GRU -> per-step class logits -> CTC
(``layers.warpctc``)."""

from .. import layers
from .common import FeedSpec, ModelSpec

__all__ = ["crnn_ctc"]


def crnn_ctc(num_classes=95, image_shape=(1, 32, 128), max_label_len=16,
             hid_dim=96):
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[max_label_len], dtype="int64")
    label_len = layers.data("label_len", shape=[], dtype="int64")

    x = img
    for i, ch in enumerate((16, 32, 64)):
        x = layers.conv2d(x, ch, 3, padding=1, act="relu")
        # halve H each stage; halve W only in the first stage so the
        # sequence axis stays long enough for CTC alignments
        stride = (2, 2) if i == 0 else (2, 1)
        x = layers.pool2d(x, pool_size=2, pool_stride=list(stride),
                          pool_type="max")
    # [B, C, H', W'] -> sequence over W': [B, W', C*H']
    b, c, h, w = x.shape
    seq = layers.reshape(layers.transpose(x, [0, 3, 1, 2]), [-1, w, c * h])

    fwd = layers.dynamic_gru(
        layers.fc(seq, size=hid_dim * 3, num_flatten_dims=2), size=hid_dim)
    bwd = layers.dynamic_gru(
        layers.fc(seq, size=hid_dim * 3, num_flatten_dims=2), size=hid_dim,
        is_reverse=True)
    feat = layers.concat([fwd, bwd], axis=-1)
    # class 0..num_classes-1 are symbols; the last index is the CTC blank
    logits = layers.fc(feat, size=num_classes + 1, num_flatten_dims=2)

    loss = layers.mean(layers.warpctc(
        logits, label, blank=num_classes, label_length=label_len))
    return ModelSpec(
        loss,
        feeds={"img": FeedSpec(list(image_shape)),
               "label": FeedSpec([max_label_len], "int64", 0, num_classes),
               "label_len": FeedSpec([], "int64", 4, max_label_len + 1)},
        tokens_per_example=max_label_len)
