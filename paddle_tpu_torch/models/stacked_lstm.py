"""Stacked LSTM sentiment classifier (the port's copy of
``paddle_tpu/models/stacked_lstm.py``; ref ``benchmark/fluid/models/
stacked_dynamic_lstm.py``): embedding, then fc -> LSTM stacked
``stacked_num`` deep (the later layers reversed), max-pooled over each
row's steps. Padded [B, T] ids with a lengths feed replace LoD; each LSTM
is ``lstm_seq``, a Python loop over the steps under autograd."""

from .. import layers
from ..layers import metric_op
from .common import FeedSpec, ModelSpec

__all__ = ["stacked_lstm_net"]


def stacked_lstm_net(dict_size=30000, emb_dim=512, hid_dim=512,
                     stacked_num=3, class_num=2, seq_len=80):
    words = layers.data("words", shape=[seq_len], dtype="int64")
    lengths = layers.data("lengths", shape=[], dtype="int64",
                          append_batch_size=True)
    label = layers.data("label", shape=[1], dtype="int64")

    emb = layers.embedding(words, size=[dict_size, emb_dim])
    fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(fc1, size=hid_dim * 4, lengths=lengths)

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc_i = layers.fc(inputs, size=hid_dim * 4, num_flatten_dims=2)
        lstm_i, _ = layers.dynamic_lstm(fc_i, size=hid_dim * 4,
                                        lengths=lengths, is_reverse=True)
        inputs = [fc_i, lstm_i]

    fc_last = layers.sequence_pool(inputs[0], pool_type="max",
                                   lengths=lengths)
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max",
                                     lengths=lengths)
    logits = layers.fc([fc_last, lstm_last], size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = metric_op.accuracy(layers.softmax(logits), label)
    return ModelSpec(
        loss,
        feeds={"words": FeedSpec([seq_len], "int64", 0, dict_size),
               "lengths": FeedSpec([], "int64", 1, seq_len + 1),
               "label": FeedSpec([1], "int64", 0, class_num)},
        fetches={"acc": acc},
        tokens_per_example=seq_len)
