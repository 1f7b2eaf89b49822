"""Semantic role labeling with a linear-chain CRF head (the port's copy
of ``paddle_tpu/models/label_semantic_roles.py``; ref the book's
``tests/book/test_label_semantic_roles.py``): word, predicate and mark
embeddings -> a stack of GRUs in alternating directions -> emissions ->
``linear_chain_crf``, decoded by ``crf_decoding``. Padded [B, T] batches
with a length feed replace LoD; the CRF masks the padded steps. The three
tables are narrow and dense, so their backward is the row scatter-add
kernel on the card (``ops/rowops.py``)."""

from .. import layers
from ..core.param_attr import ParamAttr
from .common import FeedSpec, ModelSpec

__all__ = ["srl_crf"]


def srl_crf(word_dict_len=500, label_dict_len=20, pred_dict_len=50,
            seq_len=16, word_dim=32, hidden_dim=64, depth=2):
    word = layers.data("word", shape=[seq_len], dtype="int64")
    predicate = layers.data("verb", shape=[seq_len], dtype="int64")
    mark = layers.data("mark", shape=[seq_len], dtype="int64")
    label = layers.data("label", shape=[seq_len], dtype="int64")
    length = layers.data("length", shape=[], dtype="int64")

    w_emb = layers.embedding(word, size=[word_dict_len, word_dim])
    p_emb = layers.embedding(predicate, size=[pred_dict_len, word_dim])
    m_emb = layers.embedding(mark, size=[2, word_dim])
    x = layers.concat([w_emb, p_emb, m_emb], axis=-1)

    # stacked alternating-direction recurrent trunk (the book's
    # bidirectional stack)
    for i in range(depth):
        fwd = layers.dynamic_gru(
            layers.fc(x, size=hidden_dim * 3, num_flatten_dims=2),
            size=hidden_dim, is_reverse=bool(i % 2))
        x = layers.concat([x, fwd], axis=-1)

    emission = layers.fc(x, size=label_dict_len, num_flatten_dims=2)
    crf_cost = layers.linear_chain_crf(
        emission, label, length=length,
        param_attr=ParamAttr(name="crfw"))
    loss = layers.mean(crf_cost)
    decoded = layers.crf_decoding(emission, param_attr=ParamAttr(name="crfw"),
                                  length=length)
    return ModelSpec(
        loss,
        feeds={"word": FeedSpec([seq_len], "int64", 0, word_dict_len),
               "verb": FeedSpec([seq_len], "int64", 0, pred_dict_len),
               "mark": FeedSpec([seq_len], "int64", 0, 2),
               "label": FeedSpec([seq_len], "int64", 0, label_dict_len),
               "length": FeedSpec([], "int64", seq_len // 2, seq_len + 1)},
        fetches={"decoded": decoded},
        tokens_per_example=seq_len)
