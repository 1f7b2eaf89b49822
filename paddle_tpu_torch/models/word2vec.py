"""Word2vec-style N-gram language model (the port's copy of
``paddle_tpu/models/word2vec.py``; ref ``tests/book/test_word2vec.py``):
``window`` context words -> the next word, under a full softmax, sampled
NCE or a hierarchical sigmoid. The context words read ONE shared sparse
table (``shared_w``), so a step's (rows, values) gradient gathers its rows
from several lookup sites."""

from .. import layers
from ..core.param_attr import ParamAttr
from .common import FeedSpec, ModelSpec

__all__ = ["ngram_lm"]


def ngram_lm(dict_size=2073, emb_dim=32, hidden_size=256, window=4,
             loss_type="softmax", neg_samples=16):
    """``loss_type``: 'softmax' (full softmax-CE), 'nce' (sampled NCE, ref
    ``nce_op``, log-uniform negatives) or 'hsigmoid' (hierarchical sigmoid,
    ref ``hierarchical_sigmoid_op``): the reference word2vec
    configurations."""
    ctx_words = [layers.data("w%d" % i, shape=[1], dtype="int64")
                 for i in range(window)]
    next_word = layers.data("next_word", shape=[1], dtype="int64")

    embs = [layers.embedding(w, size=[dict_size, emb_dim], is_sparse=True,
                             param_attr=ParamAttr(name="shared_w"))
            for w in ctx_words]
    concat = layers.concat(embs, axis=1)
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    if loss_type == "nce":
        loss = layers.mean(layers.nce(hidden, next_word, dict_size,
                                      num_neg_samples=neg_samples,
                                      sampler="log_uniform"))
    elif loss_type == "hsigmoid":
        loss = layers.mean(layers.hsigmoid(hidden, next_word, dict_size))
    else:
        logits = layers.fc(hidden, size=dict_size)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, next_word))
    feeds = {"w%d" % i: FeedSpec([1], "int64", 0, dict_size)
             for i in range(window)}
    feeds["next_word"] = FeedSpec([1], "int64", 0, dict_size)
    return ModelSpec(loss, feeds=feeds)
