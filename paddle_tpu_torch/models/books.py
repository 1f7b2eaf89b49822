"""The remaining book-chapter models (the port's copy of
``paddle_tpu/models/books.py``; ref ``tests/book/``):
``test_fit_a_line.py`` (linear regression), ``test_understand_sentiment.py``
(fc + stacked-LSTM sentiment), ``test_recommender_system.py`` (dual-tower
embedding recommender). The sentiment and recommender tables are narrow
and dense: their backward is the row scatter-add kernel on the card."""

from .. import layers
from .common import FeedSpec, ModelSpec

__all__ = ["fit_a_line", "understand_sentiment", "recommender_system"]


def fit_a_line(feature_dim=13):
    """Linear regression on uci_housing-shaped data."""
    x = layers.data("x", shape=[feature_dim], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, size=1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    return ModelSpec(
        loss,
        feeds={"x": FeedSpec([feature_dim]), "y": FeedSpec([1])},
        fetches={"pred": pred})


def understand_sentiment(word_dict_len=500, seq_len=32, emb_dim=32,
                         hid_dim=64, class_num=2, stacked_num=3):
    """The book's stacked-LSTM sentiment classifier: embedding -> fc+lstm
    stack with alternating directions -> max-pool over time -> softmax."""
    words = layers.data("words", shape=[seq_len], dtype="int64")
    length = layers.data("length", shape=[], dtype="int64")
    label = layers.data("label", shape=[1], dtype="int64")

    emb = layers.embedding(words, size=[word_dict_len, emb_dim])
    fc1 = layers.fc(emb, size=hid_dim, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(fc1, size=hid_dim, lengths=length)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(layers.concat(inputs, axis=-1), size=hid_dim,
                       num_flatten_dims=2)
        lstm, _ = layers.dynamic_lstm(fc, size=hid_dim, lengths=length,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    mask = layers.sequence_mask(length, maxlen=seq_len, dtype="float32")
    neg = layers.scale(layers.elementwise_sub(
        layers.fill_constant([1], "float32", 1.0), mask), scale=-1e9)

    def time_max(x):
        return layers.reduce_max(
            layers.elementwise_add(x, layers.unsqueeze(neg, [2]),
                                   axis=0), dim=1)

    pooled = layers.concat([time_max(inputs[0]), time_max(inputs[1])],
                           axis=-1)
    logits = layers.fc(pooled, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return ModelSpec(
        loss,
        feeds={"words": FeedSpec([seq_len], "int64", 0, word_dict_len),
               "length": FeedSpec([], "int64", seq_len // 2, seq_len + 1),
               "label": FeedSpec([1], "int64", 0, class_num)},
        fetches={"acc": acc},
        tokens_per_example=seq_len)


def recommender_system(user_vocab=200, item_vocab=300, emb_dim=16,
                       categorical=((10, "age"), (8, "job"), (5, "genre"))):
    """Dual-tower recommender (the book's movielens model): user tower =
    id + categorical embeddings, item tower = id + genre; cosine match
    scaled to a 0..5 rating, L2-regressed."""
    uid = layers.data("uid", shape=[1], dtype="int64")
    iid = layers.data("iid", shape=[1], dtype="int64")
    feats = {}
    for size, name in categorical:
        feats[name] = layers.data(name, shape=[1], dtype="int64")
    score = layers.data("score", shape=[1], dtype="float32")

    sizes = {n: s for s, n in categorical}

    def tower(ids, vocab, extra, name):
        # embedding squeezes the trailing [B, 1] ids to [B, emb] already
        parts = [layers.embedding(ids, size=[vocab, emb_dim])]
        for nm in extra:
            parts.append(layers.embedding(feats[nm],
                                          size=[sizes[nm], emb_dim]))
        h = layers.fc(layers.concat(parts, axis=-1), size=32, act="tanh",
                      name=name)
        return h

    usr = tower(uid, user_vocab, [n for _, n in categorical[:2]], "usr")
    itm = tower(iid, item_vocab, [categorical[2][1]], "itm")
    sim = layers.cos_sim(usr, itm)
    pred = layers.scale(sim, scale=5.0)
    loss = layers.mean(layers.square_error_cost(pred, score))
    return ModelSpec(
        loss,
        feeds={"uid": FeedSpec([1], "int64", 0, user_vocab),
               "iid": FeedSpec([1], "int64", 0, item_vocab),
               **{n: FeedSpec([1], "int64", 0, s)
                  for s, n in categorical},
               "score": FeedSpec([1], "float32", 0.0, 5.0)},
        fetches={"pred": pred})
