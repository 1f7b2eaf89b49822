"""BERT-base pretraining (BASELINE config 4; ``paddle_tpu/models/bert.py``).

``bert_encoder`` and ``bert_base`` build the same programs as
``paddle_tpu``'s, var for var and name for name, so weights saved by
either package load in the other. ``bert_base`` is the pretraining model
``paddle_tpu``'s bench.py trains: the masked-LM head (gelu transform,
LayerNorm, the fused vocabulary projection + CE over every position,
weighted by ``mlm_weights``) and the next-sentence head on [CLS]. A
served model puts its own head on the encoder (``chip_smoke.py`` builds a
[CLS] classifier)."""

from .. import layers
from ..core.param_attr import ParamAttr
from .common import FeedSpec, ModelSpec

__all__ = ["bert_base", "bert_encoder"]


def _postnorm(x, sub, dropout_rate):
    y = sub(x)
    if dropout_rate:
        y = layers.dropout(y, dropout_rate)
    return layers.layer_norm(layers.elementwise_add(x, y), begin_norm_axis=2)


def bert_encoder(input_ids, segment_ids, input_len, seq_len, vocab_size,
                 d_model, d_ff, n_head, n_layer, dropout_rate,
                 max_position=512, type_vocab=2):
    """Serve with ``dropout_rate=0.0``: ``Program.clone(for_test=True)``
    turns ``dropout`` ops off but leaves attention dropout on, in
    ``paddle_tpu`` as here."""
    pos = layers.range(0, seq_len, 1, "int64")
    word = layers.embedding(input_ids, size=[vocab_size, d_model],
                            param_attr=ParamAttr(name="word_emb"))
    posv = layers.embedding(pos, size=[max(max_position, seq_len), d_model],
                            param_attr=ParamAttr(name="pos_emb"))
    seg = layers.embedding(segment_ids, size=[type_vocab, d_model],
                           param_attr=ParamAttr(name="seg_emb"))
    x = layers.elementwise_add(layers.elementwise_add(word, seg), posv)
    x = layers.layer_norm(x, begin_norm_axis=2)
    if dropout_rate:
        x = layers.dropout(x, dropout_rate)

    mask = layers.sequence_mask(input_len, maxlen=seq_len, dtype="float32")
    bias = layers.reshape(
        layers.scale(mask, scale=1e9, bias=-1e9), [-1, 1, 1, seq_len])

    for i in range(n_layer):
        nm = "layer%d" % i
        x = _postnorm(
            x, lambda h: layers.multi_head_attention(
                h, h, h, attn_bias=bias, d_model=d_model, n_head=n_head,
                dropout_rate=dropout_rate, name=nm + "_attn"),
            dropout_rate)
        x = _postnorm(
            x, lambda h: layers.fc(
                layers.fc(h, size=d_ff, num_flatten_dims=2, act="gelu",
                          param_attr=ParamAttr(name=nm + "_ffn1.w",
                                               sharding=(None, "mp")),
                          name=nm + "_ffn1"),
                size=d_model, num_flatten_dims=2,
                param_attr=ParamAttr(name=nm + "_ffn2.w",
                                     sharding=("mp", None)),
                name=nm + "_ffn2"),
            dropout_rate)
    return x


def bert_base(vocab_size=30522, seq_len=128, d_model=768, d_ff=3072,
              n_head=12, n_layer=12, dropout_rate=0.1):
    """The pretraining loss: the masked-LM CE at every position, weighted
    by ``mlm_weights`` over their sum + 1e-6 (static shapes: no gather of
    the masked positions), plus the mean next-sentence CE."""
    input_ids = layers.data("input_ids", shape=[seq_len], dtype="int64")
    segment_ids = layers.data("segment_ids", shape=[seq_len], dtype="int64")
    input_len = layers.data("input_len", shape=[], dtype="int64")
    mlm_labels = layers.data("mlm_labels", shape=[seq_len], dtype="int64")
    mlm_weights = layers.data("mlm_weights", shape=[seq_len],
                              dtype="float32")
    nsp_label = layers.data("nsp_label", shape=[1], dtype="int64")

    x = bert_encoder(input_ids, segment_ids, input_len, seq_len, vocab_size,
                     d_model, d_ff, n_head, n_layer, dropout_rate)

    # MLM head: transform, then the fused vocabulary projection + CE
    h = layers.fc(x, size=d_model, num_flatten_dims=2, act="gelu",
                  name="mlm_transform")
    h = layers.layer_norm(h, begin_norm_axis=2)
    mlm_ce = layers.fused_linear_smooth_ce(
        h, mlm_labels, size=vocab_size,
        param_attr=ParamAttr(name="mlm_out.w", sharding=(None, "mp")),
        name="mlm_out")
    mlm_loss = layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(mlm_ce, mlm_weights)),
        layers.elementwise_add(
            layers.reduce_sum(mlm_weights),
            layers.fill_constant([], "float32", 1e-6)))

    # NSP head on [CLS] (position 0)
    cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = layers.squeeze(cls, [1])
    pooled = layers.fc(cls, size=d_model, act="tanh", name="pooler")
    nsp_logits = layers.fc(pooled, size=2, name="nsp_out")
    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(nsp_logits, nsp_label))

    loss = layers.elementwise_add(mlm_loss, nsp_loss)

    per_layer_mac = (4 * d_model * d_model + 2 * d_model * d_ff
                     + 2 * seq_len * d_model)
    total_mac = n_layer * per_layer_mac + d_model * vocab_size
    return ModelSpec(
        loss,
        feeds={"input_ids": FeedSpec([seq_len], "int64", 0, vocab_size),
               "segment_ids": FeedSpec([seq_len], "int64", 0, 2),
               "input_len": FeedSpec([], "int64", seq_len, seq_len + 1),
               "mlm_labels": FeedSpec([seq_len], "int64", 0, vocab_size),
               "mlm_weights": FeedSpec([seq_len], "float32", 0.0, 1.0),
               "nsp_label": FeedSpec([1], "int64", 0, 2)},
        flops_per_example=2 * 3 * total_mac * seq_len,
        tokens_per_example=seq_len,
        sequence_feeds=["input_ids", "segment_ids", "mlm_labels",
                        "mlm_weights"])
