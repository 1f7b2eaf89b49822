"""BERT-base encoder (BASELINE config 4; ``paddle_tpu/models/bert.py``).

``bert_encoder`` builds the same program as ``paddle_tpu``'s, var for var
and name for name, so weights saved by either package load in the other.
A served model puts its own head on the encoder (``chip_smoke.py`` builds
a [CLS] classifier)."""

from .. import layers
from ..core.param_attr import ParamAttr

__all__ = ["bert_encoder"]


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
