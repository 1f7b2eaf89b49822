"""Transformer-base NMT (BASELINE config 3; the port's copy of
``paddle_tpu/models/transformer.py``): ``transformer_base`` builds the same
training program as ``paddle_tpu``'s, var for var and name for name, on the
fused ``multi_head_attention`` layer (flash attention), the last-axis
``layer_norm`` (fused LayerNorm) and ``fused_linear_smooth_ce`` (fused
projection + label-smoothed CE); each runs the port's hand-written kernels
on CUDA, forward and backward.

Pre-norm residual blocks, padded [B, S] batches with length masks, and
label smoothing in closed form, as in ``paddle_tpu``. The mixture-of-experts
FFN (``moe_experts > 0``) and the decoder-only LM family
(``transformer_lm``/``_step``/``_chunk``) come with later slices.
"""

from .. import layers
from ..core.param_attr import ParamAttr
from .common import FeedSpec, ModelSpec

__all__ = ["transformer_base", "transformer_flops_per_token"]


def _ffn(x, d_model, d_ff, name):
    h = layers.fc(x, size=d_ff, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=name + "_fc1.w",
                                       sharding=(None, "mp")),
                  name=name + "_fc1")
    return layers.fc(h, size=d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + "_fc2.w",
                                          sharding=("mp", None)),
                     name=name + "_fc2")


def _prenorm(x, sub, dropout_rate, name):
    y = sub(layers.layer_norm(x, begin_norm_axis=2))
    if dropout_rate:
        y = layers.dropout(y, dropout_rate)
    return layers.elementwise_add(x, y)


def _pad_bias(lengths, seq_len, neg=-1e9):
    """[B] lengths -> additive attention bias [B, 1, 1, S]."""
    mask = layers.sequence_mask(lengths, maxlen=seq_len, dtype="float32")
    bias = layers.scale(mask, scale=-neg, bias=neg)  # 1->0, 0->neg
    return layers.reshape(bias, [-1, 1, 1, seq_len])


def _embed(ids, pos, vocab_size, d_model, dropout_rate, name):
    word = layers.embedding(ids, size=[vocab_size, d_model],
                            param_attr=ParamAttr(name=name + "_word_emb"))
    word = layers.scale(word, scale=float(d_model) ** 0.5)
    posv = layers.embedding(pos, size=[pos.shape[-1] + 1024, d_model],
                            param_attr=ParamAttr(name=name + "_pos_emb"))
    x = layers.elementwise_add(word, posv)
    if dropout_rate:
        x = layers.dropout(x, dropout_rate)
    return x


def transformer_base(src_vocab=30000, trg_vocab=30000, seq_len=256,
                     d_model=512, d_ff=2048, n_head=8, n_layer=6,
                     dropout_rate=0.1, label_smooth_eps=0.1,
                     moe_experts=0, moe_k=2):
    if moe_experts:
        raise NotImplementedError(
            "transformer_base(moe_experts > 0): the mixture-of-experts FFN "
            "comes with the multi-device slice of paddle_tpu_torch")
    src = layers.data("src_ids", shape=[seq_len], dtype="int64")
    trg = layers.data("trg_ids", shape=[seq_len], dtype="int64")
    lbl = layers.data("lbl_ids", shape=[seq_len], dtype="int64")
    src_len = layers.data("src_len", shape=[], dtype="int64")
    trg_len = layers.data("trg_len", shape=[], dtype="int64")
    pos = layers.range(0, seq_len, 1, "int64")

    src_bias = _pad_bias(src_len, seq_len)
    enc = _embed(src, pos, src_vocab, d_model, dropout_rate, "src")
    for i in range(n_layer):
        nm = "enc%d" % i
        enc = _prenorm(
            enc, lambda x: layers.multi_head_attention(
                x, x, x, attn_bias=src_bias, d_model=d_model, n_head=n_head,
                dropout_rate=dropout_rate, name=nm + "_attn"),
            dropout_rate, nm + "_attn")
        enc = _prenorm(enc, lambda x: _ffn(x, d_model, d_ff, nm + "_ffn"),
                       dropout_rate, nm + "_ffn")
    enc = layers.layer_norm(enc, begin_norm_axis=2)

    dec = _embed(trg, pos, trg_vocab, d_model, dropout_rate, "trg")
    for i in range(n_layer):
        nm = "dec%d" % i
        dec = _prenorm(
            dec, lambda x: layers.multi_head_attention(
                x, x, x, d_model=d_model, n_head=n_head, causal=True,
                dropout_rate=dropout_rate, name=nm + "_self"),
            dropout_rate, nm + "_self")
        dec = _prenorm(
            dec, lambda x: layers.multi_head_attention(
                x, enc, enc, attn_bias=src_bias, d_model=d_model,
                n_head=n_head, dropout_rate=dropout_rate, name=nm + "_cross"),
            dropout_rate, nm + "_cross")
        dec = _prenorm(dec, lambda x: _ffn(x, d_model, d_ff, nm + "_ffn"),
                       dropout_rate, nm + "_ffn")
    dec = layers.layer_norm(dec, begin_norm_axis=2)

    # fused projection + closed-form label smoothing: the [B, S, V] logits
    # never reach device memory (ops/fused_ce.py kernel)
    ce = layers.fused_linear_smooth_ce(
        dec, lbl, size=trg_vocab, epsilon=label_smooth_eps,
        bias_attr=False,
        param_attr=ParamAttr(name="out_proj.w", sharding=(None, "mp")),
        name="out_proj")  # [B, S]
    mask = layers.sequence_mask(trg_len, maxlen=seq_len, dtype="float32")
    tok_loss = layers.elementwise_mul(ce, mask)
    loss = layers.elementwise_div(layers.reduce_sum(tok_loss),
                                  layers.reduce_sum(mask))

    return ModelSpec(
        loss,
        feeds={"src_ids": FeedSpec([seq_len], "int64", 0, src_vocab),
               "trg_ids": FeedSpec([seq_len], "int64", 0, trg_vocab),
               "lbl_ids": FeedSpec([seq_len], "int64", 0, trg_vocab),
               "src_len": FeedSpec([], "int64", seq_len, seq_len + 1),
               "trg_len": FeedSpec([], "int64", seq_len, seq_len + 1)},
        flops_per_example=transformer_flops_per_token(
            src_vocab, trg_vocab, seq_len, d_model, d_ff, n_head,
            n_layer) * seq_len,
        tokens_per_example=seq_len,
        sequence_feeds=["src_ids", "trg_ids", "lbl_ids"])


def transformer_flops_per_token(src_vocab, trg_vocab, seq_len, d_model, d_ff,
                                n_head, n_layer):
    """Analytic fwd+bwd matmul FLOPs per target token (MFU accounting).

    Counts: per-layer QKV/out projections (4*d^2), FFN (2*d*d_ff), attention
    score+context (2*2*S*d per token), final vocab projection; x2 for
    mul+add, x3 for fwd+bwd. Encoder layers process src tokens (same S here).
    """
    per_layer_proj = 4 * d_model * d_model + 2 * d_model * d_ff
    attn = 2 * seq_len * d_model  # scores + context, per token
    enc = n_layer * (per_layer_proj + attn)
    dec = n_layer * (per_layer_proj + d_model * d_model * 4 + 2 * attn)
    out = d_model * trg_vocab
    total_mac = enc + dec + out
    return 2 * 3 * total_mac
