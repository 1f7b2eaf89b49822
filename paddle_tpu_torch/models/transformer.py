"""Transformer-base NMT (BASELINE config 3; the port's copy of
``paddle_tpu/models/transformer.py``): ``transformer_base`` builds the same
training program as ``paddle_tpu``'s, var for var and name for name, on the
fused ``multi_head_attention`` layer (flash attention), the last-axis
``layer_norm`` (fused LayerNorm) and ``fused_linear_smooth_ce`` (fused
projection + label-smoothed CE); each runs the port's hand-written kernels
on CUDA, forward and backward.

Pre-norm residual blocks, padded [B, S] batches with length masks, and
label smoothing in closed form, as in ``paddle_tpu``. The mixture-of-experts
FFN (``moe_experts > 0``) comes with a later slice.

The decoder-only LM family (``paddle_tpu/models/transformer.py:155-353``):
``transformer_lm`` (full causal program), ``transformer_lm_step`` (KV-cached
one-token step) and ``transformer_lm_chunk`` (KV-cached K-token chunk) name
every parameter explicitly, so the three programs share one scope's weights
(``serving.DecodeBatcher`` drives the step and chunk programs, a
``serving.DraftLM`` the full one).
"""

from .. import layers
from ..core.param_attr import ParamAttr
from .common import FeedSpec, ModelSpec

__all__ = ["transformer_base", "transformer_flops_per_token",
           "transformer_lm", "lm_step_config", "transformer_lm_step",
           "transformer_lm_chunk"]


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


# ---------------------------------------------------------------------------
# Decoder-only LM family: the full causal program and the KV-cached step and
# chunk programs the decode tier serves. Every parameter is named, so the
# three programs share weights through the scope.
# ---------------------------------------------------------------------------

def _named_ln(x, name, axis):
    return layers.layer_norm(x, begin_norm_axis=axis,
                             param_attr=ParamAttr(name=name + ".w"),
                             bias_attr=ParamAttr(name=name + ".b"))


def _lm_ffn(x, d_ff, d_model, nm, flat_dims):
    h = layers.fc(x, size=d_ff, num_flatten_dims=flat_dims, act="relu",
                  param_attr=ParamAttr(name=nm + "_ffn_fc1.w",
                                       sharding=(None, "mp")),
                  bias_attr=ParamAttr(name=nm + "_ffn_fc1.b"),
                  name=nm + "_ffn_fc1")
    return layers.fc(h, size=d_model, num_flatten_dims=flat_dims,
                     param_attr=ParamAttr(name=nm + "_ffn_fc2.w",
                                          sharding=("mp", None)),
                     bias_attr=ParamAttr(name=nm + "_ffn_fc2.b"),
                     name=nm + "_ffn_fc2")


def _lm_embed(ids, pos, vocab, pos_cap, d_model, pad_positions=False):
    """Scaled word embeddings plus learned positions. ``pad_positions``:
    the positions may hold the cache capacity (the chunk's pad lanes),
    past the table when it is ``pos_cap``, so their lookup fills NaN rows
    as ``jnp.take`` does instead of raising."""
    word = layers.embedding(ids, size=[vocab, d_model],
                            param_attr=ParamAttr(name="lm_word_emb"))
    word = layers.scale(word, scale=float(d_model) ** 0.5)
    posv = layers.embedding(pos, size=[pos_cap, d_model],
                            param_attr=ParamAttr(name="lm_pos_emb"))
    if pad_positions:
        posv.op.attrs["out_of_range"] = "fill"
    return layers.elementwise_add(word, posv)


def _lm_head(x, vocab, axis):
    x = _named_ln(x, "lm_ln", axis)
    return layers.fc(x, size=vocab, num_flatten_dims=axis,
                     param_attr=ParamAttr(name="lm_out.w",
                                          sharding=(None, "mp")),
                     bias_attr=False, name="lm_out")


def transformer_lm(vocab=4000, seq_len=64, d_model=64, d_ff=128, n_head=4,
                   n_layer=2, dropout_rate=0.0, pos_cap=512):
    """Full-sequence causal LM (pre-norm decoder blocks, learned positions,
    ReLU FFN, final LayerNorm, untied bias-free output projection): the
    whole-sequence twin of :func:`transformer_lm_step`. ``dropout_rate``
    defaults to 0 so full-vs-step logits agree. Extras carry the
    ``logits`` var name ([B, S, V])."""
    if seq_len > pos_cap:
        raise ValueError("seq_len %d exceeds the shared pos table %d"
                         % (seq_len, pos_cap))
    ids = layers.data("ids", shape=[seq_len], dtype="int64")
    lbl = layers.data("lbl", shape=[seq_len], dtype="int64")
    pos = layers.range(0, seq_len, 1, "int64")
    x = _lm_embed(ids, pos, vocab, pos_cap, d_model)
    if dropout_rate:
        x = layers.dropout(x, dropout_rate)
    for i in range(n_layer):
        nm = "lm%d" % i
        y = _named_ln(x, nm + "_attn_ln", 2)
        a = layers.multi_head_attention(
            y, y, y, d_model=d_model, n_head=n_head, causal=True,
            dropout_rate=dropout_rate, name=nm + "_attn")
        x = layers.elementwise_add(x, a)
        f = _lm_ffn(_named_ln(x, nm + "_ffn_ln", 2), d_ff, d_model, nm, 2)
        x = layers.elementwise_add(x, f)
    logits = _lm_head(x, vocab, 2)
    ce = layers.squeeze(layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(lbl, [2])), [2])
    loss = layers.mean(ce)
    per_layer = 4 * d_model * d_model + 2 * d_model * d_ff \
        + 2 * seq_len * d_model
    flops = 2 * 3 * (n_layer * per_layer + d_model * vocab) * seq_len
    return ModelSpec(
        loss,
        feeds={"ids": FeedSpec([seq_len], "int64", 0, vocab),
               "lbl": FeedSpec([seq_len], "int64", 0, vocab)},
        flops_per_example=flops, tokens_per_example=seq_len,
        sequence_feeds=["ids", "lbl"],
        extras={"logits": logits.name})


def lm_step_config(vocab=4000, d_model=64, d_ff=128, n_head=4, n_layer=2,
                   ctx_cap=64, pos_cap=512):
    """The shared kwargs of a :func:`transformer_lm` /
    :func:`transformer_lm_step` / :func:`transformer_lm_chunk` family
    (they agree on everything but the sequence geometry)."""
    return dict(vocab=vocab, d_model=d_model, d_ff=d_ff, n_head=n_head,
                n_layer=n_layer, ctx_cap=ctx_cap, pos_cap=pos_cap)


def _cached_lm(tok, pos, vocab, d_model, n_head, n_layer, d_ff, ctx_cap,
               pos_cap, axis, attention):
    """The body the step (``axis`` 1) and chunk (``axis`` 2) programs
    share: per-layer ``cache_k_i``/``cache_v_i`` feeds [B, -1, d_model]
    (capacity is the scheduler's ctx-rung choice), the cached attention
    layer, the head. Returns ``(fetch_vars, spec)``: the logits then the
    updated caches, and the plain-dict layout ``DecodeBatcher`` reads."""
    if ctx_cap > pos_cap:
        raise ValueError("ctx_cap %d exceeds the shared pos table %d"
                         % (ctx_cap, pos_cap))
    cache_in = [(layers.data("cache_k_%d" % i, shape=[-1, d_model]),
                 layers.data("cache_v_%d" % i, shape=[-1, d_model]))
                for i in range(n_layer)]
    x = _lm_embed(tok, pos, vocab, pos_cap, d_model, pad_positions=axis == 2)
    cache_out = []
    for i, (ck, cv) in enumerate(cache_in):
        nm = "lm%d" % i
        a, nk, nv = attention(
            _named_ln(x, nm + "_attn_ln", axis), ck, cv, pos,
            d_model=d_model, n_head=n_head, name=nm + "_attn")
        cache_out.append((nk, nv))
        x = layers.elementwise_add(x, a)
        f = _lm_ffn(_named_ln(x, nm + "_ffn_ln", axis), d_ff, d_model, nm,
                    axis)
        x = layers.elementwise_add(x, f)
    logits = _lm_head(x, vocab, axis)
    fetch_vars = [logits]
    cache_feeds = []
    for i, (nk, nv) in enumerate(cache_out):
        fetch_vars += [nk, nv]
        cache_feeds += [
            {"feed": "cache_k_%d" % i, "fetch": nk.name,
             "tail": [d_model], "dtype": "float32"},
            {"feed": "cache_v_%d" % i, "fetch": nv.name,
             "tail": [d_model], "dtype": "float32"}]
    spec = {"token_feed": tok.name, "pos_feed": pos.name,
            "logits_fetch": logits.name, "cache_feeds": cache_feeds,
            "vocab": vocab, "ctx_cap": ctx_cap}
    return fetch_vars, spec


def transformer_lm_step(vocab=4000, d_model=64, d_ff=128, n_head=4,
                        n_layer=2, ctx_cap=64, pos_cap=512):
    """KV-cached one-token decode step program (the continuous batcher's
    unit, one geometry per (batch rung, ctx rung)). Feeds ``tok_ids`` [B]
    (the token to ingest), ``pos`` [B] int32 (each slot's own fill level)
    and the per-layer caches; fetches the next-token ``logits`` [B, vocab]
    then the updated caches, which the scheduler carries on the device and
    feeds back. Returns ``(fetch_vars, decode_spec)``."""
    tok = layers.data("tok_ids", shape=[], dtype="int64")
    pos = layers.data("pos", shape=[], dtype="int32")
    return _cached_lm(tok, pos, vocab, d_model, n_head, n_layer, d_ff,
                      ctx_cap, pos_cap, 1,
                      layers.cached_multi_head_attention)


def transformer_lm_chunk(vocab=4000, d_model=64, d_ff=128, n_head=4,
                         n_layer=2, ctx_cap=64, pos_cap=512):
    """KV-cached K-token chunk program, the third member of the family: one
    dispatch ingests K tokens a slot row (chunked prefill) or scores k
    draft tokens (speculative verify). Feeds ``tok_chunk`` [B, K] (K is a
    prefill-ladder rung), ``chunk_pos`` [B, K] int32 (each token's write
    index; the scheduler pads a partial lane with the cache capacity) and
    the same caches as the step program; fetches per-position ``logits``
    [B, K, vocab] then the updated caches. Returns ``(fetch_vars,
    chunk_spec)``, whose ``cache_feeds`` names match the step spec's."""
    tok = layers.data("tok_chunk", shape=[-1], dtype="int64")
    cpos = layers.data("chunk_pos", shape=[-1], dtype="int32")
    return _cached_lm(tok, cpos, vocab, d_model, n_head, n_layer, d_ff,
                      ctx_cap, pos_cap, 2,
                      layers.cached_multi_head_attention_chunk)


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
