"""Attention seq2seq NMT with GRUs (the port's
``paddle_tpu/models/machine_translation.py``; ref ``benchmark/fluid/models/
machine_translation.py`` / ``tests/book/test_machine_translation.py``:
bi-GRU encoder + attention decoder).

The TRAIN program (``seq2seq_attention``) runs the decoder teacher-forced
over the whole target at once: a decoder GRU over the target, then one
attention between the decoder states and the encoder states (the
``flash_attention`` op: one head of 512, a per-key padding bias). The
INFER program (``seq2seq_attention_infer``) decodes with beam search in a
While loop: ``gru_unit`` + attention (one query against the source's keys)
+ ``beam_search`` a step, (ids, parents) recorded into fixed-capacity
tensor arrays and backtracked by ``beam_search_decode``; the loop reads
its condition on the host, so the program is interpreted. Every parameter
has an explicit ``mt_*`` name, so the programs built in one scope share
the trained weights.
"""

from .. import layers
from ..core.param_attr import ParamAttr
from .common import FeedSpec, ModelSpec

__all__ = ["seq2seq_attention", "seq2seq_attention_infer",
           "seq2seq_attention_greedy_infer"]


def _p(name):
    return ParamAttr(name=name)


def _encoder(src, src_len, src_vocab, seq_len, emb_dim, hid_dim):
    """bi-GRU encoder shared by the train and infer programs."""
    src_emb = layers.embedding(src, size=[src_vocab, emb_dim],
                               param_attr=_p("mt_src_emb"))
    fwd = layers.dynamic_gru(
        layers.fc(src_emb, size=hid_dim * 3, num_flatten_dims=2,
                  param_attr=_p("mt_enc_f_fc_w"),
                  bias_attr=_p("mt_enc_f_fc_b")),
        size=hid_dim, lengths=src_len, param_attr=_p("mt_enc_f_gru_w"),
        bias_attr=_p("mt_enc_f_gru_b"))
    bwd = layers.dynamic_gru(
        layers.fc(src_emb, size=hid_dim * 3, num_flatten_dims=2,
                  param_attr=_p("mt_enc_b_fc_w"),
                  bias_attr=_p("mt_enc_b_fc_b")),
        size=hid_dim, lengths=src_len, is_reverse=True,
        param_attr=_p("mt_enc_b_gru_w"), bias_attr=_p("mt_enc_b_gru_b"))
    enc = layers.concat([fwd, bwd], axis=-1)  # [B, S, 2H]
    mask = layers.sequence_mask(src_len, maxlen=seq_len, dtype="float32")
    bias = layers.reshape(
        layers.scale(mask, scale=1e9, bias=-1e9), [-1, 1, 1, seq_len])
    return enc, bias


def seq2seq_attention(src_vocab=10000, trg_vocab=10000, seq_len=50,
                      emb_dim=512, hid_dim=512):
    src = layers.data("src_ids", shape=[seq_len], dtype="int64")
    trg = layers.data("trg_ids", shape=[seq_len], dtype="int64")
    lbl = layers.data("lbl_ids", shape=[seq_len], dtype="int64")
    src_len = layers.data("src_len", shape=[], dtype="int64")
    trg_len = layers.data("trg_len", shape=[], dtype="int64")

    enc, bias = _encoder(src, src_len, src_vocab, seq_len, emb_dim, hid_dim)

    # teacher-forced decoder GRU
    trg_emb = layers.embedding(trg, size=[trg_vocab, emb_dim],
                               param_attr=_p("mt_trg_emb"))
    dec = layers.dynamic_gru(
        layers.fc(trg_emb, size=hid_dim * 3, num_flatten_dims=2,
                  param_attr=_p("mt_dec_fc_w"),
                  bias_attr=_p("mt_dec_fc_b")),
        size=hid_dim, lengths=trg_len, param_attr=_p("mt_dec_gru_w"),
        bias_attr=_p("mt_dec_gru_b"))  # [B, S, H]

    # attention: decoder states attend over encoder states
    ctx = layers.multi_head_attention(dec, enc, enc, attn_bias=bias,
                                      d_model=hid_dim, n_head=1,
                                      name="dec_attn")
    merged = layers.fc(layers.concat([dec, ctx], axis=-1), size=hid_dim,
                       num_flatten_dims=2, act="tanh",
                       param_attr=_p("mt_merge_fc_w"),
                       bias_attr=_p("mt_merge_fc_b"))
    logits = layers.fc(merged, size=trg_vocab, num_flatten_dims=2,
                       param_attr=_p("mt_out_fc_w"),
                       bias_attr=_p("mt_out_fc_b"))

    ce = layers.squeeze(layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(lbl, [2])), [2])
    trg_mask = layers.sequence_mask(trg_len, maxlen=seq_len, dtype="float32")
    loss = layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(ce, trg_mask)),
        layers.reduce_sum(trg_mask))

    return ModelSpec(
        loss,
        feeds={"src_ids": FeedSpec([seq_len], "int64", 0, src_vocab),
               "trg_ids": FeedSpec([seq_len], "int64", 0, trg_vocab),
               "lbl_ids": FeedSpec([seq_len], "int64", 0, trg_vocab),
               "src_len": FeedSpec([], "int64", 2, seq_len + 1),
               "trg_len": FeedSpec([], "int64", 2, seq_len + 1)},
        tokens_per_example=seq_len)


def seq2seq_attention_infer(src_vocab=10000, trg_vocab=10000, seq_len=50,
                            emb_dim=512, hid_dim=512, beam_size=4,
                            max_out_len=None, bos_id=0, eos_id=1):
    """Beam-search decode program sharing the train program's parameters.
    Returns ``(sentence_ids [B, K, T], sentence_scores [B, K])`` vars.

    Ref call path: ``layers/nn.py`` beam_search inside a While +
    ``beam_search_decode`` (``tests/book/test_machine_translation.py``
    decode()); re-designed on dense [B, K] beam tensors + fixed-capacity
    TensorArrays (see ``core/opimpl/decode_ops.py``)."""
    from ..layers import tensor as T

    max_out_len = max_out_len or seq_len
    k = beam_size

    src = layers.data("src_ids", shape=[seq_len], dtype="int64")
    src_len = layers.data("src_len", shape=[], dtype="int64")
    enc, bias = _encoder(src, src_len, src_vocab, seq_len, emb_dim, hid_dim)

    # tile encoder state & attention bias over the beam axis: [B*K, S, 2H]
    enc_t = layers.reshape(
        T.expand(layers.unsqueeze(enc, [1]), [1, k, 1, 1]),
        [-1, seq_len, 2 * hid_dim])
    bias_t = layers.reshape(
        T.expand(layers.unsqueeze(bias, [1]), [1, k, 1, 1, 1]),
        [-1, 1, 1, seq_len])

    # beam state: pre_ids [B,K]=bos, pre_scores [B,K]=[0,-1e9,...]
    pre_ids = T.fill_constant_batch_size_like(
        enc, [-1, k], "int64", float(bos_id))
    first_col = layers.one_hot(
        T.fill_constant_batch_size_like(enc, [-1, 1], "int64", 0.0), k)
    pre_scores = layers.scale(first_col, scale=1e9, bias=-1e9)
    hidden = T.fill_constant_batch_size_like(
        enc, [-1, k, hid_dim], "float32", 0.0)

    step = T.fill_constant([], "int64", 0)
    max_len_v = T.fill_constant([], "int64", max_out_len)
    cond = layers.less_than(step, max_len_v)
    ids_arr = layers.create_array("int64", capacity=max_out_len)
    par_arr = layers.create_array("int32", capacity=max_out_len)
    # materialize the arrays before the loop so they can be loop carries
    ids_arr = layers.array_write(pre_ids, step, ids_arr)
    par_arr = layers.array_write(
        T.cast(pre_ids, "int32"), step, par_arr)

    w = layers.While(cond, loop_vars=[step, pre_ids, pre_scores, hidden,
                                      ids_arr, par_arr])
    with w.block():
        emb = layers.embedding(pre_ids, size=[trg_vocab, emb_dim],
                               param_attr=_p("mt_trg_emb"))
        x = layers.fc(layers.reshape(emb, [-1, emb_dim]),
                      size=hid_dim * 3, param_attr=_p("mt_dec_fc_w"),
                      bias_attr=_p("mt_dec_fc_b"))
        h_flat = layers.reshape(hidden, [-1, hid_dim])
        h_new = layers.gru_unit(x, h_flat, hid_dim * 3,
                                param_attr=_p("mt_dec_gru_w"),
                                bias_attr=_p("mt_dec_gru_b"))
        q = layers.reshape(h_new, [-1, 1, hid_dim])
        ctx = layers.multi_head_attention(q, enc_t, enc_t,
                                          attn_bias=bias_t,
                                          d_model=hid_dim, n_head=1,
                                          name="dec_attn")
        merged = layers.fc(
            layers.concat([h_new, layers.reshape(ctx, [-1, hid_dim])],
                          axis=-1),
            size=hid_dim, act="tanh", param_attr=_p("mt_merge_fc_w"),
            bias_attr=_p("mt_merge_fc_b"))
        logits = layers.fc(merged, size=trg_vocab,
                           param_attr=_p("mt_out_fc_w"),
                           bias_attr=_p("mt_out_fc_b"))
        logp = layers.reshape(layers.log_softmax(logits),
                              [-1, k, trg_vocab])
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, logp, k, eos_id)
        h_re = layers.beam_search_gather(
            layers.reshape(h_new, [-1, k, hid_dim]), parent)
        layers.array_write(sel_ids, step, ids_arr)
        layers.array_write(parent, step, par_arr)
        T.assign(sel_ids, pre_ids)
        T.assign(sel_scores, pre_scores)
        T.assign(h_re, hidden)
        layers.increment(step, 1)
        layers.less_than(step, max_len_v, cond=cond)

    sent_ids, sent_scores = layers.beam_search_decode(
        ids_arr, par_arr, step, pre_scores, k, eos_id)
    return sent_ids, sent_scores


def seq2seq_attention_greedy_infer(src_vocab=10000, trg_vocab=10000,
                                   seq_len=50, emb_dim=512, hid_dim=512,
                                   max_out_len=None, bos_id=0, eos_id=1):
    """Greedy decode program sharing the train program's parameters: the
    beam program at K=1 squeezed to dense ``(ids [B, T], scores [B])``.
    This is the one-shot serving entry (`ServingEngine.submit` with
    ``src_ids``/``src_len`` feeds) and the static-batching A/B baseline
    the continuous batcher is measured against: served one-shot, a batch
    rides until its LONGEST member finishes.

    Every per-step op is per-row (top-1, GRU, attention), so a request
    batched with strangers decodes bitwise-identically to the same
    request served solo at the same bucket rung — the property the
    serving parity tests pin."""
    from ..core.layer_helper import LayerHelper

    sent_ids, sent_scores = seq2seq_attention_infer(
        src_vocab=src_vocab, trg_vocab=trg_vocab, seq_len=seq_len,
        emb_dim=emb_dim, hid_dim=hid_dim, beam_size=1,
        max_out_len=max_out_len, bos_id=bos_id, eos_id=eos_id)
    # the decode outputs' static shape is dynamic-length (None), so the
    # beam axis squeezes through a raw op, not the shape-checked layer
    helper = LayerHelper("mt_greedy")
    ids = helper.create_variable_for_type_inference(dtype="int64",
                                                    shape=None)
    helper.append_op("squeeze", {"X": sent_ids}, {"Out": ids},
                     {"axes": [1]})            # [B, 1, T] -> [B, T]
    scores = helper.create_variable_for_type_inference(
        dtype=str(sent_scores.dtype), shape=None)
    helper.append_op("squeeze", {"X": sent_scores}, {"Out": scores},
                     {"axes": [1]})            # [B, 1] -> [B]
    return ids, scores
