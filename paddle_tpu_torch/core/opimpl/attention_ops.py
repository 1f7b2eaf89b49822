"""The ``flash_attention`` op: bridge to ``paddle_tpu_torch.ops``
(``paddle_tpu/core/opimpl/attention_ops.py:13``)."""

from ..op_registry import register, get, put, next_rng


@register("flash_attention")
def _flash_attention_op(env, op):
    from ...ops.flash_attention import flash_attention

    dropout = op.attr("dropout_rate", 0.0)
    out = flash_attention(
        get(env, op.input("Q")), get(env, op.input("K")),
        get(env, op.input("V")), op.attr("num_heads", 1),
        bias=get(env, op.input("Bias")), causal=op.attr("causal", False),
        dropout_rate=dropout,
        generator=next_rng(env) if dropout > 0.0 else None)
    put(env, op.output("Out"), out)
