"""Attention + sampling ops (``paddle_tpu/core/opimpl/attention_ops.py``):
the ``flash_attention`` bridge to ``paddle_tpu_torch.ops``, which records
the gate's decision in ``op.attrs["_kernel_choice"]`` as the reference
does, and the incremental-decode primitives (KV-cache write + cached
attention) the serving tier's step and chunk programs are built from.

The decode primitives are jnp in the reference, outside any Pallas kernel,
so their port is plain PyTorch: batched matrix products, a mask and an f32
softmax. Every one is strictly per row: row b reads and writes only its own
cache row, the property the decode batcher's solo-vs-batched bitwise parity
rests on."""

import math

import torch

from ..op_registry import register, get, put, next_rng, mxu_cast


@register("flash_attention")
def _flash_attention_op(env, op):
    from ...ops.flash_attention import flash_attention

    q = get(env, op.input("Q"))
    out_dtype = q.dtype
    # under AMP q/k/v go in as bf16 and the output comes back in q's own
    # dtype (paddle_tpu's attention_ops.py:17-33)
    q, k, v = mxu_cast(q, get(env, op.input("K")), get(env, op.input("V")))
    dropout = op.attr("dropout_rate", 0.0)
    out = flash_attention(
        q, k, v, op.attr("num_heads", 1),
        bias=get(env, op.input("Bias")), causal=op.attr("causal", False),
        dropout_rate=dropout,
        generator=next_rng(env) if dropout > 0.0 else None, op=op)
    put(env, op.output("Out"), out.to(out_dtype))


def cache_write(cache, x, pos):
    """``out[b, pos[b, j]] = x[b, j]`` out of place: cache [B, C, ...], x
    [B, K, ...], pos [B, K] int. A position in [-C, 0) counts from the end
    (``.at[...].set(mode="drop")`` in the reference); any other position
    outside [0, C) writes nothing. The dropped lanes write into a scratch
    column past the end of a [B, C + 1, ...] buffer, and the result is the
    view of its first C columns: no index leaves the buffer (an
    out-of-range index would raise on the CPU and assert on the card) and
    nothing waits on the host."""
    b, c = cache.shape[0], cache.shape[1]
    pos = pos.to(device=cache.device, dtype=torch.long)
    pos = torch.where(pos < 0, pos + c, pos)
    pos = torch.where((pos >= 0) & (pos < c), pos, c)
    buf = cache.new_empty((b, c + 1) + tuple(cache.shape[2:]))
    buf[:, :c] = cache
    rows = torch.arange(b, device=cache.device).unsqueeze(1).expand_as(pos)
    buf.index_put_((rows, pos), x.to(cache.dtype))
    return buf[:, :c]


@register("kv_cache_write")
def _kv_cache_write(env, op):
    """Per-row cache update: Cache [B, C, ...], X [B, ...], Pos [B] ->
    Out[b, Pos[b]] = X[b], other entries untouched."""
    cache = get(env, op.input("Cache"))
    x = get(env, op.input("X"))
    pos = get(env, op.input("Pos")).reshape(-1, 1)
    put(env, op.output("Out"), cache_write(cache, x.unsqueeze(1), pos))


@register("kv_cache_write_chunk")
def _kv_cache_write_chunk(env, op):
    """K-row cache update: Cache [B, C, ...], X [B, K, ...], Pos [B, K] ->
    Out[b, Pos[b, j]] = X[b, j]. The scheduler pads a partial chunk lane
    with Pos = C, so a padded lane writes nothing."""
    put(env, op.output("Out"), cache_write(
        get(env, op.input("Cache")), get(env, op.input("X")),
        get(env, op.input("Pos"))))


def cached_attention(q, k, v, pos, num_heads):
    """Q [B, K, H*D] over CacheK/CacheV [B, C, H*D]: query j of row b
    attends cache positions <= Pos[b, j] ([B, K]). Logits * 1/sqrt(D),
    masked to ``finfo(float32).min`` past each query's fill level, f32
    softmax (``ops.flash_attention.mha_reference``'s numerics). Returns
    [B, K, H*D]."""
    b, c, hd = k.shape
    kq = q.shape[1]
    d = hd // num_heads
    qh = q.reshape(b, kq, num_heads, d).transpose(1, 2)    # [B, H, K, D]
    kh = k.reshape(b, c, num_heads, d).permute(0, 2, 3, 1)  # [B, H, D, C]
    vh = v.reshape(b, c, num_heads, d).transpose(1, 2)     # [B, H, C, D]
    logits = torch.matmul(qh, kh) * (1.0 / math.sqrt(d))
    pos = pos.to(device=q.device, dtype=torch.long)
    mask = (torch.arange(c, device=q.device).view(1, 1, 1, c)
            <= pos.view(b, 1, kq, 1))
    logits = torch.where(mask, logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    ctx = torch.matmul(probs, vh)                           # [B, H, K, D]
    return ctx.transpose(1, 2).reshape(b, kq, hd)


@register("cached_attention")
def _cached_attention(env, op):
    """One-token attention over a fixed-capacity KV cache: Q [B, H*D],
    CacheK/CacheV [B, C, H*D], Pos [B] (the index the current token was
    just written at)."""
    q = get(env, op.input("Q"))
    out = cached_attention(
        q.unsqueeze(1), get(env, op.input("CacheK")),
        get(env, op.input("CacheV")),
        get(env, op.input("Pos")).reshape(-1, 1),
        int(op.attr("num_heads", 1)))
    put(env, op.output("Out"), out.squeeze(1))


@register("cached_attention_chunk")
def _cached_attention_chunk(env, op):
    """K-query attention over a fixed-capacity KV cache: Q [B, K, H*D],
    Pos [B, K] (the index each query token was just written at): the step
    op's semantics applied K times."""
    put(env, op.output("Out"), cached_attention(
        get(env, op.input("Q")), get(env, op.input("CacheK")),
        get(env, op.input("CacheV")), get(env, op.input("Pos")),
        int(op.attr("num_heads", 1))))


@register("sampling_id")
def _sampling_id(env, op):
    """One categorical draw per row of X [B, C] (probabilities) over
    log(max(x, 1e-20)), from the executor's generator: ids [B] in int32,
    the 32-bit convention (``paddle_tpu``'s int64 is int32 without x64)."""
    x = get(env, op.input("X"))
    p = torch.clamp_min(x.float(), 1e-20)
    ids = torch.multinomial(p, 1, generator=next_rng(env)).squeeze(1)
    put(env, op.output("Out"), ids.to(torch.int32))
