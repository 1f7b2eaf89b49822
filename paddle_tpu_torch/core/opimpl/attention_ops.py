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

from ..op_registry import LENT_KEY, get, mxu_cast, put, register, rng_draw


@register("flash_attention")
def _flash_attention_op(env, op):
    from ...ops.flash_attention import draw_seed, flash_attention

    q = get(env, op.input("Q"))
    out_dtype = q.dtype
    # under AMP q/k/v go in as bf16 and the output comes back in q's own
    # dtype (paddle_tpu's attention_ops.py:17-33)
    q, k, v = mxu_cast(q, get(env, op.input("K")), get(env, op.input("V")))
    dropout = op.attr("dropout_rate", 0.0)
    seed = None
    if dropout > 0.0:
        seed = rng_draw(env, lambda gen: draw_seed(gen, q.device))
    out = flash_attention(
        q, k, v, op.attr("num_heads", 1),
        bias=get(env, op.input("Bias")), causal=op.attr("causal", False),
        dropout_rate=dropout, seed=seed, op=op)
    put(env, op.output("Out"), out.to(out_dtype))


def _write_index(pos, b, c, device):
    """(rows, columns) of a cache write at ``pos`` [B, K]: a position in
    [-C, 0) counts from the end (``.at[...].set(mode="drop")`` in the
    reference) and any other position outside [0, C) goes to the scratch
    column C, so no index leaves the buffer (an out-of-range index would
    raise on the CPU and assert on the card) and nothing waits on the
    host."""
    pos = pos.to(device=device, dtype=torch.long)
    pos = torch.where(pos < 0, pos + c, pos)
    pos = torch.where((pos >= 0) & (pos < c), pos, c)
    rows = torch.arange(b, device=device).unsqueeze(1).expand_as(pos)
    return rows, pos


def cache_write(cache, x, pos):
    """``out[b, pos[b, j]] = x[b, j]`` out of place: cache [B, C, ...], x
    [B, K, ...], pos [B, K] int. The cache is copied into a [B, C + 1, ...]
    buffer whose scratch column takes the dropped lanes, and the result is
    the view of its first C columns."""
    b, c = cache.shape[0], cache.shape[1]
    buf = cache.new_empty((b, c + 1) + tuple(cache.shape[2:]))
    buf[:, :c] = cache
    buf.index_put_(_write_index(pos, b, c, cache.device), x.to(cache.dtype))
    return buf[:, :c]


def lendable_cache(b, c, tail, dtype, device):
    """A zeroed [B, C, *tail] cache that a step may write in place
    (:func:`cache_write_`): the first C positions of a [C + 1, B, *tail]
    buffer, position-major, so that (row, head) is one batch stride of
    ``cached_attention``'s products (no copy of the cache), and position C
    is the scratch column."""
    buf = torch.zeros((c + 1, b) + tuple(tail), dtype=dtype, device=device)
    return buf[:c].transpose(0, 1)


def _with_scratch(cache):
    """The [B, C + 1, ...] view over a lent cache's storage whose column C
    (the scratch column) lies outside the cache's own elements. Raises
    unless the cache is :func:`lendable_cache`'s: the first C positions of
    a whole [C + 1, B, ...] buffer, so that position C is nobody's data (a
    view of a wider buffer could hold live rows there)."""
    b, c = cache.shape[0], cache.shape[1]
    tail = tuple(cache.shape[2:])
    row = math.prod(tail)
    dense_tail = cache[0, 0].is_contiguous() if b and c else True
    whole = (c + 1) * b * row * cache.element_size()
    if (dense_tail and cache.stride()[:2] == (row, b * row)
            and cache.storage_offset() == 0
            and cache.untyped_storage().nbytes() == whole):
        return cache.as_strided((b, c + 1) + tail, cache.stride(), 0)
    raise ValueError(
        "a lent cache [B, C, ...] must leave a scratch column C in its "
        "storage (attention_ops.lendable_cache); got shape %s, strides %s"
        % (tuple(cache.shape), cache.stride()))


def cache_write_(cache, x, pos):
    """:func:`cache_write` in place, into a lent cache: the dropped lanes
    write its scratch column (:func:`_with_scratch`). Returns ``cache``."""
    b, c = cache.shape[0], cache.shape[1]
    _with_scratch(cache).index_put_(_write_index(pos, b, c, cache.device),
                                    x.to(cache.dtype))
    return cache


def _write(env, op, x, pos):
    cache = get(env, op.input("Cache"))
    if op.input("Cache").name in env.get(LENT_KEY, ()):
        out = cache_write_(cache, x, pos)
    else:
        out = cache_write(cache, x, pos)
    put(env, op.output("Out"), out)


@register("kv_cache_write")
def _kv_cache_write(env, op):
    """Per-row cache update: Cache [B, C, ...], X [B, ...], Pos [B] ->
    Out[b, Pos[b]] = X[b], other entries untouched; in place into a lent
    cache, which is then the output."""
    _write(env, op, get(env, op.input("X")).unsqueeze(1),
           get(env, op.input("Pos")).reshape(-1, 1))


@register("kv_cache_write_chunk")
def _kv_cache_write_chunk(env, op):
    """K-row cache update: Cache [B, C, ...], X [B, K, ...], Pos [B, K] ->
    Out[b, Pos[b, j]] = X[b, j]. The scheduler pads a partial chunk lane
    with Pos = C, so a padded lane writes nothing."""
    _write(env, op, get(env, op.input("X")), get(env, op.input("Pos")))


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
    ids = rng_draw(env, lambda gen: torch.multinomial(
        p, 1, generator=gen)).squeeze(1)
    put(env, op.output("Out"), ids.to(torch.int32))
