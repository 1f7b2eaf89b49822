"""Sequence ops over padded batches with explicit lengths (the port's
``paddle_tpu/core/opimpl/sequence_ops.py``; ref
``operators/sequence_ops/``). The reference replaces LoD-packed batches
by dense [B, T, ...] tensors and a Lengths [B] companion; so does the
port. All of them are ``jnp``/``lax`` there, so plain PyTorch here; none
reads a value on the host, so a captured step may hold any of them."""

import torch

from ..framework import torch_dtype
from ..op_registry import register, get, get_list, put


def _mask(lengths, t, dtype):
    """[B, T] in ``dtype``: 1 where a step lies inside its row's length."""
    pos = torch.arange(t, device=lengths.device)
    return (pos[None, :] < lengths.reshape(-1, 1)).to(dtype)


@register("sequence_mask")
def _sequence_mask(env, op):
    x = get(env, op.input("X")).reshape(-1)
    maxlen = op.attr("maxlen", -1)
    if maxlen is None or maxlen <= 0:
        # the reference reads the declared (n, -1) shape, so an omitted
        # maxlen gives an [N, 0] mask (Fluid takes max(x)); matched here
        maxlen = max(op.output("Y").shape[-1], 0)
    dtype = torch_dtype(op.attr("out_dtype", "int64"))
    put(env, op.output("Y"), _mask(x, maxlen, dtype))


def _lowest(dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


@register("sequence_pool")
def _sequence_pool(env, op):
    """X [B, T, D] (+ Lengths) -> Out [B, D] by ``pooltype``: SUM,
    AVERAGE, SQRT (the sum over sqrt of the length, a length at least 1),
    MAX (the padded steps at the dtype's lowest value; ``amax`` shares a
    tied maximum's gradient equally, as ``jnp.max`` does), LAST (the
    step at length - 1), FIRST."""
    x = get(env, op.input("X"))
    lengths = get(env, op.input("Lengths"))
    ptype = op.attr("pooltype", "AVERAGE").upper()
    if lengths is None:
        m3 = torch.ones(x.shape[:2] + (1,) * (x.dim() - 2), dtype=x.dtype,
                        device=x.device)
    else:
        m3 = _mask(lengths, x.shape[1], x.dtype).reshape(
            x.shape[:2] + (1,) * (x.dim() - 2))
    if ptype == "SUM":
        out = torch.sum(x * m3, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m3, dim=1) / torch.clamp(torch.sum(m3, dim=1),
                                                     min=1.0)
    elif ptype == "SQRT":
        out = torch.sum(x * m3, dim=1) / torch.sqrt(
            torch.clamp(torch.sum(m3, dim=1), min=1.0))
    elif ptype == "MAX":
        out = torch.amax(torch.where(m3 > 0, x, _lowest(x.dtype)), dim=1)
    elif ptype == "LAST":
        if lengths is None:
            out = x[:, -1]
        else:
            idx = torch.clamp(lengths.reshape(-1).long() - 1, min=0)
            out = torch.gather(x, 1, idx.reshape(
                (-1, 1) + (1,) * (x.dim() - 2)).expand(
                (-1, 1) + tuple(x.shape[2:]))).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError("sequence_pool: pooltype %r" % ptype)
    put(env, op.output("Out"), out)


@register("sequence_softmax")
def _sequence_softmax(env, op):
    """Softmax over each row's valid steps of X [B, T]; 0 past them."""
    x = get(env, op.input("X"))
    lengths = get(env, op.input("Lengths"))
    if lengths is None:
        put(env, op.output("Out"), torch.softmax(x, dim=-1))
        return
    m = _mask(lengths, x.shape[1], x.dtype)
    out = torch.softmax(torch.where(m > 0, x, torch.finfo(x.dtype).min),
                        dim=-1) * m
    put(env, op.output("Out"), out)


@register("sequence_reverse")
def _sequence_reverse(env, op):
    """Reverse each row's first length steps of X [B, T, ...]; the padded
    steps stay where they are."""
    x = get(env, op.input("X"))
    lengths = get(env, op.input("Lengths"))
    if lengths is None:
        put(env, op.output("Y"), torch.flip(x, dims=[1]))
        return
    t = x.shape[1]
    lens = lengths.reshape(-1, 1).long()
    pos = torch.arange(t, device=x.device)[None, :]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    src = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    put(env, op.output("Y"), torch.gather(x, 1, src))


@register("sequence_expand")
def _sequence_expand(env, op):
    """X [B, ...] repeated along a new time axis of Y's length T: [B, T,
    ...] (the reference's padded form of tiling rows per target length)."""
    x = get(env, op.input("X"))
    t = get(env, op.input("Y")).shape[1]
    put(env, op.output("Out"), x.unsqueeze(1).expand(
        (x.shape[0], t) + tuple(x.shape[1:])).contiguous())


@register("sequence_conv")
def _sequence_conv(env, op):
    """Context-window projection over time (ref ``sequence_conv_op``):
    step t concatenates the rows t + start ... t + start + len - 1 (zeros
    outside [0, T)), then one product with Filter [len * D, M]."""
    x = get(env, op.input("X"))
    w = get(env, op.input("Filter"))
    ctx_len = op.attr("contextLength")
    ctx_start = op.attr("contextStart", -((ctx_len - 1) // 2))
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        valid = ((pos + off >= 0) & (pos + off < t))[None, :, None]
        cols.append(torch.where(valid, torch.roll(x, -off, dims=1), 0.0))
    put(env, op.output("Out"), torch.cat(cols, dim=-1) @ w)


@register("sequence_concat")
def _sequence_concat(env, op):
    put(env, op.output("Out"), torch.cat(get_list(env, op, "X"), dim=1))


@register("sequence_slice")
def _sequence_slice(env, op):
    """``length`` steps of X from the step Offset holds (its first
    entry), the start clamped into [0, T - length] as
    ``lax.dynamic_slice`` clamps it; read on the device."""
    x = get(env, op.input("X"))
    length = op.attr("length")
    offset = get(env, op.input("Offset")).reshape(-1)[0].long()
    start = torch.clamp(offset, 0, x.shape[1] - length)
    idx = start + torch.arange(length, device=x.device)
    put(env, op.output("Out"), x.index_select(1, idx))


@register("sequence_pad")
def _sequence_pad(env, op):
    """The input is already padded: X passes through, Lengths (when
    given) becomes Length."""
    put(env, op.output("Out"), get(env, op.input("X")))
    lengths = get(env, op.input("Lengths"))
    if lengths is not None:
        put(env, op.output("Length"), lengths)


@register("sequence_unpad")
def _sequence_unpad(env, op):
    put(env, op.output("Out"), get(env, op.input("X")))


@register("sequence_enumerate")
def _sequence_enumerate(env, op):
    """Ids X [B, T] -> [B, T, win_size]: the window of ids starting at
    each step, ``pad_value`` past the end of the row's T steps."""
    x = get(env, op.input("X"))
    win = op.attr("win_size")
    pad = op.attr("pad_value", 0)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    outs = [torch.where((pos + i < t)[None, :], torch.roll(x, -i, dims=1),
                        pad) for i in range(win)]
    put(env, op.output("Out"), torch.stack(outs, dim=-1))


@register("sequence_erase")
def _sequence_erase(env, op):
    """Static shapes cannot drop tokens: each of ``tokens`` becomes 0 and
    the rest stays (the reference's padded form)."""
    x = get(env, op.input("X"))
    hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for tok in op.attr("tokens"):
        hit = hit | (x == tok)
    put(env, op.output("Out"), torch.where(hit, 0, x))
