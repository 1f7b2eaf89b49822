"""Tensor creation / manipulation / random / embedding ops (the port's
``paddle_tpu/core/opimpl/tensor_ops.py``: every op type it registers).
Random ops draw from the executor's ``torch.Generator``; they give other
numbers than the reference's threefry draws from one seed, so the tests
compare them by their statistics."""

import math

import torch
import torch.nn.functional as F

from ...ops.rowops import pack_factor, packed_take
from ..framework import convert_np_dtype, torch_dtype
from ..op_registry import (DEVICE_KEY, SPARSE_SITES_KEY, amp_out_cast,
                           get, get_list, put, register, rng_draw)


def _out_dtype(op):
    return torch_dtype(convert_np_dtype(op.attr("dtype", "float32")))


@register("fill_constant")
def _fill_constant(env, op):
    put(env, op.output("Out"),
        torch.full(tuple(op.attr("shape")), op.attr("value", 0.0),
                   dtype=_out_dtype(op), device=env[DEVICE_KEY]))


@register("uniform_random")
def _uniform_random(env, op):
    lo, hi = op.attr("min", -1.0), op.attr("max", 1.0)
    u = rng_draw(env, lambda gen: torch.rand(
        tuple(op.attr("shape")), generator=gen, dtype=torch.float32,
        device=env[DEVICE_KEY]))
    put(env, op.output("Out"), (lo + (hi - lo) * u).to(_out_dtype(op)))


@register("gaussian_random")
def _gaussian_random(env, op):
    mean, std = op.attr("mean", 0.0), op.attr("std", 1.0)
    n = rng_draw(env, lambda gen: torch.randn(
        tuple(op.attr("shape")), generator=gen, dtype=torch.float32,
        device=env[DEVICE_KEY]))
    put(env, op.output("Out"), (mean + std * n).to(_out_dtype(op)))


@register("increment")
def _increment(env, op):
    """``Out = X + step`` (``paddle_tpu``'s tensor_ops.py:373), in X's
    dtype: an integer counter stays an integer (the reference's counter
    turns float32 at its first step, by JAX's promotion of an int array
    plus a Python float; its values are the same), so the state keeps its
    dtype from step to step and a captured step can write it in place."""
    x = get(env, op.input("X"))
    step = op.attr("step", 1.0)
    if not x.is_floating_point() and float(step).is_integer():
        step = int(step)
    put(env, op.output("Out"), (x + step).to(x.dtype))


@register("assign")
def _assign(env, op):
    put(env, op.output("Out"), get(env, op.input("X")))


@register("assign_value")
def _assign_value(env, op):
    dtype = torch_dtype(convert_np_dtype(op.attr("dtype", "float32")))
    vals = torch.tensor(op.attr("values"), dtype=dtype,
                        device=env[DEVICE_KEY])
    put(env, op.output("Out"), vals.reshape(tuple(op.attr("shape"))))


@register("cast")
def _cast(env, op):
    dtype = torch_dtype(convert_np_dtype(op.attr("out_dtype")))
    put(env, op.output("Out"), get(env, op.input("X")).to(dtype))


@register("concat")
def _concat(env, op):
    put(env, op.output("Out"),
        torch.cat(get_list(env, op, "X"), dim=op.attr("axis", 0)))


@register("reshape", "reshape2")
def _reshape(env, op):
    x = get(env, op.input("X"))
    shape = list(op.attr("shape"))
    for i, s in enumerate(shape):  # 0 copies the input dim, -1 is inferred
        if s == 0:
            shape[i] = x.shape[i]
    put(env, op.output("Out"), x.reshape(shape))


@register("squeeze", "squeeze2")
def _squeeze(env, op):
    x = get(env, op.input("X"))
    axes = op.attr("axes", [])
    if axes:
        out = x
        for a in sorted((a if a >= 0 else a + x.dim() for a in axes),
                        reverse=True):
            out = out.squeeze(a)
    else:
        out = x.squeeze()
    put(env, op.output("Out"), out)


@register("unsqueeze", "unsqueeze2")
def _unsqueeze(env, op):
    out = get(env, op.input("X"))
    for a in sorted(op.attr("axes")):
        out = out.unsqueeze(a)
    put(env, op.output("Out"), out)


@register("slice")
def _slice(env, op):
    x = get(env, op.input("Input"))
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(op.attr("axes"), op.attr("starts"), op.attr("ends")):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    put(env, op.output("Out"), x[tuple(idx)])


@register("range")
def _range(env, op):
    start = get(env, op.input("Start")).reshape(())
    step = get(env, op.input("Step")).reshape(())
    # the length is static: it comes from the var metadata, as in paddle_tpu
    n = op.output("Out").shape[0]
    put(env, op.output("Out"),
        start + step * torch.arange(n, dtype=start.dtype, device=start.device))


@register("lookup_table")
def _lookup_table(env, op):
    """Embedding lookup (ref ``lookup_table_op.cc``); padding_idx rows give
    zeros. Ids may be int32 or int64. ``paddle_tpu``'s 128-lane packed
    gather (``ops/rowops.py``) exists for TPU lanes; here the forward is a
    plain row index. A lookup whose op carries ``out_of_range="fill"`` indexes
    as ``jnp.take`` does (the reference's gather for tables whose width
    does not divide 128): an id in [-V, 0) counts from the end, and any
    other outside [0, V) gives a row of NaN, not an index error (on the
    card, a device assert). Only the decode chunk's position lookup
    carries it (``models.transformer``): its pad lanes feed position C,
    past the position table when C is its size, and their outputs are
    ignored. Every other lookup gathers with ``index_select``.

    A dense 2-D table of a narrow width (``rowops.pack_factor(K) > 1``: K
    below 128 and dividing it, where the reference gathers through its
    packed layout) takes ``rowops.packed_take``, whose backward is the row
    scatter-add kernel on the card (``_kernel_choice``
    ``cuda_scatter_add``; ``plain_scatter_add`` on the CPU), as the
    reference's backward is its Pallas scatter (``paddle_tpu/core/
    opimpl/tensor_ops.py:292-319``); any other width keeps
    ``index_select``'s own backward.

    A table with a sparse gradient in a training step (listed under
    ``SPARSE_SITES_KEY`` by the Executor) is not on the tape: the lookup
    gathers from it, makes its masked output a leaf and records the site,
    whose output gradient the ``autodiff`` op turns into (rows, values)."""
    w_name = op.input("W").name
    w = get(env, op.input("W"))
    ids = get(env, op.input("Ids"))
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    flat = ids.reshape(-1)
    sites = env.get(SPARSE_SITES_KEY)
    sparse = (sites is not None and w_name in sites
              and torch.is_grad_enabled())
    if op.attr("out_of_range") == "fill":
        v = w.shape[0]
        flat = torch.where(flat < 0, flat + v, flat)
        valid = (flat >= 0) & (flat < v)
        out = w.index_select(0, torch.where(valid, flat, 0))
        out = torch.where(valid.unsqueeze(1), out, float("nan"))
    elif not sparse and w.dim() == 2 and pack_factor(w.shape[1]) > 1:
        out = packed_take(w, flat, op)
    else:
        out = w.index_select(0, flat)
    out = out.reshape(*ids.shape, w.shape[1])
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    if sparse:
        out = out.detach().requires_grad_(True)
        sites[w_name].append((ids, out, padding_idx))
    # under AMP the rows go on in bf16 (paddle_tpu's tensor_ops.py:314-315);
    # a sparse site's leaf stays the f32 gather, so its gradient is f32
    put(env, op.output("Out"), amp_out_cast(out))


@register("scatter")
def _scatter(env, op):
    """``X.at[Ids].set(Updates)`` (``overwrite``) or ``.add`` along dim 0
    (``paddle_tpu``'s ``tensor_ops.py:235``, XLA's scatter there, so a
    plain one here): an id in [-N, 0) counts from the end and any other
    out-of-range id drops, as JAX's scatter drops it. The ids are masked
    on the device, never filtered on the host, so a captured step may
    hold the op (gradient accumulation's sparse branch)."""
    x = get(env, op.input("X"))
    n = x.shape[0]
    idx = get(env, op.input("Ids")).reshape(-1).long()
    upd = get(env, op.input("Updates")).to(x.dtype)
    upd = upd.reshape((idx.shape[0],) + tuple(x.shape[1:]))
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    if op.attr("overwrite", True):
        # the dropped ids write a scratch row past the end
        out = torch.cat([x, x[:1]]).index_copy(
            0, torch.where(valid, idx, n), upd)[:n]
    else:
        mask = valid.reshape((-1,) + (1,) * (upd.dim() - 1))
        out = x.index_add(0, torch.where(valid, idx, 0),
                          torch.where(mask, upd, torch.zeros_like(upd)))
    put(env, op.output("Out"), out)


# ---------------- the rest of paddle_tpu's tensor_ops.py ----------------
# (its :34-366). Every op is plain PyTorch, as every one is jnp there.

def _batch_like_shape(env, op):
    """``shape`` with entry ``output_dim_idx`` taken from the Input's dim
    ``input_dim_idx``."""
    ref = get(env, op.input("Input"))
    shape = list(op.attr("shape"))
    shape[op.attr("output_dim_idx", 0)] = ref.shape[op.attr("input_dim_idx",
                                                            0)]
    return tuple(shape), ref.device


@register("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(env, op):
    shape, device = _batch_like_shape(env, op)
    put(env, op.output("Out"), torch.full(shape, op.attr("value", 0.0),
                                          dtype=_out_dtype(op),
                                          device=device))


@register("fill_zeros_like")
def _fill_zeros_like(env, op):
    put(env, op.output("Out"), torch.zeros_like(get(env, op.input("X"))))


@register("uniform_random_batch_size_like")
def _uniform_random_batch_size_like(env, op):
    shape, device = _batch_like_shape(env, op)
    lo, hi = op.attr("min", -1.0), op.attr("max", 1.0)
    u = rng_draw(env, lambda gen: torch.rand(
        shape, generator=gen, dtype=torch.float32, device=device))
    put(env, op.output("Out"), (lo + (hi - lo) * u).to(_out_dtype(op)))


@register("gaussian_random_batch_size_like")
def _gaussian_random_batch_size_like(env, op):
    shape, device = _batch_like_shape(env, op)
    mean, std = op.attr("mean", 0.0), op.attr("std", 1.0)
    n = rng_draw(env, lambda gen: torch.randn(
        shape, generator=gen, dtype=torch.float32, device=device))
    put(env, op.output("Out"), (mean + std * n).to(_out_dtype(op)))


@register("truncated_gaussian_random")
def _truncated_gaussian_random(env, op):
    """``mean + std * z``, z a standard normal truncated to [-2, 2]
    (``jax.random.truncated_normal``), drawn by the inverse CDF of a
    uniform on [Phi(-2), Phi(2)]."""
    mean, std = op.attr("mean", 0.0), op.attr("std", 1.0)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = rng_draw(env, lambda gen: torch.rand(
        tuple(op.attr("shape")), generator=gen, dtype=torch.float32,
        device=env[DEVICE_KEY]))
    p = lo + (1.0 - 2.0 * lo) * u
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(-2.0, 2.0)
    put(env, op.output("Out"), (mean + std * z).to(_out_dtype(op)))


@register("randint")
def _randint(env, op):
    """Uniform integers in [low, high), held in int32 (the reference asks
    for int64, which JAX without x64 truncates to int32)."""
    out = rng_draw(env, lambda gen: torch.randint(
        op.attr("low", 0), op.attr("high"), tuple(op.attr("shape")),
        generator=gen, device=env[DEVICE_KEY]))
    put(env, op.output("Out"), out.to(torch.int32))


@register("split")
def _split(env, op):
    x = get(env, op.input("X"))
    axis = op.attr("axis", 0)
    sections = op.attr("sections")
    if not sections:
        num = op.attr("num", 0)
        sections = [x.shape[axis] // num] * num
    for v, o in zip(op.output_list("Out"),
                    torch.split(x, list(sections), dim=axis)):
        put(env, v, o)


@register("flatten", "flatten2")
def _flatten(env, op):
    x = get(env, op.input("X"))
    axis = op.attr("axis", 1)
    lead = 1
    for s in x.shape[:axis]:
        lead *= s
    put(env, op.output("Out"), x.reshape(lead, -1))


@register("transpose", "transpose2")
def _transpose(env, op):
    put(env, op.output("Out"),
        get(env, op.input("X")).permute(*op.attr("axis")))


@register("strided_slice")
def _strided_slice(env, op):
    """numpy's ``x[s:e:st]`` on each listed axis, negative strides
    included (torch's slicing takes none): the indices the slice picks,
    gathered."""
    x = get(env, op.input("Input"))
    for a, s, e, st in zip(op.attr("axes"), op.attr("starts"),
                           op.attr("ends"), op.attr("strides")):
        idx = range(*slice(s, e, st).indices(x.shape[a]))
        x = x.index_select(a, torch.tensor(list(idx), dtype=torch.long,
                                           device=x.device))
    put(env, op.output("Out"), x)


def _take_fill(dtype):
    """``jnp.take``'s fill for an index outside the array: NaN for floats,
    the most negative value for signed integers, the largest for unsigned
    ones, True for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


@register("gather")
def _gather(env, op):
    """Rows of X by Index (``jnp.take`` on axis 0): an index in [-N, 0)
    counts from the end, any other outside [0, N) gives a row of the
    dtype's fill, as ``jnp.take``'s default mode does."""
    x = get(env, op.input("X"))
    n = x.shape[0]
    idx = get(env, op.input("Index")).reshape(-1).long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = x.index_select(0, torch.where(valid, idx, 0))
    mask = valid.reshape((-1,) + (1,) * (x.dim() - 1))
    put(env, op.output("Out"),
        torch.where(mask, out, torch.full((), _take_fill(x.dtype),
                                          dtype=x.dtype, device=x.device)))


@register("gather_nd")
def _gather_nd(env, op):
    """``x[tuple(moveaxis(index, -1, 0))]``: as in JAX's indexing, a
    negative index counts from the end, any other outside the dim is
    clamped into it, and the gradient of such a clamped read is dropped."""
    x = get(env, op.input("X"))
    idx = get(env, op.input("Index")).long()
    parts, valid = [], None
    for j in range(idx.shape[-1]):
        n = x.shape[j]
        i = idx[..., j]
        i = torch.where(i < 0, i + n, i)
        ok = (i >= 0) & (i < n)
        valid = ok if valid is None else valid & ok
        parts.append(i.clamp(0, n - 1))
    out = x[tuple(parts)]
    mask = valid.reshape(tuple(valid.shape) + (1,) * (out.dim()
                                                      - valid.dim()))
    put(env, op.output("Out"), torch.where(mask, out, out.detach()))


@register("expand")
def _expand(env, op):
    """``jnp.tile(x, expand_times)``: fewer times than dims repeat the
    trailing dims, more prepend dims."""
    x = get(env, op.input("X"))
    times = list(op.attr("expand_times"))
    times = [1] * (x.dim() - len(times)) + times
    put(env, op.output("Out"), x.repeat(*times))


@register("expand_as")
def _expand_as(env, op):
    target = get(env, op.input("target_tensor"))
    put(env, op.output("Out"),
        get(env, op.input("X")).expand(target.shape).contiguous())


@register("stack")
def _stack(env, op):
    put(env, op.output("Y"),
        torch.stack(get_list(env, op, "X"), dim=op.attr("axis", 0)))


@register("unstack")
def _unstack(env, op):
    x = get(env, op.input("X"))
    for v, o in zip(op.output_list("Y"),
                    torch.unbind(x, dim=op.attr("axis", 0))):
        put(env, v, o)


@register("shape")
def _shape(env, op):
    x = get(env, op.input("Input"))
    put(env, op.output("Out"), torch.tensor(tuple(x.shape), dtype=torch.int32,
                                            device=x.device))


@register("one_hot")
def _one_hot(env, op):
    """float32 rows, 1 at each id (a trailing dim of 1 squeezed); an id
    outside [0, depth) gives a row of zeros, as ``jax.nn.one_hot``."""
    ids = get(env, op.input("X"))
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    depth = op.attr("depth")
    put(env, op.output("Out"),
        (ids.long().unsqueeze(-1) == torch.arange(
            depth, device=ids.device)).to(torch.float32))


@register("pad")
def _pad(env, op):
    x = get(env, op.input("X"))
    p = op.attr("paddings")  # flat [before0, after0, before1, ...]
    pads = []
    for i in reversed(range(x.dim())):  # F.pad lists the last dim first
        pads += [p[2 * i], p[2 * i + 1]]
    put(env, op.output("Out"),
        F.pad(x, pads, value=op.attr("pad_value", 0.0)))


@register("pad2d")
def _pad2d(env, op):
    """NCHW, paddings [top, bottom, left, right]; ``reflect`` mirrors
    without the edge, any other non-constant mode repeats the edge
    (``jnp.pad``'s ``edge``)."""
    x = get(env, op.input("X"))
    t, b, l, r = op.attr("paddings")
    mode = op.attr("mode", "constant")
    if mode == "constant":
        out = F.pad(x, [l, r, t, b], value=op.attr("pad_value", 0.0))
    else:
        out = F.pad(x, [l, r, t, b],
                    mode="reflect" if mode == "reflect" else "replicate")
    put(env, op.output("Out"), out)


@register("reverse")
def _reverse(env, op):
    put(env, op.output("Out"),
        torch.flip(get(env, op.input("X")), dims=list(op.attr("axis"))))


@register("roll")
def _roll(env, op):
    put(env, op.output("Out"), torch.roll(get(env, op.input("X")),
                                          op.attr("shifts"), op.attr("axis")))


@register("where")
def _where(env, op):
    put(env, op.output("Out"),
        torch.where(get(env, op.input("Condition")).bool(),
                    get(env, op.input("X")), get(env, op.input("Y"))))
