"""Tensor creation / manipulation / random / embedding ops (the subset of
``paddle_tpu/core/opimpl/tensor_ops.py`` that startup programs and the
ported models run). Random ops draw from the executor's
``torch.Generator``."""

import torch

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
    gather (``ops/rowops.py``) exists for TPU lanes; here it is a plain
    row index. A lookup whose op carries ``out_of_range="fill"`` indexes
    as ``jnp.take`` does (the reference's gather for tables whose width
    does not divide 128): an id in [-V, 0) counts from the end, and any
    other outside [0, V) gives a row of NaN, not an index error (on the
    card, a device assert). Only the decode chunk's position lookup
    carries it (``models.transformer``): its pad lanes feed position C,
    past the position table when C is its size, and their outputs are
    ignored. Every other lookup is one ``index_select``.

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
    if op.attr("out_of_range") == "fill":
        v = w.shape[0]
        flat = torch.where(flat < 0, flat + v, flat)
        valid = (flat >= 0) & (flat < v)
        out = w.index_select(0, torch.where(valid, flat, 0))
        out = torch.where(valid.unsqueeze(1), out, float("nan"))
    else:
        out = w.index_select(0, flat)
    out = out.reshape(*ids.shape, w.shape[1])
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    sites = env.get(SPARSE_SITES_KEY)
    if sites is not None and w_name in sites and torch.is_grad_enabled():
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
