"""Tensor creation / manipulation / random / embedding ops (the subset of
``paddle_tpu/core/opimpl/tensor_ops.py`` that startup programs and the
ported models run). Random ops draw from the executor's
``torch.Generator``."""

import torch

from ..framework import convert_np_dtype, torch_dtype
from ..op_registry import (DEVICE_KEY, SPARSE_SITES_KEY, get, get_list,
                           next_rng, put, register)


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
    u = torch.rand(tuple(op.attr("shape")), generator=next_rng(env),
                   dtype=torch.float32, device=env[DEVICE_KEY])
    put(env, op.output("Out"), (lo + (hi - lo) * u).to(_out_dtype(op)))


@register("gaussian_random")
def _gaussian_random(env, op):
    mean, std = op.attr("mean", 0.0), op.attr("std", 1.0)
    n = torch.randn(tuple(op.attr("shape")), generator=next_rng(env),
                    dtype=torch.float32, device=env[DEVICE_KEY])
    put(env, op.output("Out"), (mean + std * n).to(_out_dtype(op)))


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
    row index.

    A table with a sparse gradient in a training step (listed under
    ``SPARSE_SITES_KEY`` by the Executor) is not on the tape: the lookup
    gathers from it, makes its masked output a leaf and records the site,
    whose output gradient the ``autodiff`` op turns into (rows, values)."""
    w_name = op.input("W").name
    w = get(env, op.input("W"))
    ids = get(env, op.input("Ids"))
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = w.index_select(0, ids.reshape(-1)).reshape(*ids.shape, w.shape[1])
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    sites = env.get(SPARSE_SITES_KEY)
    if sites is not None and w_name in sites and torch.is_grad_enabled():
        out = out.detach().requires_grad_(True)
        sites[w_name].append((ids, out, padding_idx))
    put(env, op.output("Out"), out)
