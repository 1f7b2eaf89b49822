"""Sequence ops over padded batches with explicit lengths (the subset of
``paddle_tpu/core/opimpl/sequence_ops.py`` the served models run)."""

import torch

from ..framework import torch_dtype
from ..op_registry import register, get, put


@register("sequence_mask")
def _sequence_mask(env, op):
    x = get(env, op.input("X")).reshape(-1)
    maxlen = op.attr("maxlen", -1)
    if maxlen is None or maxlen <= 0:
        maxlen = op.output("Y").shape[-1]
    dtype = torch_dtype(op.attr("out_dtype", "int64"))
    pos = torch.arange(maxlen, device=x.device)
    put(env, op.output("Y"), (pos[None, :] < x[:, None]).to(dtype))
