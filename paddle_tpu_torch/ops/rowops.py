"""The dense row gather of a narrow embedding table, with the row
scatter-add kernel as its backward (the port's ``paddle_tpu/ops/
rowops.py``: ``packed_take`` :38-59 and its VJP :88-93).

On the TPU a table whose width K divides 128 (``pack_factor(K) > 1``) is
gathered through a packed 128-lane layout, and the gather's gradient, the
row scatter-add ``dW[ids] += g``, goes to ``ops/scatter.py``'s
``scatter_add_rows`` (the Pallas kernel where its gate admits the table).
The packing is the TPU's lanes and does not carry over: the port's forward
is one ``index_select``. The backward is the same call:
:func:`~.scatter.scatter_add_rows` into a zero table, so on the card the
hand-written kernel (``csrc/scatter_add.cu``) takes it, one launch a
lookup, and on the CPU its plain version; the gradient is cast to the
table's dtype first (under AMP the rows arrive in bf16, the table stays
f32). Tables of any other width keep ``index_select``'s own backward, as
the reference keeps ``jnp.take``'s.
"""

import torch

from .scatter import scatter_add_rows

__all__ = ["pack_factor", "packed_take"]

_LANES = 128


def pack_factor(k):
    """How many K-wide rows fit one 128-lane row on the TPU (1: K does
    not divide 128, or is not below it); above 1 selects this route."""
    if k <= 0 or k >= _LANES or _LANES % k:
        return 1
    return _LANES // k


class _NarrowTake(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, ids, op):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype, ctx.op = w.shape, w.dtype, op
        return w.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dw = torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)
        return scatter_add_rows(dw, ids, g, inplace=True, op=ctx.op), \
            None, None


def packed_take(w, ids, op=None):
    """``w[ids]`` of a 2-D ``[V, K]`` table for flat ids ``[N]``, whose
    gradient is the row scatter-add (the kernel on the card); ``op``, the
    lookup, gets the scatter's path in ``_kernel_choice`` when the
    backward runs. Only tables with ``pack_factor(K) > 1`` come here."""
    return _NarrowTake.apply(w, ids, op)
