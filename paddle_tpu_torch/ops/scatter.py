"""Row scatter-add ``out[rows] += vals`` over a ``[V, K]`` table: the
hand-written CUDA kernel (``csrc/scatter_add.cu``) and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``_scatter_kernel`` of
``paddle_tpu/ops/scatter.py`` (:163, via ``_scatter_packed_call`` :194),
with the index semantics of its entry ``scatter_add_rows`` (:232-269):
rows of any integer shape flatten to ``[N]``, vals to ``[N, K]`` in the
table's dtype; a row in ``[-V, 0)`` wraps python-style, any other
out-of-range row drops; duplicate rows accumulate; the result is a new
tensor unless the caller hands over a table it owns (``inplace=True``).
It is the backward of every sparse embedding: the densify of non-lazy
Adam and the sparse SGD update (``core/opimpl/optimizer_ops.py``).

The TPU kernel keeps a 128-lane packed copy of the table in VMEM, and its
gate weighs that against a VMEM budget; neither the packing, the budget
nor the environment switches around them carry over. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises (a table
of another dtype than f32 raises ``NotImplementedError`` until AMP is
ported). There is no fallback from one to the other. The path a call
took is recorded in the consuming op's ``_kernel_choice``.

The kernel's launch is planned here (:func:`scatter_plan`: 16-byte or
4-byte columns, chunk of slots per block, lanes per group, grid), and
:func:`scatter_add_chunked_emulated` repeats the kernel's per-chunk
aggregation of duplicate rows on the CPU for the tests; it is not on any
path.
"""

import collections
import ctypes
import functools

import torch

from . import _build

__all__ = ["scatter_add_rows", "scatter_add", "scatter_add_plain",
           "scatter_plan", "ScatterPlan", "scatter_add_chunked_emulated"]

_INT32 = (-(2 ** 31), 2 ** 31 - 1)
# the kernel's limits (csrc/scatter_add.cu): slots a block sorts at most,
# and the blocks of 256 threads an SM holds (its __launch_bounds__
# MIN_BLOCKS, which the C entry holds the plan's per_sm to)
_MAX_CHUNK = 1024
_BLOCKS_PER_SM = 6
# a block takes at least this many slots where there are that many:
# smaller chunks merge fewer duplicates and pay a block's fixed cost more
# often (tools/kernel_plans.py)
_MIN_CHUNK = 128

ScatterPlan = collections.namedtuple("ScatterPlan",
                                     "vec chunk group blocks per_sm")


def scatter_add_plain(base, rows, vals, inplace=False):
    """The plain version: wrap ``[-V, 0)``, drop the rest of the
    out-of-range rows, then ``index_add`` (into ``base`` itself when
    ``inplace``)."""
    v, k = base.shape
    rows = rows.reshape(-1).long()
    vals = vals.reshape(-1, k).to(base.dtype)
    rows = torch.where(rows < 0, rows + v, rows)
    keep = (rows >= 0) & (rows < v)
    rows, vals = rows[keep], vals[keep]
    if inplace:
        return base.index_add_(0, rows, vals)
    return base.index_add(0, rows, vals)


@functools.lru_cache(maxsize=256)
def scatter_plan(n, k, aligned, sms):
    """The kernel's launch for ``n`` slots of ``k`` columns on ``sms``
    SMs: a :class:`ScatterPlan` ``(vec, chunk, group, blocks, per_sm)``.

    ``vec`` 4 (float4 loads and reductions) where ``k % 4 == 0`` and vals
    and the table are 16-byte ``aligned``, else 1. ``group``: the lanes
    that share a slot, one per ``vec``-wide column group up to 32, a power
    of two. ``chunk``: slots per block, each block sorting its chunk by
    row and reducing each row's sum once; at most ``_MAX_CHUNK``, sized so
    the ``blocks = ceil(n / chunk)`` fill whole waves of the ``per_sm``
    resident blocks an SM, but at least ``_MIN_CHUNK`` (or ``n``). ``n ==
    0`` gives no block."""
    if n < 0 or k <= 0 or sms <= 0:
        raise ValueError("scatter_plan: N >= 0, K and SMs > 0, got %d, %d, "
                         "%d" % (n, k, sms))
    vec = 4 if k % 4 == 0 and aligned else 1
    group = min(32, 1 << (k // vec - 1).bit_length())
    if n == 0:
        return ScatterPlan(vec, 1, group, 0, _BLOCKS_PER_SM)
    resident = sms * _BLOCKS_PER_SM
    waves = -(-n // (resident * _MAX_CHUNK))
    chunk = -(-n // (waves * resident))
    chunk = min(_MAX_CHUNK, max(chunk, min(n, _MIN_CHUNK)))
    blocks = -(-n // chunk)
    return ScatterPlan(vec, chunk, group, blocks, _BLOCKS_PER_SM)


def scatter_add_chunked_emulated(base, rows, vals, plan):
    """The kernel's aggregation on the CPU, for the tests: a new ``[V,
    K]`` table. Per chunk of ``plan.chunk`` consecutive slots, in-range
    rows (``[-V, 0)`` wrapped) are summed per row first, and each sum is
    then added into the table once. Within a row the kernel takes the
    slots in no fixed order; here they go in slot order."""
    v, k = base.shape
    out = base.clone()
    rows = rows.reshape(-1).long()
    rows = torch.where(rows < 0, rows + v, rows)
    vals = vals.reshape(-1, k).to(base.dtype)
    for c0 in range(0, rows.shape[0], plan.chunk):
        r = rows[c0:c0 + plan.chunk]
        x = vals[c0:c0 + plan.chunk]
        keep = (r >= 0) & (r < v)
        uniq, inv = torch.unique(r[keep], return_inverse=True)
        sums = torch.zeros(uniq.shape[0], k, dtype=base.dtype)
        sums.index_add_(0, inv, x[keep])
        out.index_add_(0, uniq, sums)
    return out


def _c_fn():
    fn = _build.load("scatter_add").scatter_add_rows_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def scatter_add(out, rows, vals):
    """Launch the CUDA kernel: ``out[rows] += vals`` in place, with the
    wrap/drop index semantics, under :func:`scatter_plan`'s plan (the C
    entry refuses one that does not fit the call). out: CUDA f32
    contiguous ``[V, K]``; rows: int32 ``[N]``; vals: f32 contiguous
    ``[N, K]``, all on one device. Returns ``out``."""
    if out.dim() != 2 or not out.is_contiguous():
        raise ValueError("scatter_add wants a contiguous [V, K] table, got "
                         "shape %s" % (tuple(out.shape),))
    v, k = out.shape
    if v == 0 or k == 0:
        raise ValueError("scatter_add: empty [%d, %d] table" % (v, k))
    n = rows.shape[0] if rows.dim() == 1 else -1
    if n < 0 or tuple(vals.shape) != (n, k) or not vals.is_contiguous():
        raise ValueError("scatter_add: rows %s and vals %s do not match a "
                         "[%d, %d] table" % (tuple(rows.shape),
                                             tuple(vals.shape), v, k))
    if out.dtype != torch.float32 or vals.dtype != torch.float32 \
            or rows.dtype != torch.int32:
        raise TypeError("scatter_add takes an f32 table and vals and int32 "
                        "rows, got %s, %s, %s" % (out.dtype, vals.dtype,
                                                  rows.dtype))
    for t in (rows, vals):
        if t.device != out.device or out.device.type != "cuda":
            raise ValueError("scatter_add: tensors on %s and %s"
                             % (out.device, t.device))
    if n == 0:
        return out
    aligned = (vals.data_ptr() | out.data_ptr()) % 16 == 0
    plan = scatter_plan(n, k, aligned, _build.sm_count(out.device.index))
    _build.launch(_c_fn(), "scatter_add", out.device, rows.data_ptr(),
                  vals.data_ptr(), out.data_ptr(), n, k, v, *plan)
    scatter_add.launches += 1
    return out


scatter_add.launches = 0


def scatter_add_rows(base, rows, vals, sort=False, inplace=False, op=None):
    """``base.at[rows].add(vals, mode="drop")`` for a 2-D ``[V, K]``
    table (``paddle_tpu/ops/scatter.py:232``). ``sort=True`` first merges
    duplicate rows (:func:`~..core.op_registry.merge_sparse_rows`, the
    sorted-segment variant). ``inplace=True`` adds into ``base``, which
    the caller must own (a fresh tensor no tape or scope holds). ``op``,
    the consuming op, gets the path taken in its attrs
    (``_kernel_choice``: ``{"kernel": "cuda_scatter_add"}`` or
    ``{"kernel": "plain_scatter_add"}``)."""
    if base.dim() != 2:
        raise ValueError("scatter_add_rows wants a [V, K] table, got shape "
                         "%s" % (tuple(base.shape),))
    on_cpu = base.device.type == "cpu"
    if not on_cpu and base.dtype != torch.float32:
        raise NotImplementedError(
            "scatter_add_rows: %s tables on CUDA come with the AMP slice of "
            "paddle_tpu_torch" % base.dtype)
    v, k = base.shape
    rows = rows.reshape(-1)
    vals = vals.reshape(-1, k)
    if vals.dtype != base.dtype:
        vals = vals.to(base.dtype)
    if sort:
        from ..core.op_registry import merge_sparse_rows

        rows = rows.long()
        rows = torch.where((rows >= -v) & (rows < 0), rows + v, rows)
        rows = torch.where((rows >= 0) & (rows < v), rows,
                           torch.full_like(rows, v))
        rows, vals = merge_sparse_rows(rows, vals, v)
    if op is not None:
        op.attrs["_kernel_choice"] = {
            "kernel": "plain_scatter_add" if on_cpu else "cuda_scatter_add"}
    if on_cpu:
        return scatter_add_plain(base, rows, vals, inplace)
    if rows.dtype != torch.int32:
        rows = rows.clamp(*_INT32).to(torch.int32)
    out = base if inplace else base.clone(
        memory_format=torch.contiguous_format)
    return scatter_add(out, rows.contiguous(), vals.contiguous())
