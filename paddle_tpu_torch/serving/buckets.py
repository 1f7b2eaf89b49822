"""Shape-bucketing policy: pad batches onto a fixed ladder of sizes.

The copy of ``paddle_tpu/serving/buckets.py``. Padding the batch dim (and
optionally a sequence dim) up to the nearest rung bounds the distinct feed
shapes a replica ever runs at ``len(ladder)`` (times ``len(seq_ladder)``),
so ``warmup()`` can touch every one of them before traffic lands. In
``paddle_tpu`` each shape is an XLA compile; in the port it is one
captured CUDA graph on the card and the set of shapes the kernels and
cuBLAS see.

Padding replicates the last real row (edge padding) rather than writing
zeros: integer feeds are usually embedding ids or lengths, and zero-padding
a feed with a declared non-zero lower bound feeds the model
out-of-distribution values. Replicated rows are sliced off by
:func:`unpad_fetch` before results leave the engine.
"""

import numpy as np

__all__ = ["pow2_ladder", "bucket_for", "pad_to_bucket", "unpad_fetch",
           "edge_pad", "BucketError"]


class BucketError(ValueError):
    """A request doesn't fit any rung of the ladder."""


def pow2_ladder(max_batch_size):
    """Powers of two up to and including ``max_batch_size`` (the default
    ladder: compile cache bounded at ~log2(max_batch_size) entries).

    >>> pow2_ladder(8)
    (1, 2, 4, 8)
    >>> pow2_ladder(6)
    (1, 2, 4, 6)
    """
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1, got %r"
                         % (max_batch_size,))
    ladder = []
    r = 1
    while r < max_batch_size:
        ladder.append(r)
        r *= 2
    ladder.append(int(max_batch_size))
    return tuple(ladder)


def _normalize(ladder):
    rungs = sorted(set(int(r) for r in ladder))
    if not rungs or rungs[0] < 1:
        raise ValueError("ladder must hold positive rungs, got %r"
                         % (ladder,))
    return rungs


def bucket_for(n, ladder):
    """Smallest rung >= n (the bucket a size-``n`` batch compiles as)."""
    for r in _normalize(ladder):
        if n <= r:
            return r
    raise BucketError("batch of %d exceeds the top ladder rung %d"
                      % (n, max(ladder)))


def edge_pad(a, target, axis):
    """Lengthen ``a`` to ``target`` along ``axis`` by replicating the last
    real entry (the in-distribution padding the module docstring argues
    for). No-op when already at or past ``target``."""
    if a.shape[axis] >= target:
        return a
    idx = np.minimum(np.arange(target), a.shape[axis] - 1)
    return np.take(a, idx, axis=axis)


def pad_to_bucket(feed, ladder, seq_ladder=None, seq_dim=1):
    """Pad every array in ``feed`` (dict name -> array with a leading batch
    dim) up to the ladder rung covering the actual batch size.

    With ``seq_ladder``, arrays of rank >= 2 also get ``seq_dim`` padded up
    its own rung (edge replication again — repeated trailing tokens), which
    bounds compiles for variable-length text serving at
    ``len(ladder) * len(seq_ladder)``.

    Returns ``(padded_feed, n)`` where ``n`` is the true batch size, for
    :func:`unpad_fetch`.
    """
    arrays = {k: np.asarray(v) for k, v in feed.items()}
    # 0-d feeds (scalars) carry no batch dim: excluded from the consensus
    # and passed through unpadded
    sizes = {k: a.shape[0] for k, a in arrays.items() if a.ndim}
    if len(set(sizes.values())) > 1:
        raise ValueError("feeds disagree on batch size: %s" % (sizes,))
    n = next(iter(sizes.values())) if sizes else 0
    if n < 1:
        raise ValueError("empty batch")
    rung = bucket_for(n, ladder)
    out = {}
    for k, a in arrays.items():
        if a.ndim == 0:
            out[k] = a
            continue
        a = edge_pad(a, rung, 0)
        if seq_ladder is not None and a.ndim >= 2:
            a = edge_pad(a, bucket_for(a.shape[seq_dim], seq_ladder),
                         seq_dim)
        out[k] = a
    return out, n


def unpad_fetch(fetches, n, padded_to=None):
    """Slice fetch results back to the true batch size ``n``. With
    ``padded_to`` (the rung the batch was padded to) only outputs whose
    leading dim IS the padded batch are sliced — a non-batch output that
    happens to be longer than ``n`` (a class-prior vector, say) passes
    through untouched, as do scalar summaries and already-reduced
    metrics."""
    out = []
    for f in fetches:
        a = np.asarray(f)
        if a.ndim >= 1 and (a.shape[0] == padded_to
                            if padded_to is not None else a.shape[0] >= n):
            a = a[:n]
        out.append(a)
    return out
