"""DataFeed: file-fed training schema + batching (the port's copy of
``paddle_tpu/data/data_feed.py``: records are byte-equal).

Reference: ``paddle/fluid/framework/data_feed.h:49`` (DataFeed /
MultiSlotDataFeed parse worker files into slot batches) configured by
``DataFeedDesc`` protobuf text (``python/paddle/fluid/data_feed_desc.py``).

Design: slots are fixed-shape dense tensors (the padded-batch
convention used framework-wide), one sample per recordio record as
concatenated little-endian slot buffers. Parsing a batch is one
``np.frombuffer`` + reshape per slot — no per-value Python. The C++ side
(``paddle_tpu_torch/native_src/prefetch_queue.cc``) owns file reading and
prefetch threading.
"""

import numpy as np

__all__ = ["DataFeedDesc"]


class DataFeedDesc:
    """Schema of one sample: ordered slots (name, shape, dtype) + batch
    size. ``shape`` excludes the batch dim and must be static (pipeline
    convention)."""

    def __init__(self, slots, batch_size=32):
        # slots: [(name, shape, dtype), ...] or {name: (shape, dtype)}
        if isinstance(slots, dict):
            slots = [(n, s, d) for n, (s, d) in slots.items()]
        self.slots = [(str(n), tuple(int(x) for x in s), np.dtype(d))
                      for n, s, d in slots]
        self.batch_size = int(batch_size)
        self._sizes = [int(np.prod(s)) * d.itemsize
                       for _, s, d in self.slots]
        self.sample_nbytes = sum(self._sizes)

    def set_batch_size(self, bs):
        self.batch_size = int(bs)

    # -- serialization ------------------------------------------------------
    def serialize(self, sample):
        """dict name->array -> one record's bytes."""
        parts = []
        for (name, shape, dtype), size in zip(self.slots, self._sizes):
            a = np.ascontiguousarray(np.asarray(sample[name], dtype=dtype)
                                     .reshape(shape))
            parts.append(a.tobytes())
        return b"".join(parts)

    def parse_batch(self, records):
        """list of record bytes -> dict name -> [n, *shape] array."""
        n = len(records)
        buf = np.frombuffer(b"".join(records), dtype=np.uint8)
        if buf.size != n * self.sample_nbytes:
            raise ValueError(
                "record size mismatch: got %d bytes for %d samples of %d "
                "bytes (corrupt file or wrong DataFeedDesc?)"
                % (buf.size, n, self.sample_nbytes))
        buf = buf.reshape(n, self.sample_nbytes)
        out = {}
        off = 0
        for (name, shape, dtype), size in zip(self.slots, self._sizes):
            piece = np.ascontiguousarray(buf[:, off:off + size])
            out[name] = piece.view(dtype).reshape((n,) + shape)
            off += size
        return out
