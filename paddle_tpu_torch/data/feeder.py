"""DataFeeder (ref ``python/paddle/fluid/data_feeder.py:156``; the port's
copy of ``paddle_tpu/data/feeder.py``): converts a
minibatch of python rows into the feed dict of dense numpy arrays, padding
ragged sequence slots and emitting companion ``<name>_len`` length tensors
(the static-shape replacement for LoD)."""

import numpy as np

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                from ..core import framework
                prog = program or framework.default_main_program()
                v = prog.global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable, pad_to=None):
        """iterable: list of rows, each row a tuple matching feed_list.
        Ragged slots (lod_level>0) are padded to the batch max (or
        ``pad_to[name]``) and produce an extra ``<name>_len`` int64 vector."""
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            col = [row[i] for row in rows]
            if var.lod_level and var.lod_level > 0:
                maxlen = max(len(np.atleast_1d(c)) for c in col)
                if pad_to and var.name in pad_to:
                    maxlen = max(maxlen, pad_to[var.name])
                arrs = []
                lens = []
                for c in col:
                    a = np.asarray(c)
                    lens.append(a.shape[0])
                    pad_width = [(0, maxlen - a.shape[0])] + \
                        [(0, 0)] * (a.ndim - 1)
                    arrs.append(np.pad(a, pad_width))
                out[var.name] = np.stack(arrs).astype(var.dtype)
                out[var.name + "_len"] = np.asarray(lens, dtype=np.int64)
            else:
                a = np.asarray(col)
                tail = tuple(s for s in (var.shape or ())[1:] if s > 0)
                if tail and a.shape[1:] != tail and a.size == len(rows) * int(np.prod(tail)):
                    a = a.reshape((len(rows),) + tail)
                out[var.name] = a.astype(var.dtype)
        return out
