"""py_reader: decoupled feed with background prefetch and device staging
(the port of ``paddle_tpu/data/py_reader.py``).

Reference: ``layers/io.py:636`` py_reader + ``create_py_reader_op`` /
``lod_tensor_blocking_queue.h`` / ``buffered_reader.cc`` (double-buffer
prefetch to the device). A background thread converts batches through
:class:`~.feeder.DataFeeder` and, on a CUDA place, stages each one ahead
of its step: each array is copied into pinned host memory and then to the
card with ``non_blocking=True`` on a side stream, and an event is recorded
after the copies. The consumer's stream waits on that event before the
batch is handed out (without the wait a step could read a half-copied
batch), and each staged tensor is marked as used on the consumer's stream
so the allocator does not hand its memory back early. On a CPU place, or
with ``device_put=False``, batches are handed out as numpy arrays.
"""

import queue
import threading

import numpy as np
import torch

from ..core.executor import resolve_device
from ..core.framework import torch_dtype

__all__ = ["py_reader", "PyReader"]


class PyReader:
    """``place`` (default ``CUDAPlace(0)``) is where batches are staged;
    without a GPU the default raises, as every entry point does.
    ``staged`` counts the batches copied to the card."""

    def __init__(self, feed_list, capacity=16, device_put=True, program=None,
                 place=None):
        from .feeder import DataFeeder

        self._feeder = DataFeeder(feed_list, program=program)
        self._vars = {v.name: v for v in self._feeder.feed_vars}
        self._capacity = capacity
        self._device = resolve_device(place) if device_put else None
        self._reader = None
        self._thread = None
        self._queue = None
        self._end = object()
        self.staged = 0

    def decorate_paddle_reader(self, reader):
        """reader: generator of minibatches (lists of rows)."""
        self._reader = reader

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_batch_generator(self, reader):
        """reader yields ready feed dicts of numpy arrays."""
        self._reader = reader
        self._feeder = None

    def _stage(self, feed, stream):
        """Pinned copy, then an async copy to the card on ``stream``; the
        event marks the end of the copies."""
        out = {}
        with torch.cuda.stream(stream):
            for name, value in feed.items():
                a = np.ascontiguousarray(value)
                var = self._vars.get(name)
                want = torch_dtype(var.dtype if var is not None
                                   else a.dtype)
                host = torch.from_numpy(a).to(want).pin_memory()
                out[name] = host.to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        self.staged += 1
        return out, done

    def start(self):
        self._queue = queue.Queue(maxsize=self._capacity)
        cuda = self._device is not None and self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None

        def worker():
            try:
                for item in self._reader():
                    feed = (self._feeder.feed(item) if self._feeder
                            else dict(item))
                    self._queue.put(self._stage(feed, stream) if cuda
                                    else (feed, None))
            finally:
                self._queue.put(self._end)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="py-reader")
        self._thread.start()

    def reset(self):
        if self._queue is not None:
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        self._thread = None

    def __iter__(self):
        if self._thread is None:
            self.start()
        while True:
            item = self._queue.get()
            if item is self._end:
                self._thread = None
                return
            feed, done = item
            if done is not None:
                cur = torch.cuda.current_stream(self._device)
                cur.wait_event(done)
                for t in feed.values():
                    t.record_stream(cur)
            yield feed


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True, place=None):
    """API-parity constructor (ref ``layers/io.py:636``): declares the data
    vars and returns a PyReader bound to them, staging on ``place``
    (default ``CUDAPlace(0)``) when ``use_double_buffer``."""
    from ..layers import io as layers_io

    lod_levels = lod_levels or [0] * len(shapes)
    feed_vars = []
    for i, (shape, dtype, lod) in enumerate(zip(shapes, dtypes, lod_levels)):
        feed_vars.append(layers_io.data(
            name="%s_slot_%d" % (name or "py_reader", i),
            shape=list(shape)[1:], dtype=dtype, lod_level=lod,
            append_batch_size=True))
    rd = PyReader(feed_vars, capacity=capacity,
                  device_put=use_double_buffer, place=place)
    rd.feed_vars = feed_vars
    return rd
