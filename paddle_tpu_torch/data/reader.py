"""Reader-decorator combinators, the port's copy of
``paddle_tpu/data/reader.py`` (ref ``python/paddle/reader/decorator.py`` +
the reader ops ``operators/reader/``): shuffle, batch, buffered
(background prefetch), map/xmap, chain, compose, multi-pass, firstn,
cache, and the recordio reader/writer over the native data plane."""

import itertools
import queue
import random
import threading

__all__ = ["shuffle", "batch", "buffered", "map_readers", "chain", "compose",
           "firstn", "cache", "xmap_readers", "multiprocess_reader",
           "multi_pass", "recordio_reader", "recordio_writer"]


def shuffle(reader, buf_size):
    def impl():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        random.shuffle(buf)
        for b in buf:
            yield b

    return impl


def batch(reader, batch_size, drop_last=True):
    """drop_last defaults True: XLA recompiles on a new batch shape, so the
    ragged final batch is dropped (vs. reference default False)."""

    def impl():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return impl


def buffered(reader, size):
    """Background-thread prefetch — the host half of the reference's
    double-buffer reader op (``buffered_reader.cc``)."""

    end = object()

    def impl():
        q = queue.Queue(maxsize=size)

        def worker():
            try:
                for item in reader():
                    q.put(item)
            finally:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item

    return impl


def map_readers(func, *readers):
    def impl():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return impl


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool mapped reader (ref xmap_readers). ``order=True`` yields
    the mapped items in the reader's order (``paddle_tpu``'s ignores the
    flag)."""
    end = object()

    def impl():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feeder():
            for item in enumerate(reader()):
                in_q.put(item)
            for _ in range(process_num):
                in_q.put(end)

        def worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                out_q.put((item[0], mapper(item[1])))

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()
        finished, held, nxt = 0, {}, 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
            elif not order:
                yield item[1]
            else:
                held[item[0]] = item[1]
                while nxt in held:
                    yield held.pop(nxt)
                    nxt += 1

    return impl


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Single-host fallback: interleave readers round-robin (true
    multi-process variant needs picklable readers; threads suffice for
    numpy-bound pipelines)."""
    def impl():
        its = [r() for r in readers]
        while its:
            nxt = []
            for it in its:
                try:
                    yield next(it)
                    nxt.append(it)
                except StopIteration:
                    pass
            its = nxt

    return impl


def chain(*readers):
    def impl():
        for r in readers:
            for item in r():
                yield item

    return impl


def compose(*readers):
    def impl():
        for vals in zip(*[r() for r in readers]):
            out = []
            for v in vals:
                if isinstance(v, tuple):
                    out.extend(v)
                else:
                    out.append(v)
            yield tuple(out)

    return impl


def firstn(reader, n):
    def impl():
        return itertools.islice(reader(), n)

    return impl


def multi_pass(reader, num_passes):
    def impl():
        for _ in range(num_passes):
            for item in reader():
                yield item

    return impl


def cache(reader):
    data = []
    filled = [False]

    def impl():
        if not filled[0]:
            for item in reader():
                data.append(item)
                yield item
            filled[0] = True
        else:
            for item in data:
                yield item

    return impl


def recordio_reader(files, n_threads=2, n_epochs=1, capacity=512):
    """Reader creator streaming raw records from recordio files through the
    NATIVE prefetch queue (C++ reader threads + bounded MPMC queue — the
    ``open_files``/double-buffer capability, ref
    ``operators/reader/open_files_op.cc``/``buffered_reader.cc``). Records
    are bytes; compose with ``map_readers`` to decode."""
    if isinstance(files, str):
        files = [files]
    import os
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        # the native worker skips unopenable files silently (robustness
        # against transient loss mid-train); fail fast on a bad config here
        raise IOError("recordio files not found: %s" % (missing,))

    def reader():
        from .. import native

        with native.PrefetchQueue(capacity=capacity) as q:
            q.start_files(list(files), n_threads=n_threads,
                          n_epochs=n_epochs)
            for rec in q:
                yield rec

    return reader


def recordio_writer(path, reader, max_chunk_records=1024,
                    serializer=None):
    """Materialize a reader's records into a recordio file (ref
    ``recordio_writer.py`` convert_reader_to_recordio_file)."""
    from .. import native

    n = 0
    with native.RecordIOWriter(path, max_chunk_records) as w:
        for item in reader():
            w.write(serializer(item) if serializer else item)
            n += 1
    return n
