"""AsyncExecutor: file-fed training driven by the native data plane (the
port of ``paddle_tpu/async_executor.py``).

Reference: ``paddle/fluid/framework/async_executor.h:64`` — worker threads
each own a DataFeed over a file split and run the program op-by-op;
``python/paddle/fluid/async_executor.py`` is the Python driver.

Design: C++ reader threads (``paddle_tpu_torch/native_src/prefetch_queue.cc``)
keep an MPMC byte-record queue full from recordio files, the host
assembles dense batches (one np.frombuffer per slot, ``data/data_feed.py``),
and ONE executor step consumes them back to back on the executor's place
(the card by default; its second run of the key is captured as a CUDA
graph and replayed, and the launches are asynchronous, so host batching
overlaps the device). ``thread_num`` scales the file readers.
``last_run`` says how the latest :meth:`run` went: ``queue`` ("native"),
``records`` popped from the C++ queue, ``steps`` and ``bad_records``.
"""

import warnings

from . import native
from .core import framework
from .core.executor import Executor, global_scope, to_numpy
from .reliability import faults

__all__ = ["AsyncExecutor"]


class AsyncExecutor:
    def __init__(self, place=None, run_mode=""):
        self.place = place
        self._exe = Executor(place)
        self.last_run = None

    def run(self, program, data_feed, filelist, thread_num=2,
            fetch=None, mode="", debug=False, n_epochs=1, scope=None,
            queue_capacity=1024, max_bad_records=0):
        """Train ``program`` over every sample in ``filelist`` (recordio
        files of ``data_feed``-serialized samples). Returns the list of
        fetch values from the last step.

        ``thread_num`` = native reader threads (ref: worker thread count).
        Partial final batches are dropped, matching the fixed-shape batch
        convention (and the reference's DataFeed batch semantics).

        ``max_bad_records``: a long-running ingest job must not die to one
        torn record (the reference's recordio chunk-CRC skip-on-corrupt,
        SURVEY §5.3) — records whose size does not match the
        ``data_feed`` schema are skipped and counted, up to this bound;
        one past it aborts the run. 0 (default) keeps fail-fast; ``None``
        is unbounded (counted + warned only)."""
        program = program or framework.default_main_program()
        fetch = fetch or []
        if isinstance(filelist, str):
            filelist = [filelist]
        if not native.native_available():
            raise RuntimeError("AsyncExecutor needs the native data plane "
                               "(g++ toolchain) — use PyReader instead")
        faults.maybe_install_from_env()
        scope = scope or global_scope()
        fetch_vals = None
        bs = data_feed.batch_size
        rec_nbytes = getattr(data_feed, "sample_nbytes", None)
        steps = 0
        bad = 0
        with native.PrefetchQueue(capacity=queue_capacity) as q:
            q.start_files(list(filelist), n_threads=int(thread_num),
                          n_epochs=int(n_epochs))
            batch = []
            for rec in q:
                # fault site: 'corrupt' truncates the record (drilling the
                # bounded-skip path below); 'error'/'hang' model a dying
                # or stalling reader
                if faults.trip("recordio.read") == "corrupt":
                    rec = faults.corrupt_bytes(rec)
                if rec_nbytes is not None and len(rec) != rec_nbytes:
                    bad += 1
                    if max_bad_records is not None and bad > max_bad_records:
                        raise ValueError(
                            "AsyncExecutor: %d malformed record(s) (got "
                            "%d bytes, schema says %d) exceeds "
                            "max_bad_records=%d — corrupt file or wrong "
                            "DataFeedDesc?"
                            % (bad, len(rec), rec_nbytes, max_bad_records))
                    continue
                batch.append(rec)
                if len(batch) < bs:
                    continue
                feed = data_feed.parse_batch(batch)
                batch = []
                fetch_vals = self._exe.run(program, feed=feed,
                                           fetch_list=fetch, scope=scope,
                                           return_numpy=False)
                steps += 1
                if debug and steps % 100 == 0:
                    print("AsyncExecutor: %d steps" % steps)
            popped = q.popped
        self.last_run = {"queue": "native", "records": popped,
                         "steps": steps, "bad_records": bad}
        if bad:
            warnings.warn(
                "AsyncExecutor: skipped %d malformed record(s) "
                "(max_bad_records=%s)" % (bad, max_bad_records),
                RuntimeWarning, stacklevel=2)
        if fetch_vals is None:
            raise RuntimeError(
                "AsyncExecutor: no full batch assembled from %d file(s) — "
                "fewer than batch_size=%d records present (partial batches "
                "are dropped)" % (len(filelist), bs))
        return [to_numpy(v) for v in fetch_vals]

    def run_from_stream(self, program, data_feed, stream, fetch=None,
                        scope=None, max_bad_records=0, max_steps=None,
                        on_step=None):
        """Continuous analog of :meth:`run`: consume a live
        :class:`~paddle_tpu_torch.streaming.RecordStream` (tail-follow over a
        growing recordio file set — pure Python, no native toolchain
        needed) until it closes or ``max_steps`` training steps ran.

        The stream trips the ``recordio.read``/``stream.tail`` fault
        sites itself; ``max_bad_records`` bounds schema-size-mismatch
        skips exactly like :meth:`run`. ``on_step(step, fetch_vals)``
        fires after every executor step (the trainer's publish hook).
        Returns the number of steps executed."""
        from .streaming.stream import StreamIngester

        program = program or framework.default_main_program()
        fetch = fetch or []
        faults.maybe_install_from_env()
        scope = scope or global_scope()
        ingester = StreamIngester(stream, data_feed,
                                  max_bad_records=max_bad_records)
        steps = 0
        for feed in ingester.batches():
            vals = self._exe.run(program, feed=feed, fetch_list=fetch,
                                 scope=scope, return_numpy=False)
            steps += 1
            if on_step is not None:
                on_step(steps, vals)
            if max_steps is not None and steps >= max_steps:
                break
        return steps
