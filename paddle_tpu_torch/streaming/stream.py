"""Tail-follow recordio ingest: the stream side of continuous learning.
(The port's copy of ``paddle_tpu/streaming/stream.py``.)

Reference: ``paddle/fluid/recordio/`` chunk format +
``async_executor.cc`` file-fed workers. The native reader
(``native_src/recordio.cc``) rescans byte-at-a-time on any framing
mismatch — correct for sealed files, wrong for a file still being
written, where a half-landed trailing chunk is NOT corruption but
"bytes in flight". This pure-Python tail parser keeps the same wire
format and corruption semantics (CRC32-verified chunks, skip-and-rescan
on damage) but treats an incomplete trailing chunk as *pending*: the
byte offset is saved and the next poll resumes exactly there.

Wire format (little-endian, ``recordio.cc``)::

    [magic u32 = 0x7061646c][num_records u32][payload_len u32][crc32 u32]
    payload: ([len u32][record bytes]) * num_records

Rotation contract (standard log rotation): files are named so
lexicographic order is write order (``part-00000``, ``part-00001``, ...)
and a file is immutable once a newer file exists. A partial tail on a
rotated-away file is therefore a torn write, counted and skipped; on the
newest file it is awaited.

Fault sites (``reliability/faults.py`` grammar):
  * ``stream.tail`` — trips once per poll cycle: ``error`` raises out of
    the iterator (a dying tailer), ``hang`` stalls the poll, ``corrupt``
    damages the first record delivered by that poll (a torn tail read).
  * ``recordio.read`` — trips once per record, same site the batch
    ``AsyncExecutor.run`` path drills: ``corrupt`` truncates the record
    so the bounded ``max_bad_records`` skip downstream can be exercised.
"""

import fnmatch
import os
import struct
import threading
import time
import warnings
import zlib
from collections import deque

from ..obs import registry as obs_registry
from ..reliability import faults

__all__ = ["RecordStream", "StreamIngester", "TailReader", "REGISTRY",
           "encode_chunk", "write_records"]

_MAGIC = 0x7061646C
_MAGIC_BYTES = struct.pack("<I", _MAGIC)
_HEADER = struct.Struct("<IIII")  # magic, num_records, payload_len, crc32
# framing guard: a corrupted payload_len must not make the tailer wait
# forever for bytes that will never come
_MAX_PAYLOAD = 1 << 26

# the streaming plane's metric registry (scrape via
# ``streaming.REGISTRY.prometheus_text()``); per-stream gauges register
# here unless a stream is given its own Registry
REGISTRY = obs_registry.Registry()


def encode_chunk(records):
    """One complete chunk (native wire format) holding ``records``."""
    payload = b"".join(struct.pack("<I", len(r)) + bytes(r)
                       for r in records)
    return _HEADER.pack(_MAGIC, len(records), len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def write_records(path, records, mode="ab"):
    """Append one chunk of ``records`` to ``path`` — the pure-Python
    counterpart of ``native.RecordIOWriter`` (no g++ toolchain needed),
    byte-compatible with the native reader. Returns bytes written."""
    chunk = encode_chunk(list(records))
    with open(path, mode) as f:
        f.write(chunk)
        f.flush()
    return len(chunk)


class TailReader:
    """Incremental chunk parser over ONE growing recordio file.

    ``poll(final=False)`` parses every complete chunk that has landed
    since the last call and returns ``(records, pending)`` — ``pending``
    means a partial trailing chunk is waiting for more bytes. With
    ``final=True`` (file rotated away / producer closed) a partial tail
    is a torn write: counted in ``bad_chunks`` and skipped."""

    def __init__(self, path):
        self.path = path
        self.offset = 0
        self.records_read = 0
        self.bad_chunks = 0
        self.done = False
        # (end_offset, n_records) per chunk parsed by the LAST poll —
        # the provenance RecordStream's durable cursor advances on
        self.last_chunks = []

    def poll(self, final=False):
        out = []
        self.last_chunks = []
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return out, False  # rotated away before we ever opened it
        if size <= self.offset:
            return out, False
        with open(self.path, "rb") as f:
            pending = self._scan(f, size, out, final)
        return out, pending

    def _scan(self, f, size, out, final):
        while self.offset < size:
            f.seek(self.offset)
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                if final:
                    self.bad_chunks += 1
                    self.offset = size
                    return False
                return True  # header still landing
            magic, nrec, plen, crc = _HEADER.unpack(header)
            if magic != _MAGIC or plen > _MAX_PAYLOAD:
                self.offset += 1
                self._rescan(f, size)
                continue
            payload = f.read(plen)
            if len(payload) < plen:
                if final:
                    self.bad_chunks += 1
                    self.offset = size
                    return False
                return True  # payload still landing
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                self.bad_chunks += 1
                self.offset += 1
                self._rescan(f, size)
                continue
            recs, ok = _parse_payload(payload, nrec)
            if not ok:
                self.bad_chunks += 1
                self.offset += 1
                self._rescan(f, size)
                continue
            out.extend(recs)
            self.records_read += len(recs)
            self.offset += _HEADER.size + plen
            self.last_chunks.append((self.offset, len(recs)))
        return False

    def _rescan(self, f, size):
        """Native-reader recovery: after lost framing, advance to the
        next magic occurrence (buffered find, not byte-at-a-time)."""
        pos = self.offset
        overlap = len(_MAGIC_BYTES) - 1
        while pos < size:
            f.seek(pos)
            buf = f.read(1 << 16)
            if not buf:
                break
            hit = buf.find(_MAGIC_BYTES)
            if hit >= 0:
                self.offset = pos + hit
                return
            pos += max(len(buf) - overlap, 1)
        self.offset = size


def _parse_payload(payload, nrec):
    recs = []
    off = 0
    n = len(payload)
    while off + 4 <= n and len(recs) < nrec:
        (ln,) = struct.unpack_from("<I", payload, off)
        off += 4
        if off + ln > n:
            return recs, False
        recs.append(payload[off:off + ln])
        off += ln
    return recs, (len(recs) == nrec and off == n)


class RecordStream:
    """Tail-follow iterator over a growing, rotating recordio file SET.

    ``source`` is a directory (files matching ``pattern``, sorted
    lexicographically = rotation order) or a zero-arg callable returning
    the current file list. ``records()`` yields record bytes forever,
    sleeping ``poll_interval_s`` between empty polls, until ``close()``
    is called AND every file has drained. The producer calls ``close()``
    when it will append no more.

    ``rows_per_sec()`` is a sliding-window ingest rate, exported as the
    fn-backed gauge ``paddle_tpu_stream_ingest_rows_per_sec`` on
    ``registry`` (default: the module :data:`REGISTRY`).

    ``cursor()``/``seek()`` make the read position durable: a cursor is
    a plain dict (per-file byte offsets + done flags + the cumulative
    row count) that a trainer persists inside every published checkpoint
    version, so a restarted host resumes the tail-follow exactly where
    the last *published* state left off — at-least-once, with replay
    bounded by the publish cadence."""

    def __init__(self, source, pattern="*.recordio", poll_interval_s=0.05,
                 registry=None, clock=None, sleep=None):
        self._source = source
        self.pattern = pattern
        self.poll_interval_s = float(poll_interval_s)
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self._readers = {}
        self._listed = []
        self._seek = {}       # basename -> {"offset": int, "done": bool}
        self._base_rows = 0   # rows accounted by an adopted cursor
        self._delivered = 0   # records handed to the consumer
        # the durable cursor: per-file positions at the last *delivered*
        # chunk boundary — never ahead of what the consumer has seen, so
        # resuming from it is at-least-once (replay <= one chunk + the
        # polls in flight), never at-most-once
        self._safe = {}
        self._safe_rows = 0
        self._closed = threading.Event()
        self._interrupted = threading.Event()
        self._window = deque(maxlen=64)  # (t, records_total) checkpoints
        reg = registry if registry is not None else REGISTRY
        self.registry = reg
        self._c_records = reg.counter(
            "paddle_tpu_stream_records_total",
            "records delivered by tail-follow streams")
        self._c_bad_chunks = reg.counter(
            "paddle_tpu_stream_bad_chunks_total",
            "CRC-failed / torn chunks skipped by tail-follow streams")
        reg.gauge("paddle_tpu_stream_ingest_rows_per_sec",
                  "sliding-window ingest throughput of the live stream",
                  fn=self.rows_per_sec)

    # -- producer-side signal ----------------------------------------------
    def close(self):
        """No more appends will happen: drain what landed, then stop."""
        self._closed.set()

    def interrupt(self):
        """Stop iterating NOW, without draining — the preemption path.
        The read position stays consistent: ``cursor()`` after an
        interrupt is a valid resume point."""
        self._interrupted.set()

    @property
    def closed(self):
        return self._closed.is_set()

    # -- stats --------------------------------------------------------------
    @property
    def records_read(self):
        return sum(r.records_read for r in self._readers.values())

    @property
    def bad_chunks(self):
        return sum(r.bad_chunks for r in self._readers.values())

    @property
    def rows_total(self):
        """Rows DELIVERED to the consumer over the stream's whole life,
        including rows the resumed cursor already accounted for (parsed-
        but-undelivered rows are excluded — they will come again)."""
        return self._base_rows + self._delivered

    def rows_per_sec(self):
        w = self._window
        if len(w) < 2:
            return 0.0
        dt = w[-1][0] - w[0][0]
        return (w[-1][1] - w[0][1]) / dt if dt > 0 else 0.0

    # -- durable position ----------------------------------------------------
    def cursor(self):
        """The stream's durable resume point: per-file byte offsets (keyed
        by basename, so checkpoint dirs stay relocatable), each file's
        rotation state (``done`` = sealed and fully drained), and the row
        count at that point. The position is the last chunk boundary
        whose records were all DELIVERED — parsed-but-undelivered bytes
        sit past it, so a resume re-reads them (at-least-once) instead of
        skipping them (at-most-once). JSON-serializable; feed it to
        :meth:`seek` on a fresh stream over the same directory."""
        files = {n: dict(e) for n, e in self._safe.items()}
        for name, ent in self._seek.items():  # adopted but not yet opened
            files.setdefault(name, dict(ent))
        return {"rows": self._base_rows + self._safe_rows, "files": files}

    def seek(self, cursor, merge=False):
        """Restore a :meth:`cursor`. Plain ``seek`` (before iteration
        starts) positions every file and adopts the cursor's row count;
        ``merge=True`` folds in positions for *additional* files mid-run
        — the partition-handover path, where a survivor adopts a dead
        host's published offsets instead of re-reading its partitions
        from byte 0. Unknown files in the cursor are kept pending and
        applied if/when they appear in the listing."""
        files = cursor.get("files", {})
        if not merge:
            if self._readers:
                raise RuntimeError(
                    "seek() must run before iteration starts; use "
                    "merge=True to adopt positions mid-run")
            self._seek = {n: dict(e) for n, e in files.items()}
            self._safe = {n: dict(e) for n, e in files.items()}
            self._base_rows = int(cursor.get("rows", 0))
            return self
        for name, ent in files.items():
            self._seek[name] = dict(ent)
            cur = self._safe.get(name)
            if cur is None or int(ent.get("offset", 0)) \
                    > int(cur.get("offset", 0)):
                self._safe[name] = dict(ent)
            for p, r in self._readers.items():
                if os.path.basename(p) == name:
                    if int(ent.get("offset", 0)) > r.offset:
                        r.offset = int(ent.get("offset", 0))
                    r.done = r.done or bool(ent.get("done", False))
        return self

    # -- iteration ----------------------------------------------------------
    def _list_files(self):
        if callable(self._source):
            return sorted(self._source())
        try:
            names = os.listdir(self._source)
        except OSError:
            return []
        return sorted(os.path.join(self._source, n) for n in names
                      if fnmatch.fnmatch(n, self.pattern))

    def _poll_once(self):
        # fault site: a dying ('error'), stalling ('hang') or torn-read
        # ('corrupt') tail-follow poll
        mode = faults.trip("stream.tail")
        listed = self._list_files()
        self._listed = listed
        for p in listed:
            if p not in self._readers:
                r = TailReader(p)
                ent = self._seek.get(os.path.basename(p))
                if ent:  # resume / partition handover: adopt the offset
                    r.offset = int(ent.get("offset", 0))
                    r.done = bool(ent.get("done", False))
                self._readers[p] = r
        out = []  # [(record, provenance)] — provenance on the LAST record
        # of each chunk: (basename, chunk_end_offset, file_drained)
        prev_bad = self.bad_chunks
        # only the CURRENT listing is polled: a partition-filtered source
        # that stops listing a file (lease lost) stops being read here
        for i, p in enumerate(listed):
            r = self._readers[p]
            if r.done:
                continue
            # rotation contract: a file is sealed once a newer one exists
            final = (i < len(listed) - 1) or self._closed.is_set()
            recs, pending = r.poll(final=final)
            if final and not pending:
                r.done = True
            base = os.path.basename(p)
            if not recs:
                # nothing to deliver for this file: its whole parse state
                # (skipped bad tails, the done flag) is already safe
                if r.last_chunks or r.done:
                    self._safe[base] = {"offset": r.offset,
                                        "done": bool(r.done)}
                continue
            idx = 0
            for end_off, nrec in r.last_chunks:
                for j in range(nrec):
                    prov = None
                    if j == nrec - 1:
                        prov = (base, end_off,
                                bool(r.done) and end_off >= r.offset)
                    out.append((recs[idx], prov))
                    idx += 1
            # bad-chunk rescans can reorder bookkeeping; never drop data
            while idx < len(recs):
                out.append((recs[idx], None))
                idx += 1
        new_bad = self.bad_chunks - prev_bad
        if new_bad:
            self._c_bad_chunks.inc(new_bad)
        if out:
            self._c_records.inc(len(out))
            self._window.append((self._clock(), self.records_read))
        if mode == "corrupt" and out:
            out[0] = (faults.corrupt_bytes(out[0][0]), out[0][1])
        return out

    def records(self):
        """Yield record bytes until closed and fully drained (or
        interrupted — then stop immediately, position preserved)."""
        while True:
            if self._interrupted.is_set():
                return
            got = self._poll_once()
            for rec, prov in got:
                # same per-record site AsyncExecutor.run drills on the
                # batch path: 'corrupt' truncates the record so the
                # bounded max_bad_records skip can be exercised
                if faults.trip("recordio.read") == "corrupt":
                    rec = faults.corrupt_bytes(rec)
                yield rec
                # the record is out the door: chunk boundaries it
                # completes become part of the durable cursor
                self._delivered += 1
                if prov is not None:
                    base, end_off, drained = prov
                    self._safe[base] = {"offset": end_off,
                                        "done": drained}
                    self._safe_rows = self._delivered
            if got:
                continue
            if self._closed.is_set():
                if all(self._readers[p].done for p in self._listed
                       if p in self._readers):
                    return
                continue  # close raced a partial tail; next poll seals it
            self._sleep(self.poll_interval_s)

    def __iter__(self):
        return self.records()


class StreamIngester:
    """Record stream -> dense ``DataFeedDesc`` batches for training.

    ``max_bad_records`` mirrors ``AsyncExecutor.run``: records whose size
    does not match the schema are skipped and counted up to this bound
    (0 = fail fast, ``None`` = unbounded, counted + warned). Partial
    final batches are dropped (fixed-shape batch convention)."""

    def __init__(self, stream, data_feed, max_bad_records=0):
        self.stream = stream
        self.data_feed = data_feed
        self.max_bad_records = max_bad_records
        self.bad_records = 0
        self._c_bad = stream.registry.counter(
            "paddle_tpu_stream_bad_records_total",
            "schema-size-mismatched records skipped by ingesters")

    def batches(self):
        bs = self.data_feed.batch_size
        want = self.data_feed.sample_nbytes
        batch = []
        for rec in self.stream.records():
            if len(rec) != want:
                self.bad_records += 1
                self._c_bad.inc()
                if (self.max_bad_records is not None
                        and self.bad_records > self.max_bad_records):
                    raise ValueError(
                        "StreamIngester: %d malformed record(s) (got %d "
                        "bytes, schema says %d) exceeds max_bad_records=%d"
                        % (self.bad_records, len(rec), want,
                           self.max_bad_records))
                continue
            batch.append(rec)
            if len(batch) == bs:
                yield self.data_feed.parse_batch(batch)
                batch = []
        if self.bad_records:
            warnings.warn(
                "StreamIngester: skipped %d malformed record(s) "
                "(max_bad_records=%s)"
                % (self.bad_records, self.max_bad_records),
                RuntimeWarning, stacklevel=2)
