"""ctypes bindings for the native data plane (``native_src/*.cc``), the
port's copy of ``paddle_tpu/native.py``.

The reference implements its data plane in C++ (recordio
``paddle/fluid/recordio/``, reader prefetch ops
``operators/reader/buffered_reader.cc``); this module loads the same
capabilities from ``libpaddle_tpu_torch_native-<hash>.so``, building it on
first use with ``g++`` (plain C ABI + ctypes) into ``build/paddle_tpu_torch/``
beside the package, where ``ops/_build.py`` puts the CUDA kernels. The
sources ship inside the package (``paddle_tpu_torch/native_src`` package
data). Without a toolchain ``native_available()`` is False, with a
one-time warning, and the pure-Python writer of ``streaming.stream``
(``write_records``) and tail reader remain.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native_src")
_SRCS = ("recordio.cc", "prefetch_queue.cc")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _lib_path():
    """Source-hash-keyed .so under the build dir (rebuilds on a source
    change; a stale library never loads)."""
    from .ops._build import BUILD_DIR

    h = hashlib.sha256()
    for s in _SRCS:
        with open(os.path.join(_NATIVE_DIR, s), "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    return os.path.join(
        BUILD_DIR, "libpaddle_tpu_torch_native-%s.so" % h.hexdigest()[:16])


def _build(lib_path):
    srcs = [os.path.join(_NATIVE_DIR, s) for s in _SRCS]
    # compile to a pid-suffixed temp and rename: concurrent processes
    # (shared home dirs, pytest workers) must never CDLL a half-linked .so
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    cmd = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-pthread",
           *srcs, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib_path)


def _load():
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib_path = _lib_path()
            if not os.path.exists(lib_path):
                _build(lib_path)
            lib = ctypes.CDLL(lib_path)
        except (OSError, subprocess.CalledProcessError) as e:
            _build_failed = True
            warnings.warn(
                "paddle_tpu_torch native data plane unavailable (%s: %s); "
                "recordio/prefetch fall back to pure Python — expect "
                "reduced input-pipeline throughput. Install g++ to "
                "enable the C++ plane." % (type(e).__name__, e),
                RuntimeWarning, stacklevel=3)
            return None
        lib.recordio_writer_open.restype = ctypes.c_void_p
        lib.recordio_writer_open.argtypes = [ctypes.c_char_p,
                                             ctypes.c_uint32]
        lib.recordio_writer_write.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p,
                                              ctypes.c_uint32]
        lib.recordio_writer_close.restype = ctypes.c_int
        lib.recordio_writer_close.argtypes = [ctypes.c_void_p]
        lib.recordio_reader_open.restype = ctypes.c_void_p
        lib.recordio_reader_open.argtypes = [ctypes.c_char_p]
        lib.recordio_reader_next.restype = ctypes.c_int64
        lib.recordio_reader_next.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p,
                                             ctypes.c_int64]
        lib.recordio_reader_close.argtypes = [ctypes.c_void_p]
        lib.prefetch_queue_create.restype = ctypes.c_void_p
        lib.prefetch_queue_create.argtypes = [ctypes.c_uint32]
        lib.prefetch_queue_start.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_int,
                                             ctypes.c_int]
        lib.prefetch_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_uint32]
        lib.prefetch_queue_pop.restype = ctypes.c_int64
        lib.prefetch_queue_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int64]
        lib.prefetch_queue_size.restype = ctypes.c_int64
        lib.prefetch_queue_size.argtypes = [ctypes.c_void_p]
        lib.prefetch_queue_mark_done.argtypes = [ctypes.c_void_p]
        lib.prefetch_queue_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available():
    return _load() is not None


class RecordIOWriter:
    """Chunked CRC-checked record file writer (ref ``recordio/writer.h``)."""

    def __init__(self, path, max_chunk_records=1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable; use "
                               "data.reader fallbacks")
        self._lib = lib
        self._h = lib.recordio_writer_open(path.encode(), max_chunk_records)
        if not self._h:
            raise IOError("cannot open %s for writing" % path)

    def write(self, data: bytes):
        self._lib.recordio_writer_write(self._h, data, len(data))

    def close(self):
        if self._h:
            ok = self._lib.recordio_writer_close(self._h)
            self._h = None
            if not ok:
                raise IOError("recordio write failed (disk full?); file "
                              "is incomplete")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOReader:
    """Sequential reader; corrupt chunks are skipped (ref scanner.h)."""

    def __init__(self, path, buf_size=1 << 20):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.recordio_reader_open(path.encode())
        if not self._h:
            raise IOError("cannot open %s" % path)
        self._buf = ctypes.create_string_buffer(buf_size)

    def __iter__(self):
        return self

    def __next__(self):
        n = self._lib.recordio_reader_next(self._h, self._buf,
                                           len(self._buf))
        if n == -1:
            raise StopIteration
        if n < -1:
            self._buf = ctypes.create_string_buffer(2 * (-int(n) - 2))
            return self.__next__()
        # string_at copies the record's n bytes; ``.raw`` would copy
        # the whole buffer (1 MB) for every record first
        return ctypes.string_at(self._buf, n)

    def close(self):
        if self._h:
            self._lib.recordio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class PrefetchQueue:
    """Bounded MPMC record queue with native reader threads — the
    double-buffer/open_files prefetch capability
    (ref ``operators/reader/buffered_reader.cc``)."""

    def __init__(self, capacity=512, buf_size=1 << 20):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.prefetch_queue_create(capacity)
        self._buf = ctypes.create_string_buffer(buf_size)
        self.popped = 0  # records handed out by the C++ queue

    def start_files(self, files, n_threads=2, n_epochs=1):
        self._lib.prefetch_queue_start(
            self._h, "\n".join(files).encode(), n_threads, n_epochs)

    def push(self, data: bytes):
        return bool(self._lib.prefetch_queue_push(self._h, data, len(data)))

    def mark_done(self):
        self._lib.prefetch_queue_mark_done(self._h)

    def pop(self):
        """Blocking pop; None when the stream is exhausted."""
        n = self._lib.prefetch_queue_pop(self._h, self._buf, len(self._buf))
        if n == -1:
            return None
        if n < -1:
            self._buf = ctypes.create_string_buffer(2 * (-int(n) - 2))
            return self.pop()
        self.popped += 1
        # string_at copies the record's n bytes; ``.raw`` would copy
        # the whole buffer (1 MB) for every record first
        return ctypes.string_at(self._buf, n)

    def qsize(self):
        return int(self._lib.prefetch_queue_size(self._h))

    def __iter__(self):
        while True:
            rec = self.pop()
            if rec is None:
                return
            yield rec

    def close(self):
        if self._h:
            self._lib.prefetch_queue_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
