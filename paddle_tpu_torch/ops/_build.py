"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is one kernel family with a plain C
interface. On first use it is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
under ``build/paddle_tpu_torch/`` beside the package, and loaded with
``ctypes``. The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library never loads.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.

Calling convention of every C entry: pointers and the stream are
``ctypes.c_void_p``; the entry launches on the given stream, synchronises
nothing, and returns ``cudaGetLastError()`` (0 on success). The wrappers
call it through :func:`launch`, which passes the stream and turns an error
into an exception.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "paddle_tpu_torch")
# -Xptxas -v: registers, shared memory and spills per kernel go to the
# build log beside each library (<library>.log)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
# seconds each library took to build in this process (0.0 = already built)
build_seconds = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on first use and need the CUDA toolkit")


def sources():
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _lib_path(name):
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC_DIR)):
        # a header edit rebuilds everything that may include it
        if fname == name + ".cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def _start(name):
    """Start nvcc for ``name`` unless its library exists. Returns
    (final path, tmp path, Popen or None)."""
    path = _lib_path(name)
    if os.path.exists(path):
        return path, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [nvcc_path()] + NVCC_FLAGS + [
        "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc


def _finish(name, path, tmp, proc, t0):
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s.cu:\n%s" % (name, out))
        with open(path + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    build_seconds[name] = time.perf_counter() - t0 if proc else 0.0
    _libs[name] = ctypes.CDLL(path)
    return _libs[name]


def build_all():
    """Build every kernel library in parallel; returns {name: seconds}."""
    with _lock:
        t0 = time.perf_counter()
        started = [(n,) + _start(n) for n in sources() if n not in _libs]
        try:
            for name, path, tmp, proc in started:
                _finish(name, path, tmp, proc, t0)
        finally:  # one failed: stop the other compilers too
            for _, _, _, proc in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return dict(build_seconds)


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            t0 = time.perf_counter()
            _finish(name, *_start(name), t0)
        return _libs[name]


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """SMs of CUDA device ``index``, read once: the plans size grids by it
    on every launch."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(fn, name, device, *args):
    """Call the C entry ``fn`` of library ``name`` with ``args`` and the
    raw handle of ``device``'s current stream, with that device current,
    and raise on a CUDA error. The raw handle and the guard taken only when
    another device is current keep the host's cost per launch low: serving
    issues a few dozen kernel launches per dispatch from Python."""
    import torch

    idx = device.index
    if torch.cuda.current_device() == idx:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        check(load(name), err, name)


def check(lib, err, what):
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        fn = lib.ptt_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError("%s: CUDA error %d (%s)"
                           % (what, err, fn(err).decode()))
