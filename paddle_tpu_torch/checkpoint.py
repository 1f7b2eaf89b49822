"""Versioned, CRC-verified, async training checkpoints (the port of
``paddle_tpu/checkpoint.py``).

Reference capabilities covered: ``fluid.io.save_checkpoint`` /
``load_checkpoint`` (versioned ``checkpoint_<n>`` dirs, ``latest`` marker,
``max_num_checkpoints`` trimming, ref ``python/paddle/fluid/io.py``
checkpoint family), retention pins, staged loads for the serving hot-swap
plane, ``resume_or_init`` and ``AutoCheckpoint``.

The file layout is the reference's, so a checkpoint either package wrote
loads in the other: ``replicated.npz`` plus ``checkpoint_manifest.json``
(per array its shape, dtype and CRC32) in each version dir; the manifest
lands atomically after the arrays, then the ``latest`` marker.

Snapshot: :func:`save_checkpoint` copies every persistable into host
memory the snapshot owns before it returns (CUDA tensors through pinned
staging, one stream synchronise; CPU tensors cloned). The writer thread
reads only that copy: it computes the CRCs and writes the files. A captured step writes the new state *into*
the scope's tensors, so a writer holding views would write a later step.

Randomness: the scope holds one ``torch.Generator`` per device
(``core/executor.py`` ``rng_name``). Each generator's ``get_state()`` is
saved under ``@TORCH_RNG@<name>`` in ``replicated.npz`` and listed in the
manifest's ``torch_rng`` field; the manifest's ``rng`` (the reference's
threefry key) is null, so the reference's loader reads the arrays and
ignores the states. A load restores each state with ``set_state`` into the
scope's generator of that device (a captured step keeps its binding and
draws on from the restored state). A reference checkpoint's key is no
torch state: its arrays load, the scope keeps its generator, with one
warning.

A load replaces scope tensors: each array goes to the device and dtype of
the tensor it replaces (else the executor's place), and the next
``exe.run`` of a captured key interprets once and captures again.

Multi-process: the save side of several processes (the ``run_id``
broadcast, sharded snapshots) waits for ROADMAP A7 and raises; the load
side reassembles the reference's per-process shard pieces with numpy.
"""

import contextlib
import json
import os
import shutil
import threading
import time
import warnings
import zipfile
import zlib

import numpy as np
import torch

from .core import framework
from .core.executor import global_scope, rng_name, to_tensor
from .core.op_registry import RNG_KEY
from .reliability import faults

__all__ = ["save_checkpoint", "load_checkpoint", "load_staged",
           "CheckpointWriter", "resume_or_init", "AutoCheckpoint",
           "pin_version", "unpin_version", "pinned_versions",
           "candidate_versions", "load_extra", "apply_updates",
           "NoCheckpointError", "GeneratorState"]

_MANIFEST = "checkpoint_manifest.json"
_PIN_PREFIX = "PIN."
_TORCH_RNG = "@TORCH_RNG@"


class NoCheckpointError(IOError):
    """The directory holds no complete ``checkpoint_<n>`` at all (cold
    start) — distinct from "checkpoints exist but none loads"."""


class GeneratorState:
    """A staged ``torch.Generator`` state: the device it belongs to and
    its ``get_state()`` bytes."""

    def __init__(self, device, state):
        self.device = torch.device(device)
        self.state = np.ascontiguousarray(state, dtype=np.uint8)


def _crc(arr):
    """CRC32 of an array's raw bytes — recorded per array/piece in the
    manifest at save, verified at load."""
    # over the array's own buffer: no bytes copy (a 0-d array is 1-d here,
    # the same bytes)
    buf = memoryview(np.ascontiguousarray(arr)).cast("B")
    return zlib.crc32(buf) & 0xFFFFFFFF


class CheckpointWriter:
    """Handle for an in-flight async checkpoint write. ``snapshot_s`` is
    the time the caller's thread spent copying the state to the host,
    ``write_s`` the writer thread's time on the disk (None until done)."""

    def __init__(self, thread, path, snapshot_s=0.0):
        self._thread = thread
        self.path = path
        self.error = None
        self.snapshot_s = snapshot_s
        self.write_s = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error
        return self.path

    def wait_until(self, deadline):
        """Bounded join against a ``reliability.policy.Deadline`` — the
        preemption grace path: a write that cannot land inside the grace
        budget is abandoned to the OS (False), never blocked on. Write
        errors are reported, not raised (the caller is already dying)."""
        if self._thread is not None:
            self._thread.join(max(0.0, deadline.remaining()))
            if self._thread.is_alive():
                return False
            self._thread = None
        return self.error is None

    def done(self):
        return self._thread is None or not self._thread.is_alive()


def _process_index():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _snapshot(values):
    """``{name: tensor or array}`` -> ``{name: np.ndarray}`` whose bytes
    the snapshot owns, taken in the order the current streams reach them.
    bf16 widens to float32 (numpy has no bf16; a load rounds back
    exactly)."""
    staged, devices = {}, set()
    for name, value in values.items():
        if not isinstance(value, torch.Tensor):
            staged[name] = np.array(value, copy=True)
            continue
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            devices.add(t.device)
        else:
            buf = t.clone()
        staged[name] = buf
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    # an ndarray made by .numpy() keeps its tensor alive
    return {n: (b.numpy() if isinstance(b, torch.Tensor) else b)
            for n, b in staged.items()}


def _generators(scope):
    return {n: scope.get(n) for n in scope.var_names()
            if n.startswith(RNG_KEY) and isinstance(scope.get(n),
                                                    torch.Generator)}


def save_checkpoint(executor, checkpoint_dir, trainer_id=None,
                    main_program=None, max_num_checkpoints=3,
                    scope=None, async_write=True, extra_meta=None,
                    max_versions=None):
    """Write a versioned checkpoint of every persistable (params + optimizer
    accumulators + counters) and the scope's generator states. Returns a
    :class:`CheckpointWriter`; call ``.wait()`` to block until the files
    are on disk.

    ``max_versions`` is the periodic-publish retention knob: when set it
    overrides ``max_num_checkpoints`` and old versions are garbage
    collected after each save — EXCEPT versions a serving process has
    pinned (:func:`pin_version`)."""
    if max_versions is not None:
        max_num_checkpoints = max_versions
    main_program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    proc, nproc = _process_index()
    if nproc > 1:
        raise NotImplementedError(
            "save_checkpoint across %d processes (the shared run_id and the "
            "sharded snapshots) is not ported yet (ROADMAP A7)" % nproc)

    t0 = time.perf_counter()
    persist = [v.name for v in main_program.list_vars()
               if v.persistable and v.name in scope]
    gens = _generators(scope)
    values = {n: scope.get(n) for n in persist}
    states = {n: g.get_state() for n, g in gens.items()}
    replicated = _snapshot(values)
    rng_keys = {}
    for name, st in states.items():
        rng_keys[name] = _TORCH_RNG + name
        replicated[rng_keys[name]] = st.numpy()
    snapshot_s = time.perf_counter() - t0

    os.makedirs(checkpoint_dir, exist_ok=True)
    existing = [int(d.split("_")[1]) for d in os.listdir(checkpoint_dir)
                if d.startswith("checkpoint_") and d.split("_")[1].isdigit()]
    version = (max(existing) + 1) if existing else 0
    vdir = os.path.join(checkpoint_dir, "checkpoint_%d" % version)
    os.makedirs(vdir, exist_ok=True)


    # writers serialize in submission order: a later checkpoint must not
    # have its 'latest' marker or _trim overtaken by an earlier in-flight
    # writer thread
    global _last_writer
    prev = _last_writer

    def write():
        # the CRCs and the files from the owned snapshot, off the caller's
        # thread
        t1 = time.perf_counter()
        try:
            manifest = {
                "version": version,
                "nproc": nproc,
                "run_id": None,
                "vars": {n: {"kind": "replicated",
                             "shape": list(replicated[n].shape),
                             "dtype": str(replicated[n].dtype),
                             "crc": _crc(replicated[n])} for n in persist},
                # the reference's threefry key: none here (its loader then
                # reads the arrays alone); the generator states beside it
                "rng": None,
                "torch_rng": {n: {"device": str(gens[n].device), "key": k,
                                  "crc": _crc(replicated[k])}
                              for n, k in rng_keys.items()},
                "extra": extra_meta or {},
            }
            if prev is not None and prev._thread is not None:
                prev._thread.join()
            _savez_atomic(os.path.join(vdir, "replicated.npz"), replicated)
            # manifests land atomically: "manifest present" must mean
            # "manifest complete" (the loaders' incomplete-dir check)
            _json_atomic(os.path.join(vdir, _MANIFEST), manifest)
            with open(os.path.join(checkpoint_dir, "latest.tmp"), "w") as f:
                f.write("checkpoint_%d" % version)
            os.replace(os.path.join(checkpoint_dir, "latest.tmp"),
                       os.path.join(checkpoint_dir, "latest"))
            _trim(checkpoint_dir, max_num_checkpoints, grace_seconds=0.0)
        except BaseException as e:  # surfaced via .wait()
            writer.error = e
        writer.write_s = time.perf_counter() - t1

    if async_write:
        t = threading.Thread(target=write, name="ckpt-writer", daemon=True)
        writer = CheckpointWriter(t, vdir, snapshot_s)
        _last_writer = writer
        t.start()
    else:
        if prev is not None and prev._thread is not None:
            prev._thread.join()
        writer = CheckpointWriter(None, vdir, snapshot_s)
        _last_writer = writer
        write()
    return writer


_last_writer = None


def _savez_atomic(path, arrays):
    from .io import _atomic_savez  # shared tmp+rename npz writer

    # fault site: an 'error' plan entry fails the write (surfaced via
    # CheckpointWriter.wait), 'corrupt' damages the landed file so the
    # CRC-verified load + fallback path can be drilled deterministically
    mode = faults.trip("checkpoint.write")
    _atomic_savez(path, arrays)
    if mode == "corrupt":
        _flip_byte(path)


def _flip_byte(path):
    """Deterministically corrupt a landed file (mid-file byte flip)."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def _json_atomic(path, obj):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def _trim(checkpoint_dir, keep, grace_seconds=60.0):
    """Keep the ``keep`` most RECENTLY WRITTEN versions (mtime, not version
    number: step-derived versions are not monotonic across a rollback
    resume). Never remove one touched in the last ``grace_seconds``.
    Pinned versions (a serving process holds a ``PIN.<owner>`` file in the
    dir) do not count against ``keep`` and are never removed."""
    if not keep or keep <= 0:
        return
    dirs = []
    for d in os.listdir(checkpoint_dir):
        if d.startswith("checkpoint_") and d.split("_")[1].isdigit():
            path = os.path.join(checkpoint_dir, d)
            if _is_pinned(path):
                continue
            try:
                dirs.append((os.path.getmtime(path), path))
            except OSError:
                continue
    dirs.sort()  # oldest write first
    now = time.time()
    for mtime, path in dirs[:-keep]:
        if grace_seconds > 0 and now - mtime < grace_seconds:
            continue
        if _is_pinned(path):  # pinned between listdir and rmtree
            continue
        shutil.rmtree(path, ignore_errors=True)


def _is_pinned(vdir):
    try:
        return any(f.startswith(_PIN_PREFIX) for f in os.listdir(vdir))
    except OSError:
        return False


def pin_version(checkpoint_dir, version, owner="serving"):
    """Drop a ``PIN.<owner>`` marker into ``checkpoint_<version>`` so
    retention GC never removes the version a serving process is serving.
    Idempotent; raises FileNotFoundError if the version dir is gone."""
    vdir = os.path.join(checkpoint_dir, "checkpoint_%d" % int(version))
    if not os.path.isdir(vdir):
        raise FileNotFoundError("no such checkpoint version dir: %s" % vdir)
    with _preserved_mtime(vdir):
        with open(os.path.join(vdir, _PIN_PREFIX + str(owner)), "w") as f:
            f.write(str(os.getpid()))


def unpin_version(checkpoint_dir, version, owner="serving"):
    """Remove this owner's pin from ``checkpoint_<version>``. Missing pin
    or missing dir is a no-op (the GC may already have run)."""
    vdir = os.path.join(checkpoint_dir, "checkpoint_%d" % int(version))
    try:
        with _preserved_mtime(vdir):
            os.remove(os.path.join(vdir, _PIN_PREFIX + str(owner)))
    except OSError:
        pass


@contextlib.contextmanager
def _preserved_mtime(vdir):
    """Pin-file churn must not refresh the version dir's mtime — retention
    GC ranks by write recency."""
    st = os.stat(vdir)
    try:
        yield
    finally:
        try:
            os.utime(vdir, (st.st_atime, st.st_mtime))
        except OSError:
            pass


def pinned_versions(checkpoint_dir):
    """Version numbers currently holding at least one pin file."""
    out = set()
    try:
        entries = os.listdir(checkpoint_dir)
    except OSError:
        return out
    for d in entries:
        if d.startswith("checkpoint_") and d.split("_")[1].isdigit():
            if _is_pinned(os.path.join(checkpoint_dir, d)):
                out.add(int(d.split("_")[1]))
    return out


def _candidate_versions(checkpoint_dir):
    """Loadable version numbers, best first: the ``latest`` marker, then
    the rest by WRITE RECENCY. Entries that are not directories and
    version dirs without a primary manifest (save killed before the
    manifest landed) are not checkpoints and are skipped."""
    by_mtime = []
    for d in os.listdir(checkpoint_dir):
        if not (d.startswith("checkpoint_") and d.split("_")[1].isdigit()):
            continue
        path = os.path.join(checkpoint_dir, d)
        if not os.path.isdir(path):
            continue
        if not os.path.exists(os.path.join(path, _MANIFEST)):
            continue  # incomplete: the save died before its manifest
        try:
            mt = os.path.getmtime(path)
        except OSError:
            continue
        by_mtime.append((mt, int(d.split("_")[1])))
    versions = [v for _, v in sorted(by_mtime, reverse=True)]
    try:
        with open(os.path.join(checkpoint_dir, "latest")) as f:
            marked = int(f.read().strip().split("_")[1])
        if marked in versions:
            versions.remove(marked)
            versions.insert(0, marked)
    except (OSError, ValueError, IndexError):
        pass
    return versions


def _verify_crc(vdir, label, arr, want):
    if want is None:
        return  # pre-CRC checkpoint: nothing recorded to verify against
    got = _crc(arr)
    if got != int(want):
        raise IOError(
            "checkpoint %s: CRC mismatch on %s (manifest %d != disk %d) "
            "— bytes corrupted on disk" % (vdir, label, int(want), got))


_warned_reference_rng = []


def _load_version(vdir, main_program):
    """Read one ``checkpoint_<n>`` dir into a staged update list
    ``[(scope_key, np.ndarray or GeneratorState), ...]`` plus the
    manifest's ``extra`` — nothing touches a scope here, so a half-read
    corrupt version can be abandoned for an older one."""
    with open(os.path.join(vdir, _MANIFEST)) as f:
        manifest = json.load(f)

    repl_path = os.path.join(vdir, "replicated.npz")
    repl = np.load(repl_path, allow_pickle=False) if \
        os.path.exists(repl_path) else {}

    # per-process piece indices of a reference checkpoint saved by several
    # processes: the primary manifest (p0) + the secondary manifests other
    # processes wrote next to their shard files; files of processes >= the
    # saving run's nproc, or of another run_id, are an earlier run's
    nproc_saved = int(manifest.get("nproc", 1))
    run_expect = manifest.get("run_id")
    piece_index = {}  # var name -> [(proc, [idx, ...], [crc, ...]|None)]
    for pf in [os.path.join(vdir, _MANIFEST)] + [
            os.path.join(vdir, f) for f in sorted(os.listdir(vdir))
            if f.startswith("manifest_p") and f.endswith(".json")]:
        try:
            with open(pf) as f:
                m = json.load(f)
        except ValueError:
            warnings.warn("checkpoint %s: unreadable secondary manifest "
                          "%s (torn save?); skipping it"
                          % (vdir, os.path.basename(pf)))
            continue
        if m.get("run_id") != run_expect:
            continue
        for name, meta in m["vars"].items():
            crcs = meta.get("crcs", {})
            for pkey, idxs in meta.get("pieces", {}).items():
                if int(pkey[1:]) >= nproc_saved:
                    continue
                piece_index.setdefault(name, []).append(
                    (int(pkey[1:]), idxs, crcs.get(pkey)))

    persist = {v.name for v in main_program.list_vars() if v.persistable}
    updates = []
    shard_cache = {}
    for name, meta in manifest["vars"].items():
        if name not in persist:
            continue
        if meta["kind"] == "replicated":
            if name not in repl:
                raise IOError(
                    "checkpoint %s: replicated var %r missing from "
                    "replicated.npz (torn save?)" % (vdir, name))
            arr = repl[name]
            _verify_crc(vdir, name, arr, meta.get("crc"))
            updates.append((name, arr))
            continue
        full = np.zeros(tuple(meta["shape"]), dtype=meta["dtype"])
        # boolean coverage mask: piece indices may overlap across processes
        covered = np.zeros(tuple(meta["shape"]), dtype=bool)
        for pnum, idxs, crcs in piece_index.get(name, ()):
            if pnum not in shard_cache:
                sf_path = os.path.join(vdir, "shards_p%d.npz" % pnum)
                shard_cache[pnum] = (np.load(sf_path, allow_pickle=False)
                                     if os.path.exists(sf_path) else None)
            sf = shard_cache[pnum]
            if sf is None:
                raise IOError(
                    "checkpoint %s: shard file shards_p%d.npz (pieces of "
                    "%r) is missing — refusing to restore zero-filled "
                    "weights" % (vdir, pnum, name))
            for k, idx in enumerate(idxs):
                key = "%s@%d" % (name, k)
                if key not in sf:
                    raise IOError(
                        "checkpoint %s: piece %s missing from "
                        "shards_p%d.npz" % (vdir, key, pnum))
                piece = sf[key]
                _verify_crc(vdir, "%s (shards_p%d)" % (key, pnum), piece,
                            crcs[k] if crcs else None)
                sl = tuple(slice(a, b) for a, b in idx)
                full[sl] = piece
                covered[sl] = True
        if not covered.all():
            raise IOError(
                "checkpoint %s: pieces of %r cover %d of %d elements — "
                "a process's shard file was never written"
                % (vdir, name, int(covered.sum()), covered.size))
        updates.append((name, full))

    for name, meta in (manifest.get("torch_rng") or {}).items():
        key = meta["key"]
        if key not in repl:
            raise IOError("checkpoint %s: generator state %r missing from "
                          "replicated.npz (torn save?)" % (vdir, key))
        data = repl[key]
        _verify_crc(vdir, key, data, meta.get("crc"))
        updates.append((name, GeneratorState(meta["device"], data)))
    if manifest.get("rng") is not None and not _warned_reference_rng:
        _warned_reference_rng.append(vdir)
        warnings.warn(
            "checkpoint %s holds the reference's threefry key (@RNG@), "
            "which is no torch generator state: its arrays load, and the "
            "scope keeps its own generator" % vdir, RuntimeWarning)
    return updates, manifest.get("extra", {})


def _restore_generator(scope, name, st):
    """``set_state`` into the scope's generator of ``st.device`` (so a
    captured step bound to it keeps its binding), or a new generator there
    when the scope has none for that device."""
    for n, gen in _generators(scope).items():
        if gen.device == st.device:
            gen.set_state(torch.from_numpy(st.state.copy()))
            return
    if st.device.type == "cuda" and not torch.cuda.is_available():
        warnings.warn("generator state of %s (%s) not restored: no CUDA "
                      "device" % (name, st.device), RuntimeWarning)
        return
    gen = torch.Generator(device=st.device)
    gen.set_state(torch.from_numpy(st.state.copy()))
    scope.set(rng_name(scope, gen.device), gen)


def apply_updates(scope, updates, device=None, program=None):
    """Write a staged update list into ``scope``: each array onto the
    device and dtype of the tensor it replaces (else ``device``, in the
    dtype of ``program``'s var of that name), each generator state into
    the scope's generator of its device."""
    gb = program.global_block() if program is not None else None
    dev = torch.device(device) if device is not None else torch.device("cpu")
    for name, value in updates:
        if isinstance(value, GeneratorState):
            _restore_generator(scope, name, value)
            continue
        old = scope.find_var(name)
        if isinstance(old, torch.Tensor):
            # np.array: an owned, C-ordered copy that keeps a 0-d shape
            t = torch.from_numpy(np.array(value))
            scope.set(name, t.to(device=old.device, dtype=old.dtype))
        else:
            var = gb.var(name) if gb is not None and gb.has_var(name) \
                else None
            scope.set(name, to_tensor(np.array(value, copy=True), dev, var))


def load_checkpoint(executor, checkpoint_dir, trainer_id=None,
                    main_program=None, scope=None, version=None):
    """Restore every persistable from the newest (or given) checkpoint.
    Returns the manifest's ``extra`` metadata dict.

    Integrity: every array is CRC-verified against the manifest. With
    ``version=None`` a corrupt or incomplete newest version falls back to
    the next most recently written intact ``checkpoint_<n>`` with a
    warning; an explicit ``version`` raises instead. The scope is only
    written once a whole version has read and verified clean."""
    main_program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    _, updates, extra = load_staged(checkpoint_dir, main_program,
                                    version=version)
    apply_updates(scope, updates, getattr(executor, "device", None),
                  main_program)
    return extra


def candidate_versions(checkpoint_dir):
    """Complete (manifest-bearing) version numbers under ``checkpoint_dir``,
    best first: the ``latest`` marker, then the rest by write recency.
    The model-swap plane polls this to detect fresh publishes."""
    if not os.path.isdir(checkpoint_dir):
        return []
    return _candidate_versions(checkpoint_dir)


def load_extra(checkpoint_dir, version=None):
    """Read just the ``extra`` metadata of one version — no array loads,
    no scope. With ``version=None``, walks ``candidate_versions`` newest
    first past torn manifests. Returns ``(version, extra)``, or
    ``(None, {})`` when nothing intact exists."""
    versions = ([int(version)] if version is not None
                else candidate_versions(checkpoint_dir))
    for v in versions:
        try:
            with open(os.path.join(checkpoint_dir, "checkpoint_%d" % v,
                                   _MANIFEST)) as f:
                manifest = json.load(f)
            return int(v), manifest.get("extra", {})
        except (OSError, ValueError):
            continue
    return None, {}


def load_staged(checkpoint_dir, main_program, version=None):
    """CRC-verified staged read of one version WITHOUT touching any scope:
    returns ``(version, updates, extra)`` where ``updates`` is a
    ``[(name, np.ndarray or GeneratorState), ...]`` list ready for an
    atomic swap (:func:`apply_updates`, or the serving hot-swap plane's
    copy-and-overlay).

    With ``version=None`` the newest intact version wins, falling back past
    corrupt/torn ones; an explicit ``version`` raises on any damage."""
    if version is not None:
        updates, extra = _load_version(
            os.path.join(checkpoint_dir, "checkpoint_%d" % int(version)),
            main_program)
        return int(version), updates, extra
    versions = candidate_versions(checkpoint_dir)
    if not versions:
        raise NoCheckpointError(
            "no complete checkpoint_<n> directory under %s" % checkpoint_dir)
    last_err = None
    for v in versions:
        try:
            updates, extra = _load_version(
                os.path.join(checkpoint_dir, "checkpoint_%d" % v),
                main_program)
            return v, updates, extra
        except (IOError, OSError, KeyError, ValueError, IndexError,
                zipfile.BadZipFile) as e:
            warnings.warn("checkpoint_%d is unusable (%s); falling back "
                          "to the previous intact version" % (v, e))
            last_err = e
    raise last_err


# ---------------------------------------------------------------------------
# preemption recovery: every restart lands in resume_or_init; AutoCheckpoint
# keeps one being written in the background at a step/time cadence
# ---------------------------------------------------------------------------


def resume_or_init(executor, startup_program, checkpoint_dir,
                   main_program=None, scope=None):
    """Run the startup program, then overwrite with the newest checkpoint
    when one exists. Returns the checkpoint's ``extra`` metadata, or None
    on a cold start."""
    executor.run(startup_program, scope=scope)
    if not os.path.isdir(checkpoint_dir):
        return None
    try:
        return load_checkpoint(executor, checkpoint_dir,
                               main_program=main_program, scope=scope)
    except NoCheckpointError:
        return None  # nothing saved yet: a cold start, not a failure


class AutoCheckpoint:
    """Background-cadence checkpointing for a training loop:

        ac = AutoCheckpoint(exe, ckpt_dir, main_program=prog,
                            every_steps=100)
        for step in range(start, n):
            ...train...
            ac.step({"step": step + 1})
        ac.close()

    Writes are async (the previous write is joined by the next save /
    close). ``every_seconds`` uses a wall-clock cadence instead."""

    def __init__(self, executor, checkpoint_dir, main_program=None,
                 scope=None, every_steps=None, every_seconds=None,
                 max_num_checkpoints=3):
        if not every_steps and not every_seconds:
            every_steps = 1000
        if every_seconds and _process_index()[1] > 1:
            raise ValueError(
                "AutoCheckpoint(every_seconds=...) is per-process "
                "wall-clock and unsafe in multi-process training; use "
                "every_steps (deterministic across processes)")
        self.executor = executor
        self.checkpoint_dir = checkpoint_dir
        self.main_program = main_program
        self.scope = scope
        self.every_steps = every_steps
        self.every_seconds = every_seconds
        self.max_num = max_num_checkpoints
        self._count = 0
        self._last_time = time.monotonic()
        self._writer = None

    def step(self, extra_meta=None, force=False):
        """Call once per training step; saves when the cadence is due.
        Returns the CheckpointWriter when a save started, else None."""
        self._count += 1
        due = force
        if self.every_steps and self._count % self.every_steps == 0:
            due = True
        if self.every_seconds and (time.monotonic() - self._last_time
                                   >= self.every_seconds):
            due = True
        if not due:
            return None
        # surface any failure of the previous cadenced write NOW
        if self._writer is not None:
            self._writer.wait()
        self._last_time = time.monotonic()
        self._writer = save_checkpoint(
            self.executor, self.checkpoint_dir,
            main_program=self.main_program, scope=self.scope,
            max_num_checkpoints=self.max_num, async_write=True,
            extra_meta=extra_meta)
        return self._writer

    def close(self):
        if self._writer is not None:
            self._writer.wait()
            self._writer = None
