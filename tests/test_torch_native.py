"""The port's native data plane (``paddle_tpu_torch/native.py`` over its
copy of ``native_src/``) against ``paddle_tpu``'s: recordio files the two
native writers and the two pure-Python writers (``streaming.write_records``)
produce are byte-equal, each package's reader reads the other's files, and
the port's C++ prefetch queue delivers every record (counted in
``PrefetchQueue.popped``). The library builds with ``g++`` into
``build/paddle_tpu_torch/``. Records are bytes, so every comparison is
exact."""

import os

import numpy as np
import pytest

from paddle_tpu import native as ref_native
from paddle_tpu.data import reader as ref_reader
from paddle_tpu.streaming import stream as ref_stream
from paddle_tpu_torch import native
from paddle_tpu_torch.data import reader as rd
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.streaming import stream as t_stream


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.native_available(), "g++ could not build the data plane"
    assert ref_native.native_available()


def _records(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(k)) for k in rng.randint(0, 300, n)] + [b""]


def _write(pkg, path, records, chunk=4):
    with pkg.RecordIOWriter(path, max_chunk_records=chunk) as w:
        for r in records:
            w.write(r)


def test_library_lands_in_the_build_dir():
    path = native._lib_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libpaddle_tpu_torch_native-")
    assert os.path.exists(path)


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_native_writers_are_byte_equal(tmp_path, chunk):
    recs = _records(37)
    a, b = str(tmp_path / "port.recordio"), str(tmp_path / "ref.recordio")
    _write(native, a, recs, chunk)
    _write(ref_native, b, recs, chunk)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_pure_python_writer_matches_both_native_writers(tmp_path, chunk):
    recs = _records(37, seed=1)
    py_port, py_ref = str(tmp_path / "pp"), str(tmp_path / "pr")
    for k in range(0, len(recs), chunk):
        t_stream.write_records(py_port, recs[k:k + chunk])
        ref_stream.write_records(py_ref, recs[k:k + chunk])
    nat = str(tmp_path / "nat")
    _write(native, nat, recs, chunk)
    want = open(nat, "rb").read()
    assert open(py_port, "rb").read() == want
    assert open(py_ref, "rb").read() == want
    assert t_stream.encode_chunk(recs[:chunk]) \
        == ref_stream.encode_chunk(recs[:chunk])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_reader_reads_the_other_packages_file(tmp_path, writer):
    recs = _records(25, seed=2) + [b"x" * 10000]
    path = str(tmp_path / "f.recordio")
    _write(native if writer == "port" else ref_native, path, recs)
    for pkg in (native, ref_native):
        with pkg.RecordIOReader(path) as r:
            assert list(r) == recs


def test_large_record_grows_the_buffer(tmp_path):
    path = str(tmp_path / "c.recordio")
    big = np.random.RandomState(3).bytes(3 << 20)  # > the 1 MB buffer
    _write(native, path, [b"small", big])
    with native.RecordIOReader(path) as r:
        assert list(r) == [b"small", big]


def test_corrupt_chunk_is_skipped_as_in_the_reference(tmp_path):
    path = str(tmp_path / "b.recordio")
    recs = [("rec%04d" % i).encode() for i in range(32)]
    _write(native, path, recs, chunk=8)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 3] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with native.RecordIOReader(path) as r:
        got = list(r)
    with ref_native.RecordIOReader(path) as r:
        assert got == list(r)
    assert 16 <= len(got) < 32 and set(got) <= set(recs)


def test_prefetch_queue_delivers_every_record_and_counts_pops(tmp_path):
    paths, want = [], []
    for i in range(3):
        p = str(tmp_path / ("f%d.recordio" % i))
        recs = [("f%d-r%d" % (i, j)).encode() for j in range(20)]
        _write(native, p, recs)
        want += recs
        paths.append(p)
    with native.PrefetchQueue(capacity=16) as q:
        q.start_files(paths, n_threads=3, n_epochs=2)
        got = list(q)
        assert q.popped == len(got) == 2 * len(want)
    assert sorted(got) == sorted(want * 2)


def test_prefetch_queue_manual_push_and_empty_list():
    with native.PrefetchQueue(capacity=4) as q:
        q.push(b"one")
        q.push(b"two")
        q.mark_done()
        assert list(q) == [b"one", b"two"]
    with native.PrefetchQueue(capacity=4) as q:
        q.start_files([], n_threads=2, n_epochs=-1)
        assert list(q) == []


def test_recordio_reader_and_writer_decorators_match_the_reference(
        tmp_path):
    items = [np.array([i, i + 1], dtype="int64") for i in range(10)]
    a, b = str(tmp_path / "a.recordio"), str(tmp_path / "b.recordio")
    assert rd.recordio_writer(a, lambda: iter(items),
                              serializer=lambda x: x.tobytes()) == 10
    ref_reader.recordio_writer(b, lambda: iter(items),
                               serializer=lambda x: x.tobytes())
    assert open(a, "rb").read() == open(b, "rb").read()
    decode = rd.map_readers(lambda r: np.frombuffer(r, dtype="int64"),
                            rd.recordio_reader(a, n_threads=1))
    batches = list(rd.batch(decode, batch_size=5)())
    assert len(batches) == 2
    assert sorted(int(x[0]) for bt in batches for x in bt) == list(range(10))
    with pytest.raises(IOError, match="not found"):
        rd.recordio_reader(str(tmp_path / "missing.recordio"))
