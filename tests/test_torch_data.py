"""The port's data plane (``paddle_tpu_torch/data``) against
``paddle_tpu``'s: ``DataFeedDesc`` records byte-equal and parsed batches
equal, ``DataFeeder`` feeds equal (padding and ``<name>_len`` included),
every synthetic dataset the same samples for its seed (no cached archive:
``DATA_HOME`` points at an empty directory, so nothing is downloaded), the
reader decorators the same items, and ``py_reader`` on the CPU (batches as
numpy; the default place is the card and raises without one). Every
comparison is exact: the same numpy draws and bytes."""

import os
import random
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.data import common as ref_common
from paddle_tpu.data import datasets as ref_datasets
from paddle_tpu.data import reader as ref_reader
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.data import common as t_common
from paddle_tpu_torch.data import datasets as t_datasets
from paddle_tpu_torch.data import reader as t_reader


@pytest.fixture(autouse=True)
def fresh_programs(monkeypatch, tmp_path):
    empty = str(tmp_path / "data_home")
    monkeypatch.setattr(ref_common, "DATA_HOME", empty)
    monkeypatch.setattr(t_common, "DATA_HOME", empty)
    monkeypatch.delenv("PADDLE_TPU_DATASET_DOWNLOAD", raising=False)
    prev = (t_framework.switch_main_program(t_framework.Program()),
            t_framework.switch_startup_program(t_framework.Program()))
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    ref_prev = (fluid.core.framework.switch_main_program(fluid.Program()),
                fluid.core.framework.switch_startup_program(fluid.Program()))
    ref_gen = fluid.unique_name.switch()
    yield
    fluid.unique_name.switch(ref_gen)
    fluid.core.framework.switch_main_program(ref_prev[0])
    fluid.core.framework.switch_startup_program(ref_prev[1])
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev[0])
    t_framework.switch_startup_program(prev[1])


SCHEMAS = [
    [("feat_ids", (26,), "int64"), ("dense_value", (13,), "float32"),
     ("label", (1,), "int64")],
    [("img", (3, 4, 5), "float32"), ("mask", (7,), "uint8"),
     ("w", (), "float64")],
]


def _sample(slots, rng):
    out = {}
    for name, shape, dtype in slots:
        out[name] = (rng.normal(0, 1, shape) * 100).astype(dtype)
    return out


@pytest.mark.parametrize("schema", range(len(SCHEMAS)))
def test_data_feed_records_are_byte_equal(schema):
    slots = SCHEMAS[schema]
    port = tfluid.DataFeedDesc(slots, batch_size=5)
    ref = fluid.DataFeedDesc(slots, batch_size=5)
    assert port.sample_nbytes == ref.sample_nbytes
    rng = np.random.RandomState(schema)
    samples = [_sample(slots, rng) for _ in range(5)]
    recs = [port.serialize(s) for s in samples]
    assert recs == [ref.serialize(s) for s in samples]
    got, want = port.parse_batch(recs), ref.parse_batch(recs)
    for name, _shape, _dtype in slots:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(ValueError, match="record size mismatch"):
        port.parse_batch(recs[:-1] + [recs[-1][:-1]])


def test_data_feeder_pads_ragged_slots_as_the_reference():
    rows = [([1, 2, 3], [0.5, 1.5], 1), ([4], [2.5, 3.5], 0),
            ([5, 6], [4.5, 5.5], 1)]
    feeds = []
    for pkg in (tfluid, fluid):
        words = pkg.layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
        x = pkg.layers.data("x", shape=[2])
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        feeds.append(pkg.DataFeeder([words, x, y]).feed(
            rows, pad_to={"words": 4}))
    got, want = feeds
    assert sorted(got) == sorted(want) == ["words", "words_len", "x", "y"]
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])


def _take(reader, n=None):
    out = []
    for item in reader():
        out.append(item)
        if n is not None and len(out) >= n:
            break
    return out


DATASETS = {
    "mnist_train": lambda ds: ds.mnist.train(n=12),
    "mnist_test": lambda ds: ds.mnist.test(n=6),
    "cifar10_train": lambda ds: ds.cifar10.train10(n=6),
    "flowers": lambda ds: ds.flowers.train(n=2),
    "uci_housing": lambda ds: ds.uci_housing.train(n=20),
    "imdb": lambda ds: ds.imdb.train(n=10),
    "imikolov": lambda ds: ds.imikolov.train(n=20),
    "movielens": lambda ds: ds.movielens.train(n=10),
    "wmt16": lambda ds: ds.wmt16.train(n=10),
    "synthetic_ctr": lambda ds: ds.synthetic_ctr(n=20),
}


def _flat(sample):
    return [np.asarray(s) for s in (sample if isinstance(sample, tuple)
                                    else (sample,))]


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_give_the_reference_samples(name):
    got = _take(DATASETS[name](t_datasets))
    want = _take(DATASETS[name](ref_datasets))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gs, ws = _flat(g), _flat(w)
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_dataset_metadata_matches():
    assert t_datasets.imdb.word_dict() == ref_datasets.imdb.word_dict()
    assert t_datasets.imikolov.build_dict() \
        == ref_datasets.imikolov.build_dict()
    assert t_datasets.movielens.age_table() \
        == ref_datasets.movielens.age_table()


def test_mnist_reads_a_seeded_idx_cache(tmp_path, monkeypatch):
    imgs = np.arange(2 * 784, dtype=np.uint8).reshape(2, 784) % 255
    d = tmp_path / "seeded" / "mnist"
    d.mkdir(parents=True)
    with open(d / "train-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 2, 28, 28))
        f.write(imgs.tobytes())
    with open(d / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, 2))
        f.write(np.array([3, 7], dtype=np.uint8).tobytes())
    monkeypatch.setattr(t_common, "DATA_HOME", str(tmp_path / "seeded"))
    monkeypatch.setattr(ref_common, "DATA_HOME", str(tmp_path / "seeded"))
    got = _take(t_datasets.mnist.train(n=2))
    want = _take(ref_datasets.mnist.train(n=2))
    assert [int(y) for _, y in got] == [3, 7]
    for (a, ya), (b, yb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert ya == yb


def test_download_serves_a_local_file_once_and_checks_md5(tmp_path,
                                                          monkeypatch):
    src = tmp_path / "blob.bin"
    src.write_bytes(b"port-payload")
    md5 = t_common.md5file(str(src))
    assert md5 == ref_common.md5file(str(src))
    monkeypatch.setattr(t_common, "DATA_HOME", str(tmp_path / "home"))
    url = "file://" + str(src)
    p1 = t_common.download(url, "unit", md5)
    assert open(p1, "rb").read() == b"port-payload"
    os.remove(src)  # the cache serves without the source
    assert t_common.download(url, "unit", md5) == p1
    open(p1, "wb").write(b"corrupt")
    with pytest.raises(RuntimeError):
        t_common.download(url, "unit", md5)


def _items():
    return [(i, np.arange(3) * i) for i in range(23)]


DECORATORS = {
    "batch": lambda r, m: m.batch(r, 5),
    "batch_drop_last": lambda r, m: m.batch(r, 5, drop_last=True),
    "shuffle": lambda r, m: m.shuffle(r, 7),
    "firstn": lambda r, m: m.firstn(r, 9),
    "chain": lambda r, m: m.chain(r, r),
    "map": lambda r, m: m.map_readers(lambda a: a[0] * 2, r),
    "compose": lambda r, m: m.compose(r, r),
    "buffered": lambda r, m: m.buffered(r, 4),
    "cache": lambda r, m: m.cache(r),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_reader_decorators_match_the_reference(name):
    def reader():
        return iter(_items())

    outs = []
    for mod in (t_reader, ref_reader):
        random.seed(5)
        outs.append(_take(DECORATORS[name](reader, mod)))
    got, want = outs
    assert len(got) == len(want) > 0
    assert repr(got) == repr(want)


def test_xmap_readers_keep_order():
    r = t_reader.xmap_readers(lambda x: x * x, lambda: iter(range(50)),
                              process_num=3, buffer_size=8, order=True)
    assert list(r()) == [i * i for i in range(50)]


def test_py_reader_on_the_cpu_hands_out_numpy_batches():
    rd = tfluid.data.py_reader(capacity=4, shapes=[[-1, 3], [-1, 1]],
                               dtypes=["float32", "int64"], name="pr",
                               place=tfluid.CPUPlace())
    names = [v.name for v in rd.feed_vars]
    assert names == ["pr_slot_0", "pr_slot_1"]
    rng = np.random.RandomState(0)
    batches = [[(rng.normal(0, 1, 3).astype("f4"), [i]) for i in range(4)]
               for _ in range(3)]
    rd.decorate_paddle_reader(lambda: iter(batches))
    got = list(rd)
    assert len(got) == 3 and rd.staged == 0
    for feed, rows in zip(got, batches):
        assert isinstance(feed[names[0]], np.ndarray)
        np.testing.assert_array_equal(feed[names[0]],
                                      np.stack([r[0] for r in rows]))
        np.testing.assert_array_equal(feed[names[1]],
                                      np.array([[r[1][0]] for r in rows]))
    # a batch generator of ready feeds passes through
    rd2 = tfluid.data.PyReader(rd.feed_vars, place=tfluid.CPUPlace())
    rd2.decorate_batch_generator(lambda: iter([{"a": np.ones(2)}]))
    assert [sorted(f) for f in rd2] == [["a"]]


def test_py_reader_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = tfluid.layers.data("x", shape=[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.data.PyReader([x])
    assert tfluid.data.PyReader([x], device_put=False)._device is None
