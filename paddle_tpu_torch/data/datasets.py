"""Dataset readers, the port's copy of ``paddle_tpu/data/datasets.py`` (ref
``python/paddle/dataset/``: mnist, cifar, flowers,
imdb, imikolov, movielens, uci_housing, wmt14/16, conll05, sentiment...).

Zero-egress environment: every dataset has a deterministic synthetic
generator with the same sample schema as the reference loader, so model/
convergence tests and benchmarks run hermetically. Real-data hooks read the
same formats from a local directory if present.
"""

import os

import numpy as np

__all__ = ["mnist", "cifar10", "flowers", "uci_housing", "imdb", "imikolov",
           "movielens", "wmt16", "synthetic_ctr"]

_SEED = 90


def _rng(tag):
    return np.random.RandomState(_SEED + hash(tag) % 1000)


# 7-segment layout per digit (segments: top, top-left, top-right, middle,
# bottom-left, bottom-right, bottom) — the procedural fallback renders
# genuinely shape-dependent classes, so convergence tests prove learning
_SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1), 1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1), 3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0), 5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1), 7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1), 9: (1, 1, 1, 1, 0, 1, 1),
}


def _render_digit(digit, r):
    """28x28 float32 in [-1,1]: 7-segment glyph with random shift, stroke
    jitter, and noise."""
    img = np.zeros((28, 28), dtype="float32")
    h, w = 16, 10  # glyph box
    oy = 6 + r.randint(-3, 4)
    ox = 9 + r.randint(-3, 4)
    t = r.randint(2, 4)  # stroke thickness
    segs = _SEGMENTS[digit]
    boxes = [
        (0, 0, t, w),                      # top
        (0, 0, h // 2, t),                 # top-left
        (0, w - t, h // 2, w),             # top-right (rows, cols ranges)
        (h // 2 - t // 2, 0, h // 2 + (t + 1) // 2, w),  # middle
        (h // 2, 0, h, t),                 # bottom-left
        (h // 2, w - t, h, w),             # bottom-right
        (h - t, 0, h, w),                  # bottom
    ]
    for on, (r0, c0, r1, c1) in zip(segs, boxes):
        if on:
            img[oy + r0:oy + r1, ox + c0:ox + c1] = 1.0
    img += r.normal(0, 0.15, (28, 28)).astype("float32")
    return np.clip(img * 2.0 - 1.0, -1, 1).astype("float32")


def _mnist_idx(images_path, labels_path):
    """Parse the real MNIST idx format (ref ``dataset/mnist.py:48``
    reader_creator's struct unpacking)."""
    import gzip
    import struct

    op = gzip.open if images_path.endswith(".gz") else open
    with op(images_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, "bad idx image magic"
        images = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        images = images.reshape(n, rows * cols)
    with op(labels_path, "rb") as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        assert magic == 2049, "bad idx label magic"
        labels = np.frombuffer(f.read(n2), dtype=np.uint8)
    return images.astype("float32") / 127.5 - 1.0, labels.astype("int64")


class mnist:
    """28x28 grayscale digits; schema: (image[784] float32 in [-1,1],
    label int64), matching ref ``dataset/mnist.py``.

    Real data: tries ``DATA_HOME/mnist/*-idx?-ubyte(.gz)`` (pre-seeded or
    via ``data.common.download`` when the environment has egress).
    Fallback: procedurally rendered 7-segment digits — shape-dependent
    classes, so the >97%-accuracy convergence test proves actual learning.
    """

    # (url, md5) per file — md5-verified so a captive-portal HTML response
    # can never poison the cache (ref dataset/mnist.py's MD5 constants)
    URLS = {
        "train-images-idx3-ubyte.gz":
            ("https://yann.lecun.com/exdb/mnist/train-images-idx3-ubyte.gz",
             "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
        "train-labels-idx1-ubyte.gz":
            ("https://yann.lecun.com/exdb/mnist/train-labels-idx1-ubyte.gz",
             "d53e105ee54ea40749a09fcbcd1e9432"),
        "t10k-images-idx3-ubyte.gz":
            ("https://yann.lecun.com/exdb/mnist/t10k-images-idx3-ubyte.gz",
             "9fb629c4189551a2d022fa330f9573f3"),
        "t10k-labels-idx1-ubyte.gz":
            ("https://yann.lecun.com/exdb/mnist/t10k-labels-idx1-ubyte.gz",
             "ec29112dd5afa0611ce80d1b7f02629c"),
    }

    @staticmethod
    def _real(split):
        from .common import DATA_HOME, download

        prefix = "train" if split == "train" else "t10k"
        paths = []
        for kind in ("images-idx3-ubyte", "labels-idx1-ubyte"):
            found = None
            for suffix in (".gz", ""):
                p = os.path.join(DATA_HOME, "mnist",
                                 "%s-%s%s" % (prefix, kind, suffix))
                if os.path.exists(p):
                    found = p
                    break
            if found is None:
                # network fetch is opt-in: a filtered-egress environment
                # would otherwise stall retries x timeout per file before
                # every synthetic fallback
                if not os.environ.get("PADDLE_TPU_DATASET_DOWNLOAD"):
                    raise FileNotFoundError(
                        "no mnist files under %s (set "
                        "PADDLE_TPU_DATASET_DOWNLOAD=1 to fetch)"
                        % os.path.join(DATA_HOME, "mnist"))
                name = "%s-%s.gz" % (prefix, kind)
                url, md5 = mnist.URLS[name]
                found = download(url, "mnist", md5sum=md5)
            paths.append(found)
        # parse errors of PRESENT files propagate: silently serving
        # synthetic data against deliberately pre-seeded real files would
        # mask corruption
        return _mnist_idx(*paths)

    @staticmethod
    def _make(n, tag, split):
        try:
            images, labels = mnist._real(split)

            def real_reader():
                for i in range(min(n, len(images)) if n else len(images)):
                    yield images[i], labels[i]

            return real_reader
        except (FileNotFoundError, RuntimeError):
            pass  # no data / download failed -> hermetic procedural digits
        r = _rng(tag)

        def reader():
            for i in range(n):
                y = i % 10
                yield _render_digit(y, r).reshape(784), np.int64(y)

        return reader

    @staticmethod
    def train(n=2048):
        return mnist._make(n, "mnist-train", "train")

    @staticmethod
    def test(n=512):
        return mnist._make(n, "mnist-test", "test")


def _cached_archive(module, fname, url, md5):
    """Resolve a dataset archive: pre-seeded ``DATA_HOME/<module>/`` cache
    first (taken as-is — pre-seeding with subset/mirror archives is the
    documented offline path); a real download only when
    PADDLE_TPU_DATASET_DOWNLOAD=1, md5-validated against the pinned hash
    (ref ``dataset/common.py:download``)."""
    from .common import DATA_HOME, download

    p = os.path.join(DATA_HOME, module, fname)
    if os.path.exists(p):
        return p
    if not os.environ.get("PADDLE_TPU_DATASET_DOWNLOAD"):
        raise FileNotFoundError(
            "no cached %s under %s (pre-seed the cache or set "
            "PADDLE_TPU_DATASET_DOWNLOAD=1 to fetch)"
            % (fname, os.path.join(DATA_HOME, module)))
    return download(url, module, md5, save_name=fname)


class cifar10:
    """3x32x32 images; schema parity with ``dataset/cifar.py`` (real
    cifar-10-python.tar.gz from the cache when primed, procedural
    prototypes otherwise)."""

    URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
    MD5 = "c58f30108f718f92721af3b95e74349a"
    _cache = {}

    @staticmethod
    def _real(sub_name):
        import pickle
        import tarfile

        path = _cached_archive("cifar", "cifar-10-python.tar.gz",
                               cifar10.URL, cifar10.MD5)
        key = (path, sub_name)
        if key in cifar10._cache:  # the tar.gz costs a full decompress
            return cifar10._cache[key]
        xs, ys = [], []
        with tarfile.open(path, mode="r") as f:
            for item in f:
                if sub_name not in item.name:
                    continue
                batch = pickle.load(f.extractfile(item), encoding="bytes")
                xs.append(batch[b"data"])
                ys.extend(int(l) for l in batch[b"labels"])
        if not xs:
            raise RuntimeError("no %s batches in %s" % (sub_name, path))
        data = np.concatenate(xs, axis=0)
        out = (data, np.asarray(ys, dtype="int64"))
        cifar10._cache[key] = out
        return out

    @staticmethod
    def _make(n, tag, sub_name):
        try:
            data, labels = cifar10._real(sub_name)

            def real_reader():
                m = min(n, len(data)) if n else len(data)
                for i in range(m):
                    # ref cifar.py read_batch: (sample/255).astype(f32)
                    yield (data[i] / 255.0).astype("float32"), labels[i]

            return real_reader
        except (FileNotFoundError, RuntimeError):
            pass
        r = _rng(tag)
        protos = r.normal(0, 1, (10, 3 * 32 * 32)).astype("float32")

        def reader():
            for i in range(n):
                y = i % 10
                x = protos[y] * 0.4 + r.normal(0, 0.4, 3 * 32 * 32)
                yield x.astype("float32"), np.int64(y)

        return reader

    @staticmethod
    def train10(n=1024):
        return cifar10._make(n, "cifar-train", "data_batch")

    @staticmethod
    def test10(n=256):
        return cifar10._make(n, "cifar-test", "test_batch")


class flowers:
    """3x224x224, 102 classes (ref ``dataset/flowers.py``)."""

    @staticmethod
    def train(n=128, use_xmap=False):
        r = _rng("flowers")

        def reader():
            for i in range(n):
                y = i % 102
                x = r.normal(0, 1, 3 * 224 * 224).astype("float32")
                yield x, np.int64(y)

        return reader


class uci_housing:
    """13 features -> price (ref ``dataset/uci_housing.py``)."""

    @staticmethod
    def _make(n, tag):
        r = _rng(tag)
        w = r.normal(0, 1, 13).astype("float32")

        def reader():
            for _ in range(n):
                x = r.normal(0, 1, 13).astype("float32")
                y = np.float32(x @ w + r.normal(0, 0.1))
                yield x, np.array([y], dtype="float32")

        return reader

    @staticmethod
    def train(n=512):
        return uci_housing._make(n, "uci-train")

    @staticmethod
    def test(n=128):
        return uci_housing._make(n, "uci-test")


class imdb:
    """Sentiment: (word-id sequence, label) (ref ``dataset/imdb.py`` —
    aclImdb_v1.tar.gz from the cache when primed: tokenize + build_dict
    with the reference's cutoff/ordering, labels pos=0 / neg=1)."""

    URL = ("http://ai.stanford.edu/%7Eamaas/data/sentiment/"
           "aclImdb_v1.tar.gz")
    MD5 = "7c2ac02c03563afcf9b574c7e56c153a"
    word_dict_size = 5149
    _cache = {}

    @staticmethod
    def _tokenize(tarf, pattern):
        import re
        import tarfile  # noqa: F401

        pat = re.compile(pattern)
        for tf in tarf:
            if tf.isfile() and pat.match(tf.name):
                doc = tarf.extractfile(tf).read().rstrip(b"\n\r").lower()
                yield doc.translate(None, b"!\"#$%&'()*+,-./:;<=>?@[\\]^_"
                                    b"`{|}~").split()

    @staticmethod
    def _real_dict(cutoff=150):
        """ref imdb.py build_dict over train/{pos,neg}: frequency-sorted
        ids + trailing <unk>."""
        if "dict" in imdb._cache:
            return imdb._cache["dict"]
        import collections
        import tarfile

        path = _cached_archive("imdb", "aclImdb_v1.tar.gz", imdb.URL,
                               imdb.MD5)
        freq = collections.defaultdict(int)
        with tarfile.open(path) as tarf:
            for doc in imdb._tokenize(tarf,
                                      r"aclImdb/train/(pos|neg)/.*\.txt$"):
                for w in doc:
                    freq[w] += 1
        pairs = sorted(((w, c) for w, c in freq.items() if c > cutoff),
                       key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(pairs)}
        word_idx[b"<unk>"] = len(word_idx)
        imdb._cache["dict"] = word_idx
        return word_idx

    @staticmethod
    def word_dict():
        try:
            return imdb._real_dict()
        except (FileNotFoundError, RuntimeError):
            return {i: i for i in range(imdb.word_dict_size)}

    @staticmethod
    def _real(split, word_idx, n):
        import tarfile

        path = _cached_archive("imdb", "aclImdb_v1.tar.gz", imdb.URL,
                               imdb.MD5)
        key = (path, split, id(word_idx), n)
        if key in imdb._cache:
            return imdb._cache[key]
        unk = word_idx[b"<unk>"]
        out = []
        # per-tag cap: a global cap would let pos fill the whole quota
        # and return a near-single-class dataset
        per_tag = ((n + 1) // 2) if n else 0
        with tarfile.open(path) as tarf:
            for label, tag in ((0, "pos"), (1, "neg")):
                pat = r"aclImdb/%s/%s/.*\.txt$" % (split, tag)
                taken = 0
                for doc in imdb._tokenize(tarf, pat):
                    out.append((np.asarray(
                        [word_idx.get(w, unk) for w in doc],
                        dtype="int64"), np.int64(label)))
                    taken += 1
                    if per_tag and taken >= per_tag:
                        break
        imdb._cache[key] = out
        return out

    @staticmethod
    def _make(n, tag, split, word_dict=None, maxlen=100):
        try:
            wd = word_dict or imdb._real_dict()
            samples = imdb._real(split, wd, n)

            def real_reader():
                for s in samples:
                    yield s

            return real_reader
        except (FileNotFoundError, RuntimeError, KeyError):
            pass
        r = _rng(tag)

        def reader():
            for i in range(n):
                y = i % 2
                length = r.randint(10, maxlen)
                base = 100 if y else 2000
                seq = (base + r.randint(0, 500, length)) % imdb.word_dict_size
                yield seq.astype("int64"), np.int64(y)

        return reader

    @staticmethod
    def train(word_dict=None, n=512):
        return imdb._make(n, "imdb-train", "train", word_dict)

    @staticmethod
    def test(word_dict=None, n=128):
        return imdb._make(n, "imdb-test", "test", word_dict)


class imikolov:
    """N-gram LM tuples (ref ``dataset/imikolov.py``)."""

    dict_size = 2073

    @staticmethod
    def build_dict():
        return {i: i for i in range(imikolov.dict_size)}

    @staticmethod
    def train(word_dict=None, n_gram=5, n=2048):
        r = _rng("imikolov")

        def reader():
            for _ in range(n):
                # markov-ish chain so the model has signal to learn
                start = r.randint(0, imikolov.dict_size - n_gram - 3)
                yield tuple(np.int64((start + k * 3) % imikolov.dict_size)
                            for k in range(n_gram))

        return reader


class movielens:
    """User/movie features + rating (ref ``dataset/movielens.py``)."""

    @staticmethod
    def max_user_id():
        return 6040

    @staticmethod
    def max_movie_id():
        return 3952

    @staticmethod
    def max_job_id():
        return 20

    @staticmethod
    def age_table():
        return [1, 18, 25, 35, 45, 50, 56]

    @staticmethod
    def train(n=1024):
        r = _rng("ml-train")

        def reader():
            for _ in range(n):
                uid = np.int64(r.randint(1, 6041))
                gender = np.int64(r.randint(0, 2))
                age = np.int64(r.randint(0, 7))
                job = np.int64(r.randint(0, 21))
                mid = np.int64(r.randint(1, 3953))
                title = r.randint(0, 5175, 10).astype("int64")
                categories = r.randint(0, 19, 4).astype("int64")
                score = np.float32((uid * 7 + mid * 3) % 5 + 1)
                yield uid, gender, age, job, mid, categories, title, score

        return reader


class wmt16:
    """Tokenized translation pairs (ref ``dataset/wmt16.py``); synthetic
    copy-task pairs so seq2seq models can overfit measurably."""

    @staticmethod
    def train(src_dict_size=10000, trg_dict_size=10000, n=1024, maxlen=20):
        r = _rng("wmt16")

        def reader():
            for _ in range(n):
                length = r.randint(5, maxlen)
                src = r.randint(4, src_dict_size, length).astype("int64")
                # target = reversed source (learnable mapping)
                trg = src[::-1].copy()
                yield src, np.concatenate([[1], trg]).astype("int64"), \
                    np.concatenate([trg, [2]]).astype("int64")

        return reader


def synthetic_ctr(n=4096, num_slots=26, vocab=int(1e5), dense_dim=13):
    """Criteo-like CTR rows for DeepFM (ref benchmark dist_ctr)."""
    r = _rng("ctr")
    w_dense = r.normal(0, 0.5, dense_dim)

    def reader():
        for _ in range(n):
            dense = r.normal(0, 1, dense_dim).astype("float32")
            sparse = r.randint(0, vocab, num_slots).astype("int64")
            logit = dense @ w_dense + 0.01 * np.sum(sparse % 97 - 48)
            y = np.int64(1 / (1 + np.exp(-logit)) > 0.5)
            yield dense, sparse, y

    return reader
