"""Dataset download / cache plumbing, the port's copy of
``paddle_tpu/data/common.py`` (ref ``python/paddle/dataset/common.py``:
``DATA_HOME``, ``download:35``, ``md5file``).

``download(url, module, md5)`` fetches into ``DATA_HOME/<module>/`` with
md5 verification, resuming nothing but retrying, and returns the local
path. Works with ``file://`` URLs (used by the hermetic tests) and honors
an existing valid cache without touching the network — so zero-egress
environments can pre-seed ``DATA_HOME`` and the loaders find real data.
"""

import hashlib
import os
import shutil
import urllib.error
import urllib.request

__all__ = ["DATA_HOME", "download", "md5file"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None, save_name=None, retries=3):
    """Fetch ``url`` into ``DATA_HOME/module_name/`` (md5-validated cache).
    Returns the local path; raises RuntimeError after ``retries`` failures
    or on a final checksum mismatch."""
    dirname = os.path.join(DATA_HOME, module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(
        dirname, save_name or os.path.basename(url.rstrip("/")))

    if os.path.exists(filename) and (
            md5sum is None or md5file(filename) == md5sum):
        return filename

    last_err = None
    for _ in range(retries):
        try:
            tmp = filename + ".part"
            with urllib.request.urlopen(url, timeout=30) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            if md5sum is not None and md5file(tmp) != md5sum:
                last_err = RuntimeError("md5 mismatch for %s" % url)
                os.remove(tmp)
                continue
            os.replace(tmp, filename)
            return filename
        except (urllib.error.URLError, OSError) as e:
            last_err = e
    raise RuntimeError("download of %s failed after %d tries: %s"
                       % (url, retries, last_err))
