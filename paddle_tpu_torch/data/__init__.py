"""Data pipeline: feeder, reader decorators, datasets, chunked record IO
(the port of ``paddle_tpu/data``).

Reference: ``python/paddle/fluid/data_feeder.py``, ``reader/decorator.py``,
``python/paddle/dataset/``, ``recordio/`` + reader ops
(``operators/reader/``). The double-buffer device prefetch is
``py_reader``: a background thread stages the next batch on the card
(pinned copy, side stream, an event the step waits on) while the current
step runs."""

from . import feeder  # noqa: F401
from . import reader  # noqa: F401
from . import datasets  # noqa: F401
from .data_feed import DataFeedDesc  # noqa: F401
from .feeder import DataFeeder  # noqa: F401
from .reader import (  # noqa: F401
    shuffle, batch, buffered, map_readers, chain, compose, firstn, cache,
    xmap_readers, multiprocess_reader, recordio_reader, recordio_writer)
from .py_reader import py_reader, PyReader  # noqa: F401
