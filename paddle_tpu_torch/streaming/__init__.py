"""``paddle_tpu_torch.streaming`` — continuous learning on the card (the
port of ``paddle_tpu/streaming``): tail-follow ingest -> long-running
trainer -> versioned publish -> live serving hot-swap.

The reference's identity is file-fed async training at ad scale
(``paddle/fluid/framework/async_executor.cc``, pslib/Downpour): log
collectors append click records to a growing file set, trainers tail it
forever, and fresh models ship to the serving fleet without a restart.

  * :mod:`~paddle_tpu_torch.streaming.stream` — :class:`RecordStream`, a
    tail-follow reader over a growing/rotating recordio file set (partial
    trailing chunks resume cleanly; corruption is CRC-detected and
    skipped), plus :class:`StreamIngester` batching into ``DataFeedDesc``
    feeds.
  * :mod:`~paddle_tpu_torch.streaming.trainer` — :class:`StreamingTrainer`,
    a DeepFM trainer (on ``cuda:0`` unless given ``CPUPlace()``) consuming
    the stream and periodically publishing CRC-verified versioned
    checkpoints (owned host snapshot, then an async write, atomic
    ``latest`` marker last) without blocking the training loop.
  * :mod:`~paddle_tpu_torch.streaming.publisher` — :class:`ModelPublisher`,
    the model-swap plane: detects new versions, stages a CRC-verified
    load, and hot-swaps a live ``ServingEngine`` (or a whole router fleet
    via the ``reload`` RPC verb) between micro-batches — in-flight
    requests finish on the old weights, zero drops; corrupt versions fall
    back to the previous intact one behind a circuit breaker. Its fleet
    form, :class:`FleetPublisher`, drives N targets through a two-phase
    swap.
  * :mod:`~paddle_tpu_torch.streaming.coordinator` —
    :class:`PartitionCoordinator`, multi-host ingest through TTL lease
    files, with resume cursors riding each published checkpoint.

Quickstart::

    from paddle_tpu_torch import serving, streaming

    stream = streaming.RecordStream(data_dir)           # tail-follows
    trainer = streaming.StreamingTrainer(ckpt_dir, publish_every_steps=50)
    eng = serving.ServingEngine(trainer.serve_dir, num_replicas=2)
    pub = streaming.ModelPublisher(ckpt_dir, eng)
    pub.start()                                         # watcher thread
    trainer.run(stream, max_steps=500)                  # train + publish
    print(streaming.REGISTRY.prometheus_text())         # ingest/swap gauges
"""

from .stream import (REGISTRY, RecordStream, StreamIngester,  # noqa: F401
                     TailReader, encode_chunk, write_records)
from .trainer import StreamingTrainer, synthesize_stream_files  # noqa: F401
from .publisher import (FleetPublisher, ModelPublisher,  # noqa: F401
                        RouterTarget)
from .coordinator import PartitionCoordinator, partition_of  # noqa: F401

__all__ = ["RecordStream", "StreamIngester", "TailReader", "REGISTRY",
           "encode_chunk", "write_records", "StreamingTrainer",
           "synthesize_stream_files", "ModelPublisher", "FleetPublisher",
           "RouterTarget", "PartitionCoordinator", "partition_of"]
