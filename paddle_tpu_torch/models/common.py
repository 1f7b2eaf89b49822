"""Shared model-zoo plumbing: ModelSpec + synthetic batch sampling (the
port's copy of ``paddle_tpu/models/common.py``)."""

import numpy as np

__all__ = ["ModelSpec", "FeedSpec"]


class FeedSpec:
    """Shape/dtype/range of one feed tensor (batch dim excluded)."""

    def __init__(self, shape, dtype="float32", low=None, high=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.low = low
        self.high = high

    def sample(self, batch_size, rng):
        shape = (batch_size,) + self.shape
        if np.issubdtype(np.dtype(self.dtype), np.integer):
            low = 0 if self.low is None else self.low
            high = 2 if self.high is None else self.high
            return rng.randint(low, high, size=shape).astype(self.dtype)
        low = -1.0 if self.low is None else self.low
        high = 1.0 if self.high is None else self.high
        return rng.uniform(low, high, size=shape).astype(self.dtype)


class ModelSpec:
    """What a model builder returns.

    Attributes:
      loss: scalar loss Variable (train target).
      feeds: ordered dict name -> FeedSpec (synthetic-data recipe).
      fetches: extra fetch Variables by name (e.g. accuracy).
      flops_per_example: analytic fwd+bwd FLOPs per example (for MFU calc);
        None if not computed.
      tokens_per_example: for sequence models, tokens per example.
      sequence_feeds: feed names whose dim 1 is the sequence axis (for
        sequence-parallel sharding, which comes with the multi-device
        slice); None when not annotated.
    """

    def __init__(self, loss, feeds, fetches=None, flops_per_example=None,
                 tokens_per_example=None, extras=None,
                 sequence_feeds=None):
        self.loss = loss
        self.feeds = feeds
        self.fetches = dict(fetches or {})
        self.flops_per_example = flops_per_example
        self.tokens_per_example = tokens_per_example
        self.sequence_feeds = (list(sequence_feeds)
                               if sequence_feeds is not None else None)
        # named internal vars (e.g. pipeline cut points, block outputs)
        self.extras = dict(extras or {})

    def sample_batch(self, batch_size, rng=None):
        rng = rng or np.random.RandomState(0)
        return {name: fs.sample(batch_size, rng)
                for name, fs in self.feeds.items()}
