"""``paddle_tpu_torch.serving`` — in-process dynamic-batching inference
serving (the one-shot path of ``paddle_tpu.serving``):

    from paddle_tpu_torch import serving

    eng = serving.ServingEngine("my/model/dir", max_batch_size=8)
    eng.warmup()                       # run every bucket rung once
    prob, = eng.submit({"x": rows}).result(timeout=1.0)
    print(eng.metrics()["latency_s"])   # p50/p95/p99
    eng.shutdown(drain=True)
"""

from .admission import (AdmissionController, DeadlineExceededError,  # noqa: F401
                        ServerOverloadedError)
from .batcher import DynamicBatcher, Request  # noqa: F401
from .buckets import (BucketError, bucket_for, pad_to_bucket,  # noqa: F401
                      pow2_ladder, unpad_fetch)
from .engine import EngineShutdownError, ServingEngine  # noqa: F401
from .metrics import Histogram, ServingMetrics  # noqa: F401

__all__ = ["ServingEngine", "EngineShutdownError", "DynamicBatcher",
           "Request", "ServingMetrics", "Histogram", "AdmissionController",
           "ServerOverloadedError", "DeadlineExceededError", "BucketError",
           "pow2_ladder", "bucket_for", "pad_to_bucket", "unpad_fetch"]
