"""``paddle_tpu_torch.serving`` — in-process serving (``paddle_tpu.serving``'s
one-shot path and its decode tier):

    from paddle_tpu_torch import serving

    eng = serving.ServingEngine("my/model/dir", max_batch_size=8)
    eng.warmup()                       # run every bucket rung once
    prob, = eng.submit({"x": rows}).result(timeout=1.0)
    print(eng.metrics()["latency_s"])   # p50/p95/p99
    eng.shutdown(drain=True)

    # continuous-batching decode from a saved step program + its spec
    serving.save_decode_spec(step_dir, decode_spec)
    eng = serving.ServingEngine(step_dir, decode=True, prefix_cache=True)
    ids = eng.predict([3, 7, 11], max_new_tokens=16)
"""

from .admission import (AdmissionController, DeadlineExceededError,  # noqa: F401
                        ServerOverloadedError)
from .batcher import DynamicBatcher, Request  # noqa: F401
from .buckets import (BucketError, bucket_for, pad_to_bucket,  # noqa: F401
                      pow2_ladder, unpad_fetch)
from .engine import EngineShutdownError, ServingEngine  # noqa: F401
from .metrics import Histogram, ServingMetrics  # noqa: F401
from .prefix_cache import PrefixCache, PrefixEntry, PrefixMatch  # noqa: F401
from .decode_batcher import (DecodeBatcher, DecodeRequest,  # noqa: F401
                             DraftLM, default_ctx_ladder,
                             default_prefill_ladder,
                             load_decode_spec, save_decode_spec)

__all__ = ["ServingEngine", "EngineShutdownError", "DynamicBatcher",
           "Request", "ServingMetrics", "Histogram", "AdmissionController",
           "ServerOverloadedError", "DeadlineExceededError", "BucketError",
           "pow2_ladder", "bucket_for", "pad_to_bucket", "unpad_fetch",
           "DecodeBatcher", "DecodeRequest", "DraftLM", "PrefixCache",
           "PrefixEntry", "PrefixMatch", "save_decode_spec",
           "load_decode_spec", "default_ctx_ladder",
           "default_prefill_ladder"]
