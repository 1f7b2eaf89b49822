"""``paddle_tpu_torch.serving`` — the port of ``paddle_tpu.serving``: the
in-process engine (one-shot and decode) and the multi-process front door:

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

Multi-process front door (``router.py`` / ``worker.py`` / ``rpc.py``):

    router = serving.Router("my/model/dir", num_workers=2)
    router.start()                     # workers serve on cuda:0
    client = serving.RouterClient(router.address)
    prob, = client.predict({"x": rows}, timeout_s=1.0)
    client.close(); router.shutdown()
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
from .router import (Router, RouterClient, RouterShutdownError,  # noqa: F401
                     WorkerFailedError)

__all__ = ["ServingEngine", "EngineShutdownError", "DynamicBatcher",
           "Request", "ServingMetrics", "Histogram", "AdmissionController",
           "ServerOverloadedError", "DeadlineExceededError", "BucketError",
           "pow2_ladder", "bucket_for", "pad_to_bucket", "unpad_fetch",
           "DecodeBatcher", "DecodeRequest", "DraftLM", "PrefixCache",
           "PrefixEntry", "PrefixMatch", "save_decode_spec",
           "load_decode_spec", "default_ctx_ladder",
           "default_prefill_ladder", "Router", "RouterClient",
           "WorkerFailedError", "RouterShutdownError"]
