"""ServingEngine: in-process dynamic-batching serving over the predictor
stack (the one-shot path of ``paddle_tpu/serving/engine.py:71``).

Reference shape: ``AnalysisPredictor::Init`` loads once, ``Clone()`` hands
each serving thread a predictor sharing the weights, and the server in
front batches requests. Here:

  * load once — one ``Predictor`` (an isolated ``Scope`` holding the
    weights on the engine's device);
  * replicate — ``clone()`` per worker thread, weights shared;
  * batch — a ``DynamicBatcher`` cuts size-or-deadline micro-batches and
    ``buckets.pad_to_bucket`` pads them onto the pow2 ladder; ``warmup()``
    runs every rung before traffic lands (it also builds the CUDA kernels).

``submit(feed) -> Future`` is the client API; a full queue rejects at the
door with ``ServerOverloadedError``; ``shutdown(drain=True)`` stops intake,
serves what is queued and joins the workers.

Decode mode (``decode=``, ``paddle_tpu/serving/engine.py:180-231``):
continuous batching replaces the one-shot pipeline. Each replica is a
``DecodeBatcher`` over a clone of the step predictor (with an optional
chunk program, speculative draft and one prefix cache for the fleet);
``submit(prompt)`` goes to the least-loaded replica and resolves to the
generated ids. On the card each replica's step and chunk dispatches are
captured as CUDA graphs over its own caches (``metrics_report`` says
whether they are).

The device is CUDA unless the caller passes ``device="cpu"`` (or a
CPU-configured ``AnalysisConfig``/predictor); without CUDA the default
raises. Not ported yet: one-shot sequence bucketing, router/worker
processes, the reliability hooks (retry, circuit breaker, supervisor, EDF
shedding), the decode build's static verification (``analysis``),
hot-swap, and mp/per-device placement.
"""

import threading
from concurrent.futures import Future

import numpy as np

from ..core.executor import place_for
from ..inference import AnalysisConfig, Predictor
from .admission import (AdmissionController, DeadlineExceededError,
                        ServerOverloadedError)
from .batcher import DynamicBatcher, Request
from .buckets import bucket_for, pad_to_bucket, pow2_ladder, unpad_fetch
from .metrics import ServingMetrics

__all__ = ["ServingEngine", "EngineShutdownError"]


class EngineShutdownError(RuntimeError):
    """The engine shut down before this admitted request was served."""


class ServingEngine:
    def __init__(self, model, num_replicas=1, max_batch_size=8,
                 ladder=None, max_wait_ms=5.0, max_queue_depth=256,
                 clock=None, device=None, seq_ladder=None, decode=None,
                 default_max_new_tokens=64, eos_id=None, prefix_cache=None,
                 decode_prefill=None, decode_speculative=None):
        """``model``: a model directory, an ``AnalysisConfig``, or a
        predictor exposing ``run``/``clone``/``feed_names``. ``device``
        (``"cuda"``, ``"cuda:1"``, ``"cpu"``, a place or a
        ``torch.device``) places a model loaded here; None means
        ``CUDAPlace(0)``.

        Decode mode: ``decode=`` a decode-spec dict (a step builder's,
        e.g. ``transformer_lm_step``), or True with a model directory
        holding ``decode_spec.json``. ``seq_ladder`` is then the ctx
        ladder (default ``default_ctx_ladder(spec)``); ``decode_prefill``
        (``{"predictor", "spec"[, "ladder"]}``), ``decode_speculative``
        (``{"draft", "k"}``), ``prefix_cache`` (True, a kwargs dict or a
        ``PrefixCache``), ``default_max_new_tokens`` and ``eos_id`` go to
        every ``DecodeBatcher``."""
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        model_dir = model if isinstance(model, str) else getattr(
            model, "model_dir", None)
        if isinstance(model, (str, AnalysisConfig)):
            config = (AnalysisConfig(model_dir=model)
                      if isinstance(model, str) else model)
            if device is not None or isinstance(model, str):
                config.place = place_for(device)
            model = Predictor(config)
        if not callable(getattr(model, "clone", None)):
            raise TypeError("model must be a dir/AnalysisConfig or a "
                            "predictor with clone(); got %r" % (model,))
        self.ladder = tuple(sorted(set(
            ladder if ladder is not None else pow2_ladder(max_batch_size))))
        self.max_batch_size = max(self.ladder)
        self.feed_names = list(getattr(model, "feed_names", []))
        self.seq_ladder = (tuple(sorted(set(seq_ladder)))
                           if seq_ladder else None)
        self._closed = False
        self._lock = threading.Lock()
        self.metrics_ = ServingMetrics()

        decode_spec = self._resolve_decode_spec(decode, model_dir)
        self._decoders = None
        if decode_spec is not None:
            self._start_decoders(
                model, num_replicas, decode_spec, max_queue_depth, clock,
                default_max_new_tokens, eos_id, prefix_cache,
                decode_prefill, decode_speculative)
            return
        if self.seq_ladder is not None:
            raise NotImplementedError(
                "ServingEngine(seq_ladder=...) outside decode mode: "
                "sequence bucketing of one-shot requests is not ported yet")

        self._batcher = DynamicBatcher(self.max_batch_size,
                                       max_wait_ms=max_wait_ms, clock=clock)
        self._admission = AdmissionController(max_queue_depth)
        self.metrics_.bind_gauges(self._batcher.depth,
                                  lambda: self._admission.in_flight)
        self._replicas = [model] + [model.clone()
                                    for _ in range(num_replicas - 1)]
        self._threads = []
        for i, pred in enumerate(self._replicas):
            t = threading.Thread(target=self._worker_loop, args=(pred,),
                                 name="paddle-tpu-torch-serve-%d" % i,
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _start_decoders(self, model, num_replicas, spec, max_queue_depth,
                        clock, default_max_new_tokens, eos_id, prefix_cache,
                        decode_prefill, decode_speculative):
        """One ``DecodeBatcher`` (with its loop thread) per replica, over
        clones of the step predictor and of the chunk predictor, sharing
        the engine's metrics and one prefix cache: any replica's harvest
        serves any replica's admission."""
        from .decode_batcher import DecodeBatcher, make_prefix_cache

        shared_prefix = make_prefix_cache(prefix_cache, self.metrics_)
        if shared_prefix is not None:
            self.metrics_.bind_prefix_bytes(lambda: shared_prefix.nbytes)
        self._decoders = []
        for i in range(num_replicas):
            prefill = None
            if decode_prefill is not None:
                prefill = dict(decode_prefill)
                if i > 0:
                    prefill["predictor"] = decode_prefill["predictor"].clone()
            self._decoders.append(DecodeBatcher(
                model if i == 0 else model.clone(), spec,
                ladder=self.ladder, ctx_ladder=self.seq_ladder,
                max_queue_depth=max_queue_depth,
                default_max_new_tokens=default_max_new_tokens,
                eos_id=eos_id, clock=clock, metrics=self.metrics_,
                prefix_cache=shared_prefix, prefill=prefill,
                speculative=decode_speculative))
        decoders = self._decoders
        # aggregate gauges over every replica (each batcher was handed the
        # shared metrics and bound none of its own)
        self.metrics_.bind_gauges(
            lambda: sum(len(d._pending) for d in decoders),
            lambda: sum(d._admission.in_flight for d in decoders))

    @staticmethod
    def _resolve_decode_spec(decode, model_dir):
        if decode is None or decode is False:
            return None
        if isinstance(decode, dict):
            return decode
        if decode is True:
            if model_dir is None:
                raise ValueError("decode=True needs a model DIRECTORY "
                                 "holding decode_spec.json; pass the spec "
                                 "dict for in-process predictors")
            from .decode_batcher import load_decode_spec

            return load_decode_spec(model_dir)
        raise TypeError("decode must be None, True, or a decode-spec "
                        "dict; got %r" % (decode,))

    # -- client surface -----------------------------------------------------
    def submit(self, feed, timeout_s=None, max_new_tokens=None,
               eos_id=None):
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        One-shot mode: ``feed`` is a dict/list of arrays with a leading
        batch dim, and the future resolves to the fetch list sliced to
        this request's rows; ``timeout_s`` (None: no deadline) fails it if
        it is still queued that long. Decode mode: ``feed`` is the prompt
        (1-D ids, or ``{"prompt_ids": ids}``) and the future resolves to
        the generated ids. Raises :class:`ServerOverloadedError` when the
        bounded queue is full, ``BucketError`` when the batch (or prompt +
        ``max_new_tokens``) exceeds the top rung, and ``RuntimeError``
        after shutdown."""
        if self._closed:
            raise RuntimeError("ServingEngine is shut down")
        if self._decoders is not None:
            if isinstance(feed, dict):
                if set(feed) != {"prompt_ids"}:
                    raise ValueError(
                        "decode-mode submit takes a prompt (1-D ids) or "
                        "{'prompt_ids': ids}; got keys %s" % sorted(feed))
                feed = feed["prompt_ids"]
            # least-loaded replica: queued + occupied slots
            dec = min(self._decoders, key=lambda d: d._admission.in_flight)
            return dec.submit(feed, max_new_tokens=max_new_tokens,
                              eos_id=eos_id, timeout_s=timeout_s)
        if max_new_tokens is not None or eos_id is not None:
            raise ValueError("max_new_tokens/eos_id are decode-mode "
                             "arguments")
        if isinstance(feed, (list, tuple)):
            if len(feed) != len(self.feed_names):
                raise ValueError("expected %d inputs (%s), got %d"
                                 % (len(self.feed_names), self.feed_names,
                                    len(feed)))
            feed = dict(zip(self.feed_names, feed))
        feed = {k: np.asarray(v) for k, v in feed.items()}
        missing = set(self.feed_names) - set(feed)
        if missing:
            raise ValueError("missing feeds: %s" % sorted(missing))
        sizes = {k: a.shape[0] for k, a in feed.items() if a.ndim}
        if not sizes:
            raise ValueError("feeds need a leading batch dim to serve")
        if len(set(sizes.values())) > 1:
            raise ValueError("feeds disagree on batch size: %s" % sizes)
        n = next(iter(sizes.values()))
        bucket_for(n, self.ladder)  # validates n fits the ladder
        now = self._batcher.now()
        deadline = now + timeout_s if timeout_s is not None else None
        try:
            self._admission.acquire(n)
        except ServerOverloadedError:
            self.metrics_.observe_rejected()
            raise
        req = Request(feed, n, Future(), now, deadline=deadline)
        try:
            self._batcher.put(req)
        except RuntimeError:
            self._admission.release(n)
            raise RuntimeError("ServingEngine is shut down")
        return req.future

    def predict(self, feed, timeout_s=None, **decode_kw):
        """Synchronous convenience: submit + wait."""
        return self.submit(feed, timeout_s=timeout_s,
                           **decode_kw).result(timeout_s)

    def warmup(self, example_feed=None):
        """Run every batch rung twice on every replica, so the first
        real request at any bucket finds its shapes warm, the kernels
        built and, on the card, the step captured (the executor interprets
        a key's first run and captures its second). ``example_feed`` is
        one example (leading dim 1); by default one is made from the
        program's var metadata. Returns the number of (replica, bucket)
        pairs warmed. Decode mode: every step and chunk geometry of every
        replica (``DecodeBatcher.warmup``)."""
        if self._decoders is not None:
            return sum(d.warmup() for d in self._decoders)
        feed = example_feed
        if feed is None:
            feed = self._synthesize_example()
        feed = {k: np.asarray(v) for k, v in feed.items()}
        warmed = 0
        for pred in self._replicas:
            for rung in self.ladder:
                padded, _ = pad_to_bucket(feed, (rung,))
                for _ in range(2):
                    pred.run(padded)
                warmed += 1
        return warmed

    def metrics(self):
        return self.metrics_.snapshot()

    def metrics_report(self):
        """The metrics table; in decode mode also, for each replica,
        whether its step and chunk programs are captured (``-`` before a
        dispatch)."""
        report = self.metrics_.report()
        if self._decoders is None:
            return report
        lines = [report]
        for i, d in enumerate(self._decoders):
            for name, r in d.step_report().items():
                lines.append("%-32s %14s" % (
                    "decode%d_%s_captured" % (i, name),
                    "-" if r is None else "yes" if r["captured"] else "no"))
        return "\n".join(lines)

    def compiled_shape_counts(self):
        """Decode mode: the distinct dispatch geometries of each replica,
        each at most its ``compile_cache_bound()``."""
        if self._decoders is None:
            raise NotImplementedError(
                "compiled_shape_counts() of a one-shot engine: the port "
                "keeps no per-replica shape record outside decode mode")
        return [c for d in self._decoders
                for c in d.compiled_shape_counts()]

    @property
    def draft_failures(self):
        """Decode mode: draft passes that raised, over every replica (each
        degraded its rows to one token of progress); 0 outside it."""
        return sum(d.draft_failures for d in self._decoders or ())

    def shutdown(self, drain=True, timeout_s=None):
        """Stop intake; with ``drain`` serve everything queued, otherwise
        cancel it. Joins the worker threads; requests still queued after
        the join fail with :class:`EngineShutdownError`. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._decoders is not None:
            for d in self._decoders:
                d.shutdown(drain=drain, timeout_s=timeout_s)
            return
        if not drain:
            for r in self._batcher.drain():
                if r.future.cancel():
                    self.metrics_.observe_expired()
                else:
                    self.metrics_.observe_failed()
                self._admission.release(r.n)
        self._batcher.close()
        for t in self._threads:
            t.join(timeout_s)
        for r in self._batcher.drain():
            self._fail(r, EngineShutdownError(
                "ServingEngine shut down before this request was served"))
            self.metrics_.observe_failed()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- worker side --------------------------------------------------------
    def _synthesize_example(self):
        """A 1-example feed from the program's var metadata."""
        prog = getattr(self._replicas[0], "_program", None)
        if prog is None or not self.feed_names:
            raise ValueError("warmup() needs example_feed for this "
                             "predictor type")
        feed = {}
        for name in self.feed_names:
            var = prog.global_block().var(name)
            shape = [1 if (d is None or d < 0) else int(d)
                     for d in (var.shape or (1,))]
            shape[0] = 1
            dtype = np.dtype(var.dtype or "float32")
            if dtype.kind in "iu":
                feed[name] = np.zeros(shape, dtype=dtype)
            else:
                feed[name] = np.full(shape, 0.5, dtype=dtype)
        return feed

    def _worker_loop(self, predictor):
        while True:
            batch = self._batcher.get_batch()
            if batch is None:
                return
            self._serve_batch(predictor, batch)

    def _serve_batch(self, predictor, batch):
        now = self._batcher.now()
        live = []
        for r in batch:
            if r.future.cancelled():
                self._admission.release(r.n)
                continue
            if r.deadline is not None and now > r.deadline:
                self._fail(r, DeadlineExceededError(
                    "request waited %.1f ms, deadline was %.1f ms"
                    % ((now - r.enqueue_t) * 1e3,
                       (r.deadline - r.enqueue_t) * 1e3)))
                self.metrics_.observe_expired()
                continue
            live.append(r)
        if not live:
            return
        try:
            merged = {}
            for k in live[0].feed:
                vals = [r.feed[k] for r in live]
                if vals[0].ndim == 0:
                    # scalar feeds have no batch dim: riders must agree
                    if any(not np.array_equal(v, vals[0]) for v in vals[1:]):
                        raise ValueError(
                            "scalar feed %r differs across batched "
                            "requests; scalars must be equal to coalesce"
                            % k)
                    merged[k] = vals[0]
                    continue
                merged[k] = np.concatenate(vals, axis=0)
            padded, n = pad_to_bucket(merged, self.ladder)
            rung = bucket_for(n, self.ladder)
            outs = unpad_fetch(predictor.run(padded), n, padded_to=rung)
        except Exception as e:  # noqa: BLE001 — the batch's futures carry it
            for r in live:
                self._fail(r, e)
            self.metrics_.observe_failed(len(live))
            return
        self.metrics_.observe_batch(actual=n, bucket=rung)
        done_t = self._batcher.now()
        off = 0
        for r in live:
            rows = [o[off:off + r.n]
                    if (getattr(o, "ndim", 0) >= 1 and o.shape[0] == n)
                    else o for o in outs]
            off += r.n
            try:
                r.future.set_result(rows)
            except Exception:  # noqa: BLE001 — a racing cancel
                pass
            self.metrics_.observe_completed(done_t - r.enqueue_t)
            self._admission.release(r.n)

    def _fail(self, req, exc):
        try:
            req.future.set_exception(exc)
        except Exception:  # noqa: BLE001 — a racing cancel
            pass
        self._admission.release(req.n)

