"""ServingEngine: in-process dynamic-batching serving over the predictor
stack (the port of ``paddle_tpu/serving/engine.py``).

Reference shape: ``AnalysisPredictor::Init`` loads once, ``Clone()`` hands
each serving thread a predictor sharing the weights, and the server in
front batches requests. Here:

  * load once — one ``Predictor`` (an isolated ``Scope`` holding the
    weights on the engine's device);
  * replicate — ``clone()`` per worker thread, weights shared, each
    replica with its own executor (its own captured graphs on the card);
    ``placement="per_device"`` pins one weight copy per device instead
    (``clone(device=...)``);
  * batch — a ``DynamicBatcher`` cuts size-or-deadline micro-batches and
    ``buckets.pad_to_bucket`` pads them onto the ladder (and, with a
    ``seq_ladder``, the sequence dim onto its own); ``warmup()`` runs
    every rung twice before traffic lands, which builds the CUDA kernels
    and captures each rung's step.

``submit(feed) -> Future`` is the client API; ``shutdown(drain=True)``
stops intake, serves what is queued and joins the workers.

Self-healing (``paddle_tpu_torch.reliability``): a failed batch gets ONE
cross-replica retry before its futures fail (inference is idempotent:
``donate_state=False`` means no state mutation); each replica carries a
:class:`~paddle_tpu_torch.reliability.CircuitBreaker` that, after K
consecutive batch failures, evicts the predictor (``close()``: its graphs
and their pool go back to the allocator) and rebuilds it from the parent
via ``clone()``; a supervisor thread respawns worker threads that die
outright; and under overload new arrivals with earlier deadlines displace
the least-urgent queued request (EDF shedding). Every event is counted in
``ServingMetrics`` (shed / retried / evicted / respawned) and recorded in
the flight ring — zero in a healthy run.

Decode mode (``decode=``): continuous batching replaces the one-shot
pipeline. Each replica is a ``DecodeBatcher`` over a clone of the step
predictor (with an optional chunk program, speculative draft and one
prefix cache for the fleet); ``submit(prompt)`` goes to the least-loaded
replica and resolves to the generated ids. On the card each replica's
step and chunk dispatches are captured as CUDA graphs over its own caches
(``metrics_report`` says whether they are).

The device is CUDA unless the caller passes ``device="cpu"`` (or a
CPU-configured ``AnalysisConfig``/predictor); without CUDA the default
raises. Hot-swap (``reload``, and the two-phase ``prepare`` / ``commit``
/ ``abort_swap``) takes a checkpoint directory, staged through
``checkpoint.load_staged`` (CRC-verified, falling back past a corrupt
newest version), or an update list. Not ported yet: ``mp>1`` (A7) and the
decode build's static verification (A10).
"""

import threading
import warnings
from concurrent.futures import Future

import numpy as np
import torch

from ..core.executor import Scope, place_for
from ..inference import AnalysisConfig, Predictor
from ..obs import flight, trace
from ..reliability import faults
from ..reliability.policy import CircuitBreaker
from .admission import (AdmissionController, DeadlineExceededError,
                        ServerOverloadedError)
from .batcher import DynamicBatcher, Request
from .buckets import (BucketError, bucket_for, edge_pad, pad_to_bucket,
                      pow2_ladder, unpad_fetch)
from .metrics import ServingMetrics

__all__ = ["ServingEngine", "EngineShutdownError"]


class EngineShutdownError(RuntimeError):
    """The engine shut down before this admitted request could be served
    (a worker was stuck or dead at shutdown); safe to retry elsewhere."""


class _Worker:
    """One replica: a predictor clone, the parent it was cloned from (and
    is rebuilt from, on the parent's device), the feed signatures it has
    dispatched (the engine-side view of its step cache), and its circuit
    breaker (touched only by this replica's worker thread)."""

    def __init__(self, predictor, index, breaker, parent):
        self.predictor = predictor
        self.parent = parent
        self.index = index
        self.breaker = breaker
        self.seen_signatures = set()
        self.thread = None


class ServingEngine:
    def __init__(self, model, num_replicas=1, max_batch_size=8,
                 ladder=None, seq_ladder=None, max_wait_ms=5.0,
                 max_queue_depth=256, default_timeout_s=None, clock=None,
                 latency_window=8192, max_replica_failures=3,
                 cross_replica_retry=True, shed_on_overload=True,
                 supervisor_interval_s=0.05, placement="single", mp=1,
                 devices=None, device=None, decode=None,
                 default_max_new_tokens=64, eos_id=None, prefix_cache=None,
                 decode_prefill=None, decode_speculative=None):
        """``model``: a model directory, an ``AnalysisConfig``, or a
        predictor exposing ``run``/``clone``/``feed_names``. ``device``
        (``"cuda"``, ``"cuda:1"``, ``"cpu"``, a place or a
        ``torch.device``) places a model loaded here; None means
        ``CUDAPlace(0)``.

        Placement: ``placement="per_device"`` pins replicas round-robin
        over ``devices`` (default: every visible CUDA device) through
        ``clone(device=...)``, one weight copy per device in use. ``mp>1``
        (tensor-parallel serving) raises ``NotImplementedError`` (A7).

        Decode mode: ``decode=`` a decode-spec dict (a step builder's,
        e.g. ``transformer_lm_step``), or True with a model directory
        holding ``decode_spec.json``. ``seq_ladder`` is then the ctx
        ladder (default ``default_ctx_ladder(spec)``); ``decode_prefill``
        (``{"predictor", "spec"[, "ladder"]}``), ``decode_speculative``
        (``{"draft", "k"}``), ``prefix_cache`` (True, a kwargs dict or a
        ``PrefixCache``), ``default_max_new_tokens`` and ``eos_id`` go to
        every ``DecodeBatcher``. Outside decode mode ``seq_ladder`` buckets
        the sequence dim (dim 1) of every feed of rank >= 2.

        Reliability knobs: ``max_replica_failures`` consecutive batch
        failures evict a replica and rebuild it from the parent
        (``None``/0 disables); ``cross_replica_retry`` re-enqueues a
        failed batch's requests once before failing their futures;
        ``shed_on_overload`` lets a full queue shed its least-urgent
        (latest-deadline) entry for a more urgent arrival;
        ``supervisor_interval_s`` is the dead-worker-thread sweep cadence
        (``None`` disables the supervisor); ``default_timeout_s`` is the
        deadline of a request submitted without one; ``latency_window``
        the latency histograms' sliding window."""
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if placement not in ("single", "per_device"):
            raise ValueError("placement must be 'single' or 'per_device', "
                             "got %r" % (placement,))
        if int(mp) > 1:
            raise NotImplementedError(
                "ServingEngine(mp=%d): tensor-parallel serving (the "
                "sharded predictor and its build-time sharding check) is "
                "not ported yet (ROADMAP A7)" % int(mp))
        faults.maybe_install_from_env()
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
        self.seq_ladder = tuple(sorted(set(
            int(c) for c in seq_ladder))) if seq_ladder else None
        self.max_batch_size = max(self.ladder)
        self.feed_names = list(getattr(model, "feed_names", []))
        self.default_timeout_s = default_timeout_s
        self.placement = placement
        self.mp = int(mp)

        self._batcher = DynamicBatcher(self.max_batch_size,
                                       max_wait_ms=max_wait_ms, clock=clock)
        self._admission = AdmissionController(max_queue_depth)
        # serializes the shutdown/_closed transition against supervisor
        # respawns and rebuilds (see _maybe_respawn)
        self._lifecycle_lock = threading.Lock()
        self.metrics_ = ServingMetrics(latency_window=latency_window)
        self.metrics_.bind_gauges(self._batcher.depth,
                                  lambda: self._admission.in_flight)

        parents = self._build_parents(model, placement, devices,
                                      num_replicas)
        self._parents = parents
        self._parent = parents[0]
        # model-swap plane: the version served and how many swaps landed
        self.serve_version = None
        self.swap_count = 0
        self._staged_swap = None  # (version, updates) between prepare
        # and commit of a two-phase swap
        self.max_replica_failures = max_replica_failures or 0
        self.cross_replica_retry = bool(cross_replica_retry)
        self.shed_on_overload = bool(shed_on_overload)
        self._closed = False
        self._shutdown_done = False
        self._stop_event = threading.Event()
        self._supervisor = None
        self._workers = []

        decode_spec = self._resolve_decode_spec(decode, model_dir)
        self._decoders = None
        if decode_spec is not None:
            self._start_decoders(
                parents, num_replicas, decode_spec, max_queue_depth,
                default_timeout_s, clock, default_max_new_tokens, eos_id,
                prefix_cache, decode_prefill, decode_speculative)
            return

        def breaker():
            return CircuitBreaker(
                failure_threshold=max(1, self.max_replica_failures or 1),
                reset_timeout_s=0.0, clock=self._batcher.now)

        for i in range(num_replicas):
            parent = parents[i % len(parents)]
            pred = parent if i < len(parents) else parent.clone()
            self._workers.append(_Worker(pred, i, breaker(), parent))
        for w in self._workers:
            self._spawn_worker_thread(w)
        if supervisor_interval_s:
            self._supervisor = threading.Thread(
                target=self._supervisor_loop, args=(supervisor_interval_s,),
                name="paddle-tpu-torch-serve-supervisor", daemon=True)
            self._supervisor.start()

    def _start_decoders(self, parents, num_replicas, spec, max_queue_depth,
                        default_timeout_s, clock, default_max_new_tokens,
                        eos_id, prefix_cache, decode_prefill,
                        decode_speculative):
        """One ``DecodeBatcher`` (with its loop thread) per replica, over
        the parents and clones of the step predictor and of the chunk
        predictor, sharing the engine's metrics and one prefix cache: any
        replica's harvest serves any replica's admission."""
        from .decode_batcher import DecodeBatcher, make_prefix_cache

        shared_prefix = make_prefix_cache(prefix_cache, self.metrics_)
        if shared_prefix is not None:
            self.metrics_.bind_prefix_bytes(lambda: shared_prefix.nbytes)
        self._decoders = []
        for i in range(num_replicas):
            parent = parents[i % len(parents)]
            pred = parent if i < len(parents) else parent.clone()
            prefill = None
            if decode_prefill is not None:
                prefill = dict(decode_prefill)
                if i > 0:
                    prefill["predictor"] = decode_prefill["predictor"].clone()
            self._decoders.append(DecodeBatcher(
                pred, spec, ladder=self.ladder, ctx_ladder=self.seq_ladder,
                max_queue_depth=max_queue_depth,
                default_timeout_s=default_timeout_s,
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

    # -- placement ----------------------------------------------------------
    @staticmethod
    def _build_parents(model, placement, devices, num_replicas):
        """The replica-parent predictors placement produces: one
        weight-holder per device in use (per_device), or just ``model``.
        Never more parents than replicas — an unused parent is an unused
        weight copy on a device."""
        if placement == "single":
            return [model]
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError(
                    "placement='per_device': no CUDA device is available; "
                    "pass devices=[...] (e.g. ['cpu']) to place on the "
                    "host")
        devices = list(devices)
        return [model.clone(device=d)
                for d in devices[:max(1, min(len(devices), num_replicas))]]

    # -- client surface -----------------------------------------------------
    def submit(self, feed, timeout_s=None, max_new_tokens=None,
               eos_id=None):
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        One-shot mode: ``feed`` is a dict/list of arrays with a leading
        batch dim, and the future resolves to the fetch list sliced to
        this request's rows; ``timeout_s`` (None: ``default_timeout_s``)
        fails it if it is still queued that long. Decode mode: ``feed`` is
        the prompt (1-D ids, or ``{"prompt_ids": ids}``) and the future
        resolves to the generated ids.

        Raises :class:`ServerOverloadedError` when the bounded queue is
        full and no later-deadline request can be shed for this one,
        ``BucketError`` when the batch (or a sequence, or prompt +
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
        if self.feed_names:
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
        if self.seq_ladder:
            for a in feed.values():
                if a.ndim >= 2:
                    # reject an over-long sequence at the door, not inside
                    # a batch where it would fail innocent co-riders
                    bucket_for(a.shape[1], self.seq_ladder)
        timeout_s = (timeout_s if timeout_s is not None
                     else self.default_timeout_s)
        now = self._batcher.now()
        deadline = now + timeout_s if timeout_s is not None else None
        while True:
            try:
                self._admission.acquire(n)
                break
            except ServerOverloadedError:
                # EDF degradation: a full queue sheds its least-urgent
                # (latest-deadline) entry for a strictly more urgent
                # arrival, only when enough strictly-later examples are
                # queued to cover the whole shortfall
                short = self._admission.shortfall(n)
                if short == 0:
                    continue  # racing release freed the capacity: retry
                victim = (self._batcher.shed_for(deadline, short)
                          if self.shed_on_overload else None)
                if victim is None:
                    self.metrics_.observe_rejected()
                    raise
                self._fail(victim, ServerOverloadedError(
                    "shed under overload: the slot went to a request "
                    "with an earlier deadline"))
                self.metrics_.observe_shed()
                flight.record("edf.shed", where="engine", n=victim.n)
        req = Request(feed, n, Future(), now, deadline=deadline)
        req.trace_ctx = trace.current()
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
        """Run every (batch rung x seq rung) bucket twice on every
        replica, so the first real request at any bucket finds its shapes
        warm, the kernels built and, on the card, the step captured (the
        executor interprets a key's first run and captures its second).
        ``example_feed`` is one example (leading dim 1); with a
        ``seq_ladder`` give it the SHORTEST sequence you expect: seq rungs
        below its length cannot be warmed from it and are skipped. By
        default one is made from the program's var metadata. Returns the
        number of (replica, bucket) pairs warmed. Decode mode: every step
        and chunk geometry of every replica (``DecodeBatcher.warmup``)."""
        if self._decoders is not None:
            return sum(d.warmup() for d in self._decoders)
        feed = example_feed
        if feed is None:
            feed = self._synthesize_example()
        feed = {k: np.asarray(v) for k, v in feed.items()}
        warmed = 0
        seq_rungs = self.seq_ladder or (None,)
        for w in self._workers:
            for rung in self.ladder:
                for s in seq_rungs:
                    try:
                        padded, _ = pad_to_bucket(
                            feed, (rung,),
                            seq_ladder=None if s is None else (s,))
                    except BucketError:
                        continue  # example longer than this seq rung
                    for _ in range(2):
                        w.predictor.run(padded)
                    w.seen_signatures.add(self._signature(padded))
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
        """Distinct dispatched feed signatures per replica — the bound the
        ladder guarantees (<= len(ladder), or len(ladder) *
        len(seq_ladder) with sequence bucketing); on the card each is one
        captured step of the replica's executor. Decode mode: the
        distinct dispatch geometries of each replica."""
        if self._decoders is not None:
            return [c for d in self._decoders
                    for c in d.compiled_shape_counts()]
        return [len(w.seen_signatures) for w in self._workers]

    @property
    def draft_failures(self):
        """Decode mode: draft passes that raised, over every replica (each
        degraded its rows to one token of progress); 0 outside it."""
        return sum(d.draft_failures for d in self._decoders or ())

    def shutdown(self, drain=True, timeout_s=None):
        """Stop intake; with ``drain`` serve everything queued, otherwise
        cancel it. Joins the worker threads (warning on any that outlive
        ``timeout_s``); requests still queued after the join — a dead or
        stuck replica raced a full batcher — fail with
        :class:`EngineShutdownError` and return their admission slots.
        Idempotent."""
        # _closed flips under _lifecycle_lock: once we hold it, no
        # in-progress _maybe_respawn can still spawn a thread
        with self._lifecycle_lock:
            self._closed = True
            if self._shutdown_done:
                return
            self._shutdown_done = True
        self._stop_event.set()
        if self._decoders is not None:
            for d in self._decoders:
                d.shutdown(drain=drain, timeout_s=timeout_s)
            return
        if self._supervisor is not None:
            self._supervisor.join(timeout_s if timeout_s is not None
                                  else 5.0)
        if not drain:
            for r in self._batcher.drain():
                if r.future.cancel():
                    self.metrics_.observe_expired()
                else:
                    self.metrics_.observe_failed()
                self._admission.release(r.n)
        self._batcher.close()
        for w in self._workers:
            if w.thread is not None:
                w.thread.join(timeout_s)
                if w.thread.is_alive():
                    warnings.warn(
                        "ServingEngine.shutdown: replica %d (%s) still "
                        "busy after %.1fs join timeout; its in-flight "
                        "batch is abandoned to the daemon thread"
                        % (w.index, w.thread.name, timeout_s or 0.0),
                        RuntimeWarning, stacklevel=2)
        for r in self._batcher.drain():
            self._fail(r, EngineShutdownError(
                "ServingEngine shut down before this request was served"))
            self.metrics_.observe_failed()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- worker side --------------------------------------------------------
    @staticmethod
    def _signature(feed):
        return tuple(sorted((k, a.shape, str(a.dtype))
                            for k, a in feed.items()))

    def _synthesize_example(self):
        """A 1-example feed from the program's var metadata."""
        prog = getattr(self._workers[0].predictor, "_program", None)
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

    def _spawn_worker_thread(self, worker):
        worker.thread = threading.Thread(
            target=self._worker_loop, args=(worker,),
            name="paddle-tpu-torch-serve-%d" % worker.index, daemon=True)
        worker.thread.start()

    def _maybe_respawn(self, w):
        """Respawn ``w``'s dead thread — unless shutdown has begun. The
        ``_closed`` check and the spawn are one atomic step under
        ``_lifecycle_lock``, so no thread is spawned that shutdown's join
        sweep would miss. Returns True iff a thread was spawned."""
        with self._lifecycle_lock:
            if self._closed:
                return False
            if w.thread is not None and not w.thread.is_alive():
                self._spawn_worker_thread(w)
                self.metrics_.observe_respawned()
                flight.record("thread.respawn", where="engine",
                              replica=w.index)
                return True
        return False

    def _supervisor_loop(self, interval_s):
        """Self-healing sweep: a worker thread that died outright is
        respawned; its replica state (predictor, breaker) carries over."""
        while not self._stop_event.wait(interval_s):
            if self._closed:
                return
            for w in self._workers:
                if self._closed:
                    return
                self._maybe_respawn(w)

    def _worker_loop(self, worker):
        while True:
            # thread-death drills land here, BEFORE a batch is claimed: a
            # killed worker never strands futures
            try:
                faults.trip("serving.worker")
            except faults.InjectedFault:
                return  # die quietly; the supervisor's sweep respawns us
            batch = self._batcher.get_batch()
            if batch is None:
                return
            try:
                self._serve_batch(worker, batch)
            except BaseException:
                # _serve_batch already failed the batch's futures; a throw
                # reaching here must not take the replica down with it
                pass

    def _rebuild_replica(self, worker):
        """Evict a repeatedly-failing replica and rebuild it from its
        parent predictor, on that parent's device (weights shared; the
        per-replica executor state, the likely contaminant, is fresh).
        The evicted predictor is
        closed: its captured graphs and their pool are released, and the
        fresh executor takes over its side stream
        (``Executor.take_stream``)."""
        try:
            fresh = worker.parent.clone()
        except Exception as e:
            warnings.warn(
                "replica %d eviction: rebuild clone() failed (%r); "
                "keeping the old predictor and re-arming the breaker"
                % (worker.index, e), RuntimeWarning)
        else:
            old, worker.predictor = worker.predictor, fresh
            worker.seen_signatures = set()
            close = getattr(old, "close", None)
            if callable(close):
                close()
            old_exe = getattr(old, "_exe", None)
            take = getattr(getattr(fresh, "_exe", None), "take_stream", None)
            if old_exe is not None and callable(take):
                take(old_exe)  # no new stream, so no new cuBLAS workspace
            self.metrics_.observe_evicted()
            flight.record("replica.evict", where="engine",
                          replica=worker.index)
        worker.breaker.reset()

    # -- live hot-swap --------------------------------------------------------
    def _staged_updates(self, source, version, verb):
        """``(version, updates)`` of a checkpoint directory (its newest
        intact version, or ``version``; CRC-verified through
        ``checkpoint.load_staged``) or of an update list."""
        if not isinstance(source, str):
            return version, list(source)
        from .. import checkpoint

        prog = getattr(self._parent, "_program", None)
        if prog is None:
            raise TypeError(
                "%s from a checkpoint dir needs a program-backed "
                "predictor; got %r" % (verb, type(self._parent).__name__))
        version, updates, _extra = checkpoint.load_staged(
            source, prog, version=version)
        return version, updates

    def reload(self, source, version=None):
        """Hot-swap model parameters into every live replica WITHOUT
        stopping serving — the streaming publish plane's engine verb.
        ``source`` is a checkpoint directory (``checkpoint.load_staged``
        stages the newest intact — or the given ``version`` — with CRC
        verification and fallback past corrupt versions) or an
        already-staged ``[(name, array), ...]`` update list.

        Each distinct predictor scope is COPIED into a fresh scope with the
        updated parameters overlaid (each on its old tensor's device and
        dtype), then a single reference assignment flips each replica to
        it. A replica's in-flight micro-batch finishes on the old weights;
        its next batch reads the new ones. The new scope is a new key of
        the replica's executor: its next run of each rung interprets and
        the one after captures again. Returns the version served; raises
        when no staged name is in any replica scope. Decode-mode engines
        do not reload."""
        if self._decoders is not None:
            raise NotImplementedError(
                "reload() is not supported in decode mode: KV caches are "
                "conversation state entangled with the weights")
        if self._closed:
            raise RuntimeError("engine is shut down")
        version, updates = self._staged_updates(source, version, "reload")
        sp = trace.span("model.swap")
        with sp:
            if sp:
                sp.set(version=version, replicas=len(self._workers))
            applied = self._swap_scopes(updates)
        self.serve_version = version
        self.swap_count += 1
        flight.record("model.swap", version=version, applied=applied,
                      replicas=len(self._workers), swap=self.swap_count)
        return version

    def prepare(self, source, version=None):
        """Phase 1 of the two-phase swap: stage a checkpoint version (or an
        update list) WITHOUT touching the served weights, held until
        :meth:`commit` applies it or :meth:`abort_swap` drops it; a
        corrupt version fails here. Fault site ``swap.prepare``:
        ``error``/``corrupt`` fail the stage. Returns the staged
        version."""
        mode = faults.trip("swap.prepare")
        if self._decoders is not None:
            raise NotImplementedError(
                "prepare() is not supported in decode mode: KV caches "
                "are conversation state entangled with the weights")
        if self._closed:
            raise RuntimeError("engine is shut down")
        version, updates = self._staged_updates(source, version, "prepare")
        if mode == "corrupt":
            raise IOError("swap.prepare: staged bytes corrupt (injected)")
        self._staged_swap = (version, updates)
        flight.record("swap.prepare", version=version,
                      staged=len(updates))
        return version

    def commit(self, version=None):
        """Phase 2: swap the prepared version in. Idempotent under retry:
        committing a ``version`` that already serves returns success.
        Raises when nothing (or a different version) is staged. Fault
        site ``swap.commit``."""
        faults.trip("swap.commit")
        staged = self._staged_swap
        if staged is None:
            if version is not None and self.serve_version == version:
                return version  # lost-ACK retry of a landed commit
            raise RuntimeError(
                "commit(%r): no staged version (prepare first)"
                % (version,))
        sv, updates = staged
        if version is not None and sv != version:
            raise RuntimeError(
                "commit(%r): staged version is %r" % (version, sv))
        sp = trace.span("model.swap")
        with sp:
            if sp:
                sp.set(version=sv, replicas=len(self._workers))
            applied = self._swap_scopes(updates)
        self._staged_swap = None
        self.serve_version = sv
        self.swap_count += 1
        flight.record("swap.commit", version=sv, applied=applied,
                      replicas=len(self._workers), swap=self.swap_count)
        return sv

    def abort_swap(self):
        """Drop a staged-but-uncommitted version. Returns True when
        something was staged."""
        staged, self._staged_swap = self._staged_swap, None
        if staged is not None:
            flight.record("swap.abort", version=staged[0])
        return staged is not None

    def _swap_scopes(self, updates):
        """Copy-and-overlay every distinct predictor scope, then flip the
        references. Returns the number of parameter names applied."""
        with self._lifecycle_lock:  # no respawn/rebuild mid-swap
            preds = {id(p): p for p in self._parents}
            for w in self._workers:
                preds.setdefault(id(w.predictor), w.predictor)
            staged = {}  # id(old scope) -> (new scope, hits)
            for pred in preds.values():
                old = getattr(pred, "_scope", None)
                if old is None or id(old) in staged:
                    continue
                names = set(old.var_names())
                hits = {}
                for name, val in updates:
                    if name.startswith("@") or name not in names:
                        continue  # RNG stream / optimizer-only state
                    ref = old.get(name)
                    if isinstance(ref, torch.Tensor):
                        val = torch.as_tensor(np.asarray(val)).to(
                            device=ref.device, dtype=ref.dtype)
                    hits[name] = val
                fresh = Scope()
                for n in old.var_names():
                    fresh.set(n, hits.get(n, old.get(n)))
                staged[id(old)] = (fresh, len(hits))
            if not any(n for _, n in staged.values()):
                raise ValueError(
                    "reload: no staged parameter matches any replica "
                    "scope — wrong checkpoint for this model?")
            applied = 0
            for pred in preds.values():
                if getattr(pred, "_scope", None) is None:
                    continue
                fresh, n = staged[id(pred._scope)]
                pred._scope = fresh  # atomic: in-flight runs hold old
                applied = max(applied, n)
        return applied

    def _serve_batch(self, worker, batch):
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
        # phase 1 — batch assembly. Failures here (disagreeing scalar
        # feeds, bucket violations) are REQUEST-CONTENT errors: the
        # replica is healthy and a retry can only repeat them, so they
        # fail the batch without touching the breaker or the retry budget
        try:
            if len(live) == 1:
                merged = live[0].feed
            else:
                merged = {}
                for k in live[0].feed:
                    vals = [r.feed[k] for r in live]
                    if vals[0].ndim == 0:
                        # scalar feeds have no batch dim: riders must agree
                        if any(not np.array_equal(v, vals[0])
                               for v in vals[1:]):
                            raise ValueError(
                                "scalar feed %r differs across batched "
                                "requests; scalars must be equal to "
                                "coalesce" % k)
                        merged[k] = vals[0]
                    else:
                        if self.seq_ladder and vals[0].ndim >= 2:
                            # different seq lengths in one micro-batch:
                            # pad each rider to the rung covering the
                            # longest before the rows can concatenate
                            tgt = bucket_for(
                                max(v.shape[1] for v in vals),
                                self.seq_ladder)
                            vals = [edge_pad(v, tgt, 1) for v in vals]
                        merged[k] = np.concatenate(vals, axis=0)
            padded, n = pad_to_bucket(merged, self.ladder,
                                      seq_ladder=self.seq_ladder)
            rung = bucket_for(n, self.ladder)
        except Exception as e:
            for r in live:
                self._fail(r, e)
            self.metrics_.observe_failed(len(live))
            return
        # phase 2 — dispatch. Failures here are REPLICA faults: they count
        # on the breaker (evict+rebuild on trip) and the batch's requests
        # get their one cross-replica retry. The batch span is parented
        # onto the first live request's trace so a propagated router trace
        # stitches through the queue hand-off; predictor.run reaches
        # Executor.run on this thread, so its span nests here
        sp = trace.span("engine.batch",
                        parent=next((r.trace_ctx for r in live
                                     if r.trace_ctx is not None), None))
        try:
            sig = self._signature(padded)
            hit = sig in worker.seen_signatures
            worker.seen_signatures.add(sig)
            faults.trip("predictor.run")
            with sp:
                if sp:  # tags must land before the span closes
                    sp.set(n=n, rung=rung, requests=len(live),
                           replica=worker.index)
                outs = worker.predictor.run(padded)
            outs = unpad_fetch(outs, n, padded_to=rung)
        except Exception as e:
            if (self.max_replica_failures
                    and worker.breaker.record_failure()):
                self._rebuild_replica(worker)
            self._dispose_failed(live, e)
            return
        worker.breaker.record_success()
        self.metrics_.observe_batch(actual=n, bucket=rung, cache_hit=hit)
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

    def _dispose_failed(self, live, exc):
        """A batch's ``predictor.run`` threw: requests that still have a
        retry budget re-enqueue for another replica to pick up (inference
        is idempotent); the rest fail with the batch's exception. Retried
        requests keep their admission slot."""
        retry = []
        for r in live:
            if (self.cross_replica_retry and r.retries < 1
                    and not self._closed):
                r.retries += 1
                retry.append(r)
            else:
                self._fail(r, exc)
                self.metrics_.observe_failed()
        for r in retry:
            try:
                self._batcher.put(r)
            except RuntimeError:  # racing shutdown: no second chance left
                self._fail(r, exc)
                self.metrics_.observe_failed()
                continue
            self.metrics_.observe_retried()

    def _fail(self, req, exc):
        try:
            req.future.set_exception(exc)
        except Exception:  # noqa: BLE001 — a racing cancel
            pass
        self._admission.release(req.n)
