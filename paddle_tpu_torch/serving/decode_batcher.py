"""Continuous batching for autoregressive decode: a slot-recycled scheduler
over a KV-cached one-token step program (the port of
``paddle_tpu/serving/decode_batcher.py``; its behaviour and metrics are the
reference's, its internals PyTorch's).

The one-shot engine (``engine.py``) serves whole requests: a batch rides
until its longest member finishes. This scheduler makes the decode STEP
the scheduling quantum:

  * a **slot table** of ``bucket_batch`` rows, each one in-flight request
    with its own fill level ``pos`` into fixed-capacity per-slot KV caches
    ([B, C, ...] per layer): one set of device tensors per (batch, ctx)
    rung, made at its first use and kept, which the step and chunk
    programs of that rung write in place (a predictor that takes lent
    feeds, ``ProgramPredictor``: its executor captures each geometry's
    dispatch as one CUDA graph over them); any other predictor's fetched
    caches are fed back as they are;
  * one geometry per ``(bucket_batch, bucket_ctx)`` on the pow2 ladders
    (``buckets.py``), so ``warmup`` can run every one of them;
  * **slot recycling**: requests enter free slots between steps and
    finished ones retire at once;
  * **re-bucketing** when occupancy crosses a ladder rung: live rows are
    copied into the new rung's caches by row index, on the device;
  * prompt tokens are ingested through the same step program, one forced
    token a step, unless a chunk program rides along.

Three optional fast paths, all off unless configured:

  * **prefix cache** (``prefix_cache=``): a hash-trie over prompt prefixes
    (``prefix_cache.PrefixCache``) maps a shared prefix to KV rows an
    earlier slot computed; admission clones them into the new slot and the
    slot starts at ``pos = prefix_len``. Entries are clones made on the
    device (``.clone()``, never a view), so eviction never touches a live
    slot.
  * **chunked prefill** (``prefill=``): a K-token chunk program
    (``transformer_lm_chunk``) ingests K prompt tokens a dispatch on its
    own pow2 prefill ladder, alternating with step ticks while some live
    rows cannot ride the chunk.
  * **speculative decode** (``speculative=``): a draft LM proposes k-1
    tokens a generating row; one chunk dispatch scores all k positions and
    each row accepts greedily, so the output is the target model's own
    greedy chain for any draft.

**Parity.** Every op of the step program is per row (``cached_attention``
masks each row to its own fill level, ``kv_cache_write`` writes only the
row's own slot, products and LayerNorm reduce over feature axes), so at a
fixed (bucket_batch, bucket_ctx) a request batched with strangers gives
bitwise the ids it gives alone. Across geometries the per-row math is the
same but runs at other shapes, so parity there is not contractual.

Sampling is greedy: the argmax of each row's logits is taken on the device
(``torch.argmax`` returns the first maximal index, as ``np.argmax`` does)
and only the B ids reach the host.
"""

import json
import os
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from ..core.framework import torch_dtype
from ..core.opimpl.attention_ops import lendable_cache
from ..obs import trace
from .admission import AdmissionController, DeadlineExceededError
from .buckets import bucket_for, pow2_ladder
from .engine import EngineShutdownError
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache

__all__ = ["DecodeBatcher", "DecodeRequest", "DraftLM", "save_decode_spec",
           "load_decode_spec", "default_ctx_ladder",
           "default_prefill_ladder"]

DECODE_SPEC_FILE = "decode_spec.json"


def default_ctx_ladder(spec):
    """The ctx-capacity rungs a decode spec gets when the caller passes
    none: pow2 rungs up to the spec's cache capacity, floored at 16."""
    cap = int(spec.get("ctx_cap", 256) or 256)
    return tuple(r for r in pow2_ladder(cap) if r >= 16) or (cap,)


def default_prefill_ladder(spec):
    """The chunk-length rungs a chunk program gets when the caller passes
    none: pow2 rungs from 4 up to half the cache capacity."""
    cap = int(spec.get("ctx_cap", 256) or 256)
    top = min(cap, max(4, cap // 2))
    return tuple(r for r in pow2_ladder(top) if r >= 4) or (min(4, cap),)


def make_prefix_cache(arg, metrics):
    """The prefix cache a ``prefix_cache=`` argument asks for: None (or
    False) for none, a ``PrefixCache`` as given, True or a kwargs dict for
    a new one reporting to ``metrics``. Not a truthiness test: an empty
    ``PrefixCache`` is falsy."""
    if arg is None or arg is False:
        return None
    if isinstance(arg, PrefixCache):
        return arg
    kw = dict(arg) if isinstance(arg, dict) else {}
    kw.setdefault("metrics", metrics)
    return PrefixCache(**kw)


def _greedy(logits):
    """Row-wise argmax of device logits, as host ints (one copy of the
    ids, never of the logits)."""
    return torch.argmax(torch.as_tensor(logits), dim=-1).tolist()


class DraftLM:
    """Greedy draft proposer over a FULL ``transformer_lm`` program: each
    draft token is one pass of the causal program over the row's last
    ``seq_len`` tokens, taking the argmax at the last real position on the
    device. The speculative accept rule keeps the output exact for any
    proposer, so the draft only has to be cheap and usually right.

    ``predictor``: ``run``/``fetch_names`` over the full program (build it
    from ``program.prune([logits])`` so no loss is computed). ``ladder``:
    pow2 batch rungs the draft batch is padded to. ``passes`` counts the
    program's dispatches."""

    def __init__(self, predictor, logits_fetch, seq_len, ids_feed="ids",
                 lbl_feed="lbl", ladder=(1, 2, 4, 8)):
        self._pred = predictor
        self._logits_idx = list(predictor.fetch_names).index(logits_fetch)
        self.seq_len = int(seq_len)
        self.ids_feed = ids_feed
        self.lbl_feed = lbl_feed
        self.ladder = tuple(sorted(set(ladder)))
        self.passes = 0

    def propose(self, histories, n):
        """``n`` greedy continuations for each token history: a list of
        n-token lists, one per history."""
        hists = [list(h) for h in histories]
        out = [[] for _ in histories]
        for _ in range(int(n)):
            b = bucket_for(len(hists), self.ladder) \
                if len(hists) <= max(self.ladder) else len(hists)
            ids = np.zeros((b, self.seq_len), np.int64)
            last = []
            for j, h in enumerate(hists):
                t = h[-self.seq_len:]
                ids[j, :len(t)] = t
                last.append(len(t) - 1)
            feed = {self.ids_feed: ids}
            if self.lbl_feed:
                feed[self.lbl_feed] = ids
            logits = torch.as_tensor(
                self._pred.run(feed, return_numpy=False)[self._logits_idx])
            self.passes += 1
            rows = torch.arange(len(last), device=logits.device)
            at = torch.tensor(last, device=logits.device)
            for j, t in enumerate(_greedy(logits[rows, at])):
                out[j].append(t)
                hists[j].append(t)
        return out


def save_decode_spec(dirname, spec):
    """Write a step builder's decode-spec dict next to a
    ``save_inference_model`` export, so ``ServingEngine(dir, decode=True)``
    serves continuous-batching decode from the directory."""
    path = os.path.join(dirname, DECODE_SPEC_FILE)
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)
    return path


def load_decode_spec(dirname):
    with open(os.path.join(dirname, DECODE_SPEC_FILE)) as f:
        return json.load(f)


class DecodeRequest:
    """One decode request: ``prompt`` (non-empty int ids),
    ``max_new_tokens``, optional ``eos_id`` (stop token, also emitted), the
    caller's future (resolves to the generated ids, int64 ndarray) and the
    admission time the TTFT/TPOT metrics read."""

    __slots__ = ("prompt", "max_new", "eos_id", "future", "enqueue_t",
                 "deadline", "n_ctx", "prefix")

    def __init__(self, prompt, max_new, eos_id, future, enqueue_t,
                 deadline=None, prefix=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline = deadline
        # pinned PrefixMatch from submit (cloned + released at admission)
        self.prefix = prefix
        # the cache capacity it needs: every prompt token is written once,
        # then at most max_new - 1 generated tokens are fed back
        self.n_ctx = len(self.prompt) + self.max_new - 1

    def __repr__(self):
        return ("DecodeRequest(prompt=%d toks, max_new=%d)"
                % (len(self.prompt), self.max_new))


class _Slot:
    """One occupied slot-table row."""

    __slots__ = ("req", "pos", "k", "out", "next_token", "first_tok_t",
                 "harvested")

    def __init__(self, req):
        self.req = req
        # a matched prefix starts the slot past its cloned rows; the last
        # prompt token always feeds through the model
        m = req.prefix.length if req.prefix is not None else 0
        self.pos = m            # next cache index == tokens ingested
        self.k = m + 1          # prompt cursor: prompt[m] feeds first
        self.out = []           # generated ids
        self.next_token = req.prompt[m]
        self.first_tok_t = None
        self.harvested = False  # this prompt's rows offered to the cache

    @property
    def forcing(self):
        """Still ingesting prompt tokens (logits ignored)."""
        return self.k < len(self.req.prompt)


class DecodeBatcher:
    """The continuous batcher, with ``ServingEngine``'s client surface
    (``submit``/``predict``/``metrics``/``warmup``/``shutdown``).

    ``predictor``: anything with ``run(feed, return_numpy=False) -> list``
    in fetch order, ``fetch_names`` and ``device``, which holds the caches
    (a ``Predictor`` over a saved step program, a ``ProgramPredictor``, a
    test fake). A predictor marked ``_lends_feeds`` is lent the rung's
    caches (``run(..., _lend=names)``): they are written in place and
    fetched back as themselves. ``spec``: the decode-spec dict a step
    builder returns (``models.transformer.transformer_lm_step``).

    ``start=False`` runs no loop thread: :meth:`drive` then runs the
    scheduler on the calling thread, deterministic and without sleeps."""

    def __init__(self, predictor, spec, ladder=None, ctx_ladder=None,
                 max_batch_size=8, max_queue_depth=256,
                 default_timeout_s=None, default_max_new_tokens=64,
                 eos_id=None, clock=None, metrics=None, start=True,
                 prefix_cache=None, prefill=None, speculative=None):
        self._predictor = predictor
        self._device = torch.device(predictor.device)
        self._spec = dict(spec)
        self._tok_feed = self._spec["token_feed"]
        self._pos_feed = self._spec["pos_feed"]
        fetch_names = list(predictor.fetch_names)
        self._logits_idx = fetch_names.index(self._spec["logits_fetch"])
        self._cache_feeds = []
        for cf in self._spec["cache_feeds"]:
            self._cache_feeds.append(
                (cf["feed"], fetch_names.index(cf["fetch"]),
                 tuple(cf["tail"]), torch_dtype(cf.get("dtype", "float32"))))
        self.ladder = tuple(sorted(set(
            ladder if ladder is not None else pow2_ladder(max_batch_size))))
        if ctx_ladder is None:
            ctx_ladder = default_ctx_ladder(self._spec)
        self.ctx_ladder = tuple(sorted(set(int(c) for c in ctx_ladder)))
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.default_timeout_s = default_timeout_s
        self.eos_id = eos_id
        self._clock = clock or time.monotonic
        self._admission = AdmissionController(max_queue_depth)
        if metrics is not None:
            # shared instance (the engine's): its owner binds the gauges
            self.metrics_ = metrics
        else:
            self.metrics_ = ServingMetrics()
            self.metrics_.bind_gauges(lambda: len(self._pending),
                                      lambda: self._admission.in_flight)

        # a PrefixCache instance is shared (the engine's), True or a
        # kwargs dict builds one this batcher owns
        self.prefix_cache = make_prefix_cache(prefix_cache, self.metrics_)
        if self.prefix_cache is not None and metrics is None:
            self.metrics_.bind_prefix_bytes(lambda: self.prefix_cache.nbytes)

        # chunked prefill / speculative verify: the chunk program shares
        # the step program's cache feed names, so one cache dict feeds both
        self._prefill = None
        self.prefill_ladder = ()
        if prefill is not None:
            p = dict(prefill)
            cpred = p["predictor"]
            cspec = dict(p["spec"])
            cfetch = list(cpred.fetch_names)
            step_feeds = {cf["feed"] for cf in self._spec["cache_feeds"]}
            cmap = []
            for cf in cspec["cache_feeds"]:
                if cf["feed"] not in step_feeds:
                    raise ValueError(
                        "chunk cache feed %r has no step-program "
                        "counterpart: the chunk program must share the "
                        "step's cache feed names" % cf["feed"])
                cmap.append((cf["feed"], cfetch.index(cf["fetch"])))
            if len(cmap) != len(step_feeds):
                raise ValueError(
                    "chunk program covers %d of the step program's %d "
                    "cache feeds" % (len(cmap), len(step_feeds)))
            pl = p.get("ladder")
            if pl is None:
                pl = default_prefill_ladder(self._spec)
            self.prefill_ladder = tuple(sorted(set(int(k) for k in pl)))
            self._prefill = {
                "pred": cpred, "tok": cspec["token_feed"],
                "pos": cspec["pos_feed"],
                "logits_idx": cfetch.index(cspec["logits_fetch"]),
                "cache_map": cmap}
        self._alt_chunk = False

        # speculative decode rides the chunk program
        self._draft = None
        self._spec_k = 0
        self.draft_failures = 0
        if speculative is not None:
            if self._prefill is None:
                raise ValueError("speculative decode needs the chunk "
                                 "program (pass prefill= as well)")
            s = dict(speculative)
            self._draft = s["draft"]
            k = int(s.get("k", 4))
            if k < 2:
                raise ValueError("speculative k must be >= 2 "
                                 "(k-1 drafts + the committed token)")
            self._spec_k = k

        self._pending = deque()
        self._slots = []          # list[_Slot | None], len == bucket_batch
        self._caches = {}         # feed name -> [B, C, *tail] tensor
        self._rungs = {}          # (B, C) -> that rung's caches
        self._bucket = (0, 0)     # (bucket_batch, bucket_ctx)
        self.seen_signatures = set()
        self._cv = threading.Condition()
        self._closed = False
        self._aborted = False
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="paddle-tpu-torch-decode",
                daemon=True)
            self._thread.start()

    # -- client surface -----------------------------------------------------
    def now(self):
        return self._clock()

    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               timeout_s=None):
        """Enqueue one decode request; returns a Future resolving to the
        generated ids (int64 ndarray, eos included when hit). Raises
        ``BucketError`` when prompt + max_new exceeds the top ctx rung,
        ``ServerOverloadedError`` when the bounded queue is full."""
        if self._closed:
            raise RuntimeError("DecodeBatcher is shut down")
        prompt = np.asarray(prompt).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must hold at least one token")
        max_new = (int(max_new_tokens) if max_new_tokens is not None
                   else self.default_max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eos = eos_id if eos_id is not None else self.eos_id
        n_ctx = int(prompt.size) + max_new - 1  # as DecodeRequest.n_ctx
        bucket_for(n_ctx, self.ctx_ladder)  # validates at the door
        timeout_s = (timeout_s if timeout_s is not None
                     else self.default_timeout_s)
        now = self._clock()
        deadline = now + timeout_s if timeout_s is not None else None
        self._admission.acquire(1)
        prefix = None
        if self.prefix_cache is not None and prompt.size > 1:
            # capped at len-1: the last prompt token must feed through the
            # model to give the first generation's logits
            prefix = self.prefix_cache.lookup(prompt,
                                              limit=int(prompt.size) - 1)
        req = DecodeRequest(prompt, max_new, eos, Future(), now,
                            deadline=deadline, prefix=prefix)
        with self._cv:
            if self._closed:
                self._admission.release(1)
                self._release_prefix(req)
                raise RuntimeError("DecodeBatcher is shut down")
            self._pending.append(req)
            self._cv.notify_all()
        return req.future

    def predict(self, prompt, max_new_tokens=None, eos_id=None,
                timeout_s=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id,
                           timeout_s=timeout_s).result(timeout_s)

    def metrics(self):
        return self.metrics_.snapshot()

    def metrics_report(self):
        return self.metrics_.report()

    def compiled_shape_counts(self):
        """Distinct step ``(bucket_batch, bucket_ctx)`` and chunk
        ``(bucket_batch, bucket_ctx, chunk_rung)`` geometries dispatched,
        at most :meth:`compile_cache_bound` by construction."""
        return [len(self.seen_signatures)]

    def compile_cache_bound(self):
        """The number of geometries the scheduler can ever dispatch: one
        step geometry per (batch rung, ctx rung) and, with a chunk
        program, one chunk geometry per (batch rung, ctx rung, prefill
        rung) — the bound ``paddle_tpu/analysis/resources.py:195`` proves
        (its budget diagnostics are not ported)."""
        return (len(self.ladder) * len(self.ctx_ladder)
                * (1 + len(self.prefill_ladder)))

    def warmup(self):
        """Run every (batch rung, ctx rung) step geometry and, with a chunk
        program, every (batch, ctx, chunk rung) chunk geometry twice on
        zero tokens over the rung's own caches, so live traffic meets no
        first-run cost (on the card: the kernels' builds, the GEMM
        heuristics, and the capture of each dispatch, which the executor
        makes on a key's second run), as the reference's warmup compiles
        every geometry. The step writes position 0 of every row and the
        chunk nothing (its lanes are pads), so it runs before any request
        is admitted. Returns the number of geometries warmed (the
        reference's count; each ran twice)."""
        if any(s is not None for s in self._slots):
            raise RuntimeError("warmup() with requests in flight: its "
                               "dispatches write the live caches")
        warmed = 0
        for b in self.ladder:
            for c in self.ctx_ladder:
                caches = self._rung_caches(b, c)
                for _ in range(2):
                    feed = dict(caches)
                    feed[self._tok_feed] = np.zeros((b,), np.int64)
                    feed[self._pos_feed] = np.zeros((b,), np.int32)
                    self._run(self._predictor, feed, caches)
                self.seen_signatures.add((b, c))
                warmed += 1
                if self._prefill is None:
                    continue
                for k in self.prefill_ladder:
                    for _ in range(2):
                        cfeed = dict(caches)
                        cfeed[self._prefill["tok"]] = np.zeros((b, k),
                                                               np.int64)
                        cfeed[self._prefill["pos"]] = np.full((b, k), c,
                                                              np.int32)
                        self._run(self._prefill["pred"], cfeed, caches)
                    self.seen_signatures.add((b, c, k))
                    warmed += 1
        return warmed

    def step_report(self):
        """Whether the step and chunk programs are captured:
        ``{"step": report, "chunk": report}``, each the predictor's
        ``step_report()`` (``Executor.step_report``) of its latest
        dispatch, or None (no dispatch yet, or a predictor without one)."""
        preds = {"step": self._predictor}
        if self._prefill is not None:
            preds["chunk"] = self._prefill["pred"]
        return {name: (p.step_report() if hasattr(p, "step_report")
                       else None) for name, p in preds.items()}

    def drive(self, max_steps=None):
        """Run the scheduler on the CALLING thread until idle (or
        ``max_steps`` dispatches). Only with ``start=False``. Returns the
        number of dispatches."""
        if self._thread is not None:
            raise RuntimeError("drive() requires start=False "
                               "(the loop thread owns the slot table)")
        steps = 0
        while max_steps is None or steps < max_steps:
            self._admit()
            if not any(s is not None for s in self._slots):
                break
            self._tick()
            steps += 1
        return steps

    def shutdown(self, drain=True, timeout_s=None):
        """Stop intake. ``drain=True`` serves everything already submitted
        to completion; ``drain=False`` fails in-flight and queued requests
        with :class:`EngineShutdownError`."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._aborted = not drain
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout_s if timeout_s is not None else 30.0)
        else:
            if drain:
                while True:
                    self._admit()
                    if not any(s is not None for s in self._slots):
                        break
                    self._tick()
            else:
                self._abort_live()
        self._fail_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- scheduler ----------------------------------------------------------
    def _loop(self):
        while True:
            with self._cv:
                while (not self._closed and not self._pending
                       and not any(s is not None for s in self._slots)):
                    self._cv.wait()
                if self._closed:
                    if self._aborted:
                        break
                    if (not any(s is not None for s in self._slots)
                            and not self._pending):
                        break
            try:
                self._admit()
                if any(s is not None for s in self._slots):
                    self._tick()
                elif self._closed:
                    break
            except BaseException as e:  # noqa: BLE001 — fail loudly, once
                self._poison(e)
                return
        if self._aborted:
            self._abort_live()

    def _poison(self, exc):
        """The step itself threw (a replica fault, not a request fault):
        fail everything in flight; a decode loop cannot retry mid-sequence
        without replaying the whole cache."""
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._resolve_exc(slot.req, exc)
                self._slots[i] = None
        self._fail_pending(exc)

    def _fail_pending(self, exc=None):
        with self._cv:
            pending = list(self._pending)
            self._pending.clear()
        for req in pending:
            self._resolve_exc(req, exc or EngineShutdownError(
                "DecodeBatcher shut down before this request started"))
            self.metrics_.observe_failed()

    def _abort_live(self):
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._resolve_exc(slot.req, EngineShutdownError(
                    "DecodeBatcher aborted mid-generation"))
                self.metrics_.observe_failed()
                self._slots[i] = None

    def _release_prefix(self, req):
        """Drop a request's pinned prefix entry (cloned, failed or
        expired: the pin never outlives the request)."""
        if self.prefix_cache is not None and req.prefix is not None:
            self.prefix_cache.release(req.prefix.entry)
            req.prefix = None

    def _resolve_exc(self, req, exc):
        self._release_prefix(req)
        try:
            req.future.set_exception(exc)
        except Exception:
            pass
        self._admission.release(1)

    # admission + re-bucketing, between dispatches only
    def _admit(self):
        now = self._clock()
        admitted = []
        with self._cv:
            live = sum(1 for s in self._slots if s is not None)
            room = max(self.ladder) - live
            while self._pending and room > 0:
                req = self._pending.popleft()
                if req.deadline is not None and now > req.deadline:
                    self._resolve_exc(req, DeadlineExceededError(
                        "request waited %.1f ms, deadline was %.1f ms"
                        % ((now - req.enqueue_t) * 1e3,
                           (req.deadline - req.enqueue_t) * 1e3)))
                    self.metrics_.observe_expired()
                    continue
                admitted.append(req)
                room -= 1
        if not admitted and self._bucket == self._target_bucket([]):
            return
        self._rebucket(admitted)

    def _target_bucket(self, admitting):
        live = [s.req for s in self._slots if s is not None]
        reqs = live + list(admitting)
        if not reqs:
            return (0, 0)
        b = bucket_for(len(reqs), self.ladder)
        c = bucket_for(max(r.n_ctx for r in reqs), self.ctx_ladder)
        return (b, c)

    @torch.inference_mode()
    def _rung_caches(self, b, c):
        """The caches of rung (b, c), made zeroed at their first use and
        kept: a rung's step and chunk dispatches always write the same
        tensors, which a captured dispatch holds."""
        caches = self._rungs.get((b, c))
        if caches is None:
            caches = self._rungs[(b, c)] = {
                feed: lendable_cache(b, c, tail, dtype, self._device)
                for feed, _idx, tail, dtype in self._cache_feeds}
        return caches

    def _run(self, pred, feed, caches):
        """One dispatch of ``pred``, lending it ``caches`` where it takes
        lent feeds."""
        if getattr(pred, "_lends_feeds", False):
            return pred.run(feed, return_numpy=False, _lend=tuple(caches))
        return pred.run(feed, return_numpy=False)

    def _as_cache(self, value):
        """A fetched cache (a tensor, or a test fake's array) as a tensor
        on the slot table's device."""
        return torch.as_tensor(value, device=self._device)

    @torch.inference_mode()
    def _rebucket(self, admitting):
        """Place admissions, and re-shape the caches when the (batch, ctx)
        bucket moved.

        Same geometry: admissions drop into free holes with no cache
        traffic: a recycled row needs no cleaning, since its new occupant
        starts at its own fill level and a row's mask never reaches past
        it. Geometry moved: live rows are gathered by index into the new
        rung's caches (other tensors than the old rung's), on the device;
        what those rows held past each fill level stays unreachable."""
        new_b, new_c = self._target_bucket(admitting)
        if (new_b, new_c) == self._bucket:
            if admitting:
                free = [i for i, s in enumerate(self._slots) if s is None]
                for req, i in zip(admitting, free):
                    self._slots[i] = _Slot(req)
                    self._install_prefix(i, req)
            return
        old_c = self._bucket[1]
        live = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        new_slots = [s for _, s in live]
        for req in admitting:
            new_slots.append(_Slot(req))
        new_slots += [None] * (new_b - len(new_slots))
        copy_c = min(old_c, new_c)
        caches = self._rung_caches(new_b, new_c)
        if live and self._caches:
            src = torch.tensor([i for i, _s in live], device=self._device)
            for feed, cache in caches.items():
                cache[:len(live), :copy_c] = \
                    self._caches[feed][src, :copy_c]
        self._caches = caches
        self._slots = new_slots
        self._bucket = (new_b, new_c)
        for j, req in enumerate(admitting, start=len(live)):
            self._install_prefix(j, req)

    def _install_prefix(self, i, req):
        """Copy a matched prefix's leading rows into slot row ``i`` and
        release the pin. The slot's cache is this batcher's own (the last
        dispatch's output), so the copy aliases nothing."""
        match = req.prefix
        if match is None:
            return
        m = match.length
        for feed, _idx, _tail, _dtype in self._cache_feeds:
            rows = match.entry.rows.get(feed)
            if rows is not None:
                self._caches[feed][i, :m] = self._as_cache(rows[:m])
        self._release_prefix(req)

    def _tick(self):
        """One scheduler quantum: a chunk dispatch (prefill and/or
        speculative verify) when the chunk program has work, else one
        step. While some live rows cannot ride the chunk (they generate
        and speculation is off), chunk and step ticks alternate."""
        if self._prefill is None:
            self._step_once()
            return
        plan = self._chunk_plan()
        if plan is None:
            self._alt_chunk = False
            self._step_once()
            return
        rows, has_uncovered, verifying = plan
        if has_uncovered and self._alt_chunk:
            self._alt_chunk = False
            self._step_once()
            return
        self._alt_chunk = True
        with trace.span("spec.verify" if verifying
                        else "prefill.chunk") as sp:
            self._chunk_once(rows, sp)

    def _chunk_plan(self):
        """This tick's chunk rows as ``(rows, has_uncovered, verifying)``,
        or None when no live row wants the chunk program. Each row is
        ``(i, slot, tokens, n_forced)``: lane j feeds ``tokens[j]`` at
        cache index ``slot.pos + j``; the first ``n_forced`` are committed
        (prompt or already emitted), the rest are drafts."""
        spec = self._spec_k > 0
        top = self.prefill_ladder[-1]
        ingest = []     # (i, slot, want): rows with prompt left
        verify = []     # (i, slot): generating rows (spec mode)
        uncovered = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            pending = len(slot.req.prompt) - slot.pos
            if pending >= 2 or (spec and pending == 1):
                # plain prefill leaves the LAST prompt token to the step
                # program (sampling stays on the step path); spec mode
                # ingests through it and samples from the chunk's logits
                want = pending if spec else pending - 1
                ingest.append((i, slot, min(want, top)))
            elif spec:
                verify.append((i, slot))
            else:
                uncovered += 1
        if not ingest and not verify:
            return None
        rows = []
        for i, slot, want in ingest:
            toks = slot.req.prompt[slot.pos:slot.pos + want]
            rows.append((i, slot, toks, len(toks)))
        if verify:
            needs = []
            for i, slot in verify:
                real = min(self._spec_k,
                           slot.req.max_new - len(slot.out), top)
                needs.append(max(0, real - 1))
            drafts = self._draft_for([s for _i, s in verify], max(needs))
            for (i, slot), d, n in zip(verify, drafts, needs):
                rows.append((i, slot, [slot.next_token] + d[:n], 1))
        return rows, uncovered > 0, bool(verify)

    def _draft_for(self, slots, n):
        """``n`` draft tokens per generating slot. Any proposal is safe
        (the accept rule emits only the target's own greedy chain), so a
        draft failure degrades to 1-token progress; ``draft_failures``
        counts them."""
        if n <= 0:
            return [[] for _ in slots]
        hists = [s.req.prompt + s.out for s in slots]
        try:
            return self._draft.propose(hists, n)
        except Exception:  # noqa: BLE001 — counted, never fatal
            self.draft_failures += 1
            return [[] for _ in slots]

    def _chunk_once(self, rows, sp):
        """Dispatch one chunk: K-token lanes per covered row; pad lanes
        carry ``pos == bucket_ctx``, so their cache writes drop and their
        logits are ignored. Commits forced tokens, then emits each verify
        row's greedy chain: drafts are accepted while they equal the
        chunk's own argmax, the first disagreement is replaced by that
        argmax (at least one token of progress), and rejected lanes are
        rewound by moving ``pos`` back: rows past a slot's fill level are
        unreachable by the mask."""
        pf = self._prefill
        b, c = self._bucket
        k = bucket_for(max(len(t) for _i, _s, t, _f in rows),
                       self.prefill_ladder)
        tok = np.zeros((b, k), np.int64)
        cpos = np.full((b, k), c, np.int32)
        for i, slot, tokens, _f in rows:
            n = len(tokens)
            tok[i, :n] = tokens
            cpos[i, :n] = np.arange(slot.pos, slot.pos + n, dtype=np.int32)
        feed = dict(self._caches)
        feed[pf["tok"]] = tok
        feed[pf["pos"]] = cpos
        outs = self._run(pf["pred"], feed, self._caches)
        self.seen_signatures.add((b, c, k))
        for name, idx in pf["cache_map"]:
            self._caches[name] = self._as_cache(outs[idx])
        greedy = None
        now = self._clock()
        live = sum(1 for s in self._slots if s is not None)
        generated = 0
        accepted = rejected = 0
        chunk_rows = 0
        chunk_toks = 0
        for i, slot, tokens, n_forced in rows:
            real = len(tokens)
            base = slot.pos
            L = len(slot.req.prompt)
            ingested = max(0, min(L - base, n_forced))
            if ingested:
                chunk_rows += 1
                chunk_toks += ingested
            if n_forced == real and base + real < L:
                # pure prompt ingestion, prompt not finished
                slot.pos = base + real
                slot.k = slot.pos + 1
                slot.next_token = slot.req.prompt[slot.pos]
                continue
            # the chunk covered the last prompt token (spec prefill) or
            # this is a verify row: emit the greedy chain
            if greedy is None:
                greedy = _greedy(outs[pf["logits_idx"]])
            req = slot.req
            j = n_forced - 1
            emitted = [greedy[i][j]]
            while (j + 1 < real
                   and len(slot.out) + len(emitted) < req.max_new
                   and (req.eos_id is None or emitted[-1] != req.eos_id)
                   and tokens[j + 1] == emitted[-1]):
                j += 1
                emitted.append(greedy[i][j])
            if n_forced < real:
                accepted += j - (n_forced - 1)
                rejected += (real - n_forced) - (j - (n_forced - 1))
            slot.pos = base + j + 1
            for t in emitted:
                slot.out.append(t)
                generated += 1
                if slot.first_tok_t is None:
                    slot.first_tok_t = now
                    self.metrics_.observe_ttft(now - req.enqueue_t)
            if not slot.harvested and slot.pos >= L:
                self._maybe_harvest(i, slot)
            done = (len(slot.out) >= req.max_new
                    or (req.eos_id is not None
                        and slot.out[-1] == req.eos_id))
            if done:
                self._retire(i, slot, now)
            else:
                slot.next_token = slot.out[-1]
        if chunk_rows:
            self.metrics_.observe_prefill_chunk(chunk_rows, chunk_toks)
        if accepted or rejected:
            self.metrics_.observe_spec(accepted, rejected)
        self.metrics_.observe_decode_step(live, b, generated)
        if sp:
            sp.set(live=live, bucket=b, ctx=c, chunk=k,
                   generated=generated, accepted=accepted,
                   rejected=rejected)

    @torch.inference_mode()
    def _maybe_harvest(self, i, slot):
        """First full ingestion of this prompt: offer its KV rows [0:L] to
        the prefix cache as device clones (once per request; kept only if
        the exact prompt is not an entry already)."""
        slot.harvested = True
        if self.prefix_cache is None:
            return
        key = slot.req.prompt
        if len(key) < 2 or key in self.prefix_cache:
            return
        rows = {feed: self._caches[feed][i, :len(key)].clone()
                for feed, _idx, _tail, _dtype in self._cache_feeds}
        self.prefix_cache.insert(key, rows)

    def _step_once(self):
        with trace.span("decode.step") as sp:
            self._step_once_traced(sp)

    def _step_once_traced(self, sp):
        b, c = self._bucket
        toks = np.zeros((b,), np.int64)
        pos = np.zeros((b,), np.int32)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                toks[i] = slot.next_token
                pos[i] = slot.pos
        feed = dict(self._caches)
        feed[self._tok_feed] = toks
        feed[self._pos_feed] = pos
        outs = self._run(self._predictor, feed, self._caches)
        self.seen_signatures.add((b, c))
        # carried state: the fetched caches feed the next dispatch as-is
        # (a lent cache is fetched back as itself)
        for name, idx, _tail, _dtype in self._cache_feeds:
            self._caches[name] = self._as_cache(outs[idx])
        greedy = None
        now = self._clock()
        live = 0
        generated = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            live += 1
            slot.pos += 1
            if slot.forcing:
                slot.next_token = slot.req.prompt[slot.k]
                slot.k += 1
                continue
            if not slot.harvested and slot.pos >= len(slot.req.prompt):
                self._maybe_harvest(i, slot)
            if greedy is None:
                greedy = _greedy(outs[self._logits_idx])
            nxt = greedy[i]
            generated += 1
            slot.out.append(nxt)
            if slot.first_tok_t is None:
                slot.first_tok_t = now
                self.metrics_.observe_ttft(now - slot.req.enqueue_t)
            done = (len(slot.out) >= slot.req.max_new
                    or (slot.req.eos_id is not None
                        and nxt == slot.req.eos_id))
            if done:
                self._retire(i, slot, now)
            else:
                slot.next_token = nxt
        self.metrics_.observe_decode_step(live, b, generated)
        if sp:
            sp.set(live=live, bucket=b, ctx=c, generated=generated)

    def _retire(self, i, slot, now):
        """Finished sequence: resolve and free the slot at once (the next
        ``_admit`` recycles it)."""
        self._slots[i] = None
        if len(slot.out) > 1:
            self.metrics_.observe_tpot(
                (now - slot.first_tok_t) / (len(slot.out) - 1))
        try:
            slot.req.future.set_result(np.asarray(slot.out, np.int64))
        except Exception:
            pass
        self.metrics_.observe_completed(now - slot.req.enqueue_t)
        self._admission.release(1)
