"""The port's decode tier on the CPU: the prefix cache, the continuous
batcher on a fake step model and on the real KV-cached ``transformer_lm``
family, and ``ServingEngine``'s decode mode (twins of
``tests/test_decode.py``'s prefix-cache tests and ``tests/test_serving.py``'s
decode tests). Bitwise parity is held in the port itself: solo vs batched,
chunked prefill vs step-only, speculative vs plain. No JAX here: the card
tests reuse :func:`build_family`."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.inference import ProgramPredictor
from paddle_tpu_torch.serving import (BucketError, DeadlineExceededError,
                                      DecodeBatcher, DraftLM,
                                      EngineShutdownError, PrefixCache,
                                      ServerOverloadedError, ServingEngine,
                                      save_decode_spec)

# bench.py's CPU decode config (paddle_tpu's bench.py:595-600)
TINY = dict(vocab=64, d_model=32, d_ff=64, n_head=2, n_layer=2, ctx_cap=32,
            pos_cap=256)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def port_programs():
    """Fresh default programs, name generator and scope for the port."""
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


def build_family(pkg, scope, cfg=TINY, seq_len=16, seed=3, place=None,
                 init=True):
    """The weight-sharing LM family of package ``pkg`` in one scope: the
    full ``transformer_lm`` (``seq_len``), the step and the chunk
    programs. Only the full startup runs (``init``). Returns a dict:
    ``step``/``chunk``/``full`` predictors, ``dspec``, ``cspec``, ``spec``
    (the full ModelSpec), ``full_main`` and ``prefill`` (the batcher's
    ``prefill=`` argument)."""
    models = pkg.models
    full_cfg = {k: v for k, v in cfg.items() if k != "ctx_cap"}
    progs = {}
    for name in ("full", "step", "chunk"):
        main, start = pkg.Program(), pkg.Program()
        main.random_seed = start.random_seed = seed
        with pkg.program_guard(main, start), pkg.scope_guard(scope):
            pkg.unique_name.switch()
            if name == "full":
                out = models.transformer.transformer_lm(seq_len=seq_len,
                                                        **full_cfg)
            elif name == "step":
                out = models.transformer.transformer_lm_step(**cfg)
            else:
                out = models.transformer.transformer_lm_chunk(**cfg)
        progs[name] = (main, start, out)
    place = place if place is not None else pkg.CPUPlace()
    if init:
        with pkg.scope_guard(scope):
            pkg.Executor(place).run(progs["full"][1])
    pp = pkg.inference.ProgramPredictor

    def cached(name):
        main, _start, (fetch_vars, spec) = progs[name]
        feeds = [spec["token_feed"], spec["pos_feed"]] \
            + [c["feed"] for c in spec["cache_feeds"]]
        kw = {} if pkg is not tfluid else {"place": place}
        return pp(main, feeds, fetch_vars, scope=scope, **kw), spec

    step, dspec = cached("step")
    chunk, cspec = cached("chunk")
    full_main, _start, spec = progs["full"]
    kw = {} if pkg is not tfluid else {"place": place}
    full = pp(full_main, ["ids", "lbl"], [spec.extras["logits"]],
              scope=scope, **kw)
    return {"step": step, "dspec": dspec, "chunk": chunk, "cspec": cspec,
            "full": full, "spec": spec, "full_main": full_main,
            "prefill": {"predictor": chunk, "spec": cspec}}


def _family(seed=3):
    return build_family(tfluid, tfluid.Scope(), seed=seed)


def _ids(fut):
    return tuple(int(t) for t in np.asarray(fut.result(0)).ravel())


# -- prefix cache (twins of tests/test_decode.py:226-305) -------------------

def _entry_rows(n_rows, fill=1.0):
    return {"cache_k_0": torch.full((n_rows, 4), fill)}


def test_prefix_cache_donor_subtree_match():
    pc = PrefixCache(max_bytes=1 << 20)
    key = (3, 7, 11, 2, 5)
    pc.insert(key, _entry_rows(5))
    m = pc.lookup(key, limit=4)   # capped at len-1: the deeper entry donates
    assert m is not None and m.length == 4
    assert m.entry.rows["cache_k_0"].shape[0] == 5
    pc.release(m.entry)
    m2 = pc.lookup((3, 7, 11, 9, 9, 9), limit=5)
    assert m2 is not None and m2.length == 3
    pc.release(m2.entry)
    assert pc.lookup((8, 8, 8), limit=2) is None
    assert pc.stats()["hits"] == 2 and pc.stats()["misses"] == 1


def test_prefix_cache_lru_eviction_skips_pinned():
    one = _entry_rows(4)["cache_k_0"].nbytes  # the tensor's own 64 bytes
    assert one == 64
    pc = PrefixCache(max_bytes=2 * one)
    pc.insert((1, 1, 1, 1), _entry_rows(4))
    pc.insert((2, 2, 2, 2), _entry_rows(4))
    m = pc.lookup((1, 1, 1, 1, 9), limit=4)   # pin the LRU entry
    assert m is not None and m.length == 4
    pc.insert((3, 3, 3, 3), _entry_rows(4))   # must evict the OTHER one
    assert pc.lookup((2, 2, 2, 2, 9), limit=4) is None
    m1b = pc.lookup((1, 1, 1, 1, 9), limit=4)
    assert m1b is not None
    pc.release(m1b.entry)
    pc.release(m.entry)
    pc.insert((4, 4, 4, 4), _entry_rows(4))
    assert pc.stats()["evictions"] >= 1
    assert pc.stats()["bytes"] <= 2 * one


def test_prefix_cache_oversized_refused_and_trie_pruned():
    pc = PrefixCache(max_bytes=32)
    pc.insert((9,) * 8, _entry_rows(8))   # 128 B > budget
    assert len(pc) == 0 and pc.stats()["bytes"] == 0
    small = {"cache_k_0": torch.zeros(2, 4)}   # 32 B fits
    pc.insert((5, 6), small)
    assert len(pc) == 1
    pc.insert((7, 8), dict(small))   # evicts (5, 6)
    assert pc.lookup((5, 6, 1), limit=2) is None
    assert len(pc._root.children) == 1   # the (5, 6) branch was pruned
    before = pc.stats()["bytes"]
    pc.insert((7, 8), dict(small))   # duplicate insert: a no-op
    assert pc.stats()["bytes"] == before and len(pc) == 1


def test_chunk_cache_write_matches_stepwise_writes(port_programs):
    """kv_cache_write_chunk == K stepwise writes; the pad sentinel
    (pos == capacity) writes nothing."""
    cap, d = 8, 4
    L = tfluid.layers
    cache = L.data("cache", shape=[cap, d], dtype="float32")
    rows = L.data("rows", shape=[3, d], dtype="float32")
    pos = L.data("pos", shape=[3], dtype="int32")
    out = L.kv_cache_write_chunk(cache, rows, pos)
    exe = tfluid.Executor(tfluid.CPUPlace())
    cache_np = np.zeros((2, cap, d), "float32")
    rows_np = np.arange(2 * 3 * d, dtype="float32").reshape(2, 3, d)
    pos_np = np.array([[1, 2, 3], [5, cap, cap]], "int32")
    got, = exe.run(feed={"cache": cache_np, "rows": rows_np,
                         "pos": pos_np}, fetch_list=[out])
    want = cache_np.copy()
    for i in range(2):
        for j in range(3):
            if pos_np[i, j] < cap:
                want[i, pos_np[i, j]] = rows_np[i, j]
    np.testing.assert_array_equal(got, want)


# -- the batcher on a fake step model (twins of test_serving.py:561-691) ----

class FakeStepModel:
    """Next token = (tok + 1) % vocab through one-hot logits; one fake
    cache layer checks that fetched caches are fed back as they are."""

    vocab = 16
    device = "cpu"
    fetch_names = ["logits", "c0_out"]
    spec = {"token_feed": "tok", "pos_feed": "pos",
            "logits_fetch": "logits",
            "cache_feeds": [{"feed": "c0", "fetch": "c0_out",
                             "tail": [2], "dtype": "float32"}],
            "vocab": 16, "ctx_cap": 64}

    def __init__(self):
        self.calls = []

    def run(self, feed, return_numpy=True):
        tok = torch.as_tensor(feed["tok"]).long()
        pos = torch.as_tensor(feed["pos"]).long()
        cache = torch.as_tensor(feed["c0"]).clone()
        self.calls.append((tok.clone(), pos.clone(), tuple(cache.shape)))
        b = tok.shape[0]
        rows = torch.arange(b)
        logits = torch.zeros(b, self.vocab)
        logits[rows, (tok + 1) % self.vocab] = 1.0
        cache[rows, pos.clamp(max=cache.shape[1] - 1), 0] = tok.float()
        return [logits, cache]


def _fake_batcher(**kw):
    m = FakeStepModel()
    kw.setdefault("ladder", (1, 2, 4))
    kw.setdefault("ctx_ladder", (8, 16))
    kw.setdefault("start", False)
    return m, DecodeBatcher(m, FakeStepModel.spec, **kw)


def _counting_seq(start, n, vocab=16):
    return [(start + 1 + i) % vocab for i in range(n)]


def test_decode_batcher_generates_and_recycles():
    m, bat = _fake_batcher()
    cases = ((3, 4), (7, 2), (1, 6), (9, 3), (5, 5))
    futs = [bat.submit([s], max_new_tokens=n) for s, n in cases]
    bat.drive()
    for f, (s, n) in zip(futs, cases):
        np.testing.assert_array_equal(f.result(0), _counting_seq(s, n))
    assert len(bat.seen_signatures) <= 2 * 3
    meters = bat.metrics()
    assert meters["requests_completed"] == 5
    assert 0 < meters["slot_occupancy"] <= 1.0
    assert meters["decode_tokens"] == 4 + 2 + 6 + 3 + 5
    assert bat._admission.in_flight == 0
    # the fetched cache came back as a tensor on the slot table's device
    assert all(isinstance(c, torch.Tensor) for c in bat._caches.values())


def test_decode_batcher_eos_stops_early():
    m, bat = _fake_batcher()
    f = bat.submit([4], max_new_tokens=10, eos_id=7)
    bat.drive()
    np.testing.assert_array_equal(f.result(0), [5, 6, 7])


def test_decode_batcher_skew_no_starvation():
    """One long request beside a stream of short ones: the shorts flow
    through recycled slots while the long one keeps one slot."""
    m, bat = _fake_batcher(ladder=(1, 2, 4), ctx_ladder=(8, 64),
                           max_queue_depth=256)
    long_f = bat.submit([1], max_new_tokens=50)
    shorts = [bat.submit([2], max_new_tokens=4) for _ in range(12)]
    steps = bat.drive()
    assert long_f.done() and all(s.done() for s in shorts)
    np.testing.assert_array_equal(long_f.result(0), _counting_seq(1, 50))
    assert steps <= 51 + 16, steps
    m2 = bat.metrics()
    assert m2["requests_completed"] == 13 and m2["requests_failed"] == 0


def test_decode_batcher_rebucket_and_compile_bound():
    """Occupancy crossing rungs re-buckets (grow and shrink), by row copies
    on the device; generation survives the moves exactly."""
    m, bat = _fake_batcher(ladder=(1, 2, 4), ctx_ladder=(8, 16))
    f1 = bat.submit([3], max_new_tokens=12)
    bat.drive(max_steps=3)
    assert bat._bucket == (1, 16)
    more = [bat.submit([5], max_new_tokens=3) for _ in range(3)]
    bat.drive(max_steps=2)
    assert bat._bucket == (4, 16)
    # the long request's cache rows moved with it: the fake model wrote
    # its fed tokens 3, 4, 5, 6, 7 at positions 0..4
    np.testing.assert_array_equal(
        bat._caches["c0"][0, :5, 0].numpy(), [3, 4, 5, 6, 7])
    bat.drive()
    assert bat._bucket[0] <= 2
    np.testing.assert_array_equal(f1.result(0), _counting_seq(3, 12))
    for f in more:
        np.testing.assert_array_equal(f.result(0), _counting_seq(5, 3))
    assert len(bat.seen_signatures) <= bat.compile_cache_bound() == 3 * 2


def test_decode_batcher_deterministic_under_fake_clock():
    def run_once():
        m, bat = _fake_batcher(clock=FakeClock())
        futs = [bat.submit([s], max_new_tokens=3 + s % 3)
                for s in (2, 9, 4, 11, 6)]
        steps = bat.drive()
        met = bat.metrics()
        return ([_ids(f) for f in futs], steps, met["decode_steps"],
                met["decode_tokens"], met["slot_occupancy"])

    assert run_once() == run_once()


def test_decode_batcher_overload_deadline_shutdown():
    m, bat = _fake_batcher(max_queue_depth=2)
    f1 = bat.submit([1], max_new_tokens=2)
    f2 = bat.submit([2], max_new_tokens=2)
    with pytest.raises(ServerOverloadedError):
        bat.submit([3], max_new_tokens=2)
    clock = FakeClock()
    m2, bat2 = _fake_batcher(clock=clock)
    doomed = bat2.submit([1], max_new_tokens=2, timeout_s=5.0)
    clock.advance(10.0)
    bat2.drive()
    with pytest.raises(DeadlineExceededError):
        doomed.result(0)
    assert bat2.metrics()["requests_expired"] == 1
    bat.shutdown(drain=True)
    assert f1.result(0) is not None and f2.result(0) is not None
    with pytest.raises(RuntimeError):
        bat.submit([1])
    m3, bat3 = _fake_batcher()
    f3 = bat3.submit([1], max_new_tokens=2)
    bat3.shutdown(drain=False)
    with pytest.raises(EngineShutdownError):
        f3.result(0)
    assert bat3._admission.in_flight == 0


def test_decode_batcher_rejects_over_capacity_prompt():
    m, bat = _fake_batcher(ctx_ladder=(8,))
    with pytest.raises(BucketError):
        bat.submit([1, 2, 3], max_new_tokens=32)
    with pytest.raises(ValueError):
        bat.submit([], max_new_tokens=4)
    f = bat.submit([1, 2, 3, 4], max_new_tokens=5)  # writes 0..7: fits
    bat.drive()
    np.testing.assert_array_equal(f.result(0), _counting_seq(4, 5))
    with pytest.raises(BucketError):
        bat.submit([1, 2, 3, 4], max_new_tokens=6)


# -- the real KV-cached family ----------------------------------------------

def test_lm_step_and_chunk_match_full_program_logits():
    """Step decode and one chunk dispatch reproduce the full causal
    program's logits, teacher-forced over the same tokens."""
    fam = _family()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, TINY["vocab"], (2, 16)).astype("int64")
    full, = fam["full"].run({"ids": ids, "lbl": ids})
    caches = {cf["feed"]: np.zeros((2, 16, TINY["d_model"]), "f4")
              for cf in fam["dspec"]["cache_feeds"]}
    steps = []
    for t in range(16):
        feed = dict(caches, tok_ids=ids[:, t],
                    pos=np.full((2,), t, "int32"))
        outs = fam["step"].run(feed)
        steps.append(outs[0])
        for cf, arr in zip(fam["dspec"]["cache_feeds"], outs[1:]):
            caches[cf["feed"]] = arr
    np.testing.assert_allclose(np.stack(steps, 1), full, rtol=1e-5,
                               atol=1e-5)
    zero = {cf["feed"]: np.zeros((2, 16, TINY["d_model"]), "f4")
            for cf in fam["cspec"]["cache_feeds"]}
    chunk = fam["chunk"].run(dict(zero, tok_chunk=ids, chunk_pos=np.tile(
        np.arange(16, dtype="int32"), (2, 1))))
    np.testing.assert_allclose(chunk[0], full, rtol=1e-5, atol=1e-5)
    for got, want in zip(chunk[1:], [caches[cf["feed"]] for cf in
                                     fam["cspec"]["cache_feeds"]]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_decode_solo_vs_batched_bitwise_greedy():
    """A request decoded with strangers, or in a recycled (dirty) slot,
    gives bitwise the ids it gives alone at the same geometry."""
    fam = _family()
    prompt = [3, 7, 11]

    def batcher():
        return DecodeBatcher(fam["step"], fam["dspec"], ladder=(4,),
                             ctx_ladder=(16,), start=False)

    solo_b = batcher()
    f = solo_b.submit(prompt, max_new_tokens=6)
    solo_b.drive()
    solo = _ids(f)
    bat = batcher()
    futs = [bat.submit(prompt, max_new_tokens=6),
            bat.submit([1, 2], max_new_tokens=9),
            bat.submit([5], max_new_tokens=3),
            bat.submit([8, 9, 10, 11], max_new_tokens=4)]
    bat.drive()
    assert _ids(futs[0]) == solo
    bat2 = batcher()
    [bat2.submit([5], max_new_tokens=2) for _ in range(4)]
    bat2.drive(max_steps=3)
    recycled = bat2.submit(prompt, max_new_tokens=6)
    bat2.drive()
    assert _ids(recycled) == solo


class GarbageDraft:
    def propose(self, histories, n):
        return [[1] * n for _ in histories]


class RaisingDraft:
    def propose(self, histories, n):
        raise RuntimeError("draft pass failed")


def _drive_all(bat, reqs):
    futs = [bat.submit(p, max_new_tokens=mn) for p, mn in reqs]
    bat.drive()
    return [_ids(f) for f in futs]


@pytest.mark.parametrize("arm", ["chunked", "spec_draft", "spec_garbage",
                                 "spec_raising"])
def test_fast_paths_bitwise_vs_plain(arm):
    """Chunked prefill and speculative decode (a good draft, the
    weight-sharing full program, a garbage one, and one that raises, which
    the batcher counts in ``draft_failures``) change latency, not ids: a
    mixed workload, then a request in a recycled slot, give the plain
    step-only batcher's ids bitwise."""
    fam = _family()
    reqs = [([3, 7, 11, 2, 5, 9, 4, 6, 1, 8, 2, 3], 6),
            ([1, 2], 4), ([5], 3), ([8, 9, 10, 11, 12, 13], 5)]
    again = ([3, 7, 11], 8)

    def run(**kw):
        bat = DecodeBatcher(fam["step"], fam["dspec"], ladder=(4,),
                            ctx_ladder=(32,), start=False, **kw)
        out = _drive_all(bat, reqs) + _drive_all(bat, [again])
        return out, bat.metrics(), bat.draft_failures

    want, mp, _ = run()
    kw = {"prefill": fam["prefill"]}
    if arm != "chunked":
        draft = {"spec_draft": lambda: DraftLM(
                     fam["full"], fam["full"].fetch_names[0], seq_len=16),
                 "spec_garbage": GarbageDraft,
                 "spec_raising": RaisingDraft}[arm]()
        kw["speculative"] = {"draft": draft, "k": 4}
    got, m, failures = run(**kw)
    assert got == want
    assert m["prefill_chunks"] > 0 and m["prefill_tokens"] > 0
    assert m["decode_steps"] < mp["decode_steps"]
    assert (failures > 0) == (arm == "spec_raising")
    if arm in ("spec_draft", "spec_garbage"):
        assert m["spec_accepted"] + m["spec_rejected"] > 0
    if arm == "spec_draft":
        assert draft.passes > 0 and m["spec_accepted"] > 0


def test_batcher_spans_under_a_tracer(tmp_path):
    """With a tracer started, every dispatch records one span: a
    ``decode.step`` per step, a ``prefill.chunk`` or ``spec.verify`` per
    chunk, tagged with its geometry and progress, whose sums are the
    batcher's metrics; ``flush()`` writes them to the trace dir, and after
    ``stop()`` ``span()`` is the falsy null span again."""
    import json

    from paddle_tpu_torch.obs import trace

    fam = _family()
    reqs = [([3, 7, 11, 2, 5, 9], 6), ([1, 2], 4)]
    ticks = iter(range(10 ** 6))
    tracer = trace.start(clock=lambda: float(next(ticks)),
                         trace_dir=str(tmp_path))
    try:
        assert trace.active() is tracer and trace.current() is None
        metrics = {}
        for arm, kw in (("plain", {}), ("spec", {
                "prefill": fam["prefill"],
                "speculative": {"draft": DraftLM(
                    fam["full"], fam["full"].fetch_names[0], seq_len=16),
                    "k": 4}})):
            bat = DecodeBatcher(fam["step"], fam["dspec"], ladder=(4,),
                                ctx_ladder=(32,), start=False, **kw)
            _drive_all(bat, reqs)
            metrics[arm] = bat.metrics()
        path = trace.flush()
    finally:
        assert trace.stop() is tracer
    assert trace.active() is None and trace.current() is None
    assert not trace.span("decode.step")
    spans = tracer.drain()
    with open(path) as f:
        assert [json.loads(line) for line in f] == spans
    assert all(s["dur"] > 0 and s["parent_id"] is None for s in spans)
    names = [s["name"] for s in spans]
    n_plain = metrics["plain"]["decode_steps"]
    assert names[:n_plain] == ["decode.step"] * n_plain
    spec = spans[n_plain:]
    assert len(spec) == metrics["spec"]["decode_steps"]
    assert {"prefill.chunk", "spec.verify"} <= {s["name"] for s in spec}
    for s in spans:
        keys = {"live", "bucket", "ctx", "generated"}
        if s["name"] != "decode.step":
            keys |= {"chunk", "accepted", "rejected"}
        assert set(s["tags"]) == keys and s["tags"]["bucket"] == 4
    for arm, group in (("plain", spans[:n_plain]), ("spec", spec)):
        assert sum(s["tags"]["generated"] for s in group) == 10, arm
    for key in ("accepted", "rejected"):
        assert sum(s["tags"][key] for s in spec) \
            == metrics["spec"]["spec_" + key]


def test_prefix_cache_eviction_refcount_no_corruption():
    """Prefix hits, LRU eviction under a starvation-level byte budget and
    pinning never change ids: every request through a churning cache
    matches the cache-less batcher bitwise."""
    fam = _family()
    shared = [3, 7, 11, 2, 5, 9, 4, 6]
    reqs = [(shared + [t], 4) for t in (1, 8, 13, 17, 20, 22)
            for _ in (0, 1)]

    def run_sequential(bat):
        out = []
        for p, mn in reqs:
            f = bat.submit(p, max_new_tokens=mn)
            bat.drive()
            out.append(_ids(f))
        return out

    plain = DecodeBatcher(fam["step"], fam["dspec"], ladder=(2,),
                          ctx_ladder=(16,), start=False)
    want = run_sequential(plain)
    d = TINY["d_model"]
    one_entry = 2 * TINY["n_layer"] * (len(shared) + 1) * d * 4
    cached = DecodeBatcher(fam["step"], fam["dspec"], ladder=(2,),
                           ctx_ladder=(16,), start=False,
                           prefix_cache={"max_bytes": 2 * one_entry})
    got = run_sequential(cached)
    assert got == want
    m = cached.metrics()
    assert m["prefix_hits"] > 0 and m["prefix_evictions"] > 0
    assert cached.prefix_cache.nbytes <= 2 * one_entry
    assert m["prefix_bytes"] == cached.prefix_cache.nbytes
    # entries hold clones: no entry's storage is a live cache's
    live = {c.untyped_storage().data_ptr() for c in cached._caches.values()}
    for e in cached.prefix_cache._lru.values():
        for rows in e.rows.values():
            assert rows.untyped_storage().data_ptr() not in live


def test_decode_compile_cache_soak_within_bound():
    """With prefill, speculation and the prefix cache on, a mixed soak
    never dispatches past the (batch x ctx x (1 + prefill rungs)) bound,
    and warmup runs exactly that many geometries."""
    fam = _family()
    draft = DraftLM(fam["full"], fam["full"].fetch_names[0], seq_len=16)
    bat = DecodeBatcher(fam["step"], fam["dspec"], ladder=(1, 2, 4),
                        ctx_ladder=(16, 32), prefill=fam["prefill"],
                        prefix_cache=True,
                        speculative={"draft": draft, "k": 3}, start=False)
    bound = bat.compile_cache_bound()
    assert bound == 3 * 2 * (1 + len(bat.prefill_ladder))
    rng = np.random.RandomState(7)
    for _ in range(4):
        n = int(rng.randint(1, 5))
        futs = [bat.submit(list(rng.randint(1, TINY["vocab"],
                                            size=rng.randint(1, 12))),
                           max_new_tokens=int(rng.randint(1, 8)))
                for _ in range(n)]
        bat.drive()
        assert all(f.done() for f in futs)
    assert bat.draft_failures == 0
    assert len(bat.seen_signatures) <= bound
    assert bat.warmup() == bound == len(bat.seen_signatures)


# -- ServingEngine decode mode (twins of test_serving.py:784,1097) ----------

def test_decode_engine_end_to_end():
    """Decode mode behind submit()/predict(), threaded: the same prompt
    gives the same ids, the decode gauges fill, geometries stay bounded."""
    fam = _family()
    eng = ServingEngine(fam["step"], num_replicas=1, ladder=(1, 2, 4),
                        seq_ladder=(16, 32), decode=fam["dspec"])
    try:
        assert eng.warmup() == 3 * 2
        futs = [eng.submit([3, 7, 11], max_new_tokens=6) for _ in range(5)]
        futs += [eng.submit({"prompt_ids": [4, 4]}, max_new_tokens=3)]
        outs = [f.result(30.0) for f in futs]
        for o in outs[:5]:
            np.testing.assert_array_equal(o, outs[0])
        m = eng.metrics()
        assert m["requests_completed"] == 6
        assert m["decode_tokens"] >= 6 * 3
        assert m["slot_occupancy"] is not None
        for p in ("p50", "p99"):
            assert m["ttft_s"][p] is not None
        assert m["tpot_s"]["p50"] is not None
        report = eng.metrics_report()
        for token in ("slot_occupancy", "ttft_p99_ms", "tpot_p50_ms"):
            assert token in report
        assert all(c <= 3 * 2 for c in eng.compiled_shape_counts())
    finally:
        eng.shutdown(drain=True)
    with pytest.raises(RuntimeError):
        eng.submit([1])


def test_decode_engine_from_saved_dir(tmp_path):
    """Step program + decode_spec.json on disk: ServingEngine(dir,
    decode=True, device="cpu") serves it through a plain Predictor, with
    the chunk program, a draft and the prefix cache beside it."""
    scope = tfluid.Scope()
    fam = build_family(tfluid, scope)
    ref_b = DecodeBatcher(fam["step"], fam["dspec"], ladder=(2,),
                          ctx_ladder=(16,), start=False)
    rf = ref_b.submit([3, 7, 9], max_new_tokens=5)
    ref_b.drive()
    want = rf.result(0)

    d = str(tmp_path / "lm_step_model")
    step = fam["step"]
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(
            d, step.feed_names, step._fetch_vars,
            tfluid.Executor(tfluid.CPUPlace()), main_program=step._program)
    save_decode_spec(d, fam["dspec"])
    draft = DraftLM(fam["full"], fam["full"].fetch_names[0], seq_len=16)
    fast = {"decode_prefill": fam["prefill"], "prefix_cache": True}
    for kw, fails in (({}, False),
                      (dict(fast, decode_speculative={"draft": draft,
                                                      "k": 3}), False),
                      (dict(fast, decode_speculative={
                          "draft": RaisingDraft(), "k": 3}), True)):
        eng = ServingEngine(d, decode=True, ladder=(2,), seq_ladder=(16,),
                            device="cpu", **kw)
        try:
            for _ in range(2):   # the second one hits the prefix cache
                got = eng.predict([3, 7, 9], timeout_s=30.0,
                                  max_new_tokens=5)
                np.testing.assert_array_equal(got, want)
            assert (eng.draft_failures > 0) == fails
        finally:
            eng.shutdown()
        assert eng.metrics()["prefix_hits"] == (1 if kw else 0)


def test_engine_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        ServingEngine(FakeStepModelPredictor(), seq_ladder=(16,))
    eng = ServingEngine(FakeStepModelPredictor())
    try:
        with pytest.raises(NotImplementedError):
            eng.compiled_shape_counts()
        with pytest.raises(ValueError):
            eng.submit({"x": np.zeros((1, 2))}, max_new_tokens=3)
    finally:
        eng.shutdown()


class FakeStepModelPredictor(FakeStepModel):
    feed_names = ["x"]

    def clone(self):
        return self
