"""The captured decode dispatch on the CPU: the serving tier lends each
(batch, ctx) rung's KV caches to the executor, the cache writes go into
them in place, and the step and chunk programs are captured over them
(the CPU stand-in for the graph, ``test_torch_captured_step.EagerGraph``,
replays the body eagerly):

* the in-place ``cache_write_`` equals the reference's ``kv_cache_write``
  and ``kv_cache_write_chunk`` exactly, for every position in [-C-2, C+2]
  (pad lanes at C included), into a ``lendable_cache``, and a lent cache
  of any other layout is refused;
* every step and chunk dispatch of a captured batcher (lent caches)
  equals the same dispatch of an interpreted one (``use_program_cache=
  False``, lent caches) bitwise, logits and the caches each row can
  reach, across re-buckets, prefix installs and speculative rewinds, and
  one over unlent caches (the out-of-place write, row-major caches whose
  products the CPU sums in another order) within 1e-5, with equal ids;
* a harvested prefix entry and an unlent fed cache are never written;
* the greedy ids of a captured batcher equal the reference's."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.serving import DecodeBatcher as JaxDecodeBatcher
from paddle_tpu_torch.core.opimpl.attention_ops import (cache_write_,
                                                        lendable_cache)
from paddle_tpu_torch.serving import DecodeBatcher, DraftLM

from test_torch_captured_step import cpu_capture  # noqa: F401
from test_torch_decode import families  # noqa: F401
from test_torch_decode_serving import TINY, build_family, port_programs  # noqa: F401

C, D = 8, 6
STEP_POSITIONS = list(range(-C - 2, C + 3))   # one row each


def _write_program(pkg, op, k):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        cache = pkg.layers.data("cache", shape=[C, D])
        if op == "kv_cache_write":
            x = pkg.layers.data("x", shape=[D])
            pos = pkg.layers.data("pos", shape=[], dtype="int32")
            out = pkg.layers.kv_cache_write(cache, x, pos)
        else:
            x = pkg.layers.data("x", shape=[k, D])
            pos = pkg.layers.data("pos", shape=[k], dtype="int32")
            out = pkg.layers.kv_cache_write_chunk(cache, x, pos)
    return main, out


@pytest.mark.parametrize("op", ["kv_cache_write", "kv_cache_write_chunk"])
def test_in_place_write_matches_reference(op, port_programs):  # noqa: F811
    rng = np.random.RandomState(5)
    if op == "kv_cache_write":
        b, k = len(STEP_POSITIONS), 1
        pos = np.array(STEP_POSITIONS, "int32")
        x = rng.normal(size=(b, D)).astype("f4")
    else:
        # each row's lanes: distinct positions of [-C-2, C+2], pads at C
        b, k = 6, 5
        pos = np.stack([rng.permutation(STEP_POSITIONS)[:k]
                        for _ in range(b)]).astype("int32")
        pos[:, -1] = C
        pos[0, 1:] = C
        x = rng.normal(size=(b, k, D)).astype("f4")
    cache = rng.normal(size=(b, C, D)).astype("f4")
    feed = {"cache": cache, "x": x, "pos": pos}
    main, out = _write_program(fluid, op, k)
    with fluid.scope_guard(fluid.Scope()):
        want, = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                     fetch_list=[out])
    main, out = _write_program(tfluid, op, k)
    lent = lendable_cache(b, C, (D,), torch.float32, "cpu")
    lent.copy_(torch.from_numpy(cache))
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, = exe.run(main, feed=dict(feed, cache=lent), fetch_list=[out],
                   scope=tfluid.Scope(), return_numpy=False,
                   _lend=("cache",))
    assert got is lent
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    unlent, = exe.run(main, feed=feed, fetch_list=[out],
                      scope=tfluid.Scope())
    np.testing.assert_array_equal(unlent, np.asarray(want))
    np.testing.assert_array_equal(feed["cache"], cache)


# lent caches whose position C is not a scratch column of their own: no
# room for it, room in a row-major buffer, and the live position C of a
# wider lendable cache
REFUSED_LAYOUTS = {
    "dense": lambda: torch.zeros(2, C, D),
    "row_major_view": lambda: torch.zeros(2, C + 1, D)[:, :C],
    "wider_lendable_view": lambda: lendable_cache(
        2, C + 1, (D,), torch.float32, "cpu")[:, :C],
}


@pytest.mark.parametrize("layout", sorted(REFUSED_LAYOUTS))
def test_lent_cache_needs_a_scratch_column(layout):
    cache = REFUSED_LAYOUTS[layout]()
    before = cache.clone()
    with pytest.raises(ValueError, match="scratch column"):
        cache_write_(cache, torch.ones(2, 1, D),
                     torch.full((2, 1), C, dtype=torch.int32))
    assert torch.equal(cache, before)


def test_lent_feed_read_elsewhere_is_refused(port_programs):  # noqa: F811
    L = tfluid.layers
    cache = L.data("cache", shape=[C, D])
    x = L.data("x", shape=[D])
    pos = L.data("pos", shape=[], dtype="int32")
    out = L.elementwise_add(L.kv_cache_write(cache, x, pos), cache)
    feed = {"cache": lendable_cache(2, C, (D,), torch.float32, "cpu"),
            "x": np.zeros((2, D), "f4"), "pos": np.zeros(2, "int32")}
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(ValueError, match="lent feed 'cache' is read by "
                                         "op 'elementwise_add'"):
        exe.run(feed=feed, fetch_list=[out], _lend=("cache",))
    with pytest.raises(ValueError, match="lent feed 'x' must be"):
        exe.run(feed=feed, fetch_list=[out], _lend=("x",))


class Recorder:
    """A predictor that records each dispatch: its logits at the lanes
    live rows write and, for each live row, its cache up to its fill level
    or the last position the dispatch wrote, whichever is further. Arms:
    ``captured`` (lent caches, the executor's cache on), ``interpreted``
    (lent, ``use_program_cache=False``), ``unlent``."""

    def __init__(self, pred, arm):
        self.pred = pred
        self.arm = arm
        self._lends_feeds = arm != "unlent"
        self.fetch_names = pred.fetch_names
        self.device = pred.device
        self.spec = None
        self.bat = None
        self.log = []

    def step_report(self):
        return self.pred.step_report()

    def run(self, feed, return_numpy=True, **kw):
        pos = np.asarray(feed[self.spec["pos_feed"]])
        pos = pos.reshape(pos.shape[0], -1)
        fill = {i: s.pos for i, s in enumerate(self.bat._slots)
                if s is not None}
        if self.arm == "interpreted":
            p = self.pred
            outs = p._exe.run(p._program, feed=feed,
                              fetch_list=p._fetch_vars, scope=p._scope,
                              return_numpy=return_numpy,
                              use_program_cache=False, donate_state=False,
                              **kw)
        else:
            outs = self.pred.run(feed, return_numpy=return_numpy, **kw)
        caches = []
        for cf, t in zip(self.spec["cache_feeds"], outs[1:]):
            for i, f in fill.items():
                top = max([f - 1] + [int(p) for p in pos[i]
                                     if p < t.shape[1]]) + 1
                caches.append(t[i, :top].clone())
        # a pad lane (pos == C) attends every position of its row: its
        # logits, which the batcher ignores, read unreachable rows
        lg = outs[0].reshape(pos.shape + (-1,))
        lanes = [lg[i, j] for i in fill for j in range(pos.shape[1])
                 if pos[i, j] < outs[1].shape[1]]
        self.log.append((torch.stack(lanes) if lanes else lg[:0, 0],
                         caches))
        return outs


def _runs(pred):
    """The runs of every cache entry of ``pred``'s program, summed."""
    tot = dict.fromkeys(("interpreted", "captures", "replays"), 0)
    for entry in pred._exe._cache.values():
        if entry.program() is pred._program:
            for k in tot:
                tot[k] += entry.runs[k]
    return tot


def _recorded_batcher(fam, mode, arm):
    step = Recorder(fam["step"], mode)
    step.spec = fam["dspec"]
    kw = {}
    chunk = None
    if arm != "plain":
        chunk = Recorder(fam["chunk"], mode)
        chunk.spec = fam["cspec"]
        kw["prefill"] = {"predictor": chunk, "spec": fam["cspec"],
                         "ladder": (4, 8)}
    if arm == "speculative":
        kw["speculative"] = {"draft": DraftLM(
            fam["full"], fam["full"].fetch_names[0], seq_len=16), "k": 4}
    bat = DecodeBatcher(step, fam["dspec"], ladder=(1, 2, 4),
                        ctx_ladder=(16, 32), start=False,
                        prefix_cache={"max_bytes": 1 << 20}, **kw)
    for rec in (step, chunk):
        if rec is not None:
            rec.bat = bat
    return bat, [r for r in (step, chunk) if r is not None]


@pytest.mark.parametrize("arm", ["plain", "chunked", "speculative"])
def test_lent_dispatches_equal_interpreted_bitwise(arm, cpu_capture):  # noqa: F811
    """One workload through a batcher whose dispatches are captured over
    lent caches, one interpreted over lent caches and one over unlent
    caches: every dispatch's logits and reachable caches are bitwise equal
    between the first two and within 1e-5 of the third, and the ids are
    equal. The workload moves the geometry up and down (re-buckets),
    repeats a prompt (prefix installs) and, speculating, rejects drafts
    (rewinds)."""
    fam = build_family(tfluid, tfluid.Scope())
    shared = [3, 7, 11, 2, 5, 9, 4, 6, 1]
    waves = [[(shared + [12], 5)],
             [(shared + [13], 6), ([1, 2], 9), ([5], 3)],
             [(shared + [14], 12), ([8, 9, 10], 2)],
             [([4] * 13, 14)]]
    out = {}
    for mode in ("captured", "interpreted", "unlent"):
        bat, recs = _recorded_batcher(fam, mode, arm)
        bat.warmup()   # each geometry twice: captured from the start
        for r in recs:
            del r.log[:]
        ids = []
        for wave in waves:
            futs = [bat.submit(p, max_new_tokens=n) for p, n in wave]
            bat.drive()
            ids += [[int(t) for t in f.result(0)] for f in futs]
        out[mode] = (ids, [r.log for r in recs], bat, bat.step_report(),
                     [_runs(r.pred) for r in recs])
    ids_c, logs_c, bat_c, reports, runs = out["captured"]
    for mode, exact in (("interpreted", True), ("unlent", False)):
        ids_o, logs_o = out[mode][:2]
        assert ids_c == ids_o, mode
        assert [len(g) for g in logs_c] == [len(g) for g in logs_o]
        for log_c, log_o in zip(logs_c, logs_o):
            for n, ((lg_c, ca_c), (lg_o, ca_o)) in enumerate(
                    zip(log_c, log_o)):
                msg = "%s dispatch %d" % (mode, n)
                pairs = [(lg_c, lg_o)] + list(zip(ca_c, ca_o))
                for a, b in pairs:
                    if exact:
                        np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                                      err_msg=msg)
                    else:
                        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                                   rtol=1e-5, atol=1e-5,
                                                   err_msg=msg)
    m = bat_c.metrics()
    assert m["prefix_hits"] > 0
    assert len(bat_c._rungs) > 1   # the geometry moved
    if arm == "speculative":
        assert m["spec_rejected"] > 0
    # the chunk program carries every dispatch when speculating
    assert logs_c[-1] and (arm == "speculative" or logs_c[0])
    for (name, r), n, log in zip(reports.items(), runs, logs_c):
        assert r["captured"] and r["reason"] == "admitted", (name, r)
        # warmup captured every geometry; each dispatch after replayed
        assert n["captures"] >= 1 and n["replays"] >= len(log), (name, n)
    for mode, why in (("interpreted", "use_program_cache=False"),
                      ("unlent", "op 'kv_cache_write")):
        for name, r in out[mode][3].items():
            assert not r["captured"] and r["reason"].startswith(why), (
                mode, name, r)


def test_no_aliasing_of_prefix_entries_or_unlent_feeds(cpu_capture):  # noqa: F811
    """Dispatches after a harvest leave the prefix entry as it was
    harvested; a cache fed through the public ``run`` is never written,
    captured or not."""
    fam = build_family(tfluid, tfluid.Scope())
    bat = DecodeBatcher(fam["step"], fam["dspec"], ladder=(2,),
                        ctx_ladder=(16,), start=False,
                        prefix_cache={"max_bytes": 1 << 20})
    prompt = [3, 7, 11, 2, 5]
    f = bat.submit(prompt, max_new_tokens=3)
    bat.drive()
    f.result(0)
    entry = next(iter(bat.prefix_cache._lru.values()))
    kept = {n: r.clone() for n, r in entry.rows.items()}
    lent = {n: c.untyped_storage().data_ptr()
            for n, c in bat._caches.items()}
    for n, r in entry.rows.items():
        assert r.untyped_storage().data_ptr() != lent[n]
    futs = [bat.submit(prompt + [9], max_new_tokens=4),
            bat.submit([6, 6], max_new_tokens=5)]
    bat.drive()
    assert bat.metrics()["prefix_hits"] == 1
    assert all(fu.done() for fu in futs)
    for n, r in entry.rows.items():
        assert torch.equal(r, kept[n]), n
    # the public run: a fed cache (tensor or array) stays as it was
    pred = fam["step"]
    spec = fam["dspec"]
    caches = {cf["feed"]: torch.randn(2, 16, TINY["d_model"])
              for cf in spec["cache_feeds"]}
    before = {n: c.clone() for n, c in caches.items()}
    for _ in range(3):   # call 1, the capture rule's refusal, again
        pred.run(dict(caches, tok_ids=np.array([1, 2]),
                      pos=np.array([0, 3], "int32")), return_numpy=False)
    for n, c in caches.items():
        assert torch.equal(c, before[n]), n


def test_captured_greedy_ids_match_reference(families, cpu_capture):  # noqa: F811
    """``DecodeBatcher`` on both packages, the port's dispatches captured
    over lent caches (test_torch_decode's workload and margin): equal
    ids."""
    jfam, tfam = families
    reqs = [([3, 7, 11], 8), ([1, 2], 9), ([5], 6),
            ([8, 9, 10, 11, 12, 13], 5)]
    out = {}
    for key, cls, fam in (("j", JaxDecodeBatcher, jfam),
                          ("t", DecodeBatcher, tfam)):
        bat = cls(fam["step"], fam["dspec"], ladder=(4,),
                  ctx_ladder=(16,), start=False)
        futs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
        bat.drive()
        out[key] = [[int(t) for t in np.asarray(f.result(0))] for f in futs]
    assert out["t"] == out["j"]
    report = tfam["step"].step_report()
    assert report["captured"] and report["graph"] and report["replays"] > 0
