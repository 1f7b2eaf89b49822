"""The port's decode ops, the KV-cached ``transformer_lm`` family and its
greedy decode against ``paddle_tpu`` on the CPU, from the same inputs and
copied weights: the five decode ops (out-of-range and wrapped cache
positions, dead rows) within 1e-6; the step, chunk and full programs'
logits within 1e-5 of the largest; ``DecodeBatcher``'s greedy ids equal to
the reference's, on a chain whose smallest top-2 margin is held above
1e-3; ``sampling_id`` by its frequencies."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.models  # noqa: F401  (fluid.models, for build_family)
import paddle_tpu_torch as tfluid
from paddle_tpu.serving import DecodeBatcher as JaxDecodeBatcher
from paddle_tpu_torch.serving import DecodeBatcher

from test_torch_decode_serving import TINY, build_family, port_programs  # noqa: F401

C, B, H, D = 8, 4, 2, 3
# cache positions per row: in range, -1 (wraps to C-1), C and C+3 (drop)
STEP_POS = {"in_range": [0, 3, 7, 5], "wrap_drop": [-1, C, C + 3, 2],
            "dead_rows": [0, 0, 6, -C]}
CHUNK_POS = {"in_range": [[0, 1, 2], [4, 5, 6], [5, 6, 7], [1, 2, 3]],
             "wrap_drop": [[-1, C, 2], [C + 3, C, C], [0, -C, 7],
                           [-C - 1, 3, C + 3]]}


def _run_op(pkg, build, feed):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        out = build(pkg.layers)
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(start)
        return exe.run(main, feed=feed, fetch_list=[out])[0]


def _both(build, feed, port_programs):  # noqa: F811
    want = _run_op(fluid, build, feed)
    got = _run_op(tfluid, build, feed)
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


@pytest.mark.parametrize("case", sorted(STEP_POS))
@pytest.mark.parametrize("op", ["kv_cache_write", "cached_attention"])
def test_step_decode_op_matches_reference(op, case, port_programs):  # noqa: F811
    rng = np.random.RandomState(len(case))
    feed = {"cache": rng.normal(size=(B, C, H * D)).astype("f4"),
            "cache_v": rng.normal(size=(B, C, H * D)).astype("f4"),
            "x": rng.normal(size=(B, H * D)).astype("f4"),
            "pos": np.array(STEP_POS[case], "int32")}

    def build(L):
        cache = L.data("cache", shape=[C, H * D])
        cache_v = L.data("cache_v", shape=[C, H * D])
        x = L.data("x", shape=[H * D])
        pos = L.data("pos", shape=[], dtype="int32")
        if op == "kv_cache_write":
            return L.kv_cache_write(cache, x, pos)
        return _attend(L, "cached_attention", x, cache, cache_v, pos)

    got, want = _both(build, feed, port_programs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if op == "kv_cache_write":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CHUNK_POS))
@pytest.mark.parametrize("op", ["kv_cache_write_chunk",
                                "cached_attention_chunk"])
def test_chunk_decode_op_matches_reference(op, case, port_programs):  # noqa: F811
    rng = np.random.RandomState(len(case))
    k = 3
    feed = {"cache": rng.normal(size=(B, C, H * D)).astype("f4"),
            "cache_v": rng.normal(size=(B, C, H * D)).astype("f4"),
            "x": rng.normal(size=(B, k, H * D)).astype("f4"),
            "pos": np.array(CHUNK_POS[case], "int32")}

    def build(L):
        cache = L.data("cache", shape=[C, H * D])
        cache_v = L.data("cache_v", shape=[C, H * D])
        x = L.data("x", shape=[k, H * D])
        pos = L.data("pos", shape=[k], dtype="int32")
        if op == "kv_cache_write_chunk":
            return L.kv_cache_write_chunk(cache, x, pos)
        return _attend(L, "cached_attention_chunk", x, cache, cache_v, pos)

    got, want = _both(build, feed, port_programs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if op == "kv_cache_write_chunk":
        np.testing.assert_array_equal(got, want)


def _attend(L, op_type, q, cache_k, cache_v, pos):
    """The bare attention op (the layers wrap it in projections)."""
    helper = L.nn.LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="float32",
                                                    shape=q.shape)
    helper.append_op(op_type, {"Q": q, "CacheK": cache_k,
                               "CacheV": cache_v, "Pos": pos},
                     {"Out": out}, {"num_heads": H})
    return out


def test_sampling_id_frequencies_match_reference(port_programs):  # noqa: F811
    """20,000 draws of one distribution per package: every class count
    within 4 sigma of N p (a categorical draw; never bitwise)."""
    n = 20000
    p = np.array([0.05, 0.1, 0.25, 0.6, 0.0], "f4")
    feed = {"x": np.tile(p, (n, 1))}

    def build(L):
        return L.sampling_id(L.data("x", shape=[len(p)]))

    dtypes = set()
    for pkg in (fluid, tfluid):
        ids = np.asarray(_run_op(pkg, build, feed))
        assert ids.shape == (n,)
        dtypes.add(ids.dtype)
        counts = np.bincount(ids, minlength=len(p))
        sigma = np.sqrt(n * p * (1 - p))
        assert np.all(np.abs(counts - n * p) <= 4 * sigma + 1e-9), \
            (pkg.__name__, counts)
    assert dtypes == {np.dtype("int32")}


# -- the LM family on copied weights ----------------------------------------

@pytest.fixture
def families(port_programs):  # noqa: F811
    """The reference family initialised by its own startup, and the
    port's with the same weights copied across by name (one copy serves
    all three programs)."""
    jscope = fluid.Scope()
    jfam = build_family(fluid, jscope)
    params = {p.name: np.asarray(jscope.get(p.name))
              for p in jfam["full_main"].all_parameters()}
    tscope = tfluid.Scope()
    tfam = build_family(tfluid, tscope, init=False)
    tfluid.bridge.load_program_params(tscope, params, tfam["full_main"],
                                      "cpu")
    return jfam, tfam


def _close(got, want, tol=1e-5):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def test_lm_family_logits_match_reference(families):
    jfam, tfam = families
    rng = np.random.RandomState(1)
    ids = rng.randint(0, TINY["vocab"], (2, 16)).astype("int64")
    want, = jfam["full"].run({"ids": ids, "lbl": ids})
    got, = tfam["full"].run({"ids": ids, "lbl": ids})
    _close(got, want)
    # 6 teacher-forced steps, then a chunk over the next 6 positions on
    # the caches the steps left, through both packages
    caches = {"j": None, "t": None}
    for key, fam in (("j", jfam), ("t", tfam)):
        feeds = fam["dspec"]["cache_feeds"]
        cache = {cf["feed"]: np.zeros((2, 16, TINY["d_model"]), "f4")
                 for cf in feeds}
        logits = []
        for t in range(6):
            outs = fam["step"].run(dict(cache, tok_ids=ids[:, t],
                                        pos=np.full((2,), t, "int32")))
            logits.append(np.asarray(outs[0]))
            cache = {cf["feed"]: np.asarray(a)
                     for cf, a in zip(feeds, outs[1:])}
        cpos = np.tile(np.arange(6, 12, dtype="int32"), (2, 1))
        outs = fam["chunk"].run(dict(cache, tok_chunk=ids[:, 6:12],
                                     chunk_pos=cpos))
        caches[key] = (np.stack(logits, 1), np.asarray(outs[0]),
                       [np.asarray(a) for a in outs[1:]])
    (js, jc, jk), (ts, tc, tk) = caches["j"], caches["t"]
    _close(ts, js)
    _close(tc, jc)
    _close(ts, want[:, :6])
    _close(tc, want[:, 6:12])
    for a, b in zip(tk, jk):
        _close(a, b)


def test_greedy_ids_match_reference(families):
    """``DecodeBatcher`` on both packages, one mixed workload: equal ids,
    on chains whose every step has a top-2 margin above 1e-3 (so the
    equality is not a tie broken the same way)."""
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
    margins = []
    for (prompt, _n), gen in zip(reqs, out["t"]):
        seq = np.array(prompt + gen, "int64")
        ids = np.zeros((1, 16), "int64")
        ids[0, :len(seq)] = seq
        logits, = tfam["full"].run({"ids": ids, "lbl": ids})
        for j in range(len(gen)):
            row = np.sort(logits[0, len(prompt) - 1 + j])
            assert int(np.argmax(logits[0, len(prompt) - 1 + j])) == gen[j]
            margins.append(row[-1] - row[-2])
    assert min(margins) > 1e-3, min(margins)


def test_lookup_out_of_range_ids_match_reference(port_programs):  # noqa: F811
    """A lookup marked ``out_of_range="fill"`` indexes as ``jnp.take``
    does: -1 wraps, V and V + 3 give rows of NaN (the decode chunk's pad
    lanes feed position C to a table of C rows), at a width the reference
    gathers unpacked. Only the chunk program's position lookup is marked;
    every other lookup stays one plain row index."""
    v, k = 6, 200
    rng = np.random.RandomState(0)
    table = rng.normal(size=(v, k)).astype("f4")
    ids = np.array([[0, v - 1, -1], [v, v + 3, 2]], "int64")
    got = {}
    for pkg in (fluid, tfluid):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start):
            out = pkg.layers.embedding(
                pkg.layers.data("ids", shape=[3], dtype="int64"),
                size=[v, k], param_attr=pkg.ParamAttr(name="w"))
        if pkg is tfluid:
            out.op.attrs["out_of_range"] = "fill"
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(start)
        if pkg is fluid:
            scope.set("w", table)
        else:
            tfluid.bridge.load_numpy_params(scope, {"w": table}, "cpu")
        with pkg.scope_guard(scope):
            got[pkg.__name__] = np.asarray(
                exe.run(main, feed={"ids": ids}, fetch_list=[out])[0])
    np.testing.assert_array_equal(got["paddle_tpu_torch"], got["paddle_tpu"])
    assert np.isnan(got["paddle_tpu_torch"][1, :2]).all()
    np.testing.assert_array_equal(got["paddle_tpu_torch"][0, 2], table[-1])
    fam = build_family(tfluid, tfluid.Scope())
    for name in ("step", "chunk", "full"):
        marked = [op.input("W").name
                  for op in fam[name]._program.global_block().ops
                  if op.type == "lookup_table"
                  and op.attr("out_of_range") == "fill"]
        assert marked == (["lm_pos_emb"] if name == "chunk" else []), name
