"""The port's row scatter-add (``paddle_tpu_torch/ops/scatter.py``, its
plain version on the CPU) against ``paddle_tpu``'s Pallas kernel run by
the Pallas interpreter (``tests/test_scatter.py``'s pattern), on the same
numpy inputs: the shape grid of that test in f32, with and without the
sorted-segment merge, drop and wrap of rows in [-2V, 2V), heavy duplicates
and multi-dim rows; ``merge_sparse_rows`` against the JAX one; the
recorded path and the wrapper's refusals. Tolerances are the JAX test's own:
1e-6 (the plain version and ``.at[].add`` both add in slot order) and 1e-4
where 500 slots land on one row."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.op_registry import merge_sparse_rows as j_merge
from paddle_tpu.ops import scatter as jscatter
from paddle_tpu_torch.core.framework import Operator
from paddle_tpu_torch.core.op_registry import merge_sparse_rows as t_merge
from paddle_tpu_torch.ops import scatter as tscatter


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jscatter, "_INTERPRET", True)


def _both(base, rows, vals, sort=False):
    want = jscatter.scatter_add_rows(jnp.asarray(base), jnp.asarray(rows),
                                     jnp.asarray(vals), sort=sort)
    got = tscatter.scatter_add_rows(torch.from_numpy(base),
                                    torch.from_numpy(rows),
                                    torch.from_numpy(vals), sort=sort)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("v,k,n", [(100, 16, 333), (50, 8, 64),
                                   (33, 32, 7), (257, 4, 1025),
                                   (120, 128, 40)])
def test_scatter_matches_jax_kernel(sort, v, k, n, rng):
    base = rng.randn(v, k).astype("f4")
    rows = rng.randint(0, v, size=(n,)).astype("i4")
    vals = rng.randn(n, k).astype("f4")
    got, want = _both(base, rows, vals, sort)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sort", [False, True])
def test_scatter_drop_and_wrap_match_jax(sort, rng):
    """Rows in [-V, 0) wrap python-style, every other out-of-range row
    drops: the exact ``.at[].add(mode="drop")`` contract."""
    v, k = 40, 16
    base = rng.randn(v, k).astype("f4")
    rows = rng.randint(-2 * v, 2 * v, size=(200,)).astype("i4")
    vals = rng.randn(200, k).astype("f4")
    got, want = _both(base, rows, vals, sort)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    dropped = (rows < -v) | (rows >= v)
    assert dropped.any() and ((rows < 0) & ~dropped).any()


@pytest.mark.parametrize("sort", [False, True])
def test_scatter_heavy_duplicates_match_jax(sort, rng):
    """Every slot on one row: 500 values summed in slot order."""
    v, k, n = 64, 16, 500
    base = np.zeros((v, k), "f4")
    rows = np.full((n,), 7, "i4")
    vals = rng.randn(n, k).astype("f4")
    got, want = _both(base, rows, vals, sort)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[7], vals.sum(0), rtol=1e-4, atol=1e-4)
    assert not np.delete(got, 7, axis=0).any()


def test_scatter_multi_dim_rows_match_jax(rng):
    """[B, F] rows with [B, F, K] vals flatten as the lookup sites give
    them."""
    v, k = 30, 8
    base = np.zeros((v, k), "f4")
    rows = rng.randint(0, v, size=(6, 4)).astype("i4")
    vals = rng.randn(6, 4, k).astype("f4")
    got, want = _both(base, rows, vals)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scatter_returns_new_tensor_unless_inplace(rng):
    base = torch.from_numpy(rng.randn(10, 4).astype("f4"))
    before = base.clone()
    rows = torch.tensor([1, 1, 3], dtype=torch.int32)
    vals = torch.ones(3, 4)
    out = tscatter.scatter_add_rows(base, rows, vals)
    assert torch.equal(base, before) and out.data_ptr() != base.data_ptr()
    assert torch.equal(out[1], before[1] + 2)
    same = tscatter.scatter_add_rows(base, rows, vals, inplace=True)
    assert same.data_ptr() == base.data_ptr() and torch.equal(same, out)


def test_scatter_int64_rows_and_cast_vals(rng):
    """int64 rows and f64 vals are taken as the table's index and dtype."""
    base = rng.randn(12, 3).astype("f4")
    rows = np.array([0, 11, -1, 12, 5], "i8")
    vals = rng.randn(5, 3)
    got = tscatter.scatter_add_rows(torch.from_numpy(base),
                                    torch.from_numpy(rows),
                                    torch.from_numpy(vals))
    want = np.asarray(jscatter.scatter_add_rows(
        jnp.asarray(base), jnp.asarray(rows.astype("i4")),
        jnp.asarray(vals.astype("f4"))))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width", [1, 8])
def test_merge_sparse_rows_matches_jax(width, rng):
    """Each row once, ascending, with its values summed; duplicate slots on
    the sentinel with zeros; the static length kept."""
    n, v = 40, 9
    rows = rng.randint(0, v, size=(n,)).astype("i4")
    rows[::7] = v  # slots already parked on the sentinel
    vals = rng.randn(n, width).astype("f4")
    jr, jv = j_merge(jnp.asarray(rows), jnp.asarray(vals), v)
    tr, tv = t_merge(torch.from_numpy(rows), torch.from_numpy(vals), v)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    assert tr.shape == (n,) and tv.shape == (n, width)


def test_merge_sparse_rows_empty():
    rows = torch.zeros(0, dtype=torch.int32)
    vals = torch.zeros(0, 4)
    r, v = t_merge(rows, vals, 5)
    assert r.shape == (0,) and v.shape == (0, 4)


def test_gate_records_kernel_choice():
    """The consuming op records the path the call took; a table off the
    CPU takes the kernel if it is f32 and raises otherwise (a ``meta``
    table stands for a card's here: the refusal comes before any data is
    read). No library scatter stands in for the kernel."""
    op = Operator(None, "adam")
    out = tscatter.scatter_add_rows(torch.zeros(100, 32),
                                    torch.tensor([1, 1, 99]),
                                    torch.ones(3, 32), op=op)
    assert op.attrs["_kernel_choice"] == {"kernel": "plain_scatter_add"}
    assert out[1].tolist() == [2.0] * 32 and float(out.sum()) == 96.0
    for dtype in (torch.int32, torch.bfloat16, torch.float64):
        op = Operator(None, "sgd")
        with pytest.raises(NotImplementedError, match="AMP"):
            tscatter.scatter_add_rows(
                torch.zeros(5, 2, dtype=dtype, device="meta"),
                torch.tensor([1, 1, 9], device="meta"),
                torch.ones(3, 2, dtype=dtype, device="meta"), op=op)
        assert "_kernel_choice" not in op.attrs
    # an int table on the CPU takes the plain version, exactly
    out = tscatter.scatter_add_rows(torch.zeros(5, 2, dtype=torch.int32),
                                    torch.tensor([1, 1, 9]),
                                    torch.ones(3, 2, dtype=torch.int32))
    assert out.tolist() == [[0, 0], [2, 2], [0, 0], [0, 0], [0, 0]]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: no quiet fallback."""
    before = tscatter.scatter_add.launches
    with pytest.raises(ValueError, match="tensors on cpu"):
        tscatter.scatter_add(torch.zeros(4, 2),
                             torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, 2))
    with pytest.raises(TypeError, match="int32 rows"):
        tscatter.scatter_add(torch.zeros(4, 2), torch.zeros(3).long(),
                             torch.zeros(3, 2))
    with pytest.raises(ValueError, match="do not match"):
        tscatter.scatter_add(torch.zeros(4, 2),
                             torch.zeros(3, dtype=torch.int32),
                             torch.zeros(2, 2))
    with pytest.raises(ValueError, match="empty"):
        tscatter.scatter_add(torch.zeros(0, 2),
                             torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, 2))
    assert tscatter.scatter_add.launches == before


def _ids(kind, n, v, rng):
    """numpy int32 ids for ``n`` slots of a ``v``-row table."""
    if kind == "uniform":
        return rng.randint(0, v, size=(n,)).astype("i4")
    if kind == "wrap_drop":
        return rng.randint(-2 * v, 2 * v, size=(n,)).astype("i4")
    if kind == "one_row":
        return np.full((n,), 7, "i4")
    if kind == "zipf":
        return ((rng.zipf(1.2, n) - 1) % v).astype("i4")
    # a hot row whose slots straddle every chunk boundary, among uniform ids
    r = rng.randint(0, v, size=(n,)).astype("i4")
    for c in range(CHUNK, n, CHUNK):
        r[c - 3:c + 3] = 5
    return r


CHUNK = 128
ID_KINDS = ["uniform", "wrap_drop", "one_row", "zipf", "straddle"]


def _row_mass(v, k, rows, vals):
    return tscatter.scatter_add_plain(torch.zeros(v, k), torch.from_numpy(
        rows), torch.from_numpy(np.abs(vals))).clamp_min(1.0).numpy()


@pytest.mark.parametrize("chunk", [CHUNK, 1024])
@pytest.mark.parametrize("kind", ID_KINDS)
def test_chunked_emulation_matches_jax_and_plain(kind, chunk, rng):
    """The kernel's per-chunk aggregation (sum each chunk's duplicate
    rows, then add each sum once), in many chunks and in one, against the
    Pallas kernel in interpret mode and the plain version, within the
    card's tolerance: 1e-5 * max(1, sum over the row's slots of |vals|)."""
    v, k, n = 300, 8, 1000
    base = rng.randn(v, k).astype("f4")
    rows = _ids(kind, n, v, rng)
    vals = rng.randn(n, k).astype("f4")
    plan = tscatter.ScatterPlan(4, chunk, 2, -(-n // chunk), 6)
    got = tscatter.scatter_add_chunked_emulated(
        torch.from_numpy(base), torch.from_numpy(rows),
        torch.from_numpy(vals), plan).numpy()
    want = np.asarray(jscatter.scatter_add_rows(
        jnp.asarray(base), jnp.asarray(rows), jnp.asarray(vals)))
    plain = tscatter.scatter_add_plain(torch.from_numpy(base),
                                       torch.from_numpy(rows),
                                       torch.from_numpy(vals)).numpy()
    tol = 1e-5 * _row_mass(v, k, rows, vals)
    assert (np.abs(got - want) <= tol).all()
    assert (np.abs(got - plain) <= tol).all()


def test_chunked_emulation_drops_sorted_sentinels(rng):
    """``sort=True`` merges duplicates first and parks the merged slots on
    the sentinel row V, which the kernel drops like any row out of range."""
    v, k, n = 64, 32, 700
    base = rng.randn(v, k).astype("f4")
    rows = _ids("zipf", n, v, rng)
    vals = rng.randn(n, k).astype("f4")
    mr, mv = t_merge(torch.from_numpy(rows).long(), torch.from_numpy(vals),
                     v)
    assert int((mr == v).sum()) > 0
    plan = tscatter.scatter_plan(n, k, True, 1)
    got = tscatter.scatter_add_chunked_emulated(torch.from_numpy(base), mr,
                                                mv, plan).numpy()
    want = np.asarray(jscatter.scatter_add_rows(
        jnp.asarray(base), jnp.asarray(rows), jnp.asarray(vals), sort=True))
    tol = 1e-5 * _row_mass(v, k, rows, vals)
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("n", [0, 1, 7, 851968])
@pytest.mark.parametrize("k", [1, 4, 16, 32, 33, 128])
@pytest.mark.parametrize("aligned", [True, False])
def test_scatter_plan_fits_the_kernel(n, k, aligned):
    """Always a plan: float4 only for K % 4 == 0 on aligned tensors; lanes
    per group a power of two covering K's column groups up to 32; chunks
    within the kernel's 1024 slots; ceil(N / chunk) blocks, none empty."""
    for sms in (1, 132):
        p = tscatter.scatter_plan(n, k, aligned, sms)
        assert p.vec == (4 if aligned and k % 4 == 0 else 1)
        cols = k // p.vec
        assert p.group in (1, 2, 4, 8, 16, 32)
        assert p.group >= min(cols, 32) and (p.group == 1
                                             or p.group // 2 < cols)
        assert 1 <= p.chunk <= 1024 and p.per_sm == 6
        assert p.blocks == -(-n // p.chunk)
        assert n == 0 or (p.blocks - 1) * p.chunk < n  # no empty block
        assert n == 0 or p.chunk >= min(n, 128)
    # the DeepFM step fills whole waves of 6 blocks an SM
    deepfm = tscatter.scatter_plan(851968, 32, True, 132)
    assert deepfm.blocks % (132 * 6) == 0 and deepfm.chunk == 538
    # a batch of 256 leaves SMs without a block: 128-slot chunks
    assert tscatter.scatter_plan(256 * 26, 32, True, 132).chunk == 128


def test_scatter_plan_refuses_nonsense():
    for args in ((-1, 4, True, 1), (3, 0, True, 1), (3, 4, True, 0)):
        with pytest.raises(ValueError, match="scatter_plan"):
            tscatter.scatter_plan(*args)


@pytest.mark.parametrize("py_name,c_name", [("_BLOCKS_PER_SM", "MIN_BLOCKS"),
                                            ("_MAX_CHUNK", "MAX_CHUNK")])
def test_scatter_plan_limits_match_the_kernel_source(py_name, c_name):
    """The plan's resident blocks an SM and largest chunk are the kernel's
    ``__launch_bounds__`` minimum and shared-memory chunk, read from
    csrc/scatter_add.cu, so the waves the plan sizes are the card's."""
    src = os.path.join(os.path.dirname(tscatter.__file__), os.pardir, "csrc",
                       "scatter_add.cu")
    with open(src) as f:
        found = re.findall(r"constexpr int %s = (\d+);" % c_name, f.read())
    assert found == [str(getattr(tscatter, py_name))]
