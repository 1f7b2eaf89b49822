"""Sparse (SelectedRows) gradients in the port: ``tests/test_sparse.py``
for SGD, Momentum and Adam, run in ``paddle_tpu_torch``, and the same
programs against ``paddle_tpu`` from carried weights.

An ``embedding(is_sparse=True)`` table read only by lookups gets a (rows,
values) gradient; the update ops take their sparse branches (the row
scatter-add's plain version here, on the CPU). Within the port, dense and
sparse runs agree within the JAX test's rtol 2e-5 / atol 2e-6. Against
``paddle_tpu`` (its scatter kernel in interpret mode), the loss of each of
two steps and the table after them agree within rtol 1e-5 / atol 1e-6:
both packages do the same f32 arithmetic, summed in other orders."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.ops import scatter as jscatter
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.ops import scatter as tscatter

VOCAB, DIM, BATCH = 50, 8, 12
IDS = np.array([1, 4, 4, 7, 30, 30, 30, 2, 9, 9, 0, 49], dtype="int64")


@pytest.fixture(autouse=True)
def fresh_port_programs():
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


OPTS = {
    "sgd": lambda pkg, **kw: pkg.optimizer.SGD(0.1, **kw),
    "momentum": lambda pkg, **kw: pkg.optimizer.Momentum(0.1, 0.9, **kw),
    "adam": lambda pkg, **kw: pkg.optimizer.Adam(0.1, **kw),
    "adam_lazy": lambda pkg, **kw: pkg.optimizer.Adam(0.1, lazy_mode=True,
                                                      **kw),
}


def _build(pkg, is_sparse, opt, padding_idx=None, regularization=None,
           global_clip=None):
    """ids -> embedding -> fc -> squared error, in fresh programs of
    ``pkg``, minimized by ``opt(pkg, regularization=...)``."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    L = pkg.layers
    with pkg.program_guard(main, startup):
        ids = L.data("ids", shape=[1], dtype="int64")
        label = L.data("label", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[VOCAB, DIM], is_sparse=is_sparse,
                          padding_idx=padding_idx)
        d = L.elementwise_sub(L.fc(emb, size=1), label)
        loss = L.mean(L.elementwise_mul(d, d))
        if global_clip is not None:
            for p in main.all_parameters():
                p.gradient_clip_attr = global_clip
        opt(pkg, regularization=regularization).minimize(loss)
    return main, startup, loss


def _table(prog):
    return [p.name for p in prog.all_parameters()
            if tuple(p.shape) == (VOCAB, DIM)][0]


def _labels(n_steps):
    rng = np.random.RandomState(3)
    return [rng.randn(BATCH, 1).astype("f4") for _ in range(n_steps)]


def _run(is_sparse, opt, ids_batches, n_steps=1, params=None, **kw):
    """Train the port's program; returns (table, losses, main)."""
    main, startup, loss = _build(tfluid, is_sparse, opt, **kw)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        tfluid.bridge.load_program_params(scope, params, main, "cpu")
    losses = []
    for i, label in enumerate(_labels(n_steps)):
        ids = ids_batches[i % len(ids_batches)]
        out, = exe.run(main, feed={"ids": ids.reshape(-1, 1),
                                   "label": label},
                       fetch_list=[loss], scope=scope)
        losses.append(float(out))
    return scope.get(_table(main)).numpy(), losses, main


def _run_jax(opt, ids_batches, n_steps, **kw):
    """The same program trained by ``paddle_tpu``: (initial params,
    table after, losses)."""
    main, startup, loss = _build(fluid, True, opt, **kw)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        params = {p.name: np.asarray(scope.get(p.name))
                  for p in main.all_parameters()}
        for i, label in enumerate(_labels(n_steps)):
            ids = ids_batches[i % len(ids_batches)]
            out, = exe.run(main, feed={"ids": ids.reshape(-1, 1),
                                       "label": label}, fetch_list=[loss])
            losses.append(float(out))
        table = np.asarray(scope.get(_table(main)))
    return params, table, losses


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_dense_sparse_one_step_equivalence(opt):
    dense, _, _ = _run(False, OPTS[opt], [IDS])
    sparse, _, main = _run(True, OPTS[opt], [IDS])
    np.testing.assert_allclose(dense, sparse, rtol=2e-5, atol=2e-6)
    upd = [o for o in main.global_block().ops if o.type == opt
           and o.input("Param").name == _table(main)][0]
    assert upd.input("GradRows").name == _table(main) + "@GRAD@ROWS"


def test_sparse_gradient_is_rows_and_values():
    """One value row per looked-up id (duplicates unmerged), in feed
    order, equal to the dense gradient summed per id."""
    main, startup, loss = _build(tfluid, True, OPTS["sgd"])
    name = _table(main)
    gb = main.global_block()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    params = {p.name: scope.get(p.name).numpy() for p in
              main.all_parameters()}
    feed = {"ids": IDS.reshape(-1, 1), "label": _labels(1)[0]}
    rows, vals = exe.run(main, feed=feed, scope=scope, fetch_list=[
        gb.var(name + "@GRAD@ROWS"), gb.var(name + "@GRAD")])
    np.testing.assert_array_equal(rows, IDS)
    assert vals.shape == (BATCH, DIM)
    dmain, dstartup, _ = _build(tfluid, False, OPTS["sgd"])
    dscope = tfluid.Scope()
    exe.run(dstartup, scope=dscope)
    # the second build's names differ: carry by creation order
    tfluid.bridge.load_program_params(
        dscope, {d.name: params[p.name] for d, p in zip(
            dmain.all_parameters(), main.all_parameters())}, dmain, "cpu")
    dense, = exe.run(dmain, feed=feed, scope=dscope, fetch_list=[
        dmain.global_block().var(_table(dmain) + "@GRAD")])
    summed = np.zeros((VOCAB, DIM), "f4")
    np.add.at(summed, IDS, vals)
    np.testing.assert_allclose(summed, dense, rtol=1e-6, atol=1e-7)


def test_two_sparse_tables_keep_their_own_rows():
    """Two sparse tables in one program, each read by two lookups: each
    table's (rows, values) holds its own sites' ids and grads, in op
    order, and the SGD step matches the dense program's."""
    def build(pkg, is_sparse):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        L = pkg.layers
        with pkg.program_guard(main, startup):
            a = L.data("a", shape=[1], dtype="int64")
            b = L.data("b", shape=[1], dtype="int64")
            embs = [L.embedding(x, size=[VOCAB, DIM], is_sparse=is_sparse,
                                param_attr=pkg.ParamAttr(name=t))
                    for t, x in (("ta", a), ("tb", b), ("tb", a),
                                 ("ta", b))]
            h = L.concat(embs, axis=1)
            loss = L.mean(L.elementwise_mul(h, h))
            pkg.optimizer.SGD(0.5).minimize(loss)
        return main, startup
    feed = {"a": IDS.reshape(-1, 1), "b": IDS[::-1].reshape(-1, 1) % 7}
    exe = tfluid.Executor(tfluid.CPUPlace())
    tables = {}
    for is_sparse in (True, False):
        main, startup = build(tfluid, is_sparse)
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        if is_sparse:
            start = {n: scope.get(n).numpy() for n in ("ta", "tb")}
            gb = main.global_block()
            rows = exe.run(main, feed=feed, scope=scope, fetch_list=[
                gb.var("ta@GRAD@ROWS"), gb.var("tb@GRAD@ROWS")])
            np.testing.assert_array_equal(
                rows[0], np.concatenate([feed["a"], feed["b"]])[:, 0])
            np.testing.assert_array_equal(
                rows[1], np.concatenate([feed["b"], feed["a"]])[:, 0])
        else:
            tfluid.bridge.load_program_params(scope, start, main, "cpu")
            exe.run(main, feed=feed, scope=scope)
        tables[is_sparse] = {n: scope.get(n).numpy() for n in ("ta", "tb")}
    for n in ("ta", "tb"):
        assert np.abs(tables[True][n] - start[n]).max() > 0
        np.testing.assert_allclose(tables[True][n], tables[False][n],
                                   rtol=2e-5, atol=2e-6)


def test_sparse_padding_idx_row_frozen():
    """The padding row receives zero gradient on the sparse path too."""
    ids = np.array([0, 0, 3, 3, 7, 0] * 2, dtype="int64")
    main, startup, loss = _build(tfluid, True, OPTS["sgd"], padding_idx=0)
    name = _table(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    before = scope.get(name).numpy().copy()
    rows, = exe.run(main, feed={"ids": ids.reshape(-1, 1),
                                "label": np.ones((len(ids), 1), "f4")},
                    fetch_list=[main.global_block().var(name + "@GRAD@ROWS")],
                    scope=scope)
    after = scope.get(name).numpy()
    np.testing.assert_array_equal(before[0], after[0])
    assert np.abs(after[3] - before[3]).max() > 0
    # padded slots parked on the dropped sentinel row V
    np.testing.assert_array_equal(rows, np.where(ids == 0, VOCAB, ids))


def test_sparse_touches_only_fed_rows():
    ids = np.array([3, 3, 5, 17] * 3, dtype="int64")
    main, startup, loss = _build(tfluid, True, OPTS["sgd"])
    name = _table(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    before = scope.get(name).numpy().copy()
    exe.run(main, feed={"ids": ids.reshape(-1, 1),
                        "label": np.ones((len(ids), 1), "f4")},
            fetch_list=[loss], scope=scope)
    after = scope.get(name).numpy()
    touched = sorted(set(ids.tolist()))
    untouched = [r for r in range(VOCAB) if r not in touched]
    np.testing.assert_array_equal(before[untouched], after[untouched])
    assert np.abs(after[touched] - before[touched]).max() > 0


def test_sparse_table_is_not_a_leaf():
    """The step differentiates the lookup's output, not the table: the
    table in the env never requires grad, and the scope gets a new
    tensor."""
    main, startup, loss = _build(tfluid, True, OPTS["adam"])
    name = _table(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    t0 = scope.get(name)
    exe.run(main, feed={"ids": IDS.reshape(-1, 1), "label": _labels(1)[0]},
            fetch_list=[loss], scope=scope)
    t1 = scope.get(name)
    assert not t1.requires_grad and t1.data_ptr() != t0.data_ptr()
    autodiff = [o for o in main.global_block().ops if o.type == "autodiff"][0]
    assert autodiff.attr("sparse_wrt_names") == [name]


def test_sparse_adam_lazy_mode():
    """``lazy_mode=True``: rows touched in step 1 but not step 2 keep
    their step-1 value, while dense Adam moves them on the momentum."""
    step1 = np.array([5] * BATCH, dtype="int64")
    step2 = np.array([9] * BATCH, dtype="int64")
    dense, _, _ = _run(False, OPTS["adam"], [step1, step2], n_steps=2)
    sparse, _, _ = _run(True, OPTS["adam_lazy"], [step1, step2], n_steps=2)
    assert np.abs(dense[5] - sparse[5]).max() > 1e-6
    np.testing.assert_allclose(dense[0], sparse[0], rtol=1e-6)
    np.testing.assert_allclose(dense[9], sparse[9], rtol=2e-5, atol=2e-6)


def test_sparse_adam_default_is_nonlazy_dense_equivalent():
    """``lazy_mode=False``: the grad is densified and the whole table
    matches the dense run over two steps, momentum tails included."""
    step1 = np.array([5] * BATCH, dtype="int64")
    step2 = np.array([9] * BATCH, dtype="int64")
    dense, _, _ = _run(False, OPTS["adam"], [step1, step2], n_steps=2)
    sparse, _, main = _run(True, OPTS["adam"], [step1, step2], n_steps=2)
    np.testing.assert_allclose(dense, sparse, rtol=2e-5, atol=2e-6)
    adam = [o for o in main.global_block().ops if o.type == "adam"
            and o.input("Param").name == _table(main)][0]
    assert adam.attrs["_kernel_choice"]["kernel"] == "plain_scatter_add"


def test_weight_tied_table_falls_back_to_dense():
    """A sparse-marked table ALSO consumed densely (weight tying) gets a
    dense grad covering both uses."""
    L = tfluid.layers
    ids = L.data("ids", shape=[1], dtype="int64")
    emb = L.embedding(ids, size=[VOCAB, DIM], is_sparse=True)
    main = tfluid.default_main_program()
    table = main.all_parameters()[0]
    gb = main.global_block()
    logits = gb.create_var(name="tied_logits", shape=(-1, VOCAB),
                           dtype="float32")
    gb.append_op("matmul", {"X": emb, "Y": table}, {"Out": logits},
                 {"transpose_Y": True})
    loss = L.mean(logits)
    _, pg = tfluid.optimizer.SGD(0.1).minimize(loss)
    (p, g), = [x for x in pg if x[0].name == table.name]
    assert getattr(g, "sparse_rows_var", None) is None
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    grad, = exe.run(feed={"ids": IDS.reshape(-1, 1)}, fetch_list=[g])
    assert grad.shape == (VOCAB, DIM)


def test_sparse_clip_and_decay_match_dense_on_touched_rows():
    """Global-norm clipping and L2 decay on the sparse path: values count
    in the norm once per row and decay applies row-wise, so touched rows
    match the dense run; untouched rows stay (lazy decay)."""
    kw = dict(regularization=tfluid.regularizer.L2Decay(0.05),
              global_clip=tfluid.clip.GradientClipByGlobalNorm(0.01))
    dense, _, _ = _run(False, OPTS["adam"], [IDS], **kw)
    sparse, _, main = _run(True, OPTS["adam"], [IDS], **kw)
    touched = sorted(set(IDS.tolist()))
    np.testing.assert_allclose(dense[touched], sparse[touched],
                               rtol=2e-5, atol=2e-6)
    untouched = [r for r in range(VOCAB) if r not in touched]
    assert np.abs(dense[untouched] - sparse[untouched]).max() > 1e-6
    autodiff = [o for o in main.global_block().ops if o.type == "autodiff"][0]
    assert autodiff.attr("merge_sparse") is True
    assert "sparse_decay" in [o.type for o in main.global_block().ops]


def test_sparse_clip_only_matches_dense_exactly():
    """With clipping and no decay the whole table matches the dense run."""
    kw = dict(global_clip=tfluid.clip.GradientClipByGlobalNorm(0.01))
    dense, _, _ = _run(False, OPTS["sgd"], [IDS], **kw)
    sparse, _, _ = _run(True, OPTS["sgd"], [IDS], **kw)
    np.testing.assert_allclose(dense, sparse, rtol=2e-5, atol=2e-6)


def test_l1_decay_sparse_matches_dense_on_touched_rows():
    kw = dict(regularization=tfluid.regularizer.L1Decay(0.05))
    dense, _, _ = _run(False, OPTS["sgd"], [IDS], **kw)
    sparse, _, _ = _run(True, OPTS["sgd"], [IDS], **kw)
    touched = sorted(set(IDS.tolist()))
    np.testing.assert_allclose(dense[touched], sparse[touched],
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_two_sparse_steps_match_jax(opt, monkeypatch):
    """Same program, the JAX package's initial weights carried across, two
    sparse steps with a new id set each: loss per step and the table after
    both agree within rtol 1e-5 / atol 1e-6."""
    monkeypatch.setattr(jscatter, "_INTERPRET", True)
    batches = [IDS, np.array([3, 3, 3, 8, 8, 1, 0, 49, 49, 20, 21, 5],
                             dtype="int64")]
    params, want_table, want_losses = _run_jax(OPTS[opt], batches, 2)
    table, losses, _ = _run(True, OPTS[opt], batches, n_steps=2,
                            params=params)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(table, want_table, rtol=1e-5, atol=1e-6)
    start, = [a for a in params.values() if a.shape == (VOCAB, DIM)]
    assert np.abs(table - start).max() > 1e-3  # both steps moved it


def test_sparse_scatter_counts_no_kernel_launch_on_cpu():
    """On the CPU the sparse update takes the plain version and launches
    nothing."""
    before = tscatter.scatter_add.launches
    _run(True, OPTS["sgd"], [IDS])
    _run(True, OPTS["adam"], [IDS])
    assert tscatter.scatter_add.launches == before
