"""The RNN and sequence builders of the port against ``paddle_tpu``'s
(``models/stacked_lstm.py``, ``label_semantic_roles.py``, ``books.py``,
``ocr_ctc.py``, ``word2vec.py`` with its nce and hsigmoid losses), at the
small sizes of ``tests/test_models.py``.

Each builds the same program in both packages, var for var and name for
name, and takes one Adam step from the same initial state (the port's
startup run, set into the reference's scope): the loss within atol 2e-5
/ rtol 1e-4, every gradient within 1e-4 relative L2, and every parameter
after the step within atol 1e-4 / rtol 1e-4 (f32 sums in other orders;
Adam moves an element by about its rate where its gradient is within
rounding of zero). SRL's Viterbi path, fetched from the same step, is
equal. The narrow dense tables (K dividing 128) take the row
scatter-add's plain version for their backward on the CPU and record it.

nce draws its negatives from a generator: both sides take the op's
``seed`` 7, the reference draws with ``jax.random.PRNGKey(7)``
(``paddle_tpu/core/opimpl/loss_ops.py:189-195``, repeated here), and the
port's sampler is replaced by those same negatives; the port's own
sampler is held by its frequencies in ``test_torch_crf_ctc_losses.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch.core.opimpl import loss_ops as t_loss_ops
from test_torch_optimizers import (assert_same_startup,  # noqa: F401
                                   fresh_port_programs)
from test_torch_training import _signature

TOL = dict(atol=2e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_REL_L2 = 1e-4
NCE_SEED = 7

BUILDERS = {
    "stacked_lstm": (lambda m: m.stacked_lstm.stacked_lstm_net(
        dict_size=100, emb_dim=16, hid_dim=16, stacked_num=3, seq_len=12),
        4),
    "srl_crf": (lambda m: m.label_semantic_roles.srl_crf(), 4),
    "understand_sentiment": (lambda m: m.books.understand_sentiment(
        seq_len=12, stacked_num=3), 4),
    "recommender_system": (lambda m: m.books.recommender_system(), 8),
    "fit_a_line": (lambda m: m.books.fit_a_line(), 8),
    "crnn_ctc": (lambda m: m.ocr_ctc.crnn_ctc(
        num_classes=12, image_shape=(1, 16, 48), max_label_len=6,
        hid_dim=16), 4),
    "ngram_nce": (lambda m: m.word2vec.ngram_lm(
        dict_size=50, emb_dim=8, hidden_size=16, loss_type="nce"), 8),
    "ngram_hsigmoid": (lambda m: m.word2vec.ngram_lm(
        dict_size=50, emb_dim=8, hidden_size=16, loss_type="hsigmoid"), 8),
}
# the dense tables of a width dividing 128 (the row scatter-add route)
NARROW = {"stacked_lstm": 1, "srl_crf": 3, "understand_sentiment": 1,
          "recommender_system": 5}


def _build(pkg, models, name):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.program_guard(main, startup):
        spec = BUILDERS[name][0](models)
        pkg.optimizer.Adam(1e-3).minimize(spec.loss)
    for op in main.global_block().ops:
        if op.type == "nce":
            op.attrs["seed"] = NCE_SEED
    return main, startup, spec


def reference_negatives(seed, batch, k, vocab, sampler):
    """The reference's nce draw for a fixed seed (its lines 189-195)."""
    key = jax.random.PRNGKey(seed)
    if sampler == "log_uniform":
        u = jax.random.uniform(key, (batch, k))
        neg = (jnp.exp(u * jnp.log(vocab + 1.0)) - 1.0).astype(jnp.int32)
        return np.array(jnp.clip(neg, 0, vocab - 1))
    return np.array(jax.random.randint(key, (batch, k), 0, vocab))


@pytest.fixture
def reference_nce_draws(monkeypatch):
    """The port's nce takes the reference's negatives for its seed."""
    def draw(generator, batch, k, vocab, sampler, device):
        seed = generator.initial_seed()
        return torch.as_tensor(reference_negatives(
            seed, batch, k, vocab, sampler), dtype=torch.long,
            device=device)

    monkeypatch.setattr(t_loss_ops, "nce_negatives", draw)


def rel_l2(got, want):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", list(BUILDERS))
def test_rnn_zoo_step_matches_reference(name, reference_nce_draws):
    jmain, jstartup, jspec = _build(fluid, jmodels, name)
    tmain, tstartup, tspec = _build(tfluid, tfluid.models, name)
    assert _signature(tmain) == _signature(jmain)
    assert _signature(tstartup) == _signature(jstartup)
    assert_same_startup(jstartup, tstartup)
    batch = BUILDERS[name][1]
    feed = jspec.sample_batch(batch, np.random.RandomState(4))
    params = sorted(p.name for p in jmain.all_parameters())
    gb = jmain.global_block()
    grads = [n + "@GRAD" for n in params if gb.has_var(n + "@GRAD")]
    extra = [v.name for v in jspec.fetches.values()]
    fetch = [jspec.loss.name] + extra + grads

    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    state = {v.name: tscope.numpy(v.name).copy()
             for v in tstartup.list_vars() if v.persistable}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
        want = exe.run(jmain, feed=feed, fetch_list=fetch)
        want_params = {n: np.asarray(scope.get(n)) for n in params}
    got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)

    np.testing.assert_allclose(got[0], want[0], err_msg="loss", **TOL)
    for n, g, w in zip(extra, got[1:], want[1:]):
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, err_msg=n, **TOL)
    for n, g, w in zip(grads, got[1 + len(extra):], want[1 + len(extra):]):
        g = g.to_dense() if hasattr(g, "to_dense") else g
        assert np.abs(w).max() > 0, n
        assert rel_l2(g, w) <= GRAD_REL_L2, (n, rel_l2(g, w))
    for n in params:
        np.testing.assert_allclose(tscope.numpy(n), want_params[n],
                                   err_msg=n, **PARAM_TOL)
    lookups = [op for op in tmain.global_block().ops
               if op.type == "lookup_table"
               and op.attr("_kernel_choice") is not None]
    assert len(lookups) == NARROW.get(name, 0)
    assert all(op.attr("_kernel_choice") == {"kernel": "plain_scatter_add"}
               for op in lookups)


@pytest.mark.parametrize("k", [1, 16, 32, 64])
def test_narrow_take_gradient_equals_index_select(k):
    """``rowops.packed_take`` (the narrow dense lookup) gathers what
    ``index_select`` gathers, and its backward (the row scatter-add's
    plain version on the CPU, recorded in the op's ``_kernel_choice``)
    gives ``index_select``'s autograd gradient within 1e-6, duplicates
    included."""
    from paddle_tpu_torch.ops import rowops

    gen = torch.Generator().manual_seed(k)
    v = 9
    w = torch.randn(v, k, generator=gen)
    ids = torch.randint(0, v, (40,), generator=gen)
    g = torch.randn(40, k, generator=gen)
    op = type("Op", (), {"attrs": {}})()
    a = w.clone().requires_grad_(True)
    out = rowops.packed_take(a, ids, op)
    out.backward(g)
    b = w.clone().requires_grad_(True)
    ref = b.index_select(0, ids)
    ref.backward(g)
    assert torch.equal(out.detach(), ref.detach())
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)
    assert op.attrs["_kernel_choice"] == {"kernel": "plain_scatter_add"}


@pytest.mark.parametrize("k,sparse,routed", [
    (16, False, True), (4, False, True), (3, False, False),
    (128, False, False), (16, True, False)])
def test_lookup_takes_the_narrow_route(k, sparse, routed):
    """A training step of ids -> embedding(K) -> fc -> mean: the lookup
    of a dense table with K below 128 and dividing it records the
    scatter's path (``plain_scatter_add`` on the CPU); a table of another
    width keeps ``index_select``'s backward, and a sparse table its
    (rows, values) gradient, recording none. A padding id's row gets a
    zero gradient either way."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", shape=[6], dtype="int64")
        emb = tfluid.layers.embedding(ids, size=[10, k], is_sparse=sparse,
                                      padding_idx=0)
        loss = tfluid.layers.mean(tfluid.layers.fc(emb, size=3,
                                                   num_flatten_dims=2))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    table = main.all_parameters()[0].name
    before = scope.numpy(table).copy()
    feed = {"ids": np.random.RandomState(0).randint(0, 10, (4, 6))}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    op = next(o for o in main.global_block().ops
              if o.type == "lookup_table")
    choice = op.attr("_kernel_choice")
    assert choice == ({"kernel": "plain_scatter_add"} if routed else None)
    np.testing.assert_array_equal(scope.numpy(table)[0], before[0])
    assert not np.array_equal(scope.numpy(table)[1:], before[1:])
