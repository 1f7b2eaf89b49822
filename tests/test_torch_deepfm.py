"""The sparse-gradient slice against ``paddle_tpu`` on the CPU: a tiny
DeepFM (V=1000, F=6, K=8 so the fused table is W=16 wide, dense 5, hidden
(16, 16), batch 16) and the word2vec n-gram LM (four lookup sites on one
shared sparse table), each built in both packages, initialised by the JAX
package (its scatter kernel in interpret mode), carried across with
``bridge``, and run by both.

Tolerances. Forward ``prob`` and loss: rtol 1e-5 / atol 1e-6 (the same f32
arithmetic, summed in other orders). After two ``Adam(1e-3)`` steps:
losses rtol 1e-5 / atol 1e-6, every parameter atol 2e-6 / rtol 1e-5:
Adam's first steps move an element by about lr * sign(g), so an element
whose gradient is within rounding of zero may differ by a share of lr;
none does at these sizes, and the bound holds on every element."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import models as jmodels
from paddle_tpu.ops import scatter as jscatter
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name

TINY = dict(sparse_feature_dim=1000, num_fields=6, embedding_size=8,
            dense_dim=5, hidden_sizes=(16, 16))
BATCH = 16
FWD = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    monkeypatch.setattr(jscatter, "_INTERPRET", True)
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


def _signature(prog):
    gb = prog.global_block()
    ops = [(op.type, sorted((s, tuple(v.name for v in vs))
                            for s, vs in op.inputs.items()),
            sorted((s, tuple(v.name for v in vs))
                   for s, vs in op.outputs.items()))
           for op in gb.ops]
    var_table = sorted((v.name, v.shape, str(v.dtype), v.persistable)
                       for v in gb.vars.values())
    return ops, var_table


def _params(scope, prog, get):
    return {p.name: get(scope, p.name) for p in prog.all_parameters()}


def _jax_run(build, opt, n_steps, fetch_names):
    """Build with ``paddle_tpu``, initialise, run ``n_steps`` batches (one
    step each): (feeds, initial params, [fetches per step], params
    after)."""
    spec = build(jmodels)
    feeds = _feeds(spec, n_steps)
    if opt is not None:
        opt(fluid).minimize(spec.loss)
    prog = fluid.default_main_program()
    fluid.default_startup_program().random_seed = 5
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    get = lambda s, n: np.asarray(s.get(n))  # noqa: E731
    start = _params(scope, prog, get)
    outs = [exe.run(feed=f, fetch_list=fetch_names(spec)) for f in feeds]
    return feeds, start, outs, _params(scope, prog, get)


def _port_run(build, opt, feeds, fetch_names, start):
    spec = build(tfluid.models)
    if opt is not None:
        opt(tfluid).minimize(spec.loss)
    prog = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    tfluid.bridge.load_program_params(scope, start, prog, "cpu")
    outs = [exe.run(feed=f, fetch_list=fetch_names(spec)) for f in feeds]
    return spec, outs, _params(scope, prog, lambda s, n: s.get(n).numpy())


def _deepfm(models):
    return models.deepfm.deepfm(**TINY)


def _loss_prob(spec):
    return [spec.loss, spec.fetches["prob"]]


def _feeds(spec, n):
    rng = np.random.RandomState(11)
    return [spec.sample_batch(BATCH, rng) for _ in range(n)]


def test_deepfm_programs_identical():
    jspec = _deepfm(jmodels)
    fluid.optimizer.Adam(1e-3).minimize(jspec.loss)
    tspec = _deepfm(tfluid.models)
    tfluid.optimizer.Adam(1e-3).minimize(tspec.loss)
    for get in ("default_main_program", "default_startup_program"):
        assert _signature(getattr(tfluid, get)()) == \
            _signature(getattr(fluid, get)())
    assert tspec.flops_per_example == jspec.flops_per_example
    assert tspec.extras["fused_table"] == jspec.extras["fused_table"] == \
        {"vocab": 1000, "width": 16, "num_fields": 6}
    ad = [o for o in tfluid.default_main_program().global_block().ops
          if o.type == "autodiff"][0]
    assert ad.attr("sparse_wrt_names") == ["fm_table"]


def test_deepfm_forward_matches_jax():
    feeds, start, want, _ = _jax_run(_deepfm, None, 1, _loss_prob)
    _, got, _ = _port_run(_deepfm, None, feeds, _loss_prob, start)
    assert got[0][1].shape == (BATCH, 1)
    for w, o in zip(want[0], got[0]):
        np.testing.assert_allclose(o, w, **FWD)


def test_deepfm_two_adam_steps_match_jax():
    def adam(pkg):
        return pkg.optimizer.Adam(1e-3)

    feeds, start, want, want_after = _jax_run(_deepfm, adam, 2, _loss_prob)
    tspec, got, after = _port_run(_deepfm, adam, feeds, _loss_prob, start)
    for step in range(2):
        for name, w, o in zip(("loss", "prob"), want[step], got[step]):
            np.testing.assert_allclose(o, w, err_msg="step %d %s"
                                       % (step, name), **FWD)
    assert set(after) == set(want_after)
    for n in sorted(after):
        assert not np.array_equal(after[n], start[n]), n
        np.testing.assert_allclose(after[n], want_after[n], err_msg=n,
                                   **PARAMS)
    # the padding columns 9..15 of the fused table stay exactly zero
    assert not after["fm_table"][:, TINY["embedding_size"] + 1:].any()
    adam_op = [o for o in tfluid.default_main_program().global_block().ops
               if o.type == "adam" and o.input("Param").name == "fm_table"][0]
    assert adam_op.attrs["_kernel_choice"] == {"kernel": "plain_scatter_add"}
    assert adam_op.input("GradRows").name == "fm_table@GRAD@ROWS"


def test_deepfm_port_startup_zeroes_padding_and_trains():
    """The port's own init: Xavier-uniform in the used columns, exact
    zeros in the padding; the loss falls on a fixed batch."""
    spec = _deepfm(tfluid.models)
    tfluid.optimizer.Adam(1e-2).minimize(spec.loss)
    tfluid.default_startup_program().random_seed = 3
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    table = tfluid.global_scope().get("fm_table").numpy()
    used = TINY["embedding_size"] + 1
    limit = np.sqrt(6.0 / (TINY["sparse_feature_dim"] + used))
    assert table.shape == (1000, 16) and not table[:, used:].any()
    assert np.abs(table[:, :used]).max() <= limit
    assert table[:, :used].std() > limit / 3
    batch = spec.sample_batch(BATCH, np.random.RandomState(0))
    losses = [float(exe.run(feed=batch, fetch_list=[spec.loss])[0])
              for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert not tfluid.global_scope().get("fm_table").numpy()[:, used:].any()


def test_deepfm_eval_clone_matches_training_forward():
    """``main.clone(for_test=True)`` drops the backward and the updates:
    its lookups take the plain path, and it gives the training step's own
    forward ``prob`` from the same weights."""
    spec = _deepfm(tfluid.models)
    tfluid.optimizer.Adam(1e-2).minimize(spec.loss)
    main = tfluid.default_main_program()
    test = main.clone(for_test=True)
    tfluid.default_startup_program().random_seed = 3
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    batch = spec.sample_batch(BATCH, np.random.RandomState(0))
    want, = exe.run(test, feed=batch, fetch_list=[spec.fetches["prob"]])
    got, = exe.run(main, feed=batch, fetch_list=[spec.fetches["prob"]])
    np.testing.assert_array_equal(got, want)
    again, = exe.run(test, feed=batch, fetch_list=[spec.fetches["prob"]])
    assert not np.array_equal(again, want)  # the step moved the weights
    assert "autodiff" not in [o.type for o in test.global_block().ops]


W2V = dict(dict_size=50, emb_dim=8, hidden_size=16)


def _w2v(models):
    return models.word2vec.ngram_lm(**W2V)


def _w2v_fetch(spec):
    gb = spec.loss.block
    return [spec.loss, gb.var("shared_w@GRAD@ROWS"),
            gb.var("shared_w@GRAD")]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_ngram_lm_two_steps_match_jax(opt):
    """Four context lookups read ``shared_w``: its (rows, values) grad
    concatenates the four sites in op order."""
    def make(pkg):
        return (pkg.optimizer.SGD(0.1) if opt == "sgd"
                else pkg.optimizer.Adam(1e-2))

    feeds, start, want, want_after = _jax_run(_w2v, make, 2, _w2v_fetch)
    _, got, after = _port_run(_w2v, make, feeds, _w2v_fetch, start)
    for step in range(2):
        rows = np.concatenate([feeds[step]["w%d" % i][:, 0]
                               for i in range(4)])
        np.testing.assert_array_equal(got[step][1], rows)
        np.testing.assert_array_equal(got[step][1], want[step][1])
        for name, i in (("loss", 0), ("values", 2)):
            np.testing.assert_allclose(got[step][i], want[step][i],
                                       err_msg="step %d %s" % (step, name),
                                       **FWD)
    for n in sorted(after):
        np.testing.assert_allclose(after[n], want_after[n], err_msg=n,
                                   **PARAMS)


def test_ngram_lm_unported_losses_raise():
    """The nce and hsigmoid losses, which raised until their ops were
    ported, now build their op and train: the loss after three SGD steps
    on one batch is finite and below the first (their parity with the
    reference is ``tests/test_torch_rnn_zoo.py``'s)."""
    for loss_type in ("nce", "hsigmoid"):
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 1
        with tfluid.program_guard(main, startup):
            spec = tfluid.models.word2vec.ngram_lm(loss_type=loss_type,
                                                   **W2V)
            tfluid.optimizer.SGD(0.5).minimize(spec.loss)
        assert loss_type in {op.type for op in main.global_block().ops}
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        feed = spec.sample_batch(8, np.random.RandomState(0))
        losses = [float(exe.run(main, feed=feed, fetch_list=[spec.loss],
                                scope=scope)[0]) for _ in range(3)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
