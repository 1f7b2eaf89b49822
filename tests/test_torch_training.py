"""The port's training slice against ``paddle_tpu`` on the CPU.

Front end: a two-layer ``fc`` network gives the same ``append_backward``
and ``calc_gradient`` grads in both packages, and the same parameters
after one SGD, Momentum and Adam step, and after one SGD step through each
gradient clip and weight decay. Whole slice: ``transformer_base`` at the size of
``tests/test_models.py`` (vocab 64, seq 16, d_model 32, d_ff 64, 2 heads,
2+2 layers, dropout 0) is built in both packages, initialised by the JAX
package (its flash, LayerNorm and fused-CE Pallas kernels in interpret
mode), carried across with ``bridge``, and trained two Adam steps by both:
loss and every grad agree within atol 2e-5 / rtol 1e-4 (f32; the two sides
sum in different orders), every parameter within atol 1e-4 / rtol 1e-4:
Adam divides by sqrt(v) + eps, so a grad element within rounding of zero
can move its parameter by a sizeable share of the learning rate (3e-3)."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.ops.flash_attention as jfa
import paddle_tpu.ops.fused_ce as jfce
import paddle_tpu.ops.fused_layer_norm as jfln
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name

TOL = dict(atol=2e-5, rtol=1e-4)
TINY = dict(src_vocab=64, trg_vocab=64, seq_len=16, d_model=32, d_ff=64,
            n_head=2, n_layer=2, dropout_rate=0.0)


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


@pytest.fixture
def pallas_interpret(monkeypatch):
    for mod in (jfa, jfce, jfln):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def jax_params(program):
    """The helper the bridge asks of a test: a ``paddle_tpu`` scope's
    parameters of ``program`` as ``{name: np.ndarray}``."""
    scope = fluid.global_scope()
    return {p.name: np.asarray(scope.get(p.name))
            for p in program.all_parameters()}


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


def _mlp(pkg):
    x = pkg.layers.data("x", shape=[12])
    y = pkg.layers.data("y", shape=[3])
    h = pkg.layers.fc(x, size=16, act="relu")
    o = pkg.layers.fc(h, size=3)
    d = pkg.layers.elementwise_add(o, pkg.layers.scale(y, scale=-1.0))
    return pkg.layers.mean(pkg.layers.elementwise_mul(d, d))


OPTIMIZERS = {
    "sgd": lambda pkg: pkg.optimizer.SGD(learning_rate=0.1),
    "momentum": lambda pkg: pkg.optimizer.Momentum(learning_rate=0.1,
                                                   momentum=0.9),
    "adam": lambda pkg: pkg.optimizer.Adam(learning_rate=0.01),
    # SGD through each clip and weight decay (their dense ops)
    "clip_by_value": lambda pkg: _clipped(
        pkg, pkg.clip.GradientClipByValue(0.05)),
    "clip_by_norm": lambda pkg: _clipped(
        pkg, pkg.clip.GradientClipByNorm(0.1)),
    "clip_by_global_norm": lambda pkg: _clipped(
        pkg, pkg.clip.GradientClipByGlobalNorm(0.1)),
    "l2_decay": lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.1, regularization=pkg.regularizer.L2Decay(0.5)),
    "l1_decay": lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.1, regularization=pkg.regularizer.L1Decay(0.5)),
}


def _clipped(pkg, clip):
    """SGD whose parameters all carry ``clip``, set per parameter (a
    program-wide ``set_gradient_clip`` would outlive the test)."""
    for p in pkg.default_main_program().all_parameters():
        p.gradient_clip_attr = clip
    return pkg.optimizer.SGD(learning_rate=0.1)


def test_append_backward_grads_match(rng):
    feed = {"x": rng.normal(size=(8, 12)).astype("f4"),
            "y": rng.normal(size=(8, 3)).astype("f4")}
    jloss = _mlp(fluid)
    jpg = fluid.append_backward(jloss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    params = jax_params(fluid.default_main_program())
    want = exe.run(feed=feed, fetch_list=[jloss] + [g for _, g in jpg])

    tloss = _mlp(tfluid)
    tpg = tfluid.append_backward(tloss)
    assert [(p.name, g.name) for p, g in tpg] == \
        [(p.name, g.name) for p, g in jpg]
    tfluid.bridge.load_program_params(tfluid.global_scope(), params,
                                      tfluid.default_main_program(), "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        feed=feed, fetch_list=[tloss] + [g for _, g in tpg])
    for w, o in zip(want, got):
        np.testing.assert_allclose(o, w, **TOL)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_one_optimizer_step_matches(rng, name):
    feed = {"x": rng.normal(size=(8, 12)).astype("f4"),
            "y": rng.normal(size=(8, 3)).astype("f4")}
    jloss = _mlp(fluid)
    OPTIMIZERS[name](fluid).minimize(jloss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    params = jax_params(fluid.default_main_program())
    exe.run(feed=feed, fetch_list=[jloss])
    want = jax_params(fluid.default_main_program())

    tloss = _mlp(tfluid)
    OPTIMIZERS[name](tfluid).minimize(tloss)
    assert _signature(tfluid.default_main_program()) == \
        _signature(fluid.default_main_program())
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tfluid.default_startup_program())
    tfluid.bridge.load_program_params(tfluid.global_scope(), params,
                                      tfluid.default_main_program(), "cpu")
    texe.run(feed=feed, fetch_list=[tloss])
    scope = tfluid.global_scope()
    for n, w in want.items():
        assert not np.array_equal(w, params[n])  # the step moved it
        np.testing.assert_allclose(scope.get(n).numpy(), w, **TOL)


def test_calc_gradient_matches(rng):
    feed = {"x": rng.normal(size=(8, 12)).astype("f4"),
            "y": rng.normal(size=(8, 3)).astype("f4")}
    jloss = _mlp(fluid)
    jx = fluid.default_main_program().global_block().var("x")
    jg, = fluid.calc_gradient(jloss, [jx])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    params = jax_params(fluid.default_main_program())
    want, = exe.run(feed=feed, fetch_list=[jg])

    tloss = _mlp(tfluid)
    tx = tfluid.default_main_program().global_block().var("x")
    tg, = tfluid.calc_gradient(tloss, [tx])
    tfluid.bridge.load_program_params(tfluid.global_scope(), params,
                                      tfluid.default_main_program(), "cpu")
    got, = tfluid.Executor(tfluid.CPUPlace()).run(feed=feed, fetch_list=[tg])
    assert got.shape == (8, 12)
    np.testing.assert_allclose(got, want, **TOL)


def test_sparse_embedding_gradient_raises():
    """``paddle_tpu`` gives an ``is_sparse`` table a (rows, values)
    gradient, and so does the port: the update op gets the rows. What
    raises is the CUDA kernel's wrapper when handed CPU tensors: the
    sparse update never falls back from the kernel to a library scatter
    (``tests/test_torch_sparse.py`` holds the branches against the JAX
    package)."""
    from paddle_tpu_torch.ops import scatter as tscatter

    ids = tfluid.layers.data("ids", shape=[4], dtype="int64")
    emb = tfluid.layers.embedding(ids, size=[10, 3], is_sparse=True)
    ops, pg = tfluid.optimizer.SGD(0.1).minimize(tfluid.layers.mean(emb))
    (_, g), = pg
    assert ops[0].input("GradRows") is g.sparse_rows_var
    with pytest.raises(ValueError, match="tensors on cpu"):
        tscatter.scatter_add(torch.zeros(10, 3),
                             torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4, 3))


def test_transformer_programs_identical():
    jspec = jmodels.transformer.transformer_base(**TINY)
    fluid.optimizer.Adam(1e-3).minimize(jspec.loss)
    tspec = tfluid.models.transformer.transformer_base(**TINY)
    tfluid.optimizer.Adam(1e-3).minimize(tspec.loss)
    assert tspec.loss.name == jspec.loss.name
    for get in ("default_main_program", "default_startup_program"):
        assert _signature(getattr(tfluid, get)()) == \
            _signature(getattr(fluid, get)())
    assert tspec.flops_per_example == jspec.flops_per_example
    assert set(tspec.feeds) == set(jspec.feeds)
    ops = [op.type for op in tfluid.default_main_program().global_block().ops]
    assert ops.count("flash_attention") == 3 * TINY["n_layer"]
    assert ops.count("layer_norm") == 5 * TINY["n_layer"] + 2
    assert ops.count("fused_linear_smooth_ce") == 1


def _grad_vars(pkg, names):
    gb = pkg.default_main_program().global_block()
    return [gb.var(n + "@GRAD") for n in names]


# the JAX package's startup seeds for the Transformer's two Adam steps. Its
# default, 0, draws a new init on every run (from ``secrets``), so each run
# of the suite tested another init. Adam's first step moves every weight by
# about the learning rate in its gradient's sign, so the second step is
# sensitive to gradients within rounding of zero, and the margin under the
# tolerance varies with the init. Fixed seeds make a failure reproducible;
# these are the first three, taken without looking at their margins.
TRANSFORMER_INIT_SEEDS = (1, 2, 3)


@pytest.mark.parametrize("init_seed", TRANSFORMER_INIT_SEEDS)
def test_transformer_two_adam_steps_match_jax(pallas_interpret, init_seed):
    jspec = jmodels.transformer.transformer_base(**TINY)
    fluid.optimizer.Adam(3e-3).minimize(jspec.loss)
    jprog = fluid.default_main_program()
    fluid.default_startup_program().random_seed = init_seed
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    params = jax_params(jprog)
    names = sorted(params)
    batch = jspec.sample_batch(4, np.random.RandomState(7))
    batch["src_len"] = np.array([16, 9, 1, 12], "int64")  # padded keys
    batch["trg_len"] = np.array([16, 16, 5, 11], "int64")  # masked loss
    want = [exe.run(feed=batch,
                    fetch_list=[jspec.loss] + _grad_vars(fluid, names))
            for _ in range(2)]
    want_params = jax_params(jprog)

    tspec = tfluid.models.transformer.transformer_base(**TINY)
    tfluid.optimizer.Adam(3e-3).minimize(tspec.loss)
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tfluid.default_startup_program())
    tfluid.bridge.load_program_params(tfluid.global_scope(), params,
                                      tfluid.default_main_program(), "cpu")
    got = [texe.run(feed=batch,
                    fetch_list=[tspec.loss] + _grad_vars(tfluid, names))
           for _ in range(2)]
    for step in range(2):
        for name, w, o in zip(["loss"] + names, want[step], got[step]):
            np.testing.assert_allclose(o, w, err_msg="step %d %s"
                                       % (step, name), **TOL)
    scope = tfluid.global_scope()
    for n in names:
        np.testing.assert_allclose(scope.get(n).numpy(), want_params[n],
                                   err_msg=n, atol=1e-4, rtol=1e-4)


def test_transformer_trains_on_cpu():
    spec = tfluid.models.transformer.transformer_base(
        **dict(TINY, dropout_rate=0.1))
    tfluid.optimizer.Adam(3e-3).minimize(spec.loss)
    tfluid.default_startup_program().random_seed = 90125
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    batch = spec.sample_batch(4, np.random.RandomState(7))
    losses = [float(exe.run(feed=batch, fetch_list=[spec.loss])[0])
              for _ in range(6)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
