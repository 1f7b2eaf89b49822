"""The port's batched optimizer updates (``core/opt_fusion.py``) against
``paddle_tpu``'s on the CPU.

* ``plan_opt_fusion`` returns the reference's (plan, skip) on the programs
  of ``tests/test_opt_fusion.py`` (SGD, Momentum, Nesterov and Adam over an
  MLP; a sparse embedding; the squared error from elementwise ops, which
  both packages have), on a program with two hyperparameter groups and
  on an op list with a hazard between two members.
* ``run_fused_group`` gives the reference's ``run_fused_group`` on the same
  numpy arrays, Adam with unequal ``Beta*Pow`` per member: rtol 2e-6 / atol
  1e-7, f32 rounding (the reference concatenates, the port runs
  multi-tensor ops; each element sees the same operations).
* Three Transformer steps with ``PADDLE_TPU_FUSED_OPT=1`` equal three
  without within f32 rounding: the same rtol / atol on the losses and on
  every parameter and Adam moment."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.core.opt_fusion as j_opt_fusion
import paddle_tpu_torch as tfluid
from paddle_tpu.core import framework as j_framework
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import opt_fusion as t_opt_fusion
from paddle_tpu_torch.core import unique_name as t_unique_name

ROUNDING = dict(rtol=2e-6, atol=1e-7)
TINY_T = dict(src_vocab=64, trg_vocab=64, seq_len=16, d_model=32, d_ff=64,
              n_head=2, n_layer=2, dropout_rate=0.1)

OPTIMIZERS = {
    "sgd": lambda pkg: pkg.optimizer.SGD(learning_rate=0.05),
    "momentum": lambda pkg: pkg.optimizer.Momentum(learning_rate=0.05,
                                                   momentum=0.9),
    "nesterov": lambda pkg: pkg.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, use_nesterov=True),
    "adam": lambda pkg: pkg.optimizer.Adam(learning_rate=0.01),
}


@pytest.fixture(autouse=True)
def fresh_programs(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_OPT", raising=False)
    saved = []
    for fw, un in ((t_framework, t_unique_name), (j_framework, j_unique_name)):
        saved.append((fw, un, fw.switch_main_program(fw.Program()),
                      fw.switch_startup_program(fw.Program()), un.switch()))
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    for fw, un, main, startup, gen in saved:
        un.switch(gen)
        fw.switch_main_program(main)
        fw.switch_startup_program(startup)


def _square_error(L, pred, y):
    """``mean(square_error_cost(pred, y))`` from the ops both packages
    have."""
    d = L.elementwise_sub(pred, y)
    return L.mean(L.elementwise_mul(d, d))


def _mlp(pkg, opt):
    L = pkg.layers
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    h = L.fc(x, size=16, act="relu")
    h = L.fc(h, size=16, act="relu")
    loss = _square_error(L, L.fc(h, size=1), y)
    if opt == "two_groups":
        params = pkg.default_main_program().all_parameters()
        pkg.optimizer.Adam(0.01, beta1=0.9).minimize(
            loss, parameter_list=[p.name for p in params[:3]])
        pkg.optimizer.Adam(0.01, beta1=0.8).minimize(
            loss, parameter_list=[p.name for p in params[3:]])
    else:
        OPTIMIZERS[opt](pkg).minimize(loss)


def _sparse(pkg):
    L = pkg.layers
    ids = L.data("ids", shape=[4], dtype="int64")
    emb = L.embedding(ids, size=(50, 8), is_sparse=True)
    pred = L.fc(L.reduce_sum(emb, dim=1), size=1)
    y = L.data("y", shape=[1], dtype="float32")
    pkg.optimizer.Adam(learning_rate=0.05).minimize(
        _square_error(L, pred, y))


def _build(pkg, case):
    if case == "sparse":
        _sparse(pkg)
    else:
        _mlp(pkg, case)
    return list(pkg.default_main_program().global_block().ops)


def _by_index(ops, plan, skip):
    return ({i: [ops.index(m) for m in members]
             for i, members in plan.items()}, sorted(skip))


def _hazard(pkg, fw, ops):
    """``ops`` with an op reading the first Adam member's ParamOut put
    right after it: the group must not fuse."""
    first = next(i for i, op in enumerate(ops) if op.type == "adam")
    op = ops[first]
    block = pkg.default_main_program().global_block()
    out = block.create_var(name="hazard_out", shape=None, dtype="float32")
    reader = fw.Operator(block, "scale", {"X": [op.output("ParamOut")]},
                         {"Out": [out]}, {"scale": 2.0})
    return ops[:first + 1] + [reader] + ops[first + 1:]


@pytest.mark.parametrize("case", sorted(OPTIMIZERS) + [
    "sparse", "two_groups", "hazard"])
def test_plan_matches_reference(case):
    plans = []
    for pkg, fw, mod in ((fluid, j_framework, j_opt_fusion),
                         (tfluid, t_framework, t_opt_fusion)):
        ops = _build(pkg, "adam" if case == "hazard" else case)
        if case == "hazard":
            ops = _hazard(pkg, fw, ops)
        plans.append(_by_index(ops, *mod.plan_opt_fusion(ops)))
    assert plans[1] == plans[0]
    plan, skip = plans[1]
    if case == "sparse":  # only the dense fc pair fuses
        assert [len(m) for m in plan.values()] == [2]
    elif case == "hazard":
        assert plan == {} and skip == []
    elif case == "two_groups":
        assert sorted(len(m) for m in plan.values()) == [3, 3]
    else:
        assert [len(m) for m in plan.values()] == [6]


def _env_arrays(ops, rng):
    """name -> numpy array for every input of ``ops``, made in op order:
    Beta pows differ per member (beta ** (k + 1))."""
    arrays = {}
    for k, op in enumerate(ops):
        for slot, vs in sorted(op.inputs.items()):
            v = vs[0]
            if v.name in arrays:
                continue
            if slot in ("Beta1Pow", "Beta2Pow"):
                beta = op.attr("beta1" if slot == "Beta1Pow" else "beta2")
                arrays[v.name] = np.array([beta ** (k + 1)], "float32")
            elif slot == "LearningRate":
                arrays[v.name] = np.array([0.01], "float32")
            else:
                shape = [d for d in v.shape if d is not None and d > 0]
                a = rng.randn(*shape).astype("float32")
                arrays[v.name] = np.abs(a) if slot == "Moment2" else a
    return arrays


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_run_fused_group_matches_reference(case):
    import jax.numpy as jnp

    outs = []
    for pkg, mod, conv in ((fluid, j_opt_fusion, jnp.asarray),
                           (tfluid, t_opt_fusion, torch.from_numpy)):
        ops = _build(pkg, case)
        plan, _ = mod.plan_opt_fusion(ops)
        members, = plan.values()
        arrays = _env_arrays(members, np.random.RandomState(0))
        env = {n: conv(a.copy()) for n, a in arrays.items()}
        mod.run_fused_group(env, members)
        outs.append([[np.asarray(env[v.name]) for vs in
                      sorted(op.outputs.items()) for v in vs[1]]
                     for op in members])
    for k, (want, got) in enumerate(zip(*outs)):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, err_msg="member %d" % k,
                                       **ROUNDING)


def _transformer_steps(fused, monkeypatch, steps=3):
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPT", "1" if fused else "")
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    try:
        spec = tfluid.models.transformer.transformer_base(**TINY_T)
        tfluid.optimizer.Adam(3e-3).minimize(spec.loss)
        main = tfluid.default_main_program()
        main.random_seed = tfluid.default_startup_program().random_seed = 9
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = t_executor.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        feed = spec.sample_batch(4, np.random.RandomState(7))
        losses = [exe.run(main, feed=feed, fetch_list=[spec.loss],
                          scope=scope)[0] for _ in range(steps)]
        n_groups = len(exe._last[id(main)].plan)
        state = {v.name: scope.get(v.name).numpy().copy()
                 for v in main.list_vars() if v.persistable}
        return np.array(losses).ravel(), state, n_groups
    finally:
        t_unique_name.switch(old_gen)
        t_framework.switch_main_program(prev_main)
        t_framework.switch_startup_program(prev_startup)


def test_fused_transformer_steps_match_per_op(monkeypatch):
    l_fused, s_fused, groups = _transformer_steps(True, monkeypatch)
    l_plain, s_plain, none = _transformer_steps(False, monkeypatch)
    assert (groups, none) == (1, 0)
    np.testing.assert_allclose(l_fused, l_plain, **ROUNDING)
    assert set(s_fused) == set(s_plain)
    for n in sorted(s_plain):
        np.testing.assert_allclose(s_fused[n], s_plain[n], err_msg=n,
                                   **ROUNDING)
