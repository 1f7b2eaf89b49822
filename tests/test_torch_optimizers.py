"""The optimizers the port added beside SGD, Momentum and Adam, against
``paddle_tpu``: LarsMomentum, Adagrad, Adamax, DecayedAdagrad, Adadelta,
RMSProp (centered), Ftrl, Lamb, and ModelAverage and
ExponentialMovingAverage over SGD with their apply/restore.

One program: ids -> embedding (dense or ``is_sparse=True``, padding id 0)
-> fc -> squared error, three steps from the same initial state (the
port's startup run, loaded into both scopes) on batches with duplicate ids and padded slots. Each step's
loss and every parameter and accumulator after the three steps agree
within rtol 2e-5 / atol 2e-6: both packages do the same f32 arithmetic,
summed in other orders (the scatter-add of a sparse grad, the norms of
LARS and Lamb). The sparse runs of the six optimizers that densify their
grad record the scatter-add in ``_kernel_choice`` (``plain_scatter_add``
on the CPU); Adagrad updates the touched rows only and records none."""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name

VOCAB, DIM, BATCH, STEPS = 40, 6, 12, 3
RTOL, ATOL = 2e-5, 2e-6


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
    "lars_momentum": lambda o: o.LarsMomentum(0.5, 0.9, lars_coeff=0.01),
    "adagrad": lambda o: o.Adagrad(0.1, initial_accumulator_value=0.1),
    "adamax": lambda o: o.Adamax(0.05),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(0.05),
    "adadelta": lambda o: o.Adadelta(1.0),
    "rmsprop": lambda o: o.RMSProp(0.01, momentum=0.5, centered=True),
    "ftrl": lambda o: o.Ftrl(0.1, l1=1e-3, l2=1e-3),
    "lamb": lambda o: o.Lamb(0.05),
    "model_average": lambda o: o.SGD(0.2),
    "ema": lambda o: o.SGD(0.2),
}
DENSIFY = ("lars_momentum", "adamax", "decayed_adagrad", "adadelta",
           "rmsprop", "ftrl", "lamb")


def _build(pkg, name, is_sparse):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    L = pkg.layers
    with pkg.program_guard(main, startup):
        ids = L.data("ids", shape=[1], dtype="int64")
        label = L.data("label", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[VOCAB, DIM], is_sparse=is_sparse,
                          padding_idx=0)
        d = L.elementwise_sub(L.fc(emb, size=1), label)
        loss = L.mean(L.elementwise_mul(d, d))
        OPTS[name](pkg.optimizer).minimize(loss)
        avg = None
        if name == "model_average":
            avg = pkg.optimizer.ModelAverage(0.15)
            avg._append_average_ops(main)
        elif name == "ema":
            avg = pkg.optimizer.ExponentialMovingAverage(0.9)
            avg.update(main)
    return main, startup, loss, avg


def _attrs(op):
    def norm(v):
        return tuple(norm(x) for x in v) if isinstance(v, (list, tuple)) \
            else v
    return op.type, {k: norm(v) for k, v in op.attrs.items()}


def assert_same_startup(jstartup, tstartup):
    """The two startup programs run the same ops with the same attributes
    (initializer kinds, fill values, shapes, seeds), so the port's startup
    state stands for the reference's in both scopes."""
    assert [_attrs(op) for op in tstartup.global_block().ops] == \
        [_attrs(op) for op in jstartup.global_block().ops]


def load_port_startup(texe):
    """Run the port's default startup program into its global scope and
    set the same state into the reference's global scope, after checking
    that the reference's default startup program is the same."""
    tstartup = tfluid.default_startup_program()
    assert_same_startup(fluid.default_startup_program(), tstartup)
    texe.run(tstartup)
    tscope, jscope = tfluid.global_scope(), fluid.global_scope()
    for v in tstartup.list_vars():
        if v.persistable:
            jscope.set(v.name, jnp.asarray(tscope.numpy(v.name)))


def _batches():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(0, 8, size=(BATCH, 1)).astype("int64")
        ids[::5] = 0  # padded slots, and ids 1-7 each several times
        out.append({"ids": ids,
                    "label": rng.randn(BATCH, 1).astype("float32")})
    return out


def _state_names(main):
    return sorted(v.name for v in main.list_vars()
                  if v.persistable and v.name not in ("ids", "label")
                  and not v.name.startswith("learning_rate"))


@pytest.mark.parametrize("is_sparse", [False, True],
                         ids=["dense", "sparse"])
@pytest.mark.parametrize("name", list(OPTS))
def test_three_steps_match_reference(name, is_sparse):
    # both start from the port's startup state (the reference's startup
    # program, one XLA computation per initializer, costs most of the case)
    main, startup, loss, avg = _build(tfluid, name, is_sparse)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: scope.numpy(v.name).copy()
             for v in startup.list_vars() if v.persistable}

    jmain, jstartup, jloss, _ = _build(fluid, name, is_sparse)
    assert_same_startup(jstartup, startup)
    assert sorted(state) == sorted(v.name for v in jstartup.list_vars()
                                   if v.persistable)
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.Scope()
    jlosses = []
    with fluid.scope_guard(jscope):
        for n, v in state.items():
            jscope.set(n, jnp.asarray(v))
        for feed in _batches():
            jlosses.append(float(jexe.run(jmain, feed=feed,
                                          fetch_list=[jloss])[0]))
        want = {n: np.asarray(jscope.get(n)) for n in _state_names(jmain)}

    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for feed in _batches()]
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    assert _state_names(main) == sorted(want)
    for n in want:
        np.testing.assert_allclose(scope.numpy(n).reshape(want[n].shape),
                                   want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    table = [p.name for p in main.all_parameters()
             if tuple(p.shape) == (VOCAB, DIM)][0]
    upd = [o for o in main.global_block().ops
           if o.attr("is_optimizer_op") and o.input("Param") is not None
           and o.input("Param").name == table][0]
    assert upd.type == name or avg is not None
    if is_sparse and name in DENSIFY:
        assert upd.attr("_kernel_choice") == {"kernel": "plain_scatter_add"}
    elif upd.type != "sgd":
        assert upd.attr("_kernel_choice") is None
    if avg is None:
        return
    # apply swaps in the average the reference's state holds, restore
    # swaps the trained parameters back, in the scope's own tensors
    trained = {p.name: scope.numpy(p.name).copy()
               for p in main.all_parameters()}
    held = {n: scope.get(n) for n in trained}
    with avg.apply(exe, scope=scope):
        for n in trained:
            if name == "ema":
                expect = want["%s.ema" % n]
            else:
                sums = [k for k in want if k.startswith(n + "_sum")]
                cnts = [k for k in want if k.startswith(n + "_cnt")]
                expect = want[sums[0]] / want[cnts[0]].reshape(())
            np.testing.assert_allclose(scope.numpy(n), expect, rtol=RTOL,
                                       atol=ATOL, err_msg=n)
            assert scope.get(n) is held[n]
    for n, v in trained.items():
        np.testing.assert_array_equal(scope.numpy(n), v)
