"""The MNIST, VGG-16 and SE-ResNeXt-50 builders of the port against
``paddle_tpu``'s (``models/mnist.py``, ``vgg.py``, ``se_resnext.py``).

Each builds the same program in both packages, var for var and name for
name. MNIST's MLP (hidden 32, 16) and conv net (dropout-free) take one
Adam step from the reference's initial weights: the loss, the accuracy
and every parameter after it agree within atol 1e-4 / rtol 1e-4 (f32,
the same arithmetic summed in other orders; Adam divides by
sqrt(v) + eps). VGG-16 at 32 x 32 and SE-ResNeXt-50 at 32 x 32 (their
channel widths are the builders' own; 10 classes, batch 2) are held by
their evaluation clones (``clone(for_test=True)``: dropout off, batch
norm on its running statistics), whose loss and accuracy agree within
the same bounds. The fusion gate admits SE-ResNeXt's groups-1 conv -> BN
chains and declines its 16 grouped 3x3 convs, which replay unfused."""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch.core import executor as t_executor
from test_torch_optimizers import (assert_same_startup,  # noqa: F401
                                   fresh_port_programs)
from test_torch_training import _signature

TOL = dict(atol=1e-4, rtol=1e-4)
BUILDERS = {
    "mnist_mlp": lambda m: m.mnist.mlp(hidden_sizes=(32, 16)),
    "mnist_cnn": lambda m: m.mnist.cnn(),
    "vgg16": lambda m: m.vgg.vgg16(image_shape=(3, 32, 32)),
    "se_resnext50": lambda m: m.se_resnext.se_resnext50(
        image_shape=(3, 32, 32), class_num=10),
}


def _build(pkg, models, name, train):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.program_guard(main, startup):
        spec = BUILDERS[name](models)
        if train:
            pkg.optimizer.Adam(1e-3).minimize(spec.loss)
    return main, startup, spec


@pytest.mark.parametrize("name", list(BUILDERS))
def test_zoo_model_matches_reference(name):
    train = name.startswith("mnist")
    jmain, jstartup, jspec = _build(fluid, jmodels, name, train)
    tmain, tstartup, tspec = _build(tfluid, tfluid.models, name, train)
    assert _signature(tmain) == _signature(jmain)
    assert _signature(tstartup) == _signature(jstartup)
    assert_same_startup(jstartup, tstartup)
    fetch = [jspec.loss.name, jspec.fetches["acc"].name]
    feed = jspec.sample_batch(2, np.random.RandomState(4))
    if not train:
        jmain, tmain = (p.clone(for_test=True) for p in (jmain, tmain))

    # both start from the port's startup state (the reference's startup
    # program, one XLA computation per initializer, costs seconds here)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    state = {v.name: tscope.numpy(v.name).copy()
             for v in tstartup.list_vars() if v.persistable}
    params = [p.name for p in jmain.all_parameters()]
    assert set(params) <= set(state)

    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
        want = exe.run(jmain, feed=feed, fetch_list=fetch)
        want_params = {n: np.asarray(scope.get(n)) for n in params}

    got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
    for n, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, w, err_msg=n, **TOL)
    if train:
        for n in params:
            np.testing.assert_allclose(tscope.numpy(n), want_params[n],
                                       err_msg=n, **TOL)
    if name == "se_resnext50":
        # after the run: every groups-1 chain admitted, every grouped one
        # declined by the gate and replayed unfused
        ops, _ = t_executor.fused_ops(tmain, fetch)
        fused = [op for op in ops if op.type == "fused_conv2d"]
        grouped = [op for op in fused if op.attr("groups", 1) > 1]
        assert len(grouped) == 16
        for op in fused:
            choice = op.attr("_kernel_choice")
            assert choice["admitted"] == (op.attr("groups", 1) == 1 and (
                op.input("Filter").shape[-1] == 1
                or op.attr("strides") in ([1, 1], (1, 1)))), choice
        assert all(not op.attr("_kernel_choice")["admitted"]
                   and "groups 32" in op.attr("_kernel_choice")["reason"]
                   for op in grouped)
