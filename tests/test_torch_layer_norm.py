"""The port's plain LayerNorm version and ``layer_norm`` op against
``paddle_tpu``'s Pallas kernels (interpret mode) and its composed op, on the
CPU: y, mean and var, with and without gamma/beta, atol 1e-5; dx, dgamma
and dbeta against the Pallas backward's vjp, atol 1e-4 (sums over 40 rows
in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.ops.fused_layer_norm as fln
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.ops import fused_layer_norm as tfln

TOL = dict(atol=1e-5, rtol=0)
ROWS, D, EPS = 40, 32, 1e-5


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


def _data(rng, affine):
    x = rng.normal(0.5, 2.0, (ROWS, D)).astype("f4")
    g = rng.normal(1.0, 0.3, D).astype("f4") if affine[0] else None
    b = rng.normal(0.0, 0.3, D).astype("f4") if affine[1] else None
    return x, g, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


AFFINE = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("affine", AFFINE)
def test_plain_matches_pallas_kernel(monkeypatch, rng, affine):
    monkeypatch.setattr(fln, "_INTERPRET", True)
    x, g, b = _data(rng, affine)
    want = fln.fused_layer_norm(_j(x), _j(g), _j(b), EPS)
    got = tfln.layer_norm_plain(_t(x), _t(g), _t(b), EPS)
    for w, o in zip(want, got):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(w), **TOL)
    via_entry = tfln.fused_layer_norm(_t(x), _t(g), _t(b), EPS)
    for a, c in zip(got, via_entry):
        assert torch.equal(a, c)


@pytest.mark.parametrize("affine", AFFINE)
def test_plain_gradients_match_pallas_backward(monkeypatch, rng, affine):
    """dx, dgamma, dbeta of the port's ``fused_layer_norm`` on the CPU
    (autograd of the plain version) against the vjp of ``paddle_tpu``'s
    ``_fused_ln`` (Pallas backward ``_bwd_kernel``, interpret mode). Mean
    and Variance cotangents are ignored by both."""
    monkeypatch.setattr(fln, "_INTERPRET", True)
    x, g, b = _data(rng, affine)
    dy = rng.normal(0, 1, (ROWS, D)).astype("f4")
    _, vjp = jax.vjp(lambda x, g, b: fln._fused_ln(x, g, b, EPS),
                     _j(x), _j(g), _j(b))
    zeros = jnp.zeros((ROWS,), jnp.float32)
    want = vjp((jnp.asarray(dy), zeros, zeros))

    tx = torch.from_numpy(x).requires_grad_(True)
    tg = None if g is None else torch.from_numpy(g).requires_grad_(True)
    tb = None if b is None else torch.from_numpy(b).requires_grad_(True)
    y, mean, var = tfln.fused_layer_norm(tx, tg, tb, EPS)
    assert not mean.requires_grad and not var.requires_grad
    (y * torch.from_numpy(dy)).sum().backward()
    for name, t, w in zip(("dx", "dgamma", "dbeta"), (tx, tg, tb), want):
        if t is None:
            assert w is None
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-5, err_msg=name)


def test_backward_wrapper_validates_before_building():
    x = torch.empty(4, 8, device="meta")
    stats = torch.empty(4, device="meta")
    with pytest.raises(TypeError, match="f32"):
        tfln.layer_norm_bwd(x.bfloat16(), None, stats, stats, x.bfloat16(),
                            EPS)
    with pytest.raises(ValueError, match="dy"):
        tfln.layer_norm_bwd(x, None, stats, stats, x[:2], EPS)


def _layer_norm_program(pkg, shape, begin, affine):
    x = pkg.layers.data("x", shape=list(shape[1:]), dtype="float32")
    y = pkg.layers.layer_norm(x, scale=affine[0], shift=affine[1],
                              begin_norm_axis=begin, epsilon=EPS)
    op = pkg.default_main_program().global_block().ops[-1]
    return y, op.output("Mean"), op.output("Variance")


@pytest.mark.parametrize("begin", [2, 1])
@pytest.mark.parametrize("affine", AFFINE)
def test_op_matches_composed_op(rng, begin, affine):
    """The op as programs run it: last axis (begin=2) takes the kernel path,
    begin=1 the composed form in both packages. Same params, copied as
    numpy from the JAX scope."""
    shape = (4, 10, D)
    x = rng.normal(0.5, 2.0, shape).astype("f4")
    jfetch = _layer_norm_program(fluid, shape, begin, affine)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    params = {p.name: np.asarray(fluid.global_scope().get(p.name))
              * rng.normal(1.0, 0.2, p.shape).astype("f4")
              for p in fluid.default_main_program().all_parameters()}
    for n, a in params.items():
        fluid.global_scope().set(n, jnp.asarray(a))
    want = exe.run(feed={"x": x}, fetch_list=list(jfetch))

    tfetch = _layer_norm_program(tfluid, shape, begin, affine)
    tfluid.bridge.load_numpy_params(tfluid.global_scope(), params, "cpu",
                                    tfluid.default_main_program())
    got = tfluid.Executor(tfluid.CPUPlace()).run(feed={"x": x},
                                                 fetch_list=list(tfetch))
    for w, o in zip(want, got):
        assert o.shape == w.shape
        np.testing.assert_allclose(o, w, **TOL)


def test_kernel_wrapper_validates_before_building():
    with pytest.raises(ValueError, match="contiguous"):
        tfln.layer_norm_fwd(torch.empty(2, 3, 4, device="meta"), None, None,
                            EPS)
    with pytest.raises(TypeError, match="dtype"):
        tfln.layer_norm_fwd(torch.empty(2, 4, dtype=torch.float16,
                                        device="meta"), None, None, EPS)
