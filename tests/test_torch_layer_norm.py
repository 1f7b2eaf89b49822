"""The port's plain LayerNorm version and ``layer_norm`` op against
``paddle_tpu``'s Pallas kernels (interpret mode) and its composed op, on the
CPU: y, mean and var, with and without gamma/beta, atol 1e-5; dx, dgamma
and dbeta against the Pallas backward's vjp, atol 1e-4 (sums over 40 rows
in another order)."""

import os
import re

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
        tfln.layer_norm_bwd(x.half(), None, stats, stats, x.half(), EPS)
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


PLAN_WIDTHS = [1, 3, 37, 512, 768, 1000, 4096, 5000]


@pytest.mark.parametrize("d", PLAN_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_fwd_plan_maps_to_a_declared_instantiation(d, dtype):
    """Every (rows, D, dtype) gets a plan the C entry takes: 16-byte
    vectors only where D is a multiple of one (and the pointers aligned),
    a register-resident form that holds the row (at 512 and 768 always)
    or the looped one, one row a warp, ceil(rows / warps) blocks."""
    wide = 4 if dtype == torch.float32 else 8
    for rows in (1, 7, 1024, 32768):
        for aligned in (True, False):
            p = tfln.ln_fwd_plan(rows, d, dtype, 132, aligned)
            assert p.vec == (wide if aligned and d % wide == 0 else 1)
            assert p.vpl == 0 or p.vpl in tfln.LN_FWD_VPL
            if p.vpl:
                assert 32 * p.vpl * p.vec >= d
            else:  # looped only where no register-resident form holds it
                assert 32 * max(tfln.LN_FWD_VPL) * p.vec < d
            assert p.warps in (1, 2, 4, 8)
            assert p.blocks == -(-rows // p.warps)
            if d in (512, 768) and aligned:
                assert p.vec == wide and p.vpl > 0
            if d % 4:
                assert p.vec == 1
    served = tfln.ln_fwd_plan(1024, 768, torch.float32, 132)
    assert served == (4, 6, 2, 512)  # two blocks an SM or more
    assert tfln.ln_fwd_plan(32768, 512, torch.float32, 132) == (4, 4, 4,
                                                                 8192)


def test_ln_fwd_plan_refuses_nonsense():
    for args in ((0, 8, torch.float32, 1), (4, 8, torch.float16, 1),
                 (4, 8, torch.float32, 0)):
        with pytest.raises(ValueError, match="ln_fwd_plan"):
            tfln.ln_fwd_plan(*args)


def test_ln_fwd_vpl_matches_the_kernel_source():
    """The vectors a lane may hold (``LN_FWD_VPL``) and the looped form 0
    are the instantiations csrc/layer_norm_fwd.cu's launch switch
    declares, so every plan lands on a compiled kernel."""
    src = os.path.join(os.path.dirname(tfln.__file__), os.pardir, "csrc",
                       "layer_norm_fwd.cu")
    with open(src) as f:
        cases = re.findall(r"^\s*PTT_LN_CASE\((\d+)\)\s*$", f.read(), re.M)
    assert [int(c) for c in cases] == [0] + list(tfln.LN_FWD_VPL)


@pytest.mark.parametrize("d", PLAN_WIDTHS)
def test_plain_matches_pallas_kernel_at_plan_widths(monkeypatch, rng, d):
    """y, mean and var of the plain version against the Pallas forward
    (interpret mode) at every width the plan tests cover, atol 1e-5."""
    monkeypatch.setattr(fln, "_INTERPRET", True)
    x = rng.normal(0.5, 2.0, (8, d)).astype("f4")
    g = rng.normal(1.0, 0.3, d).astype("f4")
    b = rng.normal(0.0, 0.3, d).astype("f4")
    want = fln.fused_layer_norm(_j(x), _j(g), _j(b), EPS)
    got = tfln.layer_norm_plain(_t(x), _t(g), _t(b), EPS)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("affine", [(True, True), (False, False)])
def test_bf16_plain_matches_pallas(monkeypatch, rng, affine):
    """bf16 x and dy (AMP) with f32 gamma and beta: the port's forward and
    backward on the CPU (the plain version and its autograd, both in f32
    from the bf16 inputs) against ``paddle_tpu``'s Pallas forward and
    backward (interpret mode) on the same inputs. y and dx are bf16,
    rounded once from f32 on both sides: within one bf16 step (2^-8
    relative to max(1, |reference|)); mean, var (1e-5) and dgamma, dbeta
    (1e-4, sums over 40 rows in another order) are f32."""
    monkeypatch.setattr(fln, "_INTERPRET", True)
    x, g, b = _data(rng, affine)
    dy = rng.normal(0, 1, (ROWS, D)).astype("f4")
    bf = jnp.bfloat16
    jx, jdy = jnp.asarray(x).astype(bf), jnp.asarray(dy).astype(bf)
    want, vjp = jax.vjp(lambda x, g, b: fln._fused_ln(x, g, b, EPS),
                        jx, _j(g), _j(b))
    zeros = jnp.zeros((ROWS,), jnp.float32)
    want_grads = vjp((jdy, zeros, zeros))

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tg = None if g is None else torch.from_numpy(g).requires_grad_(True)
    tb = None if b is None else torch.from_numpy(b).requires_grad_(True)
    got = tfln.fused_layer_norm(tx, tg, tb, EPS)
    got[0].backward(torch.from_numpy(dy).to(torch.bfloat16))
    assert [o.dtype for o in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    for name, o, w, tol in zip(("y", "mean", "var"), got, want,
                               (2.0 ** -8, 1e-5, 1e-5)):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(o.detach().float().numpy(), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    for name, t, w, tol in zip(("dx", "dgamma", "dbeta"), (tx, tg, tb),
                               want_grads, (2.0 ** -8, 1e-4, 1e-4)):
        if t is None:
            assert w is None
            continue
        assert t.grad.dtype == t.dtype, name
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=name)
