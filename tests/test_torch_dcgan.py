"""DCGAN at small widths (z 16, G 32-16-8 to 3 x 32 x 32, D 8-16-32) in
both packages, built by ``chip_smoke.build_dcgan`` from public layers
(three programs sharing the parameters by name: G; D on real and fake
images with D's ``parameter_list``; G through D with G's), from the
reference's startup state carried to the port (``bridge``).

The G program's images, then one D step on the seeded real images and
the reference's fake ones, then one G step: each loss within 1e-5
relative, each gradient within 1e-5 relative L2, and after the two steps
every parameter and moving statistic within 1e-5 relative L2 (f32
convolutions in two libraries; Adam's first update moves each element by
about its rate, so an element whose gradient is near 0 may move the
other way: the parameters are held as wholes, by relative L2)."""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import unique_name as t_unique_name
from test_torch_optimizers import fresh_port_programs  # noqa: F401

SMALL = dict(z_dim=16, g_widths=(32, 16, 8), d_widths=(8, 16, 32),
             channels=3)
BATCH = 4
TOL = 1e-5


def rel_l2(got, want):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _build(pkg):
    gen = fluid.unique_name if pkg is fluid else t_unique_name
    old = gen.switch()
    try:
        return chip_smoke.build_dcgan(pkg, **SMALL)
    finally:
        gen.switch(old)


def _grad_vars(prog, names):
    gb = prog.global_block()
    return [gb.var(n + "@GRAD") for n in names]


@pytest.fixture(scope="module")
def runs():
    """Per package: G's images, the D step's (loss, grads), the G step's
    (loss, grads), every parameter after both steps."""
    out = {}
    state = None
    fake_ref = None
    for pkg in (fluid, tfluid):
        net = _build(pkg)
        z, real = chip_smoke.dcgan_feed(net, BATCH)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(net.startup)
            names = [p.name for p in net.dg.all_parameters()]
            if pkg is fluid:
                state = {n: np.asarray(scope.get(n)) for n in names}
            else:
                tfluid.bridge.load_program_params(scope, state, net.dg,
                                                  "cpu")
            fake, = exe.run(net.g, feed={"z": z}, fetch_list=[net.fake])
            if fake_ref is None:
                fake_ref = fake
            d = exe.run(net.d, feed={"real": real, "fake": fake_ref},
                        fetch_list=[net.d_loss] + _grad_vars(
                            net.d, net.d_params))
            g = exe.run(net.dg, feed={"z": z}, fetch_list=[
                net.g_loss] + _grad_vars(net.dg, net.g_params))
            after = {n: np.asarray(scope.get(n)) if pkg is fluid
                     else scope.numpy(n) for n in names}
        out[pkg.__name__] = dict(fake=fake, d=d, g=g, after=after, net=net,
                                 before=state)
    return out["paddle_tpu"], out["paddle_tpu_torch"]


def test_programs_and_parameters_match(runs):
    want, got = runs
    jn, tn = want["net"], got["net"]
    for prog in ("g", "d", "dg"):
        assert [op.type for op in getattr(tn, prog).global_block().ops] == [
            op.type for op in getattr(jn, prog).global_block().ops]
    assert tn.d_params == jn.d_params and tn.g_params == jn.g_params
    assert len(tn.g_params) == 3 * 3 + 1 and len(tn.d_params) == 4 + 2 * 2


def test_generator_images_match(runs):
    want, got = runs
    assert got["fake"].shape == (BATCH, 3, 32, 32)
    assert np.abs(got["fake"]).max() <= 1.0
    assert rel_l2(got["fake"], want["fake"]) <= TOL


@pytest.mark.parametrize("step", ["d", "g"])
def test_step_loss_and_gradients_match(runs, step):
    want, got = runs
    w, g = want[step], got[step]
    assert abs(float(g[0]) - float(w[0])) <= TOL * abs(float(w[0]))
    for i, (a, b) in enumerate(zip(g[1:], w[1:])):
        assert np.abs(b).max() > 0
        assert rel_l2(a, b) <= TOL, (step, i, rel_l2(a, b))


def test_parameters_after_both_steps_match(runs):
    want, got = runs
    net = got["net"]
    moved = set(net.d_params) | set(net.g_params)
    for n, w in want["after"].items():
        assert rel_l2(got["after"][n], w) <= TOL, (n, rel_l2(
            got["after"][n], w))
        if n in moved:  # each trained parameter moved in both
            assert not np.array_equal(w, want["before"][n]), n
