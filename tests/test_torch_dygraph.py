"""The port's dygraph (imperative) mode against ``paddle_tpu``'s on the CPU.

Each test of ``tests/test_dygraph.py`` has a twin here that runs the same
seeded numpy inputs through both packages: the port's tape (torch
autograd) against the reference's (``jax.vjp`` per node), its layers and
its optimizers on weights carried across by ``bridge.load_dygraph_state``
(both packages name parameters alike from fresh name generators). Every
dygraph layer of ``nn.__all__`` is held to the reference's forward and
gradients. Tolerances (f32, the packages sum in different orders): a
single forward or gradient within atol 1e-5 / rtol 1e-5 (1e-4 through a
convolution), a trajectory of optimizer steps within rtol 1e-4 on the
loss, parameters after it within atol 1e-4 / rtol 1e-4 (an Adam step
divides by sqrt(v) + eps, so a gradient within rounding of zero moves
its weight by a share of the rate). Dropout and NCE's negatives draw
from different generators in the two packages: dropout is held by its
keep share, NCE at one class, where every negative is class 0."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph import nn as jnn
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.dygraph import nn as tnn

CPU = tfluid.CPUPlace()
TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def fresh_port_names():
    old = t_unique_name.switch()
    yield
    t_unique_name.switch(old)


def carry(jlayer, tlayer):
    """The reference layer's weights into the port's, by name."""
    tfluid.bridge.load_dygraph_state(
        tlayer, {n: np.asarray(v) for n, v in jlayer.state_pytree().items()},
        "cpu")


def both_names_equal(jlayer, tlayer):
    assert [p.name for p in jlayer.parameters()] == \
        [p.name for p in tlayer.parameters()]


# -- the tape ---------------------------------------------------------------

def test_tape_backward_matches_jax_grad(rng):
    wv, xv = rng.randn(4, 3).astype("f4"), rng.randn(2, 4).astype("f4")
    grads = []
    for dy, guard in ((jdy, jdy.guard()), (tdy, tdy.guard(CPU))):
        with guard:
            w = dy.to_variable(wv)
            x = dy.to_variable(xv)
            x.stop_gradient = True
            y = (x @ w).mean() * 3.0 + (w * w).sum()
            y.backward()
            grads.append(w.gradient())
            assert x.gradient() is None
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


def test_gradient_accumulation_and_clear():
    got = []
    for dy, guard in ((jdy, jdy.guard()), (tdy, tdy.guard(CPU))):
        with guard:
            w = dy.to_variable(np.ones((3,), "f4"))
            (w * 2.0).sum().backward()
            (w * 3.0).sum().backward()  # accumulates
            acc = w.gradient()
            w.clear_gradient()
            assert w.gradient() is None
            y = (w * w * 1.5).sum()
            y.backward()
            y.backward()  # twice over one graph: adds again
            got.append((acc, w.gradient()))
    np.testing.assert_allclose(got[1][0], [5.0, 5.0, 5.0])
    for a, b in zip(got[1], got[0]):
        np.testing.assert_allclose(a, b, **TOL)


def test_no_grad_suspends_tape():
    for dy, guard in ((jdy, jdy.guard()), (tdy, tdy.guard(CPU))):
        with guard:
            w = dy.to_variable(np.ones((2,), "f4"))
            with dy.no_grad():
                y = (w * 2.0).sum()
            assert y._producer is None
            z = (w * 2.0).sum()
            assert z._producer is not None


def test_deep_tape_no_recursion_limit():
    got = []
    for dy, guard in ((jdy, jdy.guard()), (tdy, tdy.guard(CPU))):
        with guard:
            w = dy.to_variable(np.ones((2,), "f4"))
            y = w * 1.0
            for _ in range(1500):
                y = y + 0.001
            y.sum().backward()
            got.append((y.numpy(), w.gradient()))
    np.testing.assert_allclose(got[1][1], [1.0, 1.0], rtol=1e-6)
    for a, b in zip(got[1], got[0]):
        np.testing.assert_allclose(a, b, **TOL)


def test_backward_uses_forward_time_values():
    for dy, guard, new in ((jdy, jdy.guard(), None),
                           (tdy, tdy.guard(CPU), torch.tensor([10.0]))):
        with guard:
            w = dy.to_variable(np.array([2.0], "f4"))
            loss = (w * w).sum()     # dloss/dw at w=2 is 4
            if new is None:
                import jax.numpy as jnp

                w._value = jnp.asarray(np.array([10.0], "f4"))
            else:
                w._value = new       # an optimizer step
            loss.backward()
            np.testing.assert_allclose(w.gradient(), [4.0])


# -- layers -------------------------------------------------------------------

def _mlp_pair(xs):
    """fc(16, relu) -> fc(1) in both packages, the port's weights the
    reference's."""
    with jdy.guard():
        jl = [jnn.FC(size=16, act="relu"), jnn.FC(size=1)]
        jl[1](jl[0](jdy.to_variable(xs)))
    with tdy.guard(CPU):
        tl = [tnn.FC(size=16, act="relu"), tnn.FC(size=1)]
        tl[1](tl[0](tdy.to_variable(xs)))
    for j, t in zip(jl, tl):
        both_names_equal(j, t)
        carry(j, t)
    return jl, tl


def _train_mlp(dy, guard, layers, xs, ys, make_opt, steps=30):
    losses = []
    with guard:
        opt = make_opt(dy, layers[0].parameters() + layers[1].parameters())
        for _ in range(steps):
            pred = layers[1](layers[0](dy.to_variable(xs)))
            diff = pred - dy.to_variable(ys)
            loss = (diff * diff).mean()
            loss.backward()
            opt.minimize(loss)
            losses.append(float(loss.numpy()))
    return losses, [np.asarray(p.numpy()) for l in layers
                    for p in l.parameters()]


def _opt_twins(rng, make_opt, factor, steps=30):
    xs = rng.randn(16, 8).astype("f4")
    ys = xs @ rng.randn(8, 1).astype("f4")
    jl, tl = _mlp_pair(xs)
    jloss, jparams = _train_mlp(jdy, jdy.guard(), jl, xs, ys, make_opt,
                                steps)
    tloss, tparams = _train_mlp(tdy, tdy.guard(CPU), tl, xs, ys, make_opt,
                                steps)
    assert tloss[-1] < factor * tloss[0], (tloss[0], tloss[-1])
    np.testing.assert_allclose(tloss, jloss, **STEP_TOL)
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_dygraph_mlp_trains_with_optimizer(rng):
    """The reference's imperative MNIST pattern: forward, loss.backward(),
    optimizer.minimize, clear — the port's losses and weights follow the
    reference's for 30 Adam steps."""
    _opt_twins(rng, lambda dy, ps: dy.AdamOptimizer(0.05, parameter_list=ps),
               0.1)


@pytest.mark.parametrize("make_opt", [
    lambda dy, ps: dy.MomentumOptimizer(0.05, 0.9, parameter_list=ps),
    lambda dy, ps: dy.MomentumOptimizer(0.05, 0.9, use_nesterov=True,
                                        parameter_list=ps),
    lambda dy, ps: dy.AdagradOptimizer(0.2, parameter_list=ps),
    lambda dy, ps: dy.LambOptimizer(0.05, parameter_list=ps),
], ids=["momentum", "nesterov", "adagrad", "lamb"])
def test_dygraph_optimizer_family_trains(rng, make_opt):
    _opt_twins(rng, make_opt, 0.3)


def test_dygraph_weight_decay_shrinks_params():
    x = np.zeros((2, 4), "f4")
    out = []
    for dy, dnn, guard, pkg in ((jdy, jnn, jdy.guard(), fluid),
                                (tdy, tnn, tdy.guard(CPU), tfluid)):
        with guard:
            fc = dnn.FC(size=4)
            (fc(dy.to_variable(x)) * 0.0).mean().backward()
            params = fc.parameters()
            before = [np.asarray(p.numpy()).copy() for p in params]
            opt = dy.SGDOptimizer(
                0.5, parameter_list=params,
                regularization=pkg.regularizer.L2Decay(0.1))
            loss = (fc(dy.to_variable(x)) * 0.0).mean()
            loss.backward()
            opt.minimize(loss)
            out.append((before, [np.asarray(p.numpy()) for p in params]))
    (jb, ja), (tb, ta) = out
    for b, a in zip(tb, ta):
        np.testing.assert_allclose(a, b * (1 - 0.5 * 0.1), rtol=1e-5)
    # the port starts from its own draw: same rule, same shrink
    for j0, j1, t0, t1 in zip(jb, ja, tb, ta):
        np.testing.assert_allclose(t1 / np.where(t0 == 0, 1, t0),
                                   j1 / np.where(j0 == 0, 1, j0), **TOL)


def test_batchnorm_train_eval_and_running_stats(rng):
    x = rng.normal(2.0, 3.0, (8, 3, 4, 4)).astype("f4")
    res = []
    for dy, dnn, guard in ((jdy, jnn, jdy.guard()),
                           (tdy, tnn, tdy.guard(CPU))):
        with guard:
            bn = dnn.BatchNorm(num_channels=3, act="relu")
            out = bn(dy.to_variable(x))
            (out * out).sum().backward()
            g = bn._scale.gradient()
            stats = (np.asarray(bn._mean.numpy()), np.asarray(bn._var.numpy()))
            bn.eval()
            out2 = bn(dy.to_variable(x))
            res.append((out.numpy(), g, stats[0], stats[1], out2.numpy()))
    # train mode: normalized by batch stats, relu'd
    assert float(res[1][2].mean()) != 0.0  # stats updated
    assert abs(float(res[1][4].mean()) - float(res[1][0].mean())) > 0.1
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5)


def test_gru_unit_steps(rng):
    xv = rng.randn(2, 5).astype("f4")
    res, layers = [], []
    for dy, dnn, guard in ((jdy, jnn, jdy.guard()),
                           (tdy, tnn, tdy.guard(CPU))):
        with guard:
            gru = dnn.GRUUnit(size=3 * 6)
            h = dy.to_variable(np.zeros((2, 6), "f4"))
            gru(dy.to_variable(xv), h)  # build
            layers.append(gru)
            if len(layers) == 2:
                both_names_equal(*layers)
                carry(*layers)
            h1, reset_pre, gate = gru(dy.to_variable(xv), h)
            h2, _, _ = gru(dy.to_variable(xv), h1)
            assert reset_pre.shape == (2, 6) and gate.shape == (2, 12)
            assert not np.allclose(h1.numpy(), h2.numpy())
            (h2 * h2).sum().backward()
            res.append([h1.numpy(), h2.numpy(), reset_pre.numpy(),
                        gate.numpy()] + [p.gradient() for p in
                                         gru.parameters()])
    assert all(g is not None for g in res[1][4:])
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, **TOL)


def test_functional_export_jits(rng):
    """The functional export: apply(params, x) equals the eager forward,
    and the reference's jitted apply on the same weights."""
    import jax

    x = rng.randn(2, 8).astype("f4")
    with jdy.guard():
        jfc = jnn.FC(size=4)
        jfc(jdy.to_variable(x))
    japply, jparams = jfc.functional()
    want = np.asarray(jax.jit(japply)(jparams, x))
    with tdy.guard(CPU):
        tfc = tnn.FC(size=4)
        tfc(tdy.to_variable(x))
        carry(jfc, tfc)
        eager = tfc(tdy.to_variable(x)).numpy()
    tapply, tparams = tfc.functional()
    got = tapply(tparams, x).detach().numpy()
    np.testing.assert_allclose(got, eager, rtol=1e-6)
    np.testing.assert_allclose(got, want, **TOL)
    # a gradient through the export reaches the tensors the caller gave
    leaves = {n: p.detach().requires_grad_() for n, p in tparams.items()}
    g = torch.autograd.grad(tapply(leaves, x).sum(), list(leaves.values()))
    assert all(gi is not None for gi in g)


# every dygraph layer of nn.__all__, forward and gradients: (build(dnn),
# inputs(rng) -> list of arrays (float inputs get gradients), tolerance)
def _conv(dnn):
    return dnn.Conv2D(num_channels=3, num_filters=4, filter_size=3,
                      stride=2, padding=1, act="relu")


LAYER_CASES = {
    "fc_gelu": (lambda d: d.FC(size=5, num_flatten_dims=2, act="gelu"),
                lambda r: [r.randn(2, 3, 4)], TOL),
    "linear_tanh": (lambda d: d.Linear(size=3, act="tanh"),
                    lambda r: [r.randn(4, 6)], TOL),
    "conv2d": (_conv, lambda r: [r.randn(2, 3, 9, 9)],
               dict(atol=1e-4, rtol=1e-4)),
    "conv2d_grouped_dilated": (
        lambda d: d.Conv2D(num_channels=4, num_filters=4, filter_size=3,
                           padding=2, dilation=2, groups=2),
        lambda r: [r.randn(2, 4, 7, 7)], dict(atol=1e-4, rtol=1e-4)),
    "conv2d_transpose": (
        lambda d: d.Conv2DTranspose(num_channels=3, num_filters=2,
                                    filter_size=3, stride=2, padding=1,
                                    act="relu"),
        lambda r: [r.randn(2, 3, 5, 5)], dict(atol=1e-4, rtol=1e-4)),
    "pool2d_max": (lambda d: d.Pool2D(pool_size=3, pool_stride=2,
                                      pool_padding=1),
                   lambda r: [r.randn(2, 3, 7, 7)], TOL),
    "pool2d_avg": (lambda d: d.Pool2D(pool_size=3, pool_type="avg",
                                      pool_stride=2, pool_padding=1),
                   lambda r: [r.randn(2, 3, 7, 7)], TOL),
    "pool2d_global": (lambda d: d.Pool2D(pool_type="avg",
                                         global_pooling=True),
                      lambda r: [r.randn(2, 3, 5, 5)], TOL),
    "group_norm": (lambda d: d.GroupNorm(channels=4, groups=2),
                   lambda r: [r.randn(2, 4, 3, 3)], dict(atol=1e-4,
                                                         rtol=1e-4)),
    "layer_norm": (lambda d: d.LayerNorm(normalized_shape=6),
                   lambda r: [r.randn(3, 4, 6)], dict(atol=1e-4,
                                                      rtol=1e-4)),
    "embedding_padding_idx": (
        lambda d: d.Embedding(size=[10, 4], padding_idx=3),
        lambda r: [r.randint(0, 10, (3, 5, 1)).astype("int32")], TOL),
    "prelu": (lambda d: d.PRelu(), lambda r: [r.randn(3, 4)], TOL),
    "bilinear_tensor_product": (
        lambda d: d.BilinearTensorProduct(input1_dim=3, input2_dim=4,
                                          output_dim=2, act="sigmoid"),
        lambda r: [r.randn(5, 3), r.randn(5, 4)], TOL),
    "spectral_norm": (
        lambda d: d.SpectralNorm(weight_shape=[4, 3, 2], dim=1,
                                 power_iters=2),
        lambda r: [r.randn(4, 3, 2)], dict(atol=1e-4, rtol=1e-4)),
    "nce_one_class": (
        lambda d: d.NCE(num_total_classes=1, dim=6, num_neg_samples=3),
        lambda r: [r.randn(4, 6), np.zeros((4, 1), "int32")], TOL),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_reference(case, rng):
    build, inputs, tol = LAYER_CASES[case]
    arrays = [a.astype("f4") if a.dtype.kind == "f" else a
              for a in inputs(rng)]
    res, layers, buffers = [], [], []
    for dy, dnn, guard in ((jdy, jnn, jdy.guard()),
                           (tdy, tnn, tdy.guard(CPU))):
        with guard:
            layer = build(dnn)
            if case == "spectral_norm":  # the power iteration's buffers
                if buffers:
                    layer._u, layer._v = (torch.tensor(b) for b in buffers)
                else:
                    buffers = [np.array(layer._u), np.array(layer._v)]
            vs = [dy.to_variable(a) for a in arrays]
            for v, a in zip(vs, arrays):
                v.stop_gradient = a.dtype.kind != "f"
            layer(*vs)  # build the lazy ones
            layers.append(layer)
            if len(layers) == 2:
                both_names_equal(*layers)
                carry(*layers)
            vs = [dy.to_variable(a) for a in arrays]
            for v, a in zip(vs, arrays):
                v.stop_gradient = a.dtype.kind != "f"
            out = layer(*vs)
            (out * out).sum().backward()
            res.append([out.numpy()] + [v.gradient() for v in vs
                                        if not v.stop_gradient]
                       + [p.gradient() for p in layer.parameters()])
    assert len(res[0]) == len(res[1])
    for a, b in zip(res[1], res[0]):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_its_share(p):
    """Different generators: held by the keep share (within 4 standard
    errors of 1 - p in both packages) and the kept values' 1 / (1 - p)
    scale; eval and p = 0 are the identity."""
    x = np.ones((64, 256), "f4")
    for dy, dnn, guard in ((jdy, jnn, jdy.guard()),
                           (tdy, tnn, tdy.guard(CPU))):
        with guard:
            drop = dnn.Dropout(p=p)
            out = drop(dy.to_variable(x)).numpy()
            kept = out != 0
            se = np.sqrt(p * (1 - p) / x.size)
            assert abs(kept.mean() - (1 - p)) < 4 * se
            np.testing.assert_allclose(out[kept], 1 / (1 - p), rtol=1e-6)
            drop.eval()
            np.testing.assert_array_equal(drop(dy.to_variable(x)).numpy(), x)


def test_dygraph_bert_lamb_step():
    """The BERT-dygraph route under Lamb (tiny shapes, dropout 0): four
    functional steps of the port's ``make_train_step`` follow the
    reference's jitted ones, loss within 1e-4 relative, parameters within
    atol / rtol 1e-4, and the loss falls."""
    import jax
    from paddle_tpu.models import bert_dygraph as jbd
    from paddle_tpu_torch.models import bert_dygraph as tbd

    cfg = dict(vocab_size=64, seq_len=8, d_model=16, d_ff=32, n_layer=1,
               n_head=2, dropout_rate=0.0, amp=False)
    feeds = jbd.sample_batch(2, 8, 64, np.random.RandomState(0))
    jmodel = jbd.bert_base_dygraph(**cfg)[0]
    with jdy.guard():
        jmodel(*feeds)
    jstep, jparams, jopt = jbd.make_train_step(
        jmodel, learning_rate=1e-3, optimizer="lamb")
    jstep = jax.jit(jstep)
    with tdy.guard(CPU):
        tmodel = tbd.bert_base_dygraph(**cfg)[0]
        tmodel(*feeds)
    carry(jmodel, tmodel)
    tstep, tparams, topt = tbd.make_train_step(
        tmodel, learning_rate=1e-3, optimizer="lamb")
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    jl, tl = [], []
    for _ in range(4):
        key, sub = jax.random.split(key)
        loss, jparams, jopt = jstep(jparams, jopt, sub, *feeds)
        jl.append(float(loss))
        tl.append(float(tstep(tparams, topt, gen, *feeds)[0]))
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    for n, v in jparams.items():
        np.testing.assert_allclose(tparams[n].numpy(), np.asarray(v),
                                   err_msg=n, **PARAM_TOL)
