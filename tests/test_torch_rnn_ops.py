"""The LSTM ops of the port (``core/opimpl/rnn_ops.py``: ``lstm_seq``,
``lstmp_seq``, ``attention_lstm``; and ``tree_conv``) and their layers
(``dynamic_lstm``, ``dynamic_lstmp``, ``attention_lstm``, ``tree_conv``,
``lstm``) against ``paddle_tpu`` on the CPU.

Each case builds the same program in both packages on the same numpy
inputs (seed 0) and the same parameters (the port's startup run, set into
the reference's scope), and fetches every output and the gradient of
sum(out * c) (c a fed random cotangent) w.r.t. every float input and
every parameter: the outputs within 1e-5 absolute, the gradients within
1e-4 relative L2 (f32 recursions over a few steps, summed in other
orders). Lengths below the padded size exercise the masked steps, forward
and reversed (a reversed row's padded tail keeps the initial state)."""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401

OUT_ATOL = 1e-5
GRAD_REL_L2 = 1e-4
B, T, H = 3, 5, 4


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: (0.5 * rng.randn(*s)).astype("float32")  # noqa: E731
    edges = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6], [0, 0]],
                      [[1, 2], [2, 3], [3, 4], [1, 5], [0, 0], [0, 0]]],
                     "int64")
    return {
        "proj": f(B, T, 4 * H), "h0": f(B, H), "c0": f(B, H),
        "r0": f(B, 2), "seq": f(B, T, 6),
        "lengths": np.array([5, 2, 4], "int64"),
        "nodes": f(2, 6, 3), "edges": edges,
    }


def run_case(pkg, build, feed, floats, state=None, seed=5):
    """Build ``build(pkg, vars)`` over data vars of ``feed`` in fresh
    programs, run its startup (``state``, a {name: array}, replaces the
    persistables it made) and return (outputs + gradients of sum(out * c)
    w.r.t. the ``floats`` inputs and every parameter, the startup state,
    the parameter names)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        v = {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False, stop_gradient=k not in floats)
             for k, a in feed.items()}
        outs = list(build(pkg, v))
        terms, cots = [], {}
        for i, o in enumerate(outs):
            if str(o.dtype) != "float32":
                continue
            c = L.data("cot%d" % i, shape=list(o.shape), dtype="float32",
                       append_batch_size=False)
            cots[c.name] = np.asarray(np.random.RandomState(i).randn(
                *o.shape), "float32")
            terms.append(L.reduce_sum(L.elementwise_mul(o, c)))
        params = sorted(p.name for p in main.all_parameters())
        gb = main.global_block()
        wrt = [v[k] for k in floats] + [gb.var(n) for n in params]
        grads = []
        if terms and wrt:
            total = terms[0] if len(terms) == 1 else L.sums(terms)
            grads = pkg.gradients(total, wrt)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        if state is None:
            state = {p.name: scope.numpy(p.name).copy()
                     for p in startup.list_vars() if p.persistable}
        else:
            for n, a in state.items():
                scope.set(n, jnp.asarray(a))
        got = exe.run(main, feed=dict(feed, **cots),
                      fetch_list=outs + list(grads))
    return got, len(outs), state, params


def rel_l2(got, want):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def assert_matches_reference(build, feed, floats, name):
    """The port's run of a case against the reference's (the port's
    startup state in both)."""
    got, n_out, state, params = run_case(tfluid, build, feed, floats)
    want, _, _, jparams = run_case(fluid, build, feed, floats, state)
    assert params == jparams
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg="%s %d" % (name, i))
        elif i < n_out:
            np.testing.assert_allclose(g, w, rtol=0, atol=OUT_ATOL,
                                       err_msg="%s %d" % (name, i))
        else:
            assert np.abs(w).max() > 0, (name, i)
            assert rel_l2(g, w) <= GRAD_REL_L2, (name, i, rel_l2(g, w))


CASES = {
    "lstm_seq": (["proj", "h0", "c0"], ["lengths"], lambda pkg, v:
                 pkg.layers.dynamic_lstm(
                     v["proj"], 4 * H, lengths=v["lengths"], h_0=v["h0"],
                     c_0=v["c0"])),
    "lstm_seq_reverse": (["proj"], ["lengths"], lambda pkg, v:
                         pkg.layers.dynamic_lstm(
                             v["proj"], 4 * H, lengths=v["lengths"],
                             is_reverse=True, use_peepholes=True)),
    "lstm_seq_no_lengths": (["proj"], [], lambda pkg, v:
                            pkg.layers.dynamic_lstm(v["proj"], 4 * H)),
    "lstmp_seq": (["proj", "r0", "c0"], ["lengths"], lambda pkg, v:
                  pkg.layers.nn.dynamic_lstmp(
                      v["proj"], 4 * H, 2, lengths=v["lengths"],
                      h_0=v["r0"], c_0=v["c0"], cell_clip=0.4,
                      proj_clip=0.3)),
    "lstmp_seq_reverse_identity": (["proj"], ["lengths"], lambda pkg, v:
                                   pkg.layers.nn.dynamic_lstmp(
                                       v["proj"], 4 * H, 3,
                                       lengths=v["lengths"],
                                       is_reverse=True,
                                       proj_activation="identity")),
    "attention_lstm": (["seq", "h0", "c0"], ["lengths"], lambda pkg, v:
                       pkg.layers.nn.attention_lstm(
                           v["seq"], H, lengths=v["lengths"], h_0=v["h0"],
                           c_0=v["c0"])),
    "tree_conv": (["nodes"], ["edges"], lambda pkg, v: [
        pkg.layers.nn.tree_conv(v["nodes"], v["edges"], output_size=4,
                             num_filters=2, max_depth=3)]),
    "lstm_bidirectional": (["seq"], ["lengths"], lambda pkg, v:
                           pkg.layers.lstm(v["seq"], hidden_size=H,
                                           num_layers=2, is_bidirec=True,
                                           lengths=v["lengths"])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_rnn_op_matches_reference(name):
    floats, others, build = CASES[name]
    feed = {k: a for k, a in _inputs().items() if k in floats + others}
    assert_matches_reference(build, feed, floats, name)


def test_lstmp_refuses_an_activation_the_reference_replaces():
    """The reference looks ``proj_activation`` up in ``jnp`` and applies
    tanh for 'relu'; the port refuses it instead of doing the same."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        proj = tfluid.layers.data("proj", shape=[B, T, 4 * H],
                                  append_batch_size=False)
        out, _ = tfluid.layers.dynamic_lstmp(proj, 4 * H, 2,
                                             proj_activation="relu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    with pytest.raises(NotImplementedError, match="relu"):
        exe.run(main, feed={"proj": _inputs()["proj"]}, fetch_list=[out])


def test_every_rnn_op_has_a_case():
    """The four op types this slice added to ``rnn_ops`` appear in the
    cases' programs, and the port registers every op type of the
    reference's ``rnn_ops``."""
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch.core.op_registry as treg

    ref = {n for n, f in jreg.OP_IMPLS.items()
           if f.__module__.endswith(".rnn_ops")}
    assert ref <= set(treg.OP_IMPLS)
    seen = set()
    for name, (floats, others, build) in CASES.items():
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            v = {k: tfluid.layers.data(k, shape=list(a.shape),
                                       dtype=str(a.dtype),
                                       append_batch_size=False)
                 for k, a in _inputs().items() if k in floats + others}
            build(tfluid, v)
        seen |= {op.type for op in main.global_block().ops}
    assert {"lstm_seq", "lstmp_seq", "attention_lstm", "tree_conv"} <= seen
