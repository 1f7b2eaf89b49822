"""Control flow, tensor arrays, the GRU ops and the beam-search ops of the
port (``control_ops.py``: ``while_block``, ``cond_block``,
``scan_block``; ``decode_ops.py``; ``rnn_ops.py``: ``gru_seq``,
``gru_unit``; ``layers/control_flow.py``) against ``paddle_tpu`` on the
CPU, one case per construct or op.

Each case builds the same program in both packages on the same numpy
inputs; the reference initialises any parameters and the port takes them
(``bridge.load_numpy_params``). Outputs agree within rtol 1e-5 /
atol 1e-6 (f32; integer outputs exactly), and so do the gradients of
sum(out * c), c a fed random cotangent, w.r.t. the inputs and parameters
of the cases the reference differentiates (not a While: ``lax.while_loop``
has no reverse mode), within atol 2e-5 / rtol 1e-4 where a GRU's products
sum over time. ``DynamicRNN`` is also held to its contract
(``tests/test_decode.py:178``): outputs past a row's length are zero and
its prefix equals a full-length run's."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
GRU_TOL = dict(atol=2e-5, rtol=1e-4)
B, T, D, H = 3, 5, 4, 6
LENS = np.array([5, 2, 4], "int64")


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    logp = np.log(np.random.RandomState(1).dirichlet(np.ones(7), (2, 3)))
    # row 0's live beams extend far below its finished one's frozen score:
    # the finished beam's other extensions (-1e9) must still lose to them
    logp[0, [0, 2]] -= 5000.0
    return {
        "x": f(2, 3), "seq": f(B, T, D), "proj": f(B, T, 3 * H),
        "h0": f(B, H), "step_x": f(B, 3 * H), "lens": LENS,
        "state": f(2, 3, 4),
        "parent": np.array([[2, 2, 0], [1, 0, 1]], "int32"),
        # beam 1 of row 0 finished (id 1 = end), ties among row 1's beams
        "pre_ids": np.array([[4, 1, 3], [5, 5, 2]], "int64"),
        "pre_scores": np.array([[-1.0, -1.5, -2.0], [-0.5, -0.5, -3.0]],
                               "float32"),
        "logp": logp.astype("float32"),
        "ids_arr": np.random.RandomState(2).randint(
            0, 9, (4, 2, 3)).astype("int64"),
        "par_arr": np.random.RandomState(3).randint(
            0, 3, (4, 2, 3)).astype("int32"),
        "final": f(2, 3),
    }


def _const(pkg, value, dtype="int64"):
    return pkg.layers.fill_constant([], dtype, value)


def _while_arrays(pkg, v):
    """Double x three times in a While; write each value into an array
    (slot 0 before the loop); read slot 2; the fill level is 4."""
    L = pkg.layers
    i, n = _const(pkg, 0), _const(pkg, 3)
    acc = L.scale(v["x"], 1.0)
    arr = L.array_write(acc, i, L.create_array("float32", capacity=6))
    cond = L.less_than(i, n)
    w = L.While(cond, loop_vars=[i, acc, arr])
    with w.block():
        nxt = L.elementwise_add(L.scale(acc, 2.0), v["x"])
        L.increment(i, 1)
        L.array_write(nxt, i, arr)
        L.assign(nxt, acc)
        L.less_than(i, n, cond=cond)
    return [acc, arr, L.array_length(arr), L.array_read(arr, _const(pkg, 2)),
            i]


def _arrays_outside(pkg, v):
    L = pkg.layers
    arr = L.array_write(v["x"], _const(pkg, 1), capacity=3)
    arr = L.array_write(L.scale(v["x"], -2.0), _const(pkg, 0), arr)
    read = L.array_read(arr, _const(pkg, 1))
    read.shape, arr.shape = (2, 3), (3, 2, 3)  # the layers declare none
    return [read, L.array_length(arr), arr]


def _cond(which):
    def build(pkg, v):
        L = pkg.layers
        pred = L.less_than(_const(pkg, 0.0 if which else 1.0, "float32"),
                           _const(pkg, 0.5, "float32"))
        return [L.cond(pred, lambda: L.scale(v["x"], 2.0),
                       lambda: L.tanh(v["x"]))]
    return build


def _if_else(pkg, v):
    L = pkg.layers
    pred = L.less_than(L.reduce_sum(v["x"]), _const(pkg, 100.0, "float32"))
    ie = L.IfElse(pred)
    with ie.true_block():
        xi = ie.input(v["x"])
        ie.output(L.scale(xi, 3.0), L.exp(xi))
    with ie.false_block():
        xi = ie.input(v["x"])
        ie.output(L.scale(xi, -1.0), L.sigmoid(xi))
    return ie()


def _rnn(cls, lengths):
    def build(pkg, v):
        L = pkg.layers
        rnn = getattr(L, cls)()
        with rnn.step():
            x_t = rnn.step_input(v["seq"])
            mem = rnn.memory(shape=[H], batch_ref=v["seq"])
            nh = L.fc(L.concat([x_t, mem], axis=-1), size=H, act="tanh",
                      name="cell")
            rnn.update_memory(mem, nh)
            rnn.step_output(nh)
        return [rnn(lengths=v["lens"]) if lengths else rnn()]
    return build


def _gru(**kw):
    def build(pkg, v):
        return [pkg.layers.dynamic_gru(v["proj"], size=H, lengths=v["lens"],
                                       **kw)]
    return build


# case -> (float inputs differentiated (None: no gradients), other
# inputs, build(pkg, v) -> output vars)
CASES = {
    "while_arrays": (None, ["x"], _while_arrays),
    "arrays_outside_loop": (["x"], [], _arrays_outside),
    "cond_true": (["x"], [], _cond(True)),
    "cond_false": (["x"], [], _cond(False)),
    "if_else": (["x"], [], _if_else),
    "static_rnn": (["seq"], ["lens"], _rnn("StaticRNN", False)),
    "dynamic_rnn": (["seq"], ["lens"], _rnn("DynamicRNN", True)),
    "gru_seq": (["proj"], ["lens"], _gru()),
    "gru_seq_reverse": (["proj"], ["lens"], _gru(is_reverse=True)),
    "gru_seq_origin_mode": (["proj"], ["lens"], _gru(origin_mode=True)),
    "gru_unit": (["step_x", "h0"], [], lambda pkg, v: [pkg.layers.gru_unit(
        v["step_x"], v["h0"], 3 * H)]),
    "beam_search_step": (None, ["pre_ids", "pre_scores", "logp"],
                         lambda pkg, v: list(pkg.layers.beam_search(
                             v["pre_ids"], v["pre_scores"], v["logp"], 3,
                             end_id=1))),
    "beam_search_gather": (["state"], ["parent"], lambda pkg, v: [
        pkg.layers.beam_search_gather(v["state"], v["parent"])]),
    "beam_search_decode": (None, ["ids_arr", "par_arr", "final"],
                           lambda pkg, v: list(pkg.layers.beam_search_decode(
                               v["ids_arr"], v["par_arr"], _const(pkg, 3),
                               v["final"], 3, end_id=1))),
}


def _run(pkg, name, feed, params=None):
    """(fetches, the parameters the run used). The reference's startup
    draws them; the port takes ``params``."""
    floats, _, build = CASES[name]
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup):
        pkg.unique_name.switch()
        v = {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False) for k, a in feed.items()}
        outs = build(pkg, v)
        grads, cots = [], {}
        if floats is not None:
            terms = []
            for i, o in enumerate(outs):
                if str(o.dtype) != "float32":
                    continue
                c = L.data("cot%d" % i, shape=list(o.shape), dtype="float32",
                           append_batch_size=False)
                cots[c.name] = np.asarray(np.random.RandomState(i).randn(
                    *o.shape), "float32")
                terms.append(L.reduce_sum(L.elementwise_mul(o, c)))
            total = terms[0] if len(terms) == 1 else L.sums(terms)
            grads = pkg.gradients(total, [v[k] for k in floats]
                                  + main.all_parameters())
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    names = [p.name for p in main.all_parameters()]
    with pkg.scope_guard(scope):
        exe.run(startup)
        if params is None:
            params = {n: np.asarray(scope.get(n)) for n in names}
        else:
            pkg.bridge.load_numpy_params(scope, params, device="cpu",
                                         program=main)
        return exe.run(main, feed=dict(feed, **cots),
                       fetch_list=list(outs) + list(grads)), params


def _compare(name, got, want):
    tol = GRU_TOL if name.startswith(("gru", "static", "dynamic")) else dict(
        rtol=RTOL, atol=ATOL)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg="%s %d" % (name, i))
        else:
            np.testing.assert_allclose(g, w, err_msg="%s %d" % (name, i),
                                       **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(name):
    floats, others, _ = CASES[name]
    feed = {k: a for k, a in _inputs().items()
            if k in (floats or []) + others}
    want, params = _run(fluid, name, feed)
    got, _ = _run(tfluid, name, feed, params)
    _compare(name, got, want)
    if name == "dynamic_rnn":  # frozen past each row's length
        out = got[0]
        assert np.abs(out[1, 2:]).max() == 0.0
        assert np.abs(out[2, 4:]).max() == 0.0
        full, _ = _run(tfluid, name, dict(feed, lens=np.full(B, T, "int64")),
                       params)
        np.testing.assert_allclose(out[1, :2], full[0][1, :2], rtol=1e-6)
    if name == "while_arrays":
        assert int(got[2]) == 4 and int(got[4]) == 3


def test_every_block_decode_and_gru_op_has_a_case():
    """The 11 op types of this group are registered and each appears in
    some case's program (a block op's body included)."""
    from paddle_tpu_torch.core import op_registry
    from paddle_tpu_torch.core.executor import _with_bodies

    want = {"cond_block", "while_block", "scan_block", "array_write",
            "array_read", "array_length", "beam_search_step",
            "beam_search_gather", "beam_search_decode", "gru_seq",
            "gru_unit"}
    assert want <= set(op_registry.OP_IMPLS)
    seen = set()
    for name, (floats, others, build) in CASES.items():
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            v = {k: tfluid.layers.data(k, shape=list(a.shape),
                                       dtype=str(a.dtype),
                                       append_batch_size=False)
                 for k, a in _inputs().items() if k in (floats or [])
                 + others}
            build(tfluid, v)
        seen |= {op.type for op in _with_bodies(main.global_block().ops)}
    assert want - seen == set()


def test_block_ops_read_their_bodies_free_names():
    """The port's dataflow reads of each op of the beam decode program
    (its While reads the weights and encoder states its body uses) equal
    the reference's ``effective_reads``."""
    from paddle_tpu.analysis.dataflow import effective_reads
    from paddle_tpu.models import machine_translation as jmt
    from paddle_tpu_torch.analysis.dataflow import own_reads

    kw = dict(src_vocab=23, trg_vocab=23, seq_len=6, emb_dim=8, hid_dim=8,
              beam_size=2, max_out_len=4)
    reads = []
    for pkg, mt, fn in ((fluid, jmt, effective_reads),
                        (tfluid, tfluid.models.machine_translation,
                         own_reads)):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            pkg.unique_name.switch()
            mt.seq2seq_attention_infer(**kw)
        reads.append([(op.type, sorted(fn(op)))
                      for op in main.global_block().ops])
    assert reads[0] == reads[1]
    loop = dict(reads[1])["while_block"]
    assert "mt_out_fc_w" in loop and "dec_attn.q" in loop
