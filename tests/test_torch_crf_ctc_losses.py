"""The CTC, CRF, NCE and hierarchical-sigmoid losses of the port
(``core/opimpl/loss_ops.py``: ``warpctc``, ``linear_chain_crf``,
``crf_decoding``, ``nce``, ``hsigmoid``) and their layers against
``paddle_tpu`` on the CPU.

Each case runs as ``test_torch_rnn_ops.py`` runs its cases: the same
program in both packages on the same numpy inputs and parameters, every
output within 1e-5 absolute (a Viterbi path or its correctness mask
exactly) and the gradient of sum(out * c) w.r.t. every float input and
parameter within 1e-4 relative L2. warpctc meets an empty label (its
only path all blanks), lengths below the padded sizes and
``norm_by_times`` (which scales the gradient only); crf_decoding meets
all-tied scores (a zero transition and emission: the first index on both
sides). nce takes the reference's negatives for its seed (the
``reference_nce_draws`` fixture of ``test_torch_rnn_zoo.py``); the port's
own sampler is held by its frequencies over 200,000 draws."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.opimpl import loss_ops as t_loss_ops
from test_torch_optimizers import fresh_port_programs  # noqa: F401
from test_torch_rnn_ops import assert_matches_reference
from test_torch_rnn_zoo import reference_nce_draws  # noqa: F401

B, T, C, L_MAX = 3, 8, 5, 3
V, DIM, K_NEG = 20, 6, 4


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    return {
        "logits": f(B, T, C),
        "ctc_label": rng.randint(1, C, (B, L_MAX)).astype("int64"),
        "in_len": np.array([8, 5, 6], "int64"),
        "lb_len": np.array([3, 0, 2], "int64"),
        "emission": f(B, 5, 4),
        "zeros": np.zeros((B, 5, 4), "float32"),
        "tags": rng.randint(0, 4, (B, 5)).astype("int64"),
        "length": np.array([5, 2, 4], "int64"),
        "x": f(B * 2, DIM),
        "word": rng.randint(0, V, (B * 2, 1)).astype("int64"),
        "cls": rng.randint(0, 6, (B * 2, 1)).astype("int64"),
        "path_table": np.array([[0, 1, -1], [0, 2, 3], [1, -1, -1],
                                [0, 1, 2], [3, 2, -1], [2, -1, -1]],
                               "int64"),
        "path_code": np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0],
                               [0, 0, 1], [1, 1, 0], [0, 0, 0]], "int64"),
    }


def _crf(pkg, v, emission, label=None, init=None):
    attr = pkg.ParamAttr(name="crfw", initializer=init)
    cost = pkg.layers.linear_chain_crf(v[emission], v["tags"],
                                       param_attr=attr, length=v["length"])
    path = pkg.layers.crf_decoding(v[emission], param_attr=attr,
                                   label=v[label] if label else None,
                                   length=v["length"])
    return [cost, path]


def _ctc(**kw):
    return lambda pkg, v: [pkg.layers.warpctc(
        v["logits"], v["ctc_label"], blank=0,
        input_length=v["in_len"], label_length=v["lb_len"], **kw)]


def _nce(sampler):
    return (["x"], ["word"], lambda pkg, v: [pkg.layers.nce(
        v["x"], v["word"], V, num_neg_samples=K_NEG, sampler=sampler,
        seed=7)])


CASES = {
    "warpctc": (["logits"], ["ctc_label", "in_len", "lb_len"], _ctc()),
    "warpctc_norm_by_times": (["logits"], ["ctc_label", "in_len", "lb_len"],
                              _ctc(norm_by_times=True)),
    "warpctc_padded_sizes": (["logits"], ["ctc_label"], lambda pkg, v: [
        pkg.layers.warpctc(v["logits"], v["ctc_label"], blank=C - 1)]),
    "crf": (["emission"], ["tags", "length"],
            lambda pkg, v: _crf(pkg, v, "emission")),
    "crf_decoding_with_label": (["emission"], ["tags", "length"],
                                lambda pkg, v: _crf(pkg, v, "emission",
                                                    label="tags")),
    "crf_decoding_ties": (["zeros"], ["tags", "length"], lambda pkg, v: _crf(
        pkg, v, "zeros", init=pkg.initializer.Constant(0.0))),
    "nce_uniform": _nce("uniform"),
    "nce_log_uniform": _nce("log_uniform"),
    "hsigmoid": (["x"], ["cls"], lambda pkg, v: [pkg.layers.hsigmoid(
        v["x"], v["cls"], 6)]),
    "hsigmoid_custom": (["x"], ["cls", "path_table", "path_code"],
                        lambda pkg, v: [pkg.layers.hsigmoid(
                            v["x"], v["cls"], 4,
                            path_table=v["path_table"],
                            path_code=v["path_code"], is_custom=True)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_op_matches_reference(name, reference_nce_draws):
    floats, others, build = CASES[name]
    feed = {k: a for k, a in _inputs().items() if k in floats + others}
    assert_matches_reference(build, feed, floats, name)


def test_ctc_empty_label_is_the_all_blank_path():
    """A row with an empty label costs -sum_t log p_t(blank), read once
    (not twice through the clamped second readout)."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    main, startup = tfluid.Program(), tfluid.Program()
    v = _inputs()
    with tfluid.program_guard(main, startup):
        d = {k: tfluid.layers.data(k, shape=list(v[k].shape),
                                   dtype=str(v[k].dtype),
                                   append_batch_size=False)
             for k in ("logits", "ctc_label", "in_len", "lb_len")}
        loss = _ctc()(tfluid, d)[0]
    exe.run(startup)
    got, = exe.run(main, feed={k: v[k] for k in d}, fetch_list=[loss])
    logp = torch.log_softmax(torch.from_numpy(v["logits"][1]), dim=-1)
    want = -float(logp[:v["in_len"][1], 0].sum())
    assert abs(float(got[1, 0]) - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_sampler_frequencies(sampler):
    """The port's draw of 200,000 negatives over V = 20 classes: each
    class's frequency within 5 standard errors of q(class) (uniform 1/V;
    log-uniform (log(c + 2) - log(c + 1)) / log(V + 1))."""
    n = 200000
    gen = torch.Generator().manual_seed(3)
    neg = t_loss_ops.nce_negatives(gen, n // 10, 10, V, sampler, "cpu")
    assert neg.dtype == torch.long and neg.min() >= 0 and neg.max() < V
    freq = np.bincount(neg.reshape(-1).numpy(), minlength=V) / n
    ids = np.arange(V)
    q = (np.full(V, 1.0 / V) if sampler == "uniform" else
         (np.log(ids + 2.0) - np.log(ids + 1.0)) / math.log(V + 1.0))
    assert abs(q.sum() - 1.0) < 1e-9
    se = np.sqrt(q * (1 - q) / n)
    assert np.all(np.abs(freq - q) <= 5 * se), (freq, q)
    got = t_loss_ops._log_q(sampler, torch.arange(V), V).numpy()
    np.testing.assert_allclose(got, np.log(q), rtol=1e-5)


def test_seeded_nce_draws_once_per_op():
    """A fixed ``seed`` gives the same negatives every run (and on every
    device: they are drawn by a CPU generator and copied once); seed 0
    draws from the executor's generator each run."""
    outs = {}
    for seed in (7, 0):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[DIM])
            w = tfluid.layers.data("word", shape=[1], dtype="int64")
            cost = tfluid.layers.nce(x, w, V, num_neg_samples=K_NEG,
                                     seed=seed)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        feed = {k: _inputs()[k] for k in ("x", "word")}
        outs[seed] = [exe.run(main, feed=feed, fetch_list=[cost])[0]
                      for _ in range(2)]
    np.testing.assert_array_equal(outs[7][0], outs[7][1])
    assert not np.array_equal(outs[0][0], outs[0][1])


def test_every_loss_op_has_a_case():
    """The port registers every op type of the reference's ``loss_ops``,
    and each appears in a case's program."""
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch.core.op_registry as treg

    ref = {n for n, f in jreg.OP_IMPLS.items()
           if f.__module__.endswith(".loss_ops")}
    assert len(ref) == 5 and ref <= set(treg.OP_IMPLS)
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
    assert ref <= seen
