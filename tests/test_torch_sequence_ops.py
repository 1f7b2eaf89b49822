"""The sequence ops of the port (``core/opimpl/sequence_ops.py``) and
their layers (``layers/sequence_lod.py``) against ``paddle_tpu`` on the
CPU, one parametrised case per op and per pooling type, over padded
[B, T, ...] batches with lengths below the padded size.

Each case runs as ``test_torch_rnn_ops.py`` runs its cases: the same
program in both packages on the same numpy inputs, every output within
1e-5 absolute (integer outputs exactly) and the gradient of sum(out * c)
w.r.t. every float input and parameter within 1e-4 relative L2. ``x_tied``
holds whole numbers, so MAX pooling meets tied maxima: both packages
share a tied maximum's gradient equally among its steps."""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from test_torch_optimizers import fresh_port_programs  # noqa: F401
from test_torch_rnn_ops import assert_matches_reference

B, T, D = 3, 6, 4


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    return {
        "x": f(B, T, D), "y": f(B, 2, D), "s": f(B, T),
        "x_tied": rng.randint(-2, 3, (B, T, D)).astype("float32"),
        "lengths": np.array([6, 3, 1], "int64"),
        "ids": rng.randint(0, 5, (B, T)).astype("int64"),
        "offset": np.array([2], "int64"),
        "row": f(B, D),
    }


def _pool(ptype, x="x"):
    return ([x], ["lengths"], lambda pkg, v: [
        pkg.layers.sequence_pool(v[x], ptype, lengths=v["lengths"])])


CASES = {
    "pool_sum": _pool("sum"),
    "pool_average": _pool("average"),
    "pool_sqrt": _pool("sqrt"),
    "pool_max": _pool("max"),
    "pool_max_tied": _pool("max", "x_tied"),
    "pool_last": _pool("last"),
    "pool_first": _pool("first"),
    "first_step": (["x"], ["lengths"], lambda pkg, v: [
        pkg.layers.sequence_first_step(v["x"], lengths=v["lengths"])]),
    "last_step": (["x"], ["lengths"], lambda pkg, v: [
        pkg.layers.sequence_last_step(v["x"], lengths=v["lengths"])]),
    "softmax": (["s"], ["lengths"], lambda pkg, v: [
        pkg.layers.sequence_softmax(v["s"], lengths=v["lengths"])]),
    "reverse": (["x"], ["lengths"], lambda pkg, v: [
        pkg.layers.sequence_reverse(v["x"], lengths=v["lengths"])]),
    "expand": (["row"], ["x"], lambda pkg, v: [
        pkg.layers.sequence_expand(v["row"], v["x"])]),
    "conv": (["x"], [], lambda pkg, v: [
        pkg.layers.sequence_conv(v["x"], num_filters=5, filter_size=3,
                                 act="tanh")]),
    "concat": (["x", "y"], [], lambda pkg, v: [
        pkg.layers.sequence_concat([v["x"], v["y"]])]),
    "slice": (["x"], ["offset"], lambda pkg, v: [
        pkg.layers.sequence_slice(v["x"], v["offset"], 3)]),
    "pad": (["x"], ["lengths"], lambda pkg, v: list(
        pkg.layers.sequence_pad(v["x"], lengths=v["lengths"]))),
    "unpad": (["x"], ["lengths"], lambda pkg, v: [
        pkg.layers.sequence_unpad(v["x"], length=v["lengths"])]),
    "enumerate": ([], ["ids"], lambda pkg, v: [
        pkg.layers.sequence_enumerate(v["ids"], win_size=3, pad_value=7)]),
    "erase": ([], ["ids"], lambda pkg, v: [
        pkg.layers.sequence_erase(v["ids"], tokens=[1, 3])]),
    "mask": ([], ["lengths"], lambda pkg, v: [
        pkg.layers.sequence_mask(v["lengths"], maxlen=T, dtype="float32")]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_op_matches_reference(name):
    floats, others, build = CASES[name]
    feed = {k: a for k, a in _inputs().items() if k in floats + others}
    assert_matches_reference(build, feed, floats, name)


def test_every_sequence_op_has_a_case():
    """The port registers every op type of the reference's
    ``sequence_ops``, and each appears in a case's program."""
    import paddle_tpu.core.op_registry as jreg
    import paddle_tpu_torch.core.op_registry as treg

    ref = {n for n, f in jreg.OP_IMPLS.items()
           if f.__module__.endswith(".sequence_ops")}
    assert len(ref) == 12 and ref <= set(treg.OP_IMPLS)
    seen = set()
    for floats, others, build in CASES.values():
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            v = {k: tfluid.layers.data(k, shape=list(a.shape),
                                       dtype=str(a.dtype),
                                       append_batch_size=False)
                 for k, a in _inputs().items() if k in floats + others}
            build(tfluid, v)
        seen |= {op.type for op in main.global_block().ops}
    assert ref <= seen
