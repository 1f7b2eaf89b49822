"""Def-use structure of an op list: the part of
``paddle_tpu/analysis/dataflow.py`` that ``core/epilogue_fusion.py`` proves
its rewrites on (copied: importing it from ``paddle_tpu`` pulls in jax).

An op reads its input names, and an ``autodiff``/``autodiff_vjp`` op also
the ``wrt_names`` it differentiates; it writes its output names. Those
replay ops' ``fwd_ops`` lists alias the enclosing ops and are not recursed
into. The port runs no control-flow or Switch-guarded op, so the
reference's sub-regions and read-modify-write reads are left out.
"""

__all__ = ["OpNode", "Region", "build_region"]

_REPLAY_OPS = frozenset({"autodiff", "autodiff_vjp"})


class OpNode:
    """One op of a Region with the names it reads and writes."""

    def __init__(self, index, op):
        self.index = index
        self.op = op
        self.reads = set(op.input_arg_names)
        if op.type in _REPLAY_OPS:
            self.reads.update(op.attr("wrt_names") or ())
        self.writes = set(op.output_arg_names)


class Region:
    """An ordered op list as one scope: its nodes, and ``writers`` /
    ``readers`` mapping each name to the ordered indices of its ops."""

    def __init__(self, ops):
        self.nodes = [OpNode(i, op) for i, op in enumerate(ops)]
        self.writers = {}
        self.readers = {}
        for node in self.nodes:
            for n in node.writes:
                self.writers.setdefault(n, []).append(node.index)
            for n in node.reads:
                self.readers.setdefault(n, []).append(node.index)


def build_region(ops):
    return Region(list(ops))
