"""Def-use structure of an op list: the part of
``paddle_tpu/analysis/dataflow.py`` that ``core/epilogue_fusion.py`` proves
its rewrites on (copied: importing it from ``paddle_tpu`` pulls in jax).

An op reads its input names, and an ``autodiff``/``autodiff_vjp`` op also
the ``wrt_names`` it differentiates; a Switch-guarded op (``_switch_cond``)
also reads its condition and the old values of its outputs, which
``run_op`` blends in (``paddle_tpu/analysis/dataflow.py:62``
``own_reads``); it writes its output names. Those replay ops' ``fwd_ops``
lists alias the enclosing ops and are not recursed into. A control-flow
op (``cond_block``, ``while_block``, ``scan_block``) runs its body on a
copy of the enclosing env, so it also reads its body's free names: those
a body op reads before the body defines them, less the names the op binds
at body entry (its carries and scanned inputs; :func:`body_reads`,
``paddle_tpu/analysis/dataflow.py:44-103``). The body's own writes stay
local to it.
"""

__all__ = ["OpNode", "Region", "build_region", "own_reads", "body_reads",
           "bodies"]

_REPLAY_OPS = frozenset({"autodiff", "autodiff_vjp"})

# op type -> ((attr holding a body's op list, fn(op) -> the names the op
# binds at that body's entry), ...)
_BODIES = {
    "cond_block": (("true_ops", lambda op: ()), ("false_ops", lambda op: ())),
    "while_block": (("body_ops", lambda op: [op.attr("cond_name")] + [
        v.name for v in op.input_list("Carry")]),),
    "scan_block": (("step_ops", lambda op: list(
        op.attr("x_step_names") or ()) + list(op.attr("carry_names")
                                              or ())),),
}


def bodies(op):
    """``[(body ops, names bound at its entry), ...]`` of a control-flow
    op; [] for any other op."""
    return [(op.attr(attr) or (), bound(op))
            for attr, bound in _BODIES.get(op.type, ())]


def body_reads(op):
    """The free names of ``op``'s control-flow bodies (none for any other
    op), nested bodies included."""
    free = set()
    for ops, bound in bodies(op):
        defined = set(bound)
        for o in ops:
            free |= (set(o.input_arg_names) | body_reads(o)) - defined
            defined |= set(o.output_arg_names)
    return free


def own_reads(op, switch_rmw=True):
    """Names ``op`` itself reads. ``switch_rmw=False`` leaves out a
    Switch-guarded op's read of its own outputs: the blend engages only
    when the var already exists, so a guarded op may be its var's first
    definition."""
    reads = set(op.input_arg_names)
    cond = op.attrs.get("_switch_cond")
    if cond is not None:
        reads.add(cond)
        if switch_rmw:
            reads.update(op.output_arg_names)  # prior values blended in
    if op.type in _REPLAY_OPS:
        reads.update(op.attr("wrt_names") or ())
    if op.type == "while_block":
        reads.add(op.attr("cond_name"))
    return reads | body_reads(op)


class OpNode:
    """One op of a Region with the names it reads and writes."""

    def __init__(self, index, op):
        self.index = index
        self.op = op
        self.reads = own_reads(op)
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
