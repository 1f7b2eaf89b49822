"""Program-level conv2d -> batch_norm (+elementwise_add) -> relu epilogue
fusion over the Program IR (the port's copy of
``paddle_tpu/core/epilogue_fusion.py``: same sites, same refusals, same
``orig_ops`` replay lists, so the two packages' rewrites compare field by
field).

The reference framework runs this as SSA-graph passes selected by
``BuildStrategy`` (``framework/details/build_strategy.cc:54``:
``fuse_elewise_add_act_ops`` / ``fuse_relu_depthwise_conv``); here the
rewrite pattern-matches op chains on the op list and replaces each proven
chain with ONE ``fused_conv2d`` op lowered through
``ops/fused_conv.py``'s CUDA epilogue kernels — so ``models/resnet.py``
(and every other conv+BN model) fuses without model changes.

Safety is proved on ``analysis/dataflow.py``'s def-use core, not assumed
from adjacency: an intermediate is absorbed only when the chain's next op
is its SOLE consumer, it has a single writer, it is neither persistable
nor protected (fetched), and no op between the chain head and the fusion
point touches anything the fused op reads or writes. Chains that fail a
check are left untouched and recorded as :class:`FusionRefusal` with the
op's creation-site provenance (``Operator.where()``), so ``--verbose``
callers and the tests can see exactly why a site did not fuse.

The fused op keeps the absorbed originals in its ``orig_ops`` attr: the
lowering replays them verbatim whenever the geometry gate declines (the
7x7 stem, stride-2 3x3 convs), on either device. Like
``autodiff.fwd_ops``, ``orig_ops`` aliases the op's own semantics and is
deliberately NOT a dataflow sub-region.

The executor applies :func:`fuse_ops` to the op list it interprets, once
per (program, version, fetch set) (``core/executor.py``), before the
forward runs: the port differentiates the tape the fused ops record, so
the rewrite must come first. The ``autodiff``/``autodiff_vjp`` ops'
``fwd_ops`` lists are rewritten too, as in ``paddle_tpu``, although the
port's autodiff reads the tape and not that list. A Switch-guarded op
(``_switch_cond``, which ``run_op`` blends with its outputs' old values)
never joins a chain, as in the reference.
"""

from ..analysis.dataflow import build_region
from .framework import Operator, Parameter

__all__ = ["FusionSite", "FusionRefusal", "FusionReport", "fuse_ops",
           "fuse_program"]

_REPLAY_OPS = ("autodiff", "autodiff_vjp")


class FusionSite:
    """One fused chain: the absorbed originals and the fused op."""

    def __init__(self, ops, fused, dropped_vars):
        self.ops = list(ops)          # conv, bn[, add][, relu]
        self.fused = fused
        self.dropped_vars = list(dropped_vars)  # absorbed intermediates

    @property
    def kinds(self):
        return tuple(o.type for o in self.ops)

    def __repr__(self):
        return "FusionSite(%s @ %s)" % ("+".join(self.kinds),
                                        self.ops[0].where())


class FusionRefusal:
    """A conv->bn candidate the pass declined, with provenance."""

    def __init__(self, op, var_name, reason):
        self.op = op
        self.var_name = var_name
        self.reason = reason

    def __str__(self):
        return "refused to fuse at op '%s' created at %s: %s" % (
            self.op.type, self.op.where(), self.reason)

    __repr__ = __str__


class FusionReport:
    def __init__(self):
        self.fused = []
        self.refused = []

    def summary(self):
        return "%d chain(s) fused, %d refused" % (len(self.fused),
                                                  len(self.refused))


def _is_param(var):
    return isinstance(var, Parameter) or getattr(var, "persistable", False)


class _Matcher:
    def __init__(self, ops, protected):
        self.ops = ops
        self.protected = frozenset(protected)
        self.region = build_region(ops)

    def sole_consumer(self, producer_idx, var):
        """Index of ``var``'s only consumer after ``producer_idx``, or a
        refusal reason string."""
        name = var.name
        if name in self.protected:
            return None, "intermediate '%s' is fetched/protected" % name
        if _is_param(var):
            return None, "intermediate '%s' is persistable state" % name
        writers = self.region.writers.get(name, [])
        if writers != [producer_idx]:
            return None, ("intermediate '%s' has other writers %s"
                          % (name, writers))
        readers = self.region.readers.get(name, [])
        if len(readers) != 1:
            where = [self.ops[i] for i in readers if i != producer_idx]
            return None, (
                "intermediate '%s' has %d consumers (%s) — fusing would "
                "change what they observe" % (
                    name, len(readers),
                    ", ".join("'%s' at %s" % (o.type, o.where())
                              for o in where) or "none"))
        if readers[0] <= producer_idx:  # malformed ordering: leave alone
            return None, ("intermediate '%s' is read before it is produced"
                          % name)
        return readers[0], None

    def hazard_between(self, lo, hi, skip, reads, writes):
        """An op in (lo, hi) outside ``skip`` that conflicts with moving
        the chain's effects to position ``hi`` — returns the op or None."""
        for idx in range(lo + 1, hi):
            if idx in skip:
                continue
            node = self.region.nodes[idx]
            if node.reads & writes or node.writes & (reads | writes):
                return self.ops[idx]
        return None


def _match_chain(m, i, report):
    """Try to match a fusable chain headed by conv op ``i``; returns
    (absorbed indices, add_op, act_op, residual_var) or None."""
    conv = m.ops[i]
    if conv.type != "conv2d" or conv.attrs.get("_switch_cond") is not None:
        return None
    out = conv.output("Output")
    if out is None:
        return None
    j, why = m.sole_consumer(i, out)
    bn = m.ops[j] if j is not None else None
    if bn is None or bn.type != "batch_norm" \
            or bn.attrs.get("_switch_cond") is not None \
            or bn.input("X") is not out \
            or bn.attr("data_layout", "NCHW") != "NCHW":
        if why is not None and bn is None:
            report.refused.append(FusionRefusal(conv, out.name, why))
        return None

    absorbed = [i, j]
    dropped = [out]
    add_op = act_op = residual = None

    y = bn.output("Y")
    k, _ = m.sole_consumer(j, y)
    nxt = m.ops[k] if k is not None else None
    if nxt is not None and nxt.type == "elementwise_add" \
            and nxt.attrs.get("_switch_cond") is None:
        xin, yin = nxt.input("X"), nxt.input("Y")
        other = yin if xin is y else (xin if yin is y else None)
        # self-add (add(y, y)) would absorb y AND take it as Residual —
        # dataflow reader-sets count it once, so guard explicitly
        if (other is not None and other is not y
                and other.shape is not None and y.shape is not None
                and tuple(other.shape) == tuple(y.shape)
                and len(y.shape) == 4):
            add_op, residual = nxt, other
            absorbed.append(k)
            dropped.append(y)
            k2, _ = m.sole_consumer(k, nxt.output("Out"))
            nxt2 = m.ops[k2] if k2 is not None else None
            if nxt2 is not None and nxt2.type == "relu" \
                    and nxt2.attrs.get("_switch_cond") is None:
                act_op = nxt2
                absorbed.append(k2)
                dropped.append(nxt.output("Out"))
        else:
            nxt = None
    elif nxt is not None and nxt.type == "relu" \
            and nxt.attrs.get("_switch_cond") is None:
        act_op = nxt
        absorbed.append(k)
        dropped.append(y)

    def check(absorbed_, add_, act_, residual_, dropped_):
        """Hazard check for one chain variant: the fused op runs at the
        tail position, so everything it reads must be unchanged and
        everything it writes unobserved across (head, tail)."""
        tail = absorbed_[-1]
        reads = {v.name for slot in ("Input", "Filter")
                 for v in conv.input_list(slot)}
        reads |= {v.name for slot in ("Scale", "Bias", "Mean", "Variance")
                  for v in bn.input_list(slot)}
        if residual_ is not None:
            reads.add(residual_.name)
        writes = set()
        for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
            v = bn.output(slot)
            if v is not None:
                writes.add(v.name)
        out_var_ = (act_ or add_ or bn).output_list(
            "Out" if (act_ or add_) else "Y")[0]
        writes.add(out_var_.name)
        hz = m.hazard_between(i, tail, set(absorbed_), reads, writes)
        return hz, out_var_

    hz, out_var = check(absorbed, add_op, act_op, residual, dropped)
    if hz is not None and len(absorbed) > 2:
        # e.g. a shortcut chain whose residual is produced later: fall
        # back to fusing conv->bn alone (still kills the stats pass)
        absorbed, add_op, act_op, residual, dropped = \
            absorbed[:2], None, None, None, dropped[:1]
        hz, out_var = check(absorbed, None, None, None, dropped)
    if hz is not None:
        report.refused.append(FusionRefusal(
            conv, out.name,
            "op '%s' at %s between the chain and its fusion point "
            "touches fused state" % (hz.type, hz.where())))
        return None
    return absorbed, bn, add_op, act_op, residual, out_var, dropped


def _build_fused(conv, bn, add_op, act_op, residual, out_var):
    inputs = {"Input": conv.input("Input"), "Filter": conv.input("Filter"),
              "Scale": bn.input("Scale"), "Bias": bn.input("Bias"),
              "Mean": bn.input("Mean"), "Variance": bn.input("Variance")}
    inputs = {k: v for k, v in inputs.items() if v is not None}
    if residual is not None:
        inputs["Residual"] = residual
    outputs = {"Y": out_var}
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        v = bn.output(slot)
        if v is not None:
            outputs[slot] = v
    orig = [conv, bn] + [o for o in (add_op, act_op) if o is not None]
    attrs = {
        "strides": conv.attr("strides", [1, 1]),
        "paddings": conv.attr("paddings", [0, 0]),
        "dilations": conv.attr("dilations", [1, 1]),
        "groups": conv.attr("groups", 1),
        "epsilon": bn.attr("epsilon", 1e-5),
        "momentum": bn.attr("momentum", 0.9),
        "is_test": bn.attr("is_test", False),
        "use_global_stats": bn.attr("use_global_stats", False),
        "data_layout": "NCHW",
        "act": "relu" if act_op is not None else None,
        "orig_ops": orig,
    }
    fused = Operator(conv.block, "fused_conv2d", inputs, outputs, attrs)
    fused.callsite = conv.callsite  # provenance points at the model line
    return fused


def fuse_ops(ops, protected=()):
    """Rewrite an op list, fusing every provable conv->bn(+add)(+relu)
    chain (including inside ``autodiff``/``autodiff_vjp`` replay lists).
    Returns ``(new_ops, FusionReport)``; the input list and its Operators
    are not mutated."""
    ops = list(ops)
    report = FusionReport()
    m = _Matcher(ops, protected)

    drop = {}        # index -> True for absorbed non-tail ops
    replace = {}     # tail index -> fused op
    claimed = set()
    for i in range(len(ops)):
        if i in claimed:
            continue
        match = _match_chain(m, i, report)
        if match is None:
            continue
        absorbed, bn, add_op, act_op, residual, out_var, dropped = match
        if claimed & set(absorbed):
            continue
        fused = _build_fused(ops[i], bn, add_op, act_op, residual, out_var)
        claimed |= set(absorbed)
        tail = absorbed[-1]
        for idx in absorbed:
            if idx != tail:
                drop[idx] = True
        replace[tail] = fused
        report.fused.append(FusionSite(
            [ops[idx] for idx in absorbed], fused, [v.name for v in dropped]))

    mapping = {}     # id(original op) -> fused op or None (absorbed)
    for idx in drop:
        mapping[id(ops[idx])] = None
    for idx, fused in replace.items():
        mapping[id(ops[idx])] = fused

    def rewrite_list(lst):
        out = []
        for o in lst:
            r = mapping.get(id(o), o)
            if r is not None:
                out.append(r)
        return out

    new_ops = []
    for idx, op in enumerate(ops):
        if idx in drop:
            continue
        if idx in replace:
            new_ops.append(replace[idx])
            continue
        if op.type in _REPLAY_OPS and mapping:
            fwd = op.attr("fwd_ops") or []
            if any(id(o) in mapping for o in fwd):
                clone = Operator(op.block, op.type, dict(op.inputs),
                                 dict(op.outputs),
                                 {**op.attrs, "fwd_ops": rewrite_list(fwd)})
                clone.callsite = op.callsite
                new_ops.append(clone)
                continue
        new_ops.append(op)
    return new_ops, report


def fuse_program(program, protected=()):
    """Clone ``program`` and fuse its global block; absorbed intermediate
    vars are dropped from the block's symbol table. Returns
    ``(fused_program, FusionReport)``."""
    p = program.clone()
    gb = p.global_block()
    new_ops, report = fuse_ops(gb.ops, protected)
    gb.ops = new_ops
    for site in report.fused:
        for name in site.dropped_vars:
            v = gb.vars.get(name)
            if v is not None and not _is_param(v):
                gb.vars.pop(name, None)
    p._version += 1
    return p, report
