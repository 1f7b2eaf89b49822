"""Symbolic program graph: Program / Block / Variable / Operator.

The port's copy of ``paddle_tpu/core/framework.py`` (itself modelled on the
reference's ``python/paddle/fluid/framework.py``: ``Variable:242``,
``Operator:571``, ``Block:1020``, ``Program:2284``). A Program records user
intent — an op list with attrs and a var table — and the port's Executor
interprets it op by op over torch tensors (``core/executor.py``).

Variables keep numpy dtypes and static shapes with -1 for the batch dim, so
a program built here and one built by ``paddle_tpu`` compare field by field.
"""

import contextlib
import os
import sys

import numpy as np
import torch

from . import unique_name

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "switch_main_program",
    "switch_startup_program",
    "program_guard",
    "convert_np_dtype",
    "torch_dtype",
    "grad_var_name",
    "name_scope",
]

_SUPPORTED_DTYPES = {
    "float16": np.float16,
    "float32": np.float32,
    "float64": np.float64,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "bool": np.bool_,
}


def convert_np_dtype(dtype):
    """Normalize a dtype spec (str / np.dtype) to a np.dtype. ``bfloat16``
    resolves through ml_dtypes, as in ``paddle_tpu``."""
    if dtype is None:
        return np.dtype("float32")
    if isinstance(dtype, str):
        if dtype == "bfloat16":
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        if dtype not in _SUPPORTED_DTYPES:
            raise ValueError("unsupported dtype: %s" % dtype)
        return np.dtype(_SUPPORTED_DTYPES[dtype])
    return np.dtype(dtype)


def grad_var_name(name):
    """Gradient variable naming convention (ref: framework ``@GRAD``
    suffix)."""
    return name + "@GRAD"


# 32-bit execution convention: ``paddle_tpu`` runs JAX without x64, so an
# int64/float64 variable holds int32/float32 values. The port keeps that
# convention so ids, masks and fetched dtypes agree between the two.
_TORCH_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float32,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int32,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def torch_dtype(dtype):
    """The torch dtype a variable of ``dtype`` is held in (32-bit
    convention: int64 -> int32, float64 -> float32)."""
    if isinstance(dtype, torch.dtype):
        return {torch.int64: torch.int32,
                torch.float64: torch.float32}.get(dtype, dtype)
    name = dtype if isinstance(dtype, str) else convert_np_dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise ValueError("unsupported dtype: %s" % name)
    return _TORCH_DTYPES[name]


# Op provenance: every appended op records the USER code line that created
# it (the reference stores an op_callstack attr on each OpDesc). Frames
# inside the graph-building machinery (core/, layers/) are skipped.
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FRAMEWORK_PREFIXES = (os.path.join(_PKG_DIR, "core"),
                       os.path.join(_PKG_DIR, "layers"))


def _user_callsite(skip=2):
    """(filename, lineno, function) of the innermost non-framework frame."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return None
    first = None
    while f is not None:
        fn = f.f_code.co_filename
        if first is None:
            first = (fn, f.f_lineno, f.f_code.co_name)
        if not fn.startswith(_FRAMEWORK_PREFIXES):
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return first


class Variable:
    """A symbolic tensor in a Block (name/shape/dtype/persistable/
    stop_gradient/lod_level, as in the reference's ``Variable``)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, lod_level=0,
                 is_data=False, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_np_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_data = is_data
        self.op = None  # producing op, set by append_op

    def to_string(self, throw_on_error=False, with_details=False):
        return "Variable(name=%s, shape=%s, dtype=%s, persistable=%s)" % (
            self.name, self.shape, self.dtype, self.persistable)

    __repr__ = __str__ = lambda self: self.to_string()


class Parameter(Variable):
    """A trainable persistable Variable (ref ``framework.py:2917``)."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or any(int(s) <= 0 for s in shape):
            raise ValueError("Parameter shape must be fully-defined and "
                             "positive, got %s" % (shape,))
        super().__init__(block, shape=shape, dtype=dtype, persistable=True, **{
            k: v for k, v in kwargs.items()
            if k in ("name", "stop_gradient", "lod_level", "is_data")
        })
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)
        self.sharding = kwargs.get("sharding", None)
        self.initializer = kwargs.get("initializer", None)
        self.is_distributed = kwargs.get("is_distributed", False)


class Operator:
    """A symbolic op: type + named input/output slots + attrs. Execution
    semantics live in ``core.op_registry``."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}
        self.outputs = {}
        self.attrs = dict(attrs) if attrs else {}
        self.callsite = None  # (file, line, function) set by Block.append_op
        # a None value (or entry) means "slot absent"
        for src, dst in ((inputs, self.inputs), (outputs, self.outputs)):
            for slot, vs in (src or {}).items():
                vs = list(vs) if isinstance(vs, (list, tuple)) else [vs]
                vs = [v for v in vs if v is not None]
                if vs:
                    dst[slot] = vs

    def input(self, slot):
        vs = self.inputs.get(slot, [])
        return vs[0] if vs else None

    def input_list(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        vs = self.outputs.get(slot, [])
        return vs[0] if vs else None

    def output_list(self, slot):
        return self.outputs.get(slot, [])

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def where(self):
        """Creation site for diagnostics, e.g. ``train.py:42 (in build)``."""
        if not self.callsite:
            return "<unknown>"
        fn, line, func = self.callsite
        return "%s:%d (in %s)" % (os.path.basename(fn), line, func)

    @property
    def input_arg_names(self):
        return [v.name for vs in self.inputs.values() for v in vs]

    @property
    def output_arg_names(self):
        return [v.name for vs in self.outputs.values() for v in vs]

    def __repr__(self):
        return "{%s: (%s) -> (%s)}" % (
            self.type, ", ".join(self.input_arg_names),
            ", ".join(self.output_arg_names))


class Block:
    """An ordered list of ops + a var symbol table (ref ``framework.py:1020``)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def var(self, name):
        """Look up a var by name, walking parent blocks."""
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise KeyError("Variable %s not found in block %d or ancestors"
                       % (name, self.idx))

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def create_var(self, **kwargs):
        name = kwargs.get("name") or unique_name.generate("_generated_var")
        kwargs["name"] = name
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, **kwargs):
        name = kwargs.get("name") or unique_name.generate("param")
        kwargs["name"] = name
        p = Parameter(self, kwargs.pop("shape"), kwargs.pop("dtype", "float32"),
                      **kwargs)
        self.vars[name] = p
        self.program._params[name] = p
        return p

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        op.callsite = _user_callsite()
        self.ops.append(op)
        for vs in op.outputs.values():
            for v in vs:
                v.op = op
        self.program._version += 1
        return op

    def __repr__(self):
        return "Block(idx=%d, ops=[%s])" % (
            self.idx, ", ".join(op.type for op in self.ops))


class Program:
    """A user-built symbolic program (ref ``framework.py:2284``)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0  # bumped on mutation
        self._params = {}
        self._is_test = False
        # set by append_backward: the program's autodiff ops
        self._backward_ops = []
        # the executor's fused op lists, by (version, fetch names, switch)
        self._fusion_cache = {}

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def all_parameters(self):
        return list(self._params.values())

    def to_string(self, throw_on_error=False, with_details=False):
        lines = []
        for b in self.blocks:
            lines.append("-- block %d (parent %d) --" % (b.idx, b.parent_idx))
            for v in b.vars.values():
                lines.append("  var %s : %s %s%s" % (
                    v.name, v.shape, v.dtype,
                    " [param]" if isinstance(v, Parameter) else ""))
            for op in b.ops:
                lines.append("  op %r" % (op,))
        return "\n".join(lines)

    __repr__ = __str__ = lambda self: self.to_string()

    def clone(self, for_test=False):
        """Structural copy (same semantics as ``paddle_tpu``'s
        ``Program.clone``). ``for_test=True`` sets ``is_test`` on ops that
        carry it and on every ``dropout``, and strips backward/optimizer
        ops. It leaves ``flash_attention``'s ``dropout_rate`` as it is, as
        the reference does."""
        p = Program()
        p.random_seed = self.random_seed
        var_map = {}
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            p.blocks.append(nb)
            for name, v in b.vars.items():
                if isinstance(v, Parameter):
                    nv = Parameter(
                        nb, v.shape, v.dtype, name=name,
                        trainable=v.trainable, optimize_attr=v.optimize_attr,
                        regularizer=v.regularizer,
                        gradient_clip_attr=v.gradient_clip_attr,
                        sharding=v.sharding, initializer=v.initializer,
                        is_distributed=v.is_distributed)
                    p._params[name] = nv
                else:
                    nv = Variable(
                        nb, name=name, shape=v.shape, dtype=v.dtype,
                        persistable=v.persistable,
                        stop_gradient=v.stop_gradient,
                        lod_level=v.lod_level, is_data=v.is_data)
                nb.vars[name] = nv
                var_map[(b.idx, name)] = nv

        def map_vars(block_idx, vs):
            return [var_map[(block_idx, v.name)] for v in vs]

        for b, nb in zip(self.blocks, p.blocks):
            for op in b.ops:
                if for_test and (op.type == "autodiff"
                                 or op.attr("is_optimizer_op")):
                    continue
                attrs = dict(op.attrs)
                if for_test and ("is_test" in attrs or op.type == "dropout"):
                    attrs["is_test"] = True
                nop = Operator(
                    nb, op.type,
                    {s: map_vars(b.idx, vs) for s, vs in op.inputs.items()},
                    {s: map_vars(b.idx, vs) for s, vs in op.outputs.items()},
                    attrs)
                nop.callsite = op.callsite
                nb.ops.append(nop)
        p._is_test = for_test
        p._version = self._version
        p.current_block_idx = 0
        return p

    def prune(self, targets):
        """Keep only ops needed to compute ``targets`` (ref
        ``Program.prune``). Persistables are state read from the scope,
        not products to chase, unless they are targets themselves."""
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        needed = {t.name if isinstance(t, Variable) else t for t in targets}
        persistable = {v.name for v in self.list_vars()
                       if v.persistable} - set(needed)
        ops = self.global_block().ops
        kept_idx = set()
        for i in range(len(ops) - 1, -1, -1):
            if set(ops[i].output_arg_names) & (needed - persistable):
                kept_idx.add(i)
                needed |= set(ops[i].input_arg_names)
        # clone keeps op order 1:1, so filter by position
        p = self.clone()
        nb = p.global_block()
        nb.ops = [o for i, o in enumerate(nb.ops) if i in kept_idx]
        p._version += 1
        return p


# default program singletons + guards (ref framework.py:3001-3069)
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """Introspection name scope (ref ``framework.py`` name_scope)."""
    _name_scope_stack.append(prefix or "")
    try:
        yield
    finally:
        _name_scope_stack.pop()
