"""Executor: runs a Program's global block op by op over torch tensors.

Reference contract: ``fluid.Executor(place).run(program, feed, fetch_list)``
(``python/paddle/fluid/executor.py:262,554``). ``paddle_tpu`` traces the
whole program into one jitted XLA computation (its ``build_step_fn``); the
port interprets it instead, in the manner of the reference's C++ executor
(``executor.cc:186``): each op's impl runs eagerly on the executor's
device, and the ops that ``paddle_tpu`` gave to Pallas launch the port's
CUDA kernels. A program without backward ops runs under
``torch.inference_mode()``.

Training mode: a program holding an ``autodiff`` (or ``autodiff_vjp``) op
runs with autograd recording. At step start the op's ``wrt_names`` that the
step reads from the scope or the feed become leaf tensors with
``requires_grad=True``; the forward ops record the tape as they run, and
the autodiff op takes ``torch.autograd.grad`` over it. ``paddle_tpu``
re-traces the forward under ``jax.grad`` from a step-start snapshot
(``ENV0_KEY``) because JAX differentiates functions, not tapes; the port
has no such replay. Ops marked ``is_optimizer_op`` run under
``torch.no_grad()``, and everything written back to the scope is detached.

A table with a sparse (rows, values) gradient (the autodiff op's
``sparse_wrt_names``) is NOT made a leaf: differentiating the table would
build a dense ``[V, K]`` gradient through the gather's own backward, a
library scatter outside the port's kernel. Each sparse lookup instead
makes its OUTPUT a leaf and records the site (table, ids, output) under
``SPARSE_SITES_KEY``; the autodiff op differentiates w.r.t. the outputs,
which is ``paddle_tpu``'s zero-delta trick (its ``control_ops.py:71-85``)
on a tape.

Epilogue fusion: before the ops run, conv2d -> batch_norm (+elementwise_add)
(+relu) chains become ``fused_conv2d`` ops (``core/epilogue_fusion.py``),
as ``paddle_tpu`` rewrites the op list it traces (its ``build_step_fn``).
Fetched vars are protected. ``paddle_tpu`` pays for the rewrite once per
compile; the port keeps the rewritten list per (program, version, fetch
set) so that no step rebuilds the dataflow region (:func:`fused_ops`).

Places are real: ``CUDAPlace(i)`` is ``cuda:i`` and ``CPUPlace()`` is the
host. The default is ``CUDAPlace(0)``; on a machine without CUDA, an entry
point that was not asked for the CPU raises instead of falling back.

Randomness: the scope holds one ``torch.Generator`` on the executor's
device under ``@RNG@``, seeded from ``program.random_seed`` on first use
(0 means a random seed, as in the reference).
"""

import contextlib
import secrets

import numpy as np
import torch

from . import framework
from .framework import Variable, torch_dtype
from .op_registry import DEVICE_KEY, RNG_KEY, SPARSE_SITES_KEY, run_op

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "CPUPlace",
           "CUDAPlace", "resolve_device", "place_for"]


_AUTODIFF_OPS = ("autodiff", "autodiff_vjp")


class CPUPlace:
    def __repr__(self):
        return "CPUPlace()"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace:
    """The CUDA device ``device_id``."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace(%d): no CUDA device is available; pass CPUPlace() "
                "(or device='cpu') to run on the host" % self.device_id)
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError("CUDAPlace(%d): only %d CUDA device(s)"
                               % (self.device_id, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)


def resolve_device(place=None):
    """A ``torch.device`` from a place, a device string, a
    ``torch.device`` or None (None = ``CUDAPlace(0)``). Raises
    ``RuntimeError`` for a CUDA device on a machine without one."""
    if place is None:
        place = CUDAPlace(0)
    if isinstance(place, (CPUPlace, CUDAPlace)):
        return place.torch_device()
    dev = torch.device(place)
    if dev.type == "cuda":
        return CUDAPlace(0 if dev.index is None else dev.index).torch_device()
    if dev.type != "cpu":
        raise ValueError("unsupported device %r" % (place,))
    return dev


def place_for(device=None):
    """The place of a device spec (see :func:`resolve_device`)."""
    dev = resolve_device(device)
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)


class Scope:
    """name -> tensor store (ref ``framework/scope.h:48``)."""

    def __init__(self):
        self._vars = {}

    def var_names(self):
        return list(self._vars.keys())

    def get(self, name):
        return self._vars[name]

    def set(self, name, value):
        self._vars[name] = value

    def __contains__(self, name):
        return name in self._vars


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)

    def __exit__(self, *a):
        _scope_stack.pop()


def fused_ops(program, fetch_names=()):
    """``(ops, report)``: the op list the Executor runs for ``program``,
    with its conv->BN(+add)(+relu) chains fused, and the
    :class:`~.epilogue_fusion.FusionReport`. Built once per (version, fetch
    set) and kept on the program; a new version drops the older ones."""
    from .epilogue_fusion import fuse_ops

    cache = program._fusion_cache
    key = (program._version, frozenset(fetch_names))
    hit = cache.get(key)
    if hit is None:
        for stale in [k for k in cache if k[0] != program._version]:
            del cache[stale]
        hit = cache[key] = fuse_ops(program.global_block().ops,
                                    protected=set(fetch_names))
    return hit


def to_numpy(t):
    """Host copy of a tensor; bf16 widens to float32 (numpy has no bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def to_tensor(value, device, var=None):
    """A feed value as a tensor on ``device``, coerced to the var's dtype
    under the 32-bit convention (int64 ids arrive as int32)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    want = torch_dtype(var.dtype if var is not None else t.dtype)
    return t.to(device=device, dtype=want)


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = resolve_device(self.place)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        gb = program.global_block()

        if RNG_KEY not in scope:
            seed = program.random_seed or secrets.randbits(31)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            scope.set(RNG_KEY, gen)

        env = {}
        persist = {v.name for v in program.list_vars() if v.persistable}
        for n in persist:
            if n in scope:
                env[n] = scope.get(n)
        for name, value in feed.items():
            var = gb.var(name) if gb.has_var(name) else None
            env[name] = to_tensor(value, self.device, var)
        env[RNG_KEY] = scope.get(RNG_KEY)
        env[DEVICE_KEY] = self.device

        ops, _ = fused_ops(program, fetch_names)
        sparse = {n for op in ops if op.type == "autodiff"
                  for n in op.attr("sparse_wrt_names") or ()}
        wrt = {n for op in ops if op.type in _AUTODIFF_OPS
               for n in op.attr("wrt_names")} - sparse
        written = set()
        if not wrt and not sparse:
            with torch.inference_mode():
                for op in ops:
                    run_op(env, op)
                    written.update(op.output_arg_names)
        else:
            for n in wrt:
                t = env.get(n)
                if t is not None and t.is_floating_point():
                    # a tensor made under inference_mode (a grad-free
                    # startup run) cannot join a tape: copy it once, and
                    # the copy is what the step writes back
                    t = t.clone() if t.is_inference() else t.detach()
                    env[n] = t.requires_grad_(True)
            if sparse:
                env[SPARSE_SITES_KEY] = {n: [] for n in sparse}
            for op in ops:
                with (torch.no_grad() if op.attr("is_optimizer_op")
                      else contextlib.nullcontext()):
                    run_op(env, op)
                written.update(op.output_arg_names)
        for n in persist & written:
            scope.set(n, env[n].detach())
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches
