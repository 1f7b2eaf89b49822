"""Executor: runs a Program's global block over torch tensors.

Reference contract: ``fluid.Executor(place).run(program, feed, fetch_list)``
(``python/paddle/fluid/executor.py:262,554``). ``paddle_tpu`` traces the
whole program into one jitted XLA computation (its ``build_step_fn``) per
cache key and runs that one executable on every later call. The port keeps
the same cache and key, and the same compiled-step model on the card: the
first run of a key interprets the op list, as the reference's C++ executor
does (``executor.cc:186``: each op's impl runs eagerly, the ops that
``paddle_tpu`` gave to Pallas launch the port's CUDA kernels); the second
captures the whole step, state updates included, as one
``torch.cuda.CUDAGraph`` (:class:`CapturedStep`), and every later run
copies the feed in, replays the graph and reads the fetches out. The state
is read from and written back into the scope's own tensors, the
counterpart of the reference's donated state. :func:`capture_rule` keeps a
program interpreted, with its reason, where a step waits on the host or
feeds what fixed buffers cannot hold; CPU places always interpret (the
reference's CPU jit has no graph). A capture of an admitted program that
fails raises: it never goes back to interpreting. ``PADDLE_TPU_FUSED_OPT``
batches the dense optimizer updates (``opt_fusion.py``) in both forms.
One executor's graphs share one memory pool and one fetch arena (their
replays are serialized), and a cache entry whose program or scope is
collected is released with its graph.

Lent feeds (the serving tier's decode caches, ``run``'s private
``_lend``): the caller's own tensor is the step's buffer, a cache write
into it goes in place, and its fetch is the tensor itself; the reference
feeds its caches and its compiled step copies them on every dispatch
(``.at[...].set``, not donated), which fixed graph buffers cannot hold.
``check_nan_inf`` interprets the program op by op and checks every float
output (``paddle_tpu/core/executor.py:535``).

A program without backward ops runs under
``torch.inference_mode()``; a training run first copies every inference
tensor it reads (state a startup, load or eval run left in the scope) out
of inference mode, once, and puts the copy in the scope, so serving, eval
and decode keep their inference tensors and no training op saves one for
backward.

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

Mixed precision: a program marked by ``amp.py`` (``_amp_bf16``) runs with
``op_registry.AMP`` on, restored afterwards (``paddle_tpu``'s
``executor.py:567-590``). The casts are ops on the tape, so the backward
follows the forward's dtypes.

Randomness: the scope holds one ``torch.Generator`` per device, seeded
from ``program.random_seed`` on the device's first run there (0 means a
random seed, as in the reference): ``@RNG@`` is the generator of the first
device that ran in the scope, ``@RNG@<device>`` (``@RNG@cuda:0``) another
device's (:func:`rng_name`). So a CPU run and a card run may share a scope:
each draws on its own device, and a captured step registers a generator on
its graph's device.

Rematerialization (an autodiff op with ``remat``: ``append_backward``'s
``checkpoints``, ``memory_optimize``): the forward runs in segments
(:func:`remat_segments`), each under ``torch.utils.checkpoint``
(non-reentrant): a segment keeps only the values later ops read, and the
backward recomputes the rest from its inputs, under the AMP flag its
forward ran under and with the random draws its forward made
(``op_registry.RngTape``), so the gradients are the ones without remat.
``paddle_tpu`` wraps its whole forward replay in one ``jax.checkpoint``
(``control_ops.py:152``).
"""

import collections
import contextlib
import gc
import math
import secrets
import threading
import weakref

import numpy as np
import torch

from ..analysis.dataflow import bodies, body_reads
from ..obs import trace as obs_trace
from . import framework
from .framework import Variable, torch_dtype
from .op_registry import (AMP, DEVICE_KEY, LENT_KEY, RNG_KEY, RNG_TAPE_KEY,
                          SPARSE_SITES_KEY, RngTape, amp_scope, env_flag,
                          run_op)
from .opt_fusion import run_fused_group

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "CPUPlace",
           "CUDAPlace", "resolve_device", "place_for", "CapturedStep",
           "capture_graph", "capture_rule", "state_writes", "step_plan", "remat_segments"]


_AUTODIFF_OPS = ("autodiff", "autodiff_vjp")


class CPUPlace:
    """The host; ``device_id`` is kept for the reference's signature."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

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
    """name -> tensor store (ref ``framework/scope.h:48``;
    ``paddle_tpu/core/executor.py:81-105``)."""

    def __init__(self):
        self._vars = {}
        # executors holding captured steps bound to this scope's tensors
        self._binders = weakref.WeakSet()

    def find_var(self, name):
        return self._vars.get(name)

    def var_names(self):
        return list(self._vars.keys())

    def get(self, name):
        return self._vars[name]

    def set(self, name, value):
        self._vars[name] = value

    def drop(self, name):
        """Forget ``name``; a captured step that reads or writes its tensor
        is released with it (the next run of its key interprets, the one
        after captures again)."""
        self._vars.pop(name, None)
        for exe in list(self._binders):
            exe._release_bound(self, name)

    def numpy(self, name):
        """Host copy of ``name``'s tensor (bf16 widens to float32); a copy
        on the CPU too, where ``.numpy()`` would share the tensor's memory
        and a captured step writes the next state into it."""
        t = self._vars[name]
        if t.device.type == "cpu" and t.dtype != torch.bfloat16:
            t = t.detach().clone()
        return to_numpy(t)

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


def step_plan(program, fetch_names, fused):
    """``(ops, plan, skip)``: :func:`fused_ops`'s op list and, with the
    fused optimizer switch on, its ``opt_fusion.plan_opt_fusion`` groups,
    both kept on the program (a cache entry holds neither: an op refers to
    its block and so to the program, which must stay collectable)."""
    ops, _ = fused_ops(program, fetch_names)
    if not fused:
        return ops, {}, frozenset()
    cache = program._fusion_cache
    key = (program._version, frozenset(fetch_names), "opt")
    hit = cache.get(key)
    if hit is None:
        from .opt_fusion import plan_opt_fusion

        hit = cache[key] = plan_opt_fusion(ops)
    return ops, hit[0], hit[1]


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
        a = np.asarray(value)
        if not a.flags.c_contiguous:  # a 0-d array always is: it keeps ()
            a = np.ascontiguousarray(a)
        t = torch.from_numpy(a)
    want = torch_dtype(var.dtype if var is not None else t.dtype)
    return t.to(device=device, dtype=want)


# one capture at a time in the process; capture_error_mode="thread_local"
# lets the other threads (serving workers) keep launching meanwhile
_CAPTURE_LOCK = threading.Lock()

# op type -> why a program holding it is not captured: each waits on the
# host, or feeds what the graph's fixed buffers cannot hold
_DECODE_CACHE = ("fed cache copied per dispatch: only a cache the caller "
                 "lends (the serving tier's) is written in place")
_CACHE_WRITES = ("kv_cache_write", "kv_cache_write_chunk")
_CACHE_READS = ("cached_attention", "cached_attention_chunk")
_NOT_CAPTURED = {
    "kv_cache_write": _DECODE_CACHE,
    "kv_cache_write_chunk": _DECODE_CACHE,
    "cached_attention": _DECODE_CACHE,
    "cached_attention_chunk": _DECODE_CACHE,
    "sampling_id": "torch.multinomial checks its probabilities on the host",
    "assign_value": "copies its host values to the device on every run",
    "while_block": ("reads its loop condition on the host before every "
                    "trip: the trip count is not known when the step is "
                    "captured"),
    "cond_block": ("reads its predicate on the host: the branch is not "
                   "known when the step is captured"),
    "print": ("prints its tensor (and its gradient) from the host on every "
              "run: a replayed graph runs no host code"),
    "py_func": ("calls a Python function on host copies of its inputs on "
                "every run: a replayed graph runs no host code"),
}

def _with_bodies(ops):
    """``ops`` and, after each control-flow op, the ops of its bodies
    (nested ones too), in order."""
    for op in ops:
        yield op
        for body, _ in bodies(op):
            yield from _with_bodies(body)


def lent_outputs(ops, lent):
    """``{output name: lent feed name}`` of the cache writes whose cache is
    a lent feed (each writes its feed's tensor in place and outputs it).
    Raises where a lent feed is read by anything but a cache write's
    ``Cache``: that reader would see the write."""
    out = {}
    for op in ops:
        for slot, vs in op.inputs.items():
            for v in vs:
                if v.name not in lent:
                    continue
                if op.type not in _CACHE_WRITES or slot != "Cache":
                    raise ValueError(
                        "lent feed %r is read by op '%s' (%s): a lent feed "
                        "may only be the Cache of a kv_cache_write, which "
                        "writes it in place" % (v.name, op.type, slot))
                out[op.output("Out").name] = v.name
    return out


def state_writes(ops, persist):
    """The persistables ``ops`` write, in op order, leaving out the moving
    statistics that a test-mode batch norm passes through unchanged."""
    out = []
    for op in ops:
        keep = set()
        if op.type in ("batch_norm", "fused_conv2d") and (
                op.attr("is_test", False)
                or op.attr("use_global_stats", False)):
            keep = {v.name for s in ("MeanOut", "VarianceOut")
                    for v in op.output_list(s)}
        out.extend(n for n in op.output_arg_names
                   if n in persist and n not in keep and n not in out)
    return out


def _reads(op):
    """The names ``op`` reads, its Switch condition and its control-flow
    bodies' free names included."""
    cond = op.attrs.get("_switch_cond")
    return (list(op.input_arg_names) + ([cond] if cond else [])
            + sorted(body_reads(op)))


def remat_segments(ops, fetch_names=(), writes=()):
    """``{start: (end, keep)}``: the rematerialized segments of a step's
    forward, ``ops[start:end]`` each, and the names each keeps (those it
    writes that a later op reads, a fetch, or a state write). Empty unless
    an ``autodiff`` op has ``remat``. A segment ends after the op that
    writes each of its ``checkpoints``, or, without checkpoints, every
    ~sqrt(n) of the n forward ops. Two kinds of op run outside every
    segment: a sparse table's lookup (its output is the gradient's leaf),
    and the fused projection + CE, whose backward keeps only its inputs
    and a row's statistics, so a recompute would save nothing and cost
    the vocabulary's products again."""
    ad = next((i for i, op in enumerate(ops)
               if op.type == "autodiff" and op.attr("remat", False)), None)
    if ad is None:
        return {}
    sparse = set(ops[ad].attr("sparse_wrt_names") or ())
    ckpts = set(ops[ad].attr("checkpoints") or ())
    if ckpts:
        cuts = {i + 1 for i in range(ad)
                if ckpts & set(ops[i].output_arg_names)}
    else:
        step = max(1, int(round(math.sqrt(ad))))
        cuts = set(range(step, ad, step))

    def outside(op):
        return (op.attr("is_optimizer_op")
                or op.type == "fused_linear_smooth_ce"
                or (op.type == "lookup_table" and op.input("W") is not None
                    and op.input("W").name in sparse))

    spans, start = [], None
    for i in range(ad + 1):
        if start is not None and (i in cuts or i == ad or outside(ops[i])):
            spans.append((start, i))
            start = None
        if i < ad and start is None and not outside(ops[i]):
            start = i
    later = set(fetch_names) | set(writes)
    segments = {}
    for start, end in reversed(spans):
        for op in ops[end:]:
            later.update(_reads(op))
        written = []
        for op in ops[start:end]:
            written += [n for n in op.output_arg_names if n not in written]
        segments[start] = (end, [n for n in written if n in later])
    return segments


def _run_segment(env, ops, keep):
    """One rematerialized segment: ``ops`` under a non-reentrant
    checkpoint over a copy of ``env``; only ``keep`` goes back into
    ``env``. The recompute runs under the AMP flag of the forward (it may
    run on autograd's device thread), replays the forward's draws, and
    runs the whole segment (no early stop), so a step's kernel launches
    follow from the segments alone."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    base, tape, amp = dict(env), RngTape(), AMP.enabled

    def body():
        local = dict(base)
        local[RNG_TAPE_KEY] = tape
        for op in ops:
            run_op(local, op)
        return [local.get(n) for n in keep]

    @contextlib.contextmanager
    def recompute():
        tape.replay = 0
        with amp_scope(amp):
            yield

    with set_checkpoint_early_stop(False):
        outs = checkpoint(body, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              recompute()))
    env.update((n, t) for n, t in zip(keep, outs) if t is not None)


def capture_rule(ops, writes=(), donate_state=True, use_program_cache=True,
                 cuda=True, lent=()):
    """``(captured, reason)``: whether a step of ``ops`` is captured as one
    CUDA graph, decided from the op list before any capture. ``writes``:
    the persistables the step writes (:func:`state_writes`); ``lent``: the
    feeds the caller lends (:func:`lent_outputs`), whose cache writes and
    cached attention the graph holds."""
    if not cuda:
        return False, "CPU place: a CPU step has no graph"
    if not use_program_cache:
        return False, "use_program_cache=False: every step is interpreted"
    if writes and not donate_state:
        return False, ("writes state (%s) and donate_state=False: the "
                       "graph would write the shared tensors in place"
                       % writes[0])
    in_place = set(lent) | set(lent_outputs(ops, lent))
    for op in _with_bodies(ops):
        if op.type in _CACHE_WRITES and op.input("Cache").name in in_place:
            continue
        if op.type in _CACHE_READS and {op.input("CacheK").name,
                                        op.input("CacheV").name} <= in_place:
            continue
        why = _NOT_CAPTURED.get(op.type)
        if why is not None:
            return False, "op '%s': %s" % (op.type, why)
        if op.type == "autodiff" and op.attr("merge_sparse", False):
            return False, ("op 'autodiff' merges sparse rows (merge_sparse): "
                           "merge_sparse_rows reads its segment counts on "
                           "the host")
        if op.input("GradRows") is not None and (
                op.type in ("momentum", "adagrad")
                or (op.type == "adam" and op.attr("lazy_mode", False))):
            return False, ("op '%s' updates the touched rows of a sparse "
                           "grad: the rows are picked by a boolean index, "
                           "on the host" % op.type)
    return True, "admitted"


def feed_signature(gb, feed):
    """``((name, shape, dtype), ...)`` of a feed, each dtype the one
    :func:`to_tensor` coerces the value to."""
    sig = []
    for name in sorted(feed):
        value = feed[name]
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        var = gb.var(name) if gb.has_var(name) else None
        sig.append((name, tuple(value.shape),
                    torch_dtype(var.dtype if var is not None
                                else value.dtype)))
    return tuple(sig)


class _Entry:
    """One cache key's plan: the facts the step needs from its op list,
    the capture decision and, from call 2 on, its :class:`CapturedStep`.
    It holds its program and scope weakly and no op (an op refers to its
    program): the op list is read from the program when the step runs
    (:meth:`ops_plan`), and an entry whose program or scope is collected is
    released (``Executor._collected``)."""

    def __init__(self, program, scope, ops, fetch_names, fused, writes,
                 captured, reason, lent=()):
        # an id() in the key may be reused once its object is gone
        self.program, self.scope = weakref.ref(program), weakref.ref(scope)
        self.fetch_names, self.fused = tuple(fetch_names), fused
        self.sparse = {n for op in ops if op.type == "autodiff"
                       for n in op.attr("sparse_wrt_names") or ()}
        self.wrt = {n for op in ops if op.type in _AUTODIFF_OPS
                    for n in op.attr("wrt_names")} - self.sparse
        self.amp = bool(getattr(program, "_amp_bf16", False))
        self.writes = writes
        self.remat = remat_segments(ops, fetch_names, writes)
        self.lent = frozenset(lent)
        self.lent_out = lent_outputs(ops, self.lent)
        self.captured, self.reason = captured, reason
        self.step = None
        # the thread whose call 1 ran (the next call on it captures): a
        # capture needs that thread's lazy state (its cuBLAS handle)
        self.warm = None
        self.runs = {"interpreted": 0, "captures": 0, "replays": 0}
        self.pool_bytes = None
        self.fetch_meta = None  # call 1's fetches: [(shape, dtype)]

    @property
    def training(self):
        return bool(self.wrt or self.sparse)

    def ops_plan(self):
        """:func:`step_plan` of the live program: (ops, plan, skip)."""
        program = self.program()
        if program is None:
            raise RuntimeError("the program of this cache entry is gone")
        return step_plan(program, self.fetch_names, self.fused)

    @property
    def plan(self):
        """The optimizer fusion groups, ``{op index: [ops]}``."""
        return self.ops_plan()[1]

    def report(self):
        return dict(captured=self.captured, reason=self.reason,
                    graph=self.step is not None, pool_bytes=self.pool_bytes,
                    **self.runs)


def _run_ops(env, entry, plan=None, after=None):
    """Run the entry's ops over ``env`` in the mode its program needs;
    returns the names written. Training: the step's wrt vars become leaf
    tensors and autograd records the forward; the updates run under
    ``no_grad``. Otherwise the whole step runs under ``inference_mode``.
    ``plan``: ``(ops, opt-fusion plan, skip)``, by default the entry's;
    ``after(op, env, before)`` runs after each op, ``before`` the values
    its outputs held before it."""
    ops, groups, skip = plan if plan is not None else entry.ops_plan()
    env[LENT_KEY] = entry.lent
    written = set()
    with amp_scope(entry.amp), (contextlib.nullcontext() if entry.training
                                else torch.inference_mode()):
        if entry.training:
            for n in entry.wrt:
                t = env.get(n)
                if t is not None and t.is_floating_point():
                    env[n] = t.detach().requires_grad_(True)
            if entry.sparse:
                env[SPARSE_SITES_KEY] = {n: [] for n in entry.sparse}
        remat = entry.remat if after is None else {}
        end = 0
        for i, op in enumerate(ops):
            if i in skip or i < end:
                continue
            seg = remat.get(i)
            if seg is not None:
                end, keep = seg
                _run_segment(env, ops[i:end], keep)
                for member in ops[i:end]:
                    written.update(member.output_arg_names)
                continue
            group = groups.get(i)
            before = None if after is None else {
                n: env.get(n) for n in op.output_arg_names}
            with (torch.no_grad() if op.attr("is_optimizer_op")
                  else contextlib.nullcontext()):
                if group is None:
                    run_op(env, op)
                    written.update(op.output_arg_names)
                else:
                    run_fused_group(env, group)
                    for member in group:
                        written.update(member.output_arg_names)
            if after is not None:
                after(op, env, before)
    return written


def _check_finite(op, env, before):
    """``FLAGS_check_nan_inf`` after one op: every float output it wrote,
    on the host; the first NaN or Inf raises naming the op type and the
    var (``paddle_tpu/core/executor.py:535`` ``_run_checked``)."""
    for n in op.output_arg_names:
        v = env.get(n)
        if (v is None or v is before.get(n)
                or not isinstance(v, torch.Tensor)
                or not v.is_floating_point()):
            continue
        v = v.detach()
        if not bool(torch.isfinite(v).all()):
            bad = "nan" if bool(torch.isnan(v).any()) else "inf"
            raise RuntimeError(
                "check_nan_inf: op '%s' produced %s in output var '%s' "
                "(shape %s)" % (op.type, bad, n, tuple(v.shape)))


def _storage(t):
    return t.untyped_storage().data_ptr()


def _same_view(a, b):
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def _write_in_place(pairs, inference):
    """Copy each new value into its state tensor, ``(dst, src)`` pairs. A
    value that already is its tensor is skipped; one that shares storage
    with a tensor being written is copied out first."""
    dsts = {_storage(d) for d, _ in pairs}
    todo = []
    for dst, src in pairs:
        src = src.detach()
        if _same_view(dst, src):
            continue
        if _storage(src) in dsts:
            src = src.clone()
        todo.append((dst, src))
    if not todo:
        return
    with (torch.inference_mode() if inference else torch.no_grad()):
        torch._foreach_copy_([d for d, _ in todo], [s for _, s in todo])


def _own(fetches, written_bufs):
    """Fetch tensors that share storage with a state tensor written in
    place are copied first, so they keep the value the step computed."""
    ptrs = {_storage(t) for t in written_bufs}
    return [f.clone() if _storage(f) in ptrs else f for f in fetches]


def _host_array(value):
    """A feed value as a tensor on its own device (numpy arrays become CPU
    tensors without a copy)."""
    if isinstance(value, torch.Tensor):
        return value
    a = np.asarray(value)
    if not a.flags.c_contiguous:  # a 0-d array always is: it keeps ()
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a)


class _GraphPool:
    """What one executor's graphs share. Their replays are serialized (under
    the executor's lock, and in stream order through ``done``) and every
    replay's fetches are copied out before the next one, so the graphs
    share one memory pool for what a step makes and drops, and one fetch
    arena: each graph copies its fetches into the arena's first bytes,
    allocated outside every pool. A graph thus keeps no live tensor in the
    pool, and a replica's keys share one scratch pool instead of holding
    one each."""

    def __init__(self, device):
        self.device = device
        self._handle = None
        self.live = 0  # graphs captured into the pool and not released
        self.arena = None
        self.done = None  # event recorded after the last replay's copies

    def handle(self):
        # a pool whose graphs are all released may be freed, and must not
        # be captured into again: a new capture then opens a new one
        if self._handle is None or self.live == 0:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def discard(self):
        """After a failed capture: the pool may still be marked as being
        recorded into, so the next capture opens a new one."""
        self._handle = None

    def fetch_views(self, meta):
        """One arena view per ``(shape, dtype)`` of ``meta``, 256-byte
        aligned; a bigger arena replaces a smaller one (the graphs that
        write the old one keep it)."""
        offsets, need = [], 0
        for shape, dtype in meta:
            offsets.append(need)
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            need += -(-n // 256) * 256
        if self.arena is None or self.arena.numel() < need:
            size = max(need, 2 * (0 if self.arena is None
                                  else self.arena.numel()))
            self.arena = torch.empty(size, dtype=torch.uint8,
                                     device=self.device)
        views = []
        for (shape, dtype), off in zip(meta, offsets):
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            views.append(self.arena[off:off + n].view(dtype).view(shape))
        return views

    def before_replay(self):
        if self.done is not None:
            torch.cuda.current_stream(self.device).wait_event(self.done)

    def after_replay(self):
        if self.done is None:
            self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(self.device))


def rng_name(scope, device):
    """The name of ``device``'s generator in ``scope`` (see the module
    docstring); the generator itself may not be there yet."""
    first = scope.find_var(RNG_KEY)
    if first is None or first.device == device:
        return RNG_KEY
    return RNG_KEY + str(device)


def capture_graph(fn, generator, device, **graph_kw):
    """Record ``fn()`` into a new ``torch.cuda.CUDAGraph`` on ``device``
    (``graph_kw``: ``torch.cuda.graph``'s pool and stream) and return
    (graph, what ``fn`` returned, its tensors the graph's outputs, the
    bytes the capture reserved). Nothing runs until the graph is replayed.
    ``generator`` is registered with the graph, so each replay advances it
    as an eager call would (dropout, the flash kernels' seeds)."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    # no cyclic collection inside the capture: a dead graph it freed (a
    # dropped engine's, say) would destroy itself with CUDA calls a
    # capturing thread may not make, and invalidate this capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local",
                              **graph_kw):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    return graph, out, torch.cuda.memory_reserved(device) - before


class CapturedStep:
    """The step body of one cache entry over static buffers: it reads the
    state from the scope's own tensors and the feed from one buffer per
    name, and writes the new state back INTO those tensors (the port's
    counterpart of the reference's donated state). A lent feed
    (``Executor.run``'s ``_lend``) is the caller's own tensor, bound as its
    buffer: the step's cache write goes into it, and the fetch of that
    write returns it. On the card the body is captured once as a
    ``torch.cuda.CUDAGraph`` and replayed; on the CPU :meth:`body` runs it
    eagerly, which is what the CPU tests check."""

    def __init__(self, entry, scope, state_names, feed, fetch_names, device,
                 gb, pool=None):
        self.entry = entry
        self.state = {n: scope.get(n) for n in state_names}
        self.rng = rng_name(scope, device)
        self.gen = scope.get(self.rng)
        self.device = device
        self.pool = pool
        self.feed = {}
        for name, value in feed.items():
            if name in entry.lent:
                self.feed[name] = value
                continue
            var = gb.var(name) if gb.has_var(name) else None
            src = _host_array(value)
            self.feed[name] = torch.empty(
                tuple(src.shape), device=device,
                dtype=torch_dtype(var.dtype if var is not None
                                  else src.dtype))
        self.fetch_names = list(fetch_names)
        missing = [n for n in entry.writes if n not in self.state]
        if missing:
            raise RuntimeError(
                "captured step: persistable %r is written but was not in "
                "the scope when the step was bound" % missing[0])
        self.graph = None
        self.fetches = None
        self.pooled = False  # captured into the pool: counted in its live

    def bound_to(self, scope, feed):
        """Whether every state name still maps to the tensor this step
        reads and writes (another writer may have replaced it: a load, a
        second startup run, a test copying weights in), and every lent
        feed is the tensor the graph writes."""
        held = scope._vars
        return (rng_name(scope, self.device) == self.rng
                and held.get(self.rng) is self.gen
                and all(held.get(n) is t for n, t in self.state.items())
                and all(_same_view(feed[n], self.feed[n])
                        for n in self.entry.lent))

    def load_feed(self, feed):
        for name, value in feed.items():
            if name not in self.entry.lent:
                self.feed[name].copy_(_host_array(value))

    def body(self):
        """One step over the static buffers; returns the fetch tensors."""
        env = dict(self.state)
        env.update(self.feed)
        env[RNG_KEY] = self.gen
        env[DEVICE_KEY] = self.device
        written = _run_ops(env, self.entry)
        pairs = [(self.state[n], env[n]) for n in self.entry.writes
                 if n in written]
        fetches = _own([env[n] for n in self.fetch_names],
                       [d for d, _ in pairs])
        _write_in_place(pairs, not self.entry.training)
        return [f.detach() for f in fetches]

    def capture(self, stream):
        """Record :meth:`body` into a CUDA graph on ``stream``, in the
        executor's shared pool, each fetch but a lent one copied into the
        fetch arena; nothing runs until :meth:`replay`."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        lent = self.entry.lent_out
        meta = [m for n, m in zip(self.fetch_names, self.entry.fetch_meta)
                if n not in lent]
        views = iter(self.pool.fetch_views(meta))

        def recorded():
            return [f if n in lent else next(views).copy_(f)
                    for n, f in zip(self.fetch_names, self.body())]

        try:
            # the scope's generator is registered with the graph
            graph, fetches, pool_bytes = capture_graph(
                recorded, self.gen, self.device, pool=self.pool.handle(),
                stream=stream)
        except Exception as e:
            self.pool.discard()
            e.add_note("  [capturing the step as one CUDA graph: the capture "
                       "rule admitted this program, so the failing op above "
                       "is a fault in the rule]")
            raise
        self.entry.pool_bytes = pool_bytes
        self.fetches = fetches
        self.graph = graph
        self.pool.live += 1
        self.pooled = True

    def replay(self, feed, return_numpy):
        self.load_feed(feed)
        cuda = self.device.type == "cuda"
        if cuda:
            self.pool.before_replay()
        self.graph.replay()
        # the next replay overwrites the graph's buffers and the arena:
        # hand out copies; a lent cache is handed back as the caller's own
        lent = self.entry.lent_out
        if return_numpy:
            out = [np.array(to_numpy(f)) for f in self.fetches]
        else:
            out = [self.feed[lent[n]] if n in lent else f.clone()
                   for n, f in zip(self.fetch_names, self.fetches)]
        if cuda:
            self.pool.after_replay()
        return out

    def release(self):
        if self.pooled:
            self.pool.live -= 1
            self.pooled = False
        self.graph = self.fetches = None
        self.state = self.feed = {}


class Executor:
    """Runs programs on one place. Each (program, version, feed signature,
    fetch set, state read, scope, AMP mark, ``donate_state``, fused
    optimizer switch, lent feeds) is one cache entry, as the reference
    keys its compiled programs (``paddle_tpu/core/executor.py:418-421``).
    On the card an entry the capture rule admits runs interpreted once
    (call 1: kernel builds, the generator, the inference-tensor copies),
    is captured as one CUDA graph on call 2 and replayed from then on:
    ``copy_`` of the feed into its buffers, one replay, the fetches read
    out. An entry whose program or scope is collected is released at the
    next call. :meth:`step_report` says whether a program's step is
    captured and why not."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = resolve_device(self.place)
        self._cache = {}
        self._last = {}
        self._lock = threading.Lock()
        self._stream = None
        self._pool = _GraphPool(self.device)
        # (key, entry ref) of entries whose program or scope was
        # collected, appended by a finalizer and released under the lock
        self._dead = collections.deque()
        self._released = 0

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True, feed_var_name="feed",
            fetch_var_name="fetch", check_nan_inf=None, donate_state=True,
            verify=None, _lend=()):
        """``use_program_cache=False`` interprets every step.
        ``donate_state=False`` (the Predictor's) captures only a program
        that writes no state: a captured step writes its state in place,
        which clones serving one scope's weights must not see.
        ``check_nan_inf`` (None: ``FLAGS_check_nan_inf``) interprets the
        program's own ops one by one and raises at the first NaN or Inf an
        op writes (never captured). ``feed_var_name`` and
        ``fetch_var_name`` are accepted and ignored, as in the reference.

        ``_lend`` (the serving tier's): feed names whose tensors the
        caller lends for the step. Each must be a tensor on this device in
        its var's dtype, read only as the ``Cache`` of a
        ``kv_cache_write(_chunk)``; the write goes into it in place and the
        fetch of that write returns the tensor itself. A lent cache is
        ``attention_ops.lendable_cache``'s: the first C positions of a
        [C + 1, B, ...] buffer whose position C is the scratch column."""
        if verify:
            raise NotImplementedError(
                "Executor.run(verify=...): the static program verifier "
                "(paddle_tpu's analysis passes) is not ported yet "
                "(ROADMAP A10)")
        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        gb = program.global_block()
        if check_nan_inf is None:
            check_nan_inf = env_flag("FLAGS_check_nan_inf")
        lend = frozenset(_lend)
        for name in lend:
            value = feed.get(name)
            var = gb.var(name) if gb.has_var(name) else None
            if (not isinstance(value, torch.Tensor)
                    or value.device != self.device or var is None
                    or value.dtype != torch_dtype(var.dtype)):
                raise ValueError(
                    "lent feed %r must be a %s tensor on %s" % (
                        name, var.dtype if var is not None else "declared",
                        self.device))
        with self._lock:
            self._reap()
            rng = rng_name(scope, self.device)
            if rng not in scope:
                seed = program.random_seed or secrets.randbits(31)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(seed))
                scope.set(rng, gen)
            persist = {v.name for v in program.list_vars() if v.persistable}
            state_in = tuple(sorted(n for n in persist if n in scope))
            sp = obs_trace.span("executor.run")
            with sp:
                out = self._run_locked(
                    program, scope, feed, fetch_names, persist, state_in,
                    lend, return_numpy, gb, check_nan_inf, donate_state,
                    use_program_cache)
                if sp and self.device.type == "cuda":
                    # under tracing the step is timed honestly: the span
                    # closes after the run's stream has done its work (the
                    # reference blocks on the fetches); it opens around
                    # the replay, the interpreted run, or the capture and
                    # its first replay, never inside a capture
                    torch.cuda.current_stream(self.device).synchronize()
            return out

    def _run_locked(self, program, scope, feed, fetch_names, persist,
                    state_in, lend, return_numpy, gb, check_nan_inf,
                    donate_state, use_program_cache):
        """:meth:`run`'s body under the executor's lock: the cache entry
        of this key, then a replay, an interpreted run or a capture."""
        if check_nan_inf:
            return self._run_checked(program, scope, feed, fetch_names,
                                     persist, state_in, lend,
                                     return_numpy)
        fused = env_flag("PADDLE_TPU_FUSED_OPT")
        key = (id(program), program._version, feed_signature(gb, feed),
               tuple(fetch_names), state_in, id(scope),
               bool(getattr(program, "_amp_bf16", False)),
               bool(donate_state), fused, lend)
        entry = self._cache.get(key) if use_program_cache else None
        if entry is None or entry.program() is not program \
                or entry.scope() is not scope:
            entry = self._entry(program, scope, fetch_names, persist,
                                fused, donate_state, use_program_cache,
                                lend)
            if use_program_cache:
                self._cache[key] = entry
                ref, me = weakref.ref(entry), weakref.ref(self)
                for owner in (program, scope):
                    weakref.finalize(owner, Executor._collected, me, key,
                                     ref)
        self._last[id(program)] = entry
        step = entry.step
        if step is not None and not step.bound_to(scope, feed):
            step.release()  # dropped: captured again from call 1
            step = entry.step = None
            entry.warm = None
        if step is not None:
            entry.runs["replays"] += 1
            return step.replay(feed, return_numpy)
        thread = threading.get_ident()
        if not entry.captured or entry.warm != thread:
            out = self._interpret(program, entry, scope, feed,
                                  fetch_names, persist, state_in,
                                  return_numpy)
            entry.warm = thread if entry.captured else None
            return out
        step = CapturedStep(entry, scope, state_in, feed, fetch_names,
                            self.device, gb, pool=self._pool)
        step.load_feed(feed)
        with _CAPTURE_LOCK:
            step.capture(self._side_stream())
        entry.step = step
        entry.runs["captures"] += 1
        scope._binders.add(self)
        return step.replay(feed, return_numpy)

    @staticmethod
    def _collected(me, key, ref):
        """Finalizer of an entry's program or scope: queue the entry for
        release (the lock may be held by the thread the collector runs
        on, so nothing is released here)."""
        exe = me()
        if exe is not None:
            exe._dead.append((key, ref))

    def _drop_entry(self, entry):
        """Release ``entry``'s graph; True if it held one."""
        if entry.step is None:
            return False
        entry.step.release()
        entry.step = None
        entry.warm = None
        return True

    def _reap(self):
        """Release the queued entries whose program or scope is gone."""
        freed = False
        while self._dead:
            key, ref = self._dead.popleft()
            entry = ref()
            if entry is None or self._cache.get(key) is not entry:
                continue
            del self._cache[key]
            for k in [k for k, e in self._last.items() if e is entry]:
                del self._last[k]
            freed |= self._drop_entry(entry)
            self._released += 1
        if freed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _release_bound(self, scope, name):
        """``Scope.drop``: release the steps bound to ``scope`` whose state
        holds ``name``."""
        with self._lock:
            for entry in self._cache.values():
                step = entry.step
                if (step is not None and entry.scope() is scope
                        and (name in step.state
                             or name in (RNG_KEY, step.rng))):
                    self._drop_entry(entry)

    def _entry(self, program, scope, fetch_names, persist, fused,
               donate_state, use_program_cache, lent=()):
        ops, _plan, _skip = step_plan(program, fetch_names, fused)
        writes = state_writes(ops, persist)
        captured, reason = capture_rule(
            ops, writes, donate_state=donate_state,
            use_program_cache=use_program_cache,
            cuda=self.device.type == "cuda", lent=lent)
        return _Entry(program, scope, ops, fetch_names, fused, writes,
                      captured, reason, lent)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def take_stream(self, other):
        """Run call 1 and the capture of this executor's captured entries
        on ``other``'s side stream instead of a stream of its own (no-op
        once this one has its own, or across devices). A serving replica
        rebuilt in place of an evicted one takes the evicted executor's
        stream: PyTorch keeps a cuBLAS workspace for each stream a GEMM
        ran on until the process ends, so a new stream every rebuild
        would hold one more workspace each time."""
        if self._stream is None and other.device == self.device:
            self._stream = other._stream

    @contextlib.contextmanager
    def _warm_up(self):
        """Call 1 of a captured entry runs on the stream the capture will
        use, so that per-stream lazy state (cuBLAS's workspace) is made
        outside the capture."""
        side = self._side_stream()
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            yield
        cur.wait_stream(side)

    def _feed_env(self, gb, scope, feed, state_in):
        env = {n: scope.get(n) for n in state_in}
        for name, value in feed.items():
            var = gb.var(name) if gb.has_var(name) else None
            env[name] = to_tensor(value, self.device, var)
        env[RNG_KEY] = scope.get(rng_name(scope, self.device))
        env[DEVICE_KEY] = self.device
        return env

    def _interpret(self, program, entry, scope, feed, fetch_names, persist,
                   state_in, return_numpy, plan=None, after=None):
        env = self._feed_env(program.global_block(), scope, feed, state_in)
        if entry.training:
            for n, t in list(env.items()):
                if isinstance(t, torch.Tensor) and t.is_inference():
                    # made by a grad-free run (startup, load, eval): it
                    # cannot be saved for backward, so it is copied, once:
                    # the copy replaces it in the scope
                    env[n] = t.clone()
                    if n in persist:
                        scope.set(n, env[n])
        warm = entry.captured
        with (self._warm_up() if warm else contextlib.nullcontext()):
            written = _run_ops(env, entry, plan, after)
            fetches = [env[n] for n in fetch_names]
            new = {n: env[n] for n in persist & written}
            if warm:
                # call 1 of a captured entry: the state stays in the
                # tensors the capture will bind, so two captured programs
                # over one scope do not replace each other's
                pairs, fresh = [], {}
                for n, t in new.items():
                    old = scope._vars.get(n)
                    if (old is not None and old.shape == t.shape
                            and old.dtype == t.dtype
                            and old.device == t.device):
                        pairs.append((old, t))
                    else:
                        fresh[n] = t
                        if old is not None:
                            entry.captured = False
                            entry.reason = ("state '%s' changes shape or "
                                            "dtype in a step" % n)
                fetches = _own(fetches, [d for d, _ in pairs])
                _write_in_place(pairs, not entry.training)
                new = fresh
                entry.fetch_meta = [(tuple(f.shape), f.dtype)
                                    for f in fetches]
        for n, t in new.items():
            scope.set(n, t.detach())
        entry.runs["interpreted"] += 1
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    def _run_checked(self, program, scope, feed, fetch_names, persist,
                     state_in, lend, return_numpy):
        """``check_nan_inf``: the program's own op list (unfused), run one
        op at a time with :func:`_check_finite` after each."""
        ops = program.global_block().ops
        entry = _Entry(program, scope, ops, fetch_names, False, [], False,
                       "check_nan_inf: interpreted op by op", lend)
        return self._interpret(program, entry, scope, feed, fetch_names,
                               persist, state_in, return_numpy,
                               plan=(ops, {}, frozenset()),
                               after=_check_finite)

    def step_report(self, program=None):
        """The capture decision of ``program``'s most recent run on this
        executor: ``captured`` (whether the capture rule admits it),
        ``reason``, ``graph`` (whether a graph is held now),
        ``pool_bytes`` (the device memory the capture reserved), and the
        runs it has had: ``interpreted``, ``captures``, ``replays``; and
        the executor's ``entries`` (cache entries held) and ``released``
        (entries released because their program or scope was collected).
        """
        if program is None:
            program = framework.default_main_program()
        with self._lock:
            self._reap()
            entry = self._last.get(id(program))
            if entry is None or entry.program() is not program:
                raise KeyError("step_report: no run of this program on this "
                               "executor")
            return dict(entry.report(), entries=len(self._cache),
                        released=self._released)

    def close(self):
        """Release every cache entry and its graph (the reference's
        ``Executor::Close``, ``executor.cc:139``): the graphs' memory
        pool and fetch arena go back to the allocator."""
        with self._lock:
            held = False
            for entry in self._cache.values():
                held |= self._drop_entry(entry)
            self._cache.clear()
            self._last.clear()
            self._dead.clear()
            self._pool = _GraphPool(self.device)
            if held and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
