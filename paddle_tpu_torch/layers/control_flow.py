"""Control-flow layers (the port's ``paddle_tpu/layers/control_flow.py``;
ref ``python/paddle/fluid/layers/control_flow.py``: While:504,
StaticRNN:278, ConditionalBlock:1055, Switch:1138).

As in the reference, a body is recorded into a sub-block and its ops are
held by one op of the enclosing block: ``StaticRNN`` and ``DynamicRNN``
become ``scan_block``, ``While`` becomes ``while_block``, ``cond`` and
``IfElse`` become ``cond_block`` (``core/opimpl/control_ops.py``, which
runs the recorded ops). A While's loop-carried vars are listed in
``loop_vars``; a tensor array is a fixed-capacity stacked buffer whose
fill level the loop carries beside it. ``while_block`` and ``cond_block``
read their condition on the host, so a program holding either is
interpreted; a StaticRNN's step is captured like any other. ``Switch``
records each case's ops in a sub-block and moves them into the global
block guarded by ``_switch_cond``; ``run_op`` then keeps each output's old
value where the case does not fire (``torch.where`` on the device), so a
step with a Switch is captured like any other.
"""

from ..core import framework
from ..core.layer_helper import LayerHelper
from .math_op_patch import binary

__all__ = ["StaticRNN", "DynamicRNN", "While", "Switch", "cond", "increment",
           "less_than", "equal", "array_write", "array_read",
           "create_array", "array_length", "IfElse"]


def less_than(x, y, force_cpu=None, cond=None):
    """``x < y`` into a new bool var, or into ``cond``: a While body
    updates its loop condition so."""
    return binary(x, y, "less_than", out=cond)


def equal(x, y, cond=None):
    return binary(x, y, "equal", out=cond)


def increment(x, value=1.0, in_place=True):
    from . import tensor

    return tensor.increment(x, value, in_place)


class BlockGuard:
    """Records into a new sub-block of ``program`` while the block runs."""

    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.block = self.program._create_block()
        return self.block

    def __exit__(self, *a):
        self.program._rollback()
        return False


class _StepGuard(BlockGuard):
    """The step block of a StaticRNN: the RNN records into it."""

    def __init__(self, rnn):
        super().__init__(framework.default_main_program())
        self.rnn = rnn

    def __enter__(self):
        self.rnn._block = super().__enter__()
        self.rnn._entered = True
        return self.rnn._block

    def __exit__(self, *a):
        self.rnn._entered = False
        return super().__exit__(*a)


class StaticRNN:
    """Static-length RNN (ref ``control_flow.py:278``): the step block is
    recorded into a sub-block and run once a step by ``scan_block``.

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [B, T, D] (batch-major)
            h = rnn.memory(shape=[H], batch_ref=x)
            nh = some_layers(x_t, h)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()                           # [B, T, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._mems = []          # (pre_var, init_var)
        self._mem_updates = {}   # pre_var.name -> post var
        self._step_inputs = []   # (step_var, full_var)
        self._step_outputs = []
        self._block = None
        self._entered = False

    def step(self):
        return _StepGuard(self)

    def _require_step(self, what):
        if not self._entered:
            raise ValueError("StaticRNN.%s must be called inside "
                             "rnn.step()" % what)

    def step_input(self, x):
        self._require_step("step_input")
        step_var = self._block.create_var(
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=str(x.dtype))
        self._step_inputs.append((step_var, x))
        return step_var

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=0):
        self._require_step("memory")
        if init is None:
            from . import tensor

            if batch_ref is None:
                raise ValueError("StaticRNN.memory needs init or batch_ref")
            # the init is built in the global block, outside the step
            prog = framework.default_main_program()
            saved = prog.current_block_idx
            prog.current_block_idx = 0
            init = tensor.fill_constant_batch_size_like(
                batch_ref, [1] + list(shape), str(batch_ref.dtype),
                init_value)
            prog.current_block_idx = saved
        pre = self._block.create_var(shape=init.shape, dtype=str(init.dtype))
        self._mems.append((pre, init))
        return pre

    def update_memory(self, mem, var):
        self._mem_updates[mem.name] = var

    def step_output(self, o):
        self._step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self, *args, **kwargs):
        from . import tensor as T

        gb = framework.default_main_program().global_block()
        x_vars = [full for _, full in self._step_inputs]
        # the scan is time-major: transposes on both sides
        xs_tm = [T.transpose(x, [1, 0] + list(range(2, len(x.shape))))
                 for x in x_vars]
        init_vars = [init for _, init in self._mems]
        carry_names = [pre.name for pre, _ in self._mems]
        lasts = [gb.create_var(shape=i.shape, dtype=str(i.dtype))
                 for i in init_vars]
        ys = [gb.create_var(shape=(x_vars[0].shape[1],) + tuple(o.shape),
                            dtype=str(o.dtype)) for o in self._step_outputs]
        gb.append_op(
            "scan_block", {"X": xs_tm, "Init": init_vars},
            {"Last": lasts, "Ys": ys},
            {"step_ops": list(self._block.ops),
             "x_step_names": [sv.name for sv, _ in self._step_inputs],
             "carry_names": carry_names,
             "carry_out_names": [self._mem_updates[n].name
                                 for n in carry_names],
             "y_names": [o.name for o in self._step_outputs]})
        outs = [T.transpose(y, [1, 0] + list(range(2, len(y.shape))))
                for y in ys]
        return outs[0] if len(outs) == 1 else outs


class _WhileGuard(BlockGuard):
    def __init__(self, loop):
        super().__init__(framework.default_main_program())
        self.loop = loop

    def __exit__(self, *exc):
        r = super().__exit__(*exc)
        if exc and exc[0] is not None:
            return r
        loop, gb = self.loop, self.program.global_block()
        outs = [gb.create_var(shape=v.shape, dtype=str(v.dtype))
                for v in loop.loop_vars]
        gb.append_op("while_block", {"Carry": list(loop.loop_vars)},
                     {"Out": outs},
                     {"body_ops": list(self.block.ops),
                      "cond_name": loop.cond_var.name})
        for v, o in zip(loop.loop_vars, outs):
            # rebind the names so later layers read the final values
            o.name = v.name
            gb.vars[v.name] = o
        return r


class While:
    """While loop (ref ``control_flow.py:504``): the body runs while
    ``cond`` (a bool var the body updates, e.g. through ``less_than(...,
    cond=cond)``) holds. The vars the loop carries from one trip to the
    next, tensor arrays included, are listed in ``loop_vars``."""

    def __init__(self, cond, loop_vars=None, name=None):
        self.cond_var = cond
        self.loop_vars = loop_vars or []
        self.helper = LayerHelper("while", name=name)

    def block(self):
        return _WhileGuard(self)


class Switch:
    """First-match cases (ref ``control_flow.py:1138``): a case's ops run
    guarded by ``its cond AND NOT(any earlier cond)``, the default's by
    ``NOT(any cond)``.

        with Switch() as switch:
            with switch.case(less_than(step, boundary)):
                assign(v0, lr)
            with switch.default():
                assign(v1, lr)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._prior_conds = []

    def case(self, condition):
        return _SwitchCase(self, condition)

    def default(self):
        return _SwitchCase(self, None)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _SwitchCase:
    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition
        self.prog = framework.default_main_program()

    def __enter__(self):
        self.block = self.prog._create_block()
        return self.block

    def __exit__(self, *a):
        self.prog._rollback()
        ops = list(self.block.ops)
        gb = self.prog.global_block()

        def _not(v):
            o = gb.create_var(shape=v.shape or (1,), dtype="bool")
            gb.append_op("logical_not", {"X": v}, {"Out": o}, {})
            return o

        def _and(a, b):
            o = gb.create_var(shape=a.shape or (1,), dtype="bool")
            gb.append_op("logical_and", {"X": a, "Y": b}, {"Out": o}, {})
            return o

        eff = self.condition
        for prior in self.switch._prior_conds:
            np_ = _not(prior)
            eff = np_ if eff is None else _and(eff, np_)
        if self.condition is not None:
            self.switch._prior_conds.append(self.condition)
        for op in ops:
            if eff is not None:
                op.attrs["_switch_cond"] = eff.name
            gb.ops.append(op)
            self.prog._version += 1
        return False


def _append_cond_block(pred, true_ops, t_outs, false_ops, f_outs):
    """The ``cond_block`` op of ``cond`` and ``IfElse``."""
    gb = framework.default_main_program().global_block()
    outs = [gb.create_var(shape=v.shape, dtype=str(v.dtype)) for v in t_outs]
    gb.append_op(
        "cond_block", {"Cond": pred}, {"Out": outs},
        {"true_ops": list(true_ops), "false_ops": list(false_ops),
         "true_out_names": [v.name for v in t_outs],
         "false_out_names": [v.name for v in f_outs]})
    return outs


def cond(pred, true_fn, false_fn, name=None):
    """Functional conditional (the reference's ``ConditionalBlock``
    pattern): both branches are recorded, the one ``pred`` selects runs.
    Both must return the same number of vars, of the same shapes."""
    prog = framework.default_main_program()
    tb = prog._create_block()
    true_out = true_fn()
    prog._rollback()
    fb = prog._create_block()
    false_out = false_fn()
    prog._rollback()
    t_outs = list(true_out) if isinstance(true_out, (list, tuple)) \
        else [true_out]
    f_outs = list(false_out) if isinstance(false_out, (list, tuple)) \
        else [false_out]
    outs = _append_cond_block(pred, tb.ops, t_outs, fb.ops, f_outs)
    return outs[0] if len(outs) == 1 else outs


def create_array(dtype, capacity=None):
    """A tensor array (ref ``create_array``, ``lod_tensor_array.h``): a
    fixed-capacity stacked buffer [capacity, ...], zero-filled at its
    first ``array_write``."""
    arr = framework.default_main_program().current_block().create_var(
        shape=None, dtype=dtype)
    arr._tensor_array_capacity = capacity
    return arr


def array_write(x, i, array=None, capacity=None):
    """Write ``x`` at position ``i`` (ref tensor_array_write); returns the
    array. Inside a While body the write updates the loop carry, so list
    the array in ``loop_vars``."""
    if array is None:
        array = create_array(str(x.dtype), capacity)
    cap = capacity or getattr(array, "_tensor_array_capacity", None)
    if cap is None:
        raise ValueError(
            "array_write needs a static capacity: pass capacity= here or "
            "on create_array (arrays are fixed-capacity buffers)")
    array._tensor_array_capacity = cap
    framework.default_main_program().current_block().append_op(
        "array_write", {"X": x, "I": i}, {"Out": array},
        {"capacity": int(cap)})
    return array


def array_read(array, i):
    cb = framework.default_main_program().current_block()
    out = cb.create_var(shape=None, dtype=str(array.dtype))
    cb.append_op("array_read", {"Array": array, "I": i}, {"Out": out}, {})
    return out


def array_length(array):
    cb = framework.default_main_program().current_block()
    out = cb.create_var(shape=(), dtype="int64")
    cb.append_op("array_length", {"Array": array}, {"Out": out}, {})
    return out


class _Branch(BlockGuard):
    def __init__(self, owner, is_true):
        super().__init__(framework.default_main_program())
        self.owner, self.is_true = owner, is_true

    def __enter__(self):
        self.owner._in_true = self.is_true
        block = super().__enter__()
        self.owner._branches[self.is_true] = block
        return block

    def __exit__(self, *a):
        self.owner._in_true = None
        return super().__exit__(*a)


class IfElse:
    """Two branches over a 0-d bool condition (ref ``control_flow.py``
    IfElse), sugar over ``cond``: ``input(x)`` returns x itself (no LoD
    split: the condition is one scalar).

        ie = IfElse(pred)
        with ie.true_block():
            ie.output(layers.scale(ie.input(x), 2.0))
        with ie.false_block():
            ie.output(layers.scale(ie.input(x), -1.0))
        out, = ie()
    """

    def __init__(self, cond_var, name=None):
        self._cond = cond_var
        self._branches = {True: None, False: None}
        self._outputs = {True: None, False: None}
        self._in_true = None

    def true_block(self):
        return _Branch(self, True)

    def false_block(self):
        return _Branch(self, False)

    def input(self, x):
        return x

    def output(self, *outs):
        self._outputs[self._in_true] = list(outs)

    def __call__(self):
        t_outs, f_outs = self._outputs[True], self._outputs[False]
        if not t_outs or not f_outs or len(t_outs) != len(f_outs):
            raise ValueError("IfElse: both branches must call output() "
                             "with the same number of vars")
        return _append_cond_block(self._cond, self._branches[True].ops,
                                  t_outs, self._branches[False].ops, f_outs)


class DynamicRNN(StaticRNN):
    """Variable-length RNN over a padded batch (ref ``control_flow.py``
    DynamicRNN, which shrinks a LoD batch as sequences end): StaticRNN's
    step, with the rows' ``lengths`` given at call time. A row's memories
    freeze after its last step (its final memory is its state there) and
    its outputs past its length are zeros.

        drnn = DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)          # x: [B, T, D]
            h = drnn.memory(shape=[H], batch_ref=x)
            nh = some_layers(x_t, h)
            drnn.update_memory(h, nh)
            drnn.step_output(nh)
        out = drnn(lengths=seq_len)           # [B, T, H], zero-padded
    """

    def block(self):
        return self.step()

    def __call__(self, lengths=None, **kwargs):
        if lengths is None:
            return super().__call__(**kwargs)
        from . import nn, tensor

        prog = framework.default_main_program()
        x_full = self._step_inputs[0][1]
        seq_len = x_full.shape[1]
        # [B, T] time indices, an extra scanned input built in the global
        # block
        t_row = tensor.unsqueeze(
            tensor.range(0, seq_len, 1, "float32"), [0])
        zero_b = tensor.fill_constant_batch_size_like(
            x_full, [1, 1], "float32", 0.0)
        t_full = nn.elementwise_add(zero_b, t_row)
        len_f = tensor.cast(lengths, "float32")

        # the masking ops go into the recorded step block
        saved = prog.current_block_idx
        prog.current_block_idx = self._block.idx
        self._entered = True
        try:
            alive = tensor.cast(less_than(self.step_input(t_full), len_f),
                                "float32")

            def mask_for(v):
                m = alive
                for _ in range(len(v.shape) - 1):
                    m = tensor.unsqueeze(m, [-1])
                return m

            for pre, _ in list(self._mems):
                post = self._mem_updates[pre.name]
                m = mask_for(post)
                self._mem_updates[pre.name] = nn.elementwise_add(
                    nn.elementwise_mul(post, m),
                    nn.elementwise_mul(pre, nn.scale(m, scale=-1.0,
                                                     bias=1.0)))
            self._step_outputs = [nn.elementwise_mul(o, mask_for(o))
                                  for o in self._step_outputs]
        finally:
            self._entered = False
            prog.current_block_idx = saved
        return super().__call__(**kwargs)
