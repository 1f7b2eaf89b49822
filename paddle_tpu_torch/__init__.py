"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

Same fluid-style surface, executed op by op over torch tensors, with the
TPU package's Pallas kernels rewritten as hand-written CUDA kernels for
Hopper (``ops/``, sources in ``csrc/``, built on first use):

    import paddle_tpu_torch as fluid
    x = fluid.layers.data("x", shape=[16])
    y = fluid.layers.fc(x, size=4, act="softmax")
    exe = fluid.Executor(fluid.CUDAPlace(0))   # the default place
    exe.run(fluid.default_startup_program())
    out, = exe.run(feed={"x": batch}, fetch_list=[y])

Training appends the backward and the optimizer's update ops to the same
program (``fluid.optimizer.Adam(1e-4).minimize(loss)``); each
``exe.run`` is then one step: forward, ``torch.autograd`` backward and
update.

This package imports neither ``jax`` nor ``paddle_tpu``. Entry points run
on the GPU unless given ``CPUPlace()`` / ``device="cpu"``; without a GPU
they raise rather than fall back.
"""

from .core import framework  # noqa: F401
from .core import opimpl  # noqa: F401  (registers every op impl)
from .core import initializer  # noqa: F401
from .core import unique_name  # noqa: F401
from .core.executor import (CPUPlace, CUDAPlace, Executor, Scope,  # noqa: F401
                            global_scope, scope_guard)
from .core.framework import (Parameter, Program, Variable,  # noqa: F401
                             default_main_program, default_startup_program,
                             name_scope, program_guard)
from .core.param_attr import ParamAttr  # noqa: F401
from . import layers  # noqa: F401
from . import optimizer  # noqa: F401
from . import backward  # noqa: F401
from .backward import append_backward, calc_gradient, gradients  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from . import amp  # noqa: F401
from .clip import set_gradient_clip  # noqa: F401
from . import io  # noqa: F401
from . import metrics  # noqa: F401
from . import inference  # noqa: F401
from . import bridge  # noqa: F401
from . import serving  # noqa: F401
from . import models  # noqa: F401


def memory_optimize(input_program=None, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """Rematerialization (``paddle_tpu/__init__.py:65``; ref
    ``memory_optimization_transpiler.py``): the program's backward
    recomputes the forward's activations instead of keeping them, segment
    by segment (the Executor's ``remat_segments``: without checkpoints,
    about the square root of the forward's op count in segments). Returns
    the program."""
    prog = input_program or framework.default_main_program()
    hit = False
    for op in prog.global_block().ops:
        if op.type == "autodiff":
            op.attrs["remat"] = True
            hit = True
    if hit:
        prog._version += 1
    elif print_log:
        print("memory_optimize: no backward in the program")
    return prog


def release_memory(input_program=None, skip_opt_set=None):
    """Ref ``release_memory`` (insert delete_var ops): a step's
    intermediates are dropped at its end, and a captured step's live in
    the graph's pool; returns the program unchanged, as
    ``paddle_tpu`` does."""
    return input_program or framework.default_main_program()
