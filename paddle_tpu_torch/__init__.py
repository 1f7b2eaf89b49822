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
                             program_guard)
from .core.param_attr import ParamAttr  # noqa: F401
from . import layers  # noqa: F401
from . import io  # noqa: F401
from . import inference  # noqa: F401
from . import bridge  # noqa: F401
from . import serving  # noqa: F401
from . import models  # noqa: F401
