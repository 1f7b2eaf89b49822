"""User-facing layers namespace (``paddle_tpu.layers`` but ``moe_ffn``,
which comes with the multi-device slice; ref
``python/paddle/fluid/layers/``)."""

from . import control_flow
from . import debug_ops
from . import detection
from . import extras
from . import io
from . import learning_rate_scheduler
from . import math_op_patch  # noqa: F401
from . import metric_op
from . import nn
from . import ops
from . import sequence_lod
from . import tensor

from .control_flow import *  # noqa: F401,F403
from .debug_ops import Print, py_func  # noqa: F401
from .detection import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
