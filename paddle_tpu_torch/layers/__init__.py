"""User-facing layers namespace (the subset of ``paddle_tpu.layers`` this
slice of the port carries; ref ``python/paddle/fluid/layers/``)."""

from . import io
from . import metric_op
from . import nn
from . import ops
from . import sequence_lod
from . import tensor

from .io import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
