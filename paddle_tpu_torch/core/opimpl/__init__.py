"""Op implementations: importing this package registers every op type the
port runs (``core/op_registry.py``)."""

from . import attention_ops  # noqa: F401
from . import control_ops  # noqa: F401
from . import decode_ops  # noqa: F401
from . import detection_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
