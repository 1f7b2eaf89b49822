"""contrib: quantization + slim (``paddle_tpu/contrib``; ref
``python/paddle/fluid/contrib/``)."""

from . import quantize  # noqa: F401
from . import slim  # noqa: F401
