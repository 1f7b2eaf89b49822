"""Model builders (the subset of ``paddle_tpu.models`` the port carries)."""

from . import bert  # noqa: F401
from . import common  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
