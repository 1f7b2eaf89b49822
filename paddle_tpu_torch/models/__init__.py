"""Model builders (the subset of ``paddle_tpu.models`` this slice carries)."""

from . import bert  # noqa: F401
