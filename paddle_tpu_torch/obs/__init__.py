"""``paddle_tpu_torch.obs``: the port's copy of the stdlib-only span API of
``paddle_tpu/obs/trace.py`` (importing that package pulls in jax). The
chrome-trace export, the flight recorder and the metrics registry are not
ported yet."""

from . import trace  # noqa: F401

__all__ = ["trace"]
