"""Program-IR analysis (the subset of ``paddle_tpu.analysis`` the port
needs): the def-use core that ``core/epilogue_fusion.py`` proves its
rewrites on."""

from .dataflow import OpNode, Region, build_region  # noqa: F401
