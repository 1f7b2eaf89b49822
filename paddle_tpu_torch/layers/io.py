"""Data-entry layers (ref ``python/paddle/fluid/layers/io.py``)."""

from ..core.layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    """Declare an input variable (ref ``layers/io.py:39``).
    ``append_batch_size=True`` prepends -1, matching the reference."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.main_program.global_block().create_var(
        name=name, shape=tuple(shape), dtype=dtype, lod_level=lod_level,
        is_data=True, stop_gradient=stop_gradient)
