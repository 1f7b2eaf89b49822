"""Sequence layers over padded batches with explicit lengths (the subset of
``paddle_tpu/layers/sequence_lod.py`` this slice carries)."""

from ..core.layer_helper import LayerHelper

__all__ = ["sequence_mask"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    n = x.shape[0] if x.shape else -1
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(n, maxlen if maxlen else -1))
    helper.append_op("sequence_mask", {"X": x}, {"Y": out},
                     {"maxlen": maxlen or -1, "out_dtype": dtype})
    return out
