"""Weight-decay regularizers (ref ``python/paddle/fluid/regularizer.py``;
the port's copy of ``paddle_tpu/regularizer.py``): append
grad-modification ops ``grad += coeff * penalty'(param)`` before the
optimizer update, honoring per-param ``ParamAttr.regularizer`` overrides.
A sparse (rows, values) grad decays row-wise on its touched rows only
(``sparse_decay``), as the reference's SelectedRows branch does."""

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


def _append_sparse_decay(param, grad, block, coeff, mode):
    """Row-wise decay on the touched rows of a sparse (rows, values) grad
    (ref regularizer.py SelectedRows branch: merge, then decay the rows).
    The decay of a row must apply exactly once, so the autodiff op is
    asked for merged rows (duplicate slots zeroed on the sentinel)."""
    from .backward import require_merged_sparse

    require_merged_sparse(block.program)
    block.append_op(
        "sparse_decay",
        {"Grad": grad, "Rows": grad.sparse_rows_var, "Param": param},
        {"Out": grad}, {"coeff": coeff, "mode": mode})
    return grad


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        if getattr(grad, "sparse_rows_var", None) is not None:
            return _append_sparse_decay(param, grad, block, self._coeff,
                                        "l2")
        decay = block.create_var(shape=param.shape, dtype=str(param.dtype))
        block.append_op("scale", {"X": param}, {"Out": decay},
                        {"scale": self._coeff})
        block.append_op("elementwise_add", {"X": grad, "Y": decay},
                        {"Out": grad}, {})
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        if getattr(grad, "sparse_rows_var", None) is not None:
            return _append_sparse_decay(param, grad, block, self._coeff,
                                        "l1")
        sign = block.create_var(shape=param.shape, dtype=str(param.dtype))
        block.append_op("sign", {"X": param}, {"Out": sign}, {})
        decay = block.create_var(shape=param.shape, dtype=str(param.dtype))
        block.append_op("scale", {"X": sign}, {"Out": decay},
                        {"scale": self._coeff})
        block.append_op("elementwise_add", {"X": grad, "Y": decay},
                        {"Out": grad}, {})
        return grad


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is not None and g is not None:
            block = p.block.program.global_block()
            g = reg(p, g, block)
        out.append((p, g))
    return out
