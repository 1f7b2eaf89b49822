"""Gradient clipping (ref ``python/paddle/fluid/clip.py``; the port's copy
of ``paddle_tpu/clip.py``): GradientClipByValue/Norm/GlobalNorm,
set_gradient_clip, append_gradient_clip_ops, ErrorClipByValue. A sparse
(rows, values) grad goes through the same ops on its values, with its rows
merged."""

from .core.framework import Parameter

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "ErrorClipByValue"]


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class ErrorClipByValue:
    """Kept for API parity (ref clip.py ErrorClipByValue); forward-error
    clipping has no role when the backward is exact autograd."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            block = p.block.program.global_block()
            o = block.create_var(shape=g.shape, dtype=str(g.dtype))
            block.append_op("clip", {"X": g}, {"Out": o},
                            {"min": self.min, "max": self.max})
            out.append((p, o))
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            block = p.block.program.global_block()
            o = block.create_var(shape=g.shape, dtype=str(g.dtype))
            block.append_op("clip_by_norm", {"X": g}, {"Out": o},
                            {"max_norm": self.clip_norm})
            out.append((p, o))
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        if not params_grads:
            return params_grads
        block = params_grads[0][0].block.program.global_block()
        sq_norms = []
        for _, g in params_grads:
            sq = block.create_var(shape=(), dtype=str(g.dtype))
            block.append_op("squared_l2_norm", {"X": g}, {"Out": sq}, {})
            sq_norms.append(sq)
        total = block.create_var(shape=(), dtype="float32")
        block.append_op("sum", {"X": sq_norms}, {"Out": total}, {})
        gnorm = block.create_var(shape=(), dtype="float32")
        block.append_op("sqrt", {"X": total}, {"Out": gnorm}, {})
        # scale = clip / max(gnorm, clip)
        maxed = block.create_var(shape=(), dtype="float32")
        clip_c = block.create_var(shape=(), dtype="float32")
        block.append_op("fill_constant", outputs={"Out": clip_c},
                        attrs={"shape": (), "dtype": "float32",
                               "value": self.clip_norm})
        block.append_op("elementwise_max", {"X": gnorm, "Y": clip_c},
                        {"Out": maxed}, {})
        factor = block.create_var(shape=(), dtype="float32")
        block.append_op("elementwise_div", {"X": clip_c, "Y": maxed},
                        {"Out": factor}, {})
        out = []
        for p, g in params_grads:
            o = block.create_var(shape=g.shape, dtype=str(g.dtype))
            block.append_op("elementwise_mul", {"X": g, "Y": factor},
                            {"Out": o}, {"axis": -1})
            out.append((p, o))
        return out


_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """Set a program-wide clip strategy (ref ``clip.py`` set_gradient_clip);
    per-param ``ParamAttr.gradient_clip`` overrides it."""
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            if isinstance(p, Parameter):
                p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    if not params_grads:
        return params_grads
    out = []
    by_attr = {}  # global-norm clips compute one norm across their group
    for p, g in params_grads:
        attr = getattr(p, "gradient_clip_attr", None) or _global_clip
        if attr is None:
            out.append((p, g))
            continue
        by_attr.setdefault(id(attr), (attr, []))[1].append((p, g))
    # Sparse (rows, values) grads go through the same clip ops: the
    # autodiff op emits them row-merged with zeros in the duplicate slots
    # (asked for here), so a squared_l2_norm of the values equals the dense
    # grad's norm and scaling the values scales the dense grad (ref clip.py
    # merges SelectedRows before clipping for the same reason).
    sparse_rows = {p.name: g.sparse_rows_var
                   for _, group in by_attr.values() for p, g in group
                   if getattr(g, "sparse_rows_var", None) is not None}
    if sparse_rows:
        from .backward import require_merged_sparse

        require_merged_sparse(params_grads[0][0].block.program)
    for attr, group in by_attr.values():
        for p, g in attr._process(group):
            if p.name in sparse_rows:
                g.sparse_rows_var = sparse_rows[p.name]
            out.append((p, g))
    return out
