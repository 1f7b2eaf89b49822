"""LayerNorm over the last axis: the hand-written CUDA forward and backward
kernels (``csrc/layer_norm_fwd.cu``, ``csrc/layer_norm_bwd.cu``) and their
plain PyTorch version.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/fused_layer_norm.py``:
the forward ``_fwd_kernel`` (:42, via ``_fwd_impl`` :95) and the backward
``_bwd_kernel`` (:57, via ``_bwd_impl`` :142). Both kernels are bound by
bytes; see the sources' headers for what their designs do about that.

``fused_layer_norm`` is a ``torch.autograd.Function`` on CUDA tensors while
autograd may record: its forward is ``layer_norm_fwd``, its backward
``layer_norm_bwd``. With grad disabled (serving) it launches the forward
kernel alone: the Function's own host cost, tens of microseconds a call,
is a tenth of a served dispatch's host time (``PERF.md``). For a tensor on
the CPU it takes the plain version, differentiated by autograd.
There is no fallback from one device to the other. bf16 x (AMP): y and dx
are bf16, each computed in f32 and rounded once; the statistics, dscale
and dbias stay f32. As in ``paddle_tpu``
(``fused_layer_norm.py:213-219``), cotangents arriving through the Mean and
Variance outputs are ignored: those are saved statistics.

The forward kernel's launch is planned here (:func:`ln_fwd_plan`: 16-byte
or single-element vectors, how many a lane holds in registers, warps a
block), where the CPU tests reach it.
"""

import collections
import ctypes
import functools

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_plain", "ln_fwd_plan", "LnFwdPlan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the vectors a lane may hold in registers: the register-resident
# instantiations of csrc/layer_norm_fwd.cu (0 is its looped form)
LN_FWD_VPL = (1, 2, 3, 4, 6, 8)

LnFwdPlan = collections.namedtuple("LnFwdPlan", "vec vpl warps blocks")


@functools.lru_cache(maxsize=256)
def ln_fwd_plan(rows, d, dtype, sms, aligned=True):
    """The forward kernel's launch for ``rows`` rows of width ``d`` in
    ``dtype`` (f32 or bf16) on ``sms`` SMs: a :class:`LnFwdPlan` ``(vec,
    vpl, warps, blocks)``.

    ``vec``: elements of a vector, 16 bytes' worth (4 f32, 8 bf16) where
    ``d`` is a multiple and the pointers are 16-byte ``aligned``, else 1.
    ``vpl``: the fewest vectors of ``LN_FWD_VPL`` a lane holds so that a
    warp holds the row, or 0 (the looped form) where 8 do not. ``warps``
    a block, one row each: 4, or fewer where that leaves under two blocks
    an SM; ``blocks = ceil(rows / warps)``."""
    if rows <= 0 or d < 0 or sms <= 0 or dtype not in _DTYPE_CODES:
        raise ValueError("ln_fwd_plan: rows %d, D %d, SMs %d, dtype %s"
                         % (rows, d, sms, dtype))
    wide = 128 // torch.finfo(dtype).bits
    vec = wide if d % wide == 0 and aligned else 1
    need = -(-(d // vec) // 32)
    vpl = next((p for p in LN_FWD_VPL if p >= need), 0)
    warps = next(w for w in (4, 2, 1) if w == 1 or -(-rows // w) >= 2 * sms)
    return LnFwdPlan(vec, vpl, warps, -(-rows // warps))


def layer_norm_plain(x, scale, bias, eps):
    """x: [..., D] -> (y [..., D] in x.dtype, mean [...] f32, var [...]
    f32): the kernel's two passes in f32 (mean, then the mean of squared
    deviations), on the row itself where the kernel shifts it by its first
    element first."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), mean.squeeze(-1), var.squeeze(-1)


def _c_fn():
    fn = _build.load("layer_norm_fwd").layer_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer_norm_fwd(x, scale, bias, eps):
    """Launch the CUDA kernel under :func:`ln_fwd_plan`'s plan (the C entry
    refuses one that does not fit the call). x: CUDA [rows, D] f32/bf16,
    contiguous; scale/bias: [D] or None. Returns (y, mean, var)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("layer_norm_fwd wants a contiguous [rows, D] "
                         "tensor, got shape %s" % (tuple(x.shape),))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError("layer_norm_fwd: unsupported dtype %s" % x.dtype)
    rows, d = x.shape
    params = []
    for p in (scale, bias):
        if p is not None:
            if p.device != x.device or p.numel() != d:
                raise ValueError("layer_norm_fwd: scale/bias must be [%d] "
                                 "on %s" % (d, x.device))
            p = p.reshape(d).to(torch.float32).contiguous()
        params.append(p)
    y = torch.empty_like(x)
    mean = torch.empty(rows, device=x.device, dtype=torch.float32)
    var = torch.empty(rows, device=x.device, dtype=torch.float32)
    if rows == 0:
        return y, mean, var
    ptrs = [p.data_ptr() if p is not None else None for p in params]
    aligned = (x.data_ptr() | (ptrs[0] or 0) | (ptrs[1] or 0)) % 16 == 0
    plan = ln_fwd_plan(rows, d, x.dtype, _build.sm_count(x.device.index),
                       aligned)
    _build.launch(_c_fn(), "layer_norm_fwd", x.device, x.data_ptr(),
                  ptrs[0], ptrs[1], y.data_ptr(), mean.data_ptr(),
                  var.data_ptr(), _DTYPE_CODES[x.dtype], rows, d, float(eps),
                  *plan)
    layer_norm_fwd.launches += 1
    layer_norm_fwd.bf16_launches += x.dtype == torch.bfloat16
    return y, mean, var


layer_norm_fwd.launches = layer_norm_fwd.bf16_launches = 0


def _bwd_c_fn():
    fn = _build.load("layer_norm_bwd").layer_norm_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer_norm_bwd(x, scale, mean, var, dy, eps):
    """Launch the CUDA backward. x, dy: CUDA contiguous [rows, D], both f32
    or both bf16; scale: f32 [D] or None; mean/var: the forward's f32
    [rows]. Returns (dx in x's dtype, dscale or None when scale is None,
    dbias), the last two f32 (summed from f32 partials)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("layer_norm_bwd wants a contiguous [rows, D] x, "
                         "got shape %s" % (tuple(x.shape),))
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError("layer_norm_bwd takes f32 or bf16 x and dy of one "
                        "dtype, got %s and %s" % (x.dtype, dy.dtype))
    for t in (x, dy, mean, var) + ((scale,) if scale is not None else ()):
        if t is not x and t is not dy and t.dtype != torch.float32:
            raise TypeError("layer_norm_bwd takes f32 mean, var and scale, "
                            "got %s" % t.dtype)
        if t.device != x.device:
            raise ValueError("layer_norm_bwd: tensors on %s and %s"
                             % (x.device, t.device))
    rows, d = x.shape
    if dy.shape != x.shape or mean.numel() != rows or var.numel() != rows:
        raise ValueError("layer_norm_bwd: dy %s, mean %s, var %s against x %s"
                         % (tuple(dy.shape), tuple(mean.shape),
                            tuple(var.shape), tuple(x.shape)))
    dy = dy.contiguous()
    g = scale.reshape(d).contiguous() if scale is not None else None
    dx = torch.empty_like(x)
    dg = torch.zeros(d, device=x.device, dtype=torch.float32) \
        if g is not None else None
    db = torch.zeros(d, device=x.device, dtype=torch.float32)
    if rows == 0:
        return dx, dg, db
    # a few blocks per SM, each summing a contiguous range of rows into one
    # partial [2, D] row; a second launch sums the partials in order
    sms = _build.sm_count(x.device.index)
    nblocks = max(1, min(-(-rows // 8), 4 * sms))
    partial = torch.empty(nblocks, 2, d, device=x.device, dtype=torch.float32)
    mean, var = mean.contiguous(), var.contiguous()
    _build.launch(_bwd_c_fn(), "layer_norm_bwd", x.device, x.data_ptr(),
                  g.data_ptr() if g is not None else None, dy.data_ptr(),
                  mean.data_ptr(), var.data_ptr(), dx.data_ptr(),
                  dg.data_ptr() if dg is not None else None, db.data_ptr(),
                  partial.data_ptr(), _DTYPE_CODES[x.dtype], rows, d,
                  nblocks, float(eps))
    layer_norm_bwd.launches += 1
    layer_norm_bwd.bf16_launches += x.dtype == torch.bfloat16
    return dx, dg, db


layer_norm_bwd.launches = layer_norm_bwd.bf16_launches = 0


class _FusedLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        y, mean, var = layer_norm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, scale, mean, var)
        ctx.eps = eps
        ctx.has_bias = bias is not None
        ctx.bias_dtype = bias.dtype if bias is not None else None
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, scale, mean, var = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2, scale, mean, var, dy.to(x2.dtype),
                                    ctx.eps)
        if dg is not None:
            dg = dg.reshape(scale.shape).to(scale.dtype)
        return dx, dg, db.to(ctx.bias_dtype) if ctx.has_bias else None, None


def fused_layer_norm(x, scale, bias, eps):
    """x: [..., D]; normalize over the LAST axis. Returns (y [..., D] in
    x.dtype, mean [...], var [...]) with f32 statistics. CUDA tensors go
    through the kernels, CPU tensors through the plain version."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    if x.device.type == "cpu":
        y, mean, var = layer_norm_plain(x, scale, bias, eps)
        return y, mean.detach(), var.detach()
    # no tape (serving): skip the Function's host cost
    fwd = _FusedLN.apply if torch.is_grad_enabled() else layer_norm_fwd
    y, mean, var = fwd(x.reshape(-1, d).contiguous(), scale, bias, eps)
    return y.reshape(*lead, d), mean.reshape(lead), var.reshape(lead)
