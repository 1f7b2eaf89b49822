"""LayerNorm over the last axis: the hand-written CUDA forward kernel
(``csrc/layer_norm_fwd.cu``) and its plain PyTorch version.

Replaces the Pallas TPU forward ``_fwd_kernel`` of
``paddle_tpu/ops/fused_layer_norm.py`` (:42, via ``_fwd_impl`` :95). The
kernel is bound by bytes (one read and one write per element); see the
source's header for what its design does about that. The backward comes
with the training slice.

``fused_layer_norm`` launches the kernel for a CUDA tensor and takes the
plain version only for a tensor on the CPU; there is no fallback from one
device to the other.
"""

import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_fwd", "layer_norm_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x, scale, bias, eps):
    """x: [..., D] -> (y [..., D] in x.dtype, mean [...] f32, var [...]
    f32): the same arithmetic as the kernel, in f32 (two-pass variance)."""
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
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer_norm_fwd(x, scale, bias, eps):
    """Launch the CUDA kernel. x: CUDA [rows, D] f32/bf16, contiguous;
    scale/bias: [D] or None. Returns (y, mean, var)."""
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
    fn = _c_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(),
                 params[0].data_ptr() if params[0] is not None else None,
                 params[1].data_ptr() if params[1] is not None else None,
                 y.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 _DTYPE_CODES[x.dtype], rows, d, float(eps), stream)
    _build.check(_build.load("layer_norm_fwd"), err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, var


layer_norm_fwd.launches = 0


def fused_layer_norm(x, scale, bias, eps):
    """x: [..., D]; normalize over the LAST axis. Returns (y [..., D] in
    x.dtype, mean [...], var [...]) with f32 statistics. CUDA tensors go
    through the kernel, CPU tensors through the plain version."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    y, mean, var = layer_norm_fwd(x.reshape(-1, d).contiguous(), scale,
                                  bias, eps)
    return y.reshape(*lead, d), mean.reshape(lead), var.reshape(lead)
