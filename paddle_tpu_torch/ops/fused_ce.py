"""Fused vocabulary projection + label-smoothed softmax cross-entropy: the
hand-written CUDA forward kernel (``csrc/fused_ce_fwd.cu``), its chunked
backward and its plain PyTorch version.

Replaces the Pallas TPU forward ``_fwd_kernel`` of
``paddle_tpu/ops/fused_ce.py`` (:57, via ``_fwd_impl`` :106): the [T, V]
logits never reach device memory. The backward is the chunked recompute of
``_bwd_impl`` (:180-217), which ``paddle_tpu`` computes outside Pallas, so
its products are ``torch.matmul``: per chunk of rows,
``dz = g * (softmax(z) - (1 - eps) * onehot(y) - eps / V)``, then
``dx = dz W^T``, ``dW += x^T dz`` and ``db += sum(dz)``. A chunk's
``[chunk, V]`` f32 tile stays under about 0.5 GB.

``linear_smooth_ce`` takes the kernel for every CUDA tensor (the TPU
package's size gate ``_FUSED_MIN_LOGITS`` and its ``PADDLE_TPU_*`` switches
were TPU measurements; its bf16 path waits for AMP) and the plain version,
differentiated by autograd, for a CPU tensor. Neither falls back to the
other.
"""

import ctypes

import torch

from . import _build

__all__ = ["linear_smooth_ce", "fused_ce_fwd", "linear_smooth_ce_bwd",
           "linear_smooth_ce_plain"]

_CHUNK_BYTES = 512 * 1024 * 1024  # one [chunk, V] f32 tile at most
_BT = 64  # rows per block of the kernel


def linear_smooth_ce_plain(x, w, b, y, eps):
    """x [T, D], w [D, V], b [V] or None, y [T] int -> (loss [T] f32,
    lse [T] f32): the projection, then the closed-form smoothed CE of
    ``paddle_tpu``'s reference path (``fused_ce.py:331-341``)."""
    logits = torch.matmul(x.float(), w.float())
    if b is not None:
        logits = logits + b.float()
    lse = torch.logsumexp(logits, dim=-1)
    logit_y = torch.gather(logits, 1, y.long()[:, None])[:, 0]
    loss = lse - (1.0 - eps) * logit_y
    if eps:
        loss = loss - eps * logits.mean(dim=-1)
    return loss, lse


def _chunk_rows(t, v):
    rows = max(1, _CHUNK_BYTES // (4 * v))
    return min(t, 1 << (rows.bit_length() - 1))  # a power of two


def linear_smooth_ce_bwd(x, w, b, y, lse, g, eps):
    """The chunked recompute backward (``paddle_tpu``'s ``_bwd_impl``) on
    any device: returns (dx, dw, db or None) for the loss cotangent g [T]."""
    t, _ = x.shape
    v = w.shape[1]
    ct = _chunk_rows(t, v)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w, dtype=torch.float32)
    db = torch.zeros(v, device=x.device, dtype=torch.float32) \
        if b is not None else None
    bf = b.float() if b is not None else None
    for r0 in range(0, t, ct):
        xc = x[r0:r0 + ct]
        gc = g[r0:r0 + ct].float()[:, None]
        z = torch.matmul(xc, w)
        if bf is not None:
            z = z + bf
        dz = torch.exp(z - lse[r0:r0 + ct, None])
        if eps:
            dz = dz - eps / v
        dz = dz * gc
        dz.scatter_add_(1, y[r0:r0 + ct].long()[:, None], -(1.0 - eps) * gc)
        dx[r0:r0 + ct] = torch.matmul(dz, w.t())
        dw.addmm_(xc.t(), dz)
        if db is not None:
            db += dz.sum(dim=0)
    return dx, dw.to(w.dtype), db.to(b.dtype) if b is not None else None


def _c_fn():
    fn = _build.load("fused_ce_fwd").fused_ce_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_ce_fwd(x, w, b, y, eps):
    """Launch the CUDA kernel. x: CUDA f32 [T, D]; w: f32 [D, V]; b: f32
    [V] or None; y: int [T]. Returns (loss [T], lse [T]) in f32."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("fused_ce_fwd wants x [T, D] and w [D, V], got %s "
                         "and %s" % (tuple(x.shape), tuple(w.shape)))
    for a in (x, w) + ((b,) if b is not None else ()):
        if a.dtype != torch.float32:
            raise TypeError("fused_ce_fwd takes f32 x/w/b (bf16 comes with "
                            "AMP), got %s" % a.dtype)
        if a.device != x.device:
            raise ValueError("fused_ce_fwd: tensors on %s and %s"
                             % (x.device, a.device))
    t, d = x.shape
    v = w.shape[1]
    if b is not None and b.shape != (v,):
        raise ValueError("fused_ce_fwd: bias of shape %s, want [%d]"
                         % (tuple(b.shape), v))
    if y.shape != (t,):
        raise ValueError("fused_ce_fwd: labels of shape %s, want [%d]"
                         % (tuple(y.shape), t))
    x, w = x.contiguous(), w.contiguous()
    b = b.contiguous() if b is not None else None
    y = y.to(device=x.device, dtype=torch.int32).contiguous()
    loss = torch.empty(t, device=x.device, dtype=torch.float32)
    lse = torch.empty(t, device=x.device, dtype=torch.float32)
    if t == 0:
        return loss, lse
    # split the vocabulary when the row tiles alone leave SMs idle
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    row_tiles = -(-t // _BT)
    nsplit = max(1, min(-(-4 * sms // row_tiles), -(-v // 128)))
    partial = torch.empty(nsplit, t, 4, device=x.device,
                          dtype=torch.float32)
    _build.launch(_c_fn(), "fused_ce_fwd", x.device, x.data_ptr(),
                  w.data_ptr(), b.data_ptr() if b is not None else None,
                  y.data_ptr(), loss.data_ptr(), lse.data_ptr(),
                  partial.data_ptr(), t, d, v, nsplit, float(eps))
    fused_ce_fwd.launches += 1
    return loss, lse


fused_ce_fwd.launches = 0


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, y, eps):
        loss, lse = fused_ce_fwd(x, w, b, y, eps)
        ctx.save_for_backward(x, w, b, y, lse)
        ctx.eps = eps
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, b, y, lse = ctx.saved_tensors
        dx, dw, db = linear_smooth_ce_bwd(x, w, b, y, lse, g, ctx.eps)
        return dx, dw, db, None, None


def linear_smooth_ce(x, w, b, y, eps):
    """x: [..., D] activations; w: [D, V]; b: [V] or None; y: [...] int
    labels. Returns the per-position f32 loss of shape ``x.shape[:-1]``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y2 = y.reshape(-1)
    if x.device.type == "cpu":
        loss, _ = linear_smooth_ce_plain(x2, w, b, y2, float(eps))
    else:
        loss = _FusedCE.apply(x2, w, b, y2, float(eps))
    return loss.reshape(lead)
