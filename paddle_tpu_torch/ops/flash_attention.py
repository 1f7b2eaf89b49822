"""Flash attention: the hand-written CUDA forward kernel
(``csrc/flash_attention_fwd.cu``) and its plain PyTorch version.

One kernel replaces the three Pallas TPU forwards of
``paddle_tpu/ops/flash_attention.py``: ``_fwd_kernel`` (:127, head-split
streaming), ``_packed_fwd_kernel`` (:567, packed streaming) and
``_dense_fwd_kernel`` (:1001, whole sequence resident). It reads the
packed ``[B, T, H*D]`` layout by strides, so the TPU package's three-way
layout choice (``kernel_plan``) has no counterpart here. It is bound by
operations and bytes together; see the source's header.

The public entry :func:`flash_attention` keeps ``paddle_tpu``'s signature
and semantics (``mha_reference``: end-anchored causal mask, masked logits at
``finfo(f32).min``, dropout on the attention weights). For a CUDA tensor it
launches the kernel, or raises for what the kernel does not take yet
(dropout, a bias other than the per-key padding mask); for a CPU tensor it
takes the plain version. Neither falls back to the other.
"""

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "mha_plain",
           "attention_plain", "key_bias"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def key_bias(bias, b, t_k):
    """The per-key ``[B, Tk]`` form of an additive padding-mask bias
    (``[B|1, 1, 1, Tk]`` or ``[B|1, Tk]``, as ``plan_for`` classifies it
    in ``paddle_tpu``), or None for any richer bias."""
    if bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1 \
            and bias.shape[0] in (1, b) and bias.shape[3] == t_k:
        return bias.reshape(bias.shape[0], t_k)
    if bias.dim() == 2 and bias.shape[0] in (1, b) and bias.shape[1] == t_k:
        return bias
    return None


def mha_plain(q, k, v, bias=None, causal=False, scale=None,
              dropout_rate=0.0, generator=None):
    """q,k,v: [B, H, T, D]; bias broadcastable to [B, H, Tq, Tk]. The
    arithmetic of ``paddle_tpu``'s ``mha_reference``; returns (out, lse)
    with lse = logsumexp of the masked logits in f32, [B, H, Tq]."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        t_q, t_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=q.device).tril(t_k - t_q)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    probs = torch.softmax(lf, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < (1.0 - dropout_rate)
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.matmul(probs, v), lse


def _split(x, num_heads):
    b, t, hd = x.shape
    return x.reshape(b, t, num_heads, hd // num_heads).transpose(1, 2)


def attention_plain(q, k, v, num_heads, bias=None, causal=False,
                    dropout_rate=0.0, generator=None):
    """The plain version on the packed layout: q,k,v [B, T, H*D] ->
    (out [B, T, H*D], lse [B, H, Tq])."""
    b, t, hd = q.shape
    if bias is not None and bias.dim() == 2:
        bias = bias[:, None, None, :]  # lift [B, Tk] onto [B, H, Tq, Tk]
    out, lse = mha_plain(_split(q, num_heads), _split(k, num_heads),
                         _split(v, num_heads), bias, causal,
                         dropout_rate=dropout_rate, generator=generator)
    return out.transpose(1, 2).reshape(b, t, hd), lse


def _c_fn():
    fn = _build.load("flash_attention_fwd").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, num_heads, bias=None, causal=False):
    """Launch the CUDA kernel. q: [B, Tq, H*D], k/v: [B, Tk, H*D] on one
    CUDA device, f32 or bf16, feature dim contiguous (any batch/row
    strides); bias: None or the per-key ``[B|1, Tk]`` form. Returns
    (out [B, Tq, H*D] in q.dtype, lse [B, H, Tq] f32)."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_attention_fwd takes f32 or bf16 q/k/v of "
                        "one dtype, got %s/%s/%s" % (q.dtype, k.dtype,
                                                     v.dtype))
    b, t_q, hd = q.shape
    t_k = k.shape[1]
    if k.shape != (b, t_k, hd) or v.shape != (b, t_k, hd):
        raise ValueError("flash_attention_fwd: q %s, k %s, v %s disagree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if hd % num_heads:
        raise ValueError("H*D=%d is not divisible by %d heads"
                         % (hd, num_heads))
    d = hd // num_heads
    if d not in _HEAD_DIMS:
        raise NotImplementedError(
            "flash_attention_fwd: head dim %d (kernel built for %s)"
            % (d, _HEAD_DIMS))
    if t_q == 0 or t_k == 0:
        raise ValueError("flash_attention_fwd: empty sequence")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    bias_sb = 0
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        if bias.shape[-1] != t_k or bias.dim() != 2:
            raise ValueError("flash_attention_fwd wants a [B|1, Tk] bias")
        bias_sb = t_k if bias.shape[0] == b else 0
    for x in (k, v) + ((bias,) if bias is not None else ()):
        if x.device != q.device:
            raise ValueError("flash_attention_fwd: tensors on %s and %s"
                             % (q.device, x.device))
    out = torch.empty(b, t_q, hd, device=q.device, dtype=q.dtype)
    lse = torch.empty(b, num_heads, t_q, device=q.device,
                      dtype=torch.float32)
    fn = _c_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), lse.data_ptr(), _DTYPE_CODES[q.dtype],
                 b, num_heads, t_q, t_k, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 bias_sb, 1.0 / math.sqrt(d), int(bool(causal)), stream)
    _build.check(_build.load("flash_attention_fwd"), err,
                 "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, num_heads, bias=None, causal=False,
                    dropout_rate=0.0, generator=None):
    """q,k,v: [B, T, H*D] (packed heads). ``bias``: None, the additive
    ``[B, 1, 1, Tk]`` / ``[B, Tk]`` key mask, or (CPU only) any bias
    broadcastable to ``[B, H, Tq, Tk]``. ``generator`` draws the dropout
    mask on the weights when ``dropout_rate > 0``. Returns [B, T, H*D]."""
    b, _, _ = q.shape
    t_k = k.shape[1]
    kb = key_bias(bias, b, t_k) if bias is not None else None
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, bias, causal,
                               dropout_rate, generator)[0]
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention on CUDA: attention dropout (Philox in the "
            "kernel) comes with the training slice; serve with "
            "dropout_rate=0")
    if bias is not None and kb is None:
        raise NotImplementedError(
            "flash_attention on CUDA: bias of shape %s; the kernel takes "
            "only the per-key [B|1,1,1,Tk] / [B|1,Tk] padding mask"
            % (tuple(bias.shape),))
    return flash_attention_fwd(q, k, v, num_heads, kb, causal)[0]
