"""Flash attention: the hand-written CUDA forward and backward kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) and their
plain PyTorch version.

The forward kernel replaces the three Pallas TPU forwards of
``paddle_tpu/ops/flash_attention.py``: ``_fwd_kernel`` (:127, head-split
streaming), ``_packed_fwd_kernel`` (:567, packed streaming) and
``_dense_fwd_kernel`` (:1001, whole sequence resident); the backward kernel
replaces their three backwards (``_bwd_dkv_kernel`` :211,
``_packed_bwd_kernel`` :644, ``_dense_bwd_kernel`` :1058). Both read the
packed ``[B, T, H*D]`` layout by strides, so the TPU package's three-way
layout choice (``kernel_plan``) has no counterpart here. See the sources'
headers for what bounds them and what their designs do about it.

The public entry :func:`flash_attention` keeps ``paddle_tpu``'s signature
and semantics (``mha_reference``: end-anchored causal mask, masked logits at
``finfo(f32).min``, dropout on the attention weights). For a CUDA tensor,
while autograd may record, it is a ``torch.autograd.Function`` whose
forward and backward are the kernels (saving ``out`` and the row ``lse``);
with grad disabled (serving, under ``inference_mode``) it launches the
forward kernel alone, since the Function's own host cost is tens of
microseconds a call and a served dispatch makes one call per layer
(``PERF.md``). It raises for what the kernels do not take (a bias other
than the per-key padding mask). For a CPU tensor it takes the plain
version, differentiated by autograd. Neither falls back to the other.

Attention dropout (``paddle_tpu``'s ``_dropout_keep``, :80) is a
counter-based hash keyed by (seed, b, h, query, key), shared by both
kernels (``csrc/flash_dropout.cuh``) and computed bit for bit by
:func:`dropout_keep` in torch integer arithmetic, so the kernels and the
plain version draw the same mask from one seed. The seed is one int64
drawn on the device from the caller's ``torch.Generator`` (the
executor's), so drawing it never waits for the device.
"""

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "mha_plain", "attention_plain", "key_bias", "dropout_keep",
           "draw_seed"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 tensors x in [0, 2^32) and a 32-bit
    constant c, in 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The kernels' ``mix32`` (``csrc/flash_dropout.cuh``) on int64
    tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate):
    """Keep iff the hash's top 24 bits fall below this."""
    return int(round((1.0 - rate) * (1 << 24)))


def dropout_keep(seed, b, h, t_q, t_k, rate):
    """The kernels' keep mask, [B, H, Tq, Tk] bool, for an int64 ``seed``
    tensor of one element (its device is the mask's)."""
    dev = seed.device
    bh = torch.arange(b * h, dtype=torch.int64, device=dev).reshape(b, h, 1, 1)
    key = _mix32((seed.reshape(()) & _M32) ^ _mix32((bh + 0x9E3779B9) & _M32))
    ctr = (torch.arange(t_q, dtype=torch.int64, device=dev)[:, None] * t_k
           + torch.arange(t_k, dtype=torch.int64, device=dev)[None, :]) & _M32
    hsh = _mix32((_mix32(ctr ^ key) + key) & _M32)
    return (hsh >> 8) < keep_threshold(rate)


def draw_seed(generator, device=None):
    """One int64 dropout seed in [0, 2^31 - 1), drawn on the generator's
    device (no host round trip) and moved to ``device``."""
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)
    return seed if device is None else seed.to(device)


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
              dropout_rate=0.0, seed=None):
    """q,k,v: [B, H, T, D]; bias broadcastable to [B, H, Tq, Tk]. The
    arithmetic of ``paddle_tpu``'s ``mha_reference``; returns (out, lse)
    with lse = logsumexp of the masked logits in f32, [B, H, Tq]. With
    ``dropout_rate > 0`` and a ``seed`` tensor, the weights are dropped by
    :func:`dropout_keep`, the kernels' mask."""
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
    if dropout_rate > 0.0 and seed is not None:
        b, h, t_q, t_k = probs.shape
        keep = dropout_keep(seed.to(probs.device), b, h, t_q, t_k,
                            dropout_rate)
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.matmul(probs, v), lse


def _split(x, num_heads):
    b, t, hd = x.shape
    return x.reshape(b, t, num_heads, hd // num_heads).transpose(1, 2)


def attention_plain(q, k, v, num_heads, bias=None, causal=False,
                    dropout_rate=0.0, seed=None):
    """The plain version on the packed layout: q,k,v [B, T, H*D] ->
    (out [B, T, H*D], lse [B, H, Tq])."""
    b, t, hd = q.shape
    if bias is not None and bias.dim() == 2:
        bias = bias[:, None, None, :]  # lift [B, Tk] onto [B, H, Tq, Tk]
    out, lse = mha_plain(_split(q, num_heads), _split(k, num_heads),
                         _split(v, num_heads), bias, causal,
                         dropout_rate=dropout_rate, seed=seed)
    return out.transpose(1, 2).reshape(b, t, hd), lse


def _c_fn(name):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        if name == "flash_attention_fwd":
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 9
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 9
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                              ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(q, k, v, num_heads, what, dtypes):
    """Validate the packed layout; returns (b, t_q, t_k, hd, d)."""
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("%s takes %s q/k/v of one dtype, got %s/%s/%s"
                        % (what, "/".join(str(t).split(".")[1]
                                          for t in dtypes),
                           q.dtype, k.dtype, v.dtype))
    b, t_q, hd = q.shape
    t_k = k.shape[1]
    if k.shape != (b, t_k, hd) or v.shape != (b, t_k, hd):
        raise ValueError("%s: q %s, k %s, v %s disagree"
                         % (what, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    if hd % num_heads:
        raise ValueError("H*D=%d is not divisible by %d heads"
                         % (hd, num_heads))
    d = hd // num_heads
    if d not in _HEAD_DIMS:
        raise NotImplementedError("%s: head dim %d (kernel built for %s)"
                                  % (what, d, _HEAD_DIMS))
    if t_q == 0 or t_k == 0:
        raise ValueError("%s: empty sequence" % what)
    return b, t_q, t_k, hd, d


def _check_bias(bias, b, t_k, what):
    """The f32 per-key bias and its batch stride (0 broadcasts)."""
    if bias is None:
        return None, 0
    bias = bias.to(torch.float32).contiguous()
    if bias.dim() != 2 or bias.shape[-1] != t_k:
        raise ValueError("%s wants a [B|1, Tk] bias" % what)
    return bias, (t_k if bias.shape[0] == b else 0)


def _dropout_args(dropout_rate, seed):
    """(seed tensor or None, keep threshold, 1 / keep probability)."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError("dropout_rate %r is outside [0, 1)" % dropout_rate)
    if dropout_rate == 0.0 or seed is None:
        return None, 0, 1.0
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise TypeError("the dropout seed is one int64 on the device")
    return seed.contiguous(), keep_threshold(dropout_rate), \
        1.0 / (1.0 - dropout_rate)


def _same_device(q, *others):
    for x in others:
        if x is not None and x.device != q.device:
            raise ValueError("flash attention: tensors on %s and %s"
                             % (q.device, x.device))


def flash_attention_fwd(q, k, v, num_heads, bias=None, causal=False,
                        dropout_rate=0.0, seed=None):
    """Launch the CUDA forward. q: [B, Tq, H*D], k/v: [B, Tk, H*D] on one
    CUDA device, f32 or bf16, feature dim contiguous (any batch/row
    strides); bias: None or the per-key ``[B|1, Tk]`` form; seed: one int64
    on the device (dropout is on iff ``dropout_rate > 0`` and a seed is
    given). Returns (out [B, Tq, H*D] in q.dtype, lse [B, H, Tq] f32)."""
    b, t_q, t_k, hd, d = _check_qkv(q, k, v, num_heads,
                                    "flash_attention_fwd", _DTYPE_CODES)
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    bias, bias_sb = _check_bias(bias, b, t_k, "flash_attention_fwd")
    seed, thresh, inv_keep = _dropout_args(dropout_rate, seed)
    _same_device(q, k, v, bias, seed)
    out = torch.empty(b, t_q, hd, device=q.device, dtype=q.dtype)
    lse = torch.empty(b, num_heads, t_q, device=q.device,
                      dtype=torch.float32)
    _build.launch(_c_fn("flash_attention_fwd"), "flash_attention_fwd",
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), lse.data_ptr(), _DTYPE_CODES[q.dtype],
                  b, num_heads, t_q, t_k, d,
                  q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                  v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                  bias_sb, 1.0 / math.sqrt(d), int(bool(causal)),
                  seed.data_ptr() if seed is not None else None, thresh,
                  inv_keep)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, num_heads, bias=None,
                        causal=False, dropout_rate=0.0, seed=None,
                        want_dbias=False):
    """Launch the CUDA backward (f32). q/k/v as for the forward; out and
    lse are the forward's; dout: [B, Tq, H*D]. Returns (dq, dk, dv, dbias)
    in the packed layout, dbias [B|1, Tk] (the bias's batch) or None."""
    b, t_q, t_k, hd, d = _check_qkv(q, k, v, num_heads,
                                    "flash_attention_bwd", (torch.float32,))
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError("flash_attention_bwd: dout %s / out %s against q %s"
                         % (tuple(dout.shape), tuple(out.shape),
                            tuple(q.shape)))
    q, k, v, dout = (x if x.stride(-1) == 1 else x.contiguous()
                     for x in (q, k, v, dout))
    bias, bias_sb = _check_bias(bias, b, t_k, "flash_attention_bwd")
    seed, thresh, inv_keep = _dropout_args(dropout_rate, seed)
    _same_device(q, k, v, dout, out, lse, bias, seed)
    # delta = rowsum(dO * O) per (b, h, t), as paddle_tpu's
    # _packed_stream_bwd_impl computes it outside the kernel (:840-843)
    delta = (dout.float() * out.float()).reshape(b, t_q, num_heads, d).sum(
        -1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    dq = torch.zeros(b, t_q, hd, device=q.device, dtype=torch.float32)
    dk = torch.empty(b, t_k, hd, device=q.device, dtype=torch.float32)
    dv = torch.empty(b, t_k, hd, device=q.device, dtype=torch.float32)
    dbias = None
    if want_dbias and bias is not None:
        dbias = torch.empty(b, num_heads, t_k, device=q.device,
                            dtype=torch.float32)
    _build.launch(_c_fn("flash_attention_bwd"), "flash_attention_bwd",
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  seed.data_ptr() if seed is not None else None,
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  dbias.data_ptr() if dbias is not None else None,
                  b, num_heads, t_q, t_k, d,
                  q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                  v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
                  bias_sb, 1.0 / math.sqrt(d), int(bool(causal)), thresh,
                  inv_keep)
    flash_attention_bwd.launches += 1
    if dbias is not None:
        dbias = dbias.sum(1)  # the per-head partials
        if bias_sb == 0:
            dbias = dbias.sum(0, keepdim=True)
    return dq, dk, dv, dbias


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kb, seed, num_heads, causal, dropout_rate):
        out, lse = flash_attention_fwd(q, k, v, num_heads, kb, causal,
                                       dropout_rate, seed)
        ctx.save_for_backward(q, k, v, kb, seed, out, lse)
        ctx.cfg = (num_heads, causal, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kb, seed, out, lse = ctx.saved_tensors
        num_heads, causal, dropout_rate = ctx.cfg
        dq, dk, dv, dkb = flash_attention_bwd(
            q, k, v, out, lse, dout, num_heads, kb, causal, dropout_rate,
            seed, want_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dkb, None, None, None, None


def flash_attention(q, k, v, num_heads, bias=None, causal=False,
                    dropout_rate=0.0, generator=None):
    """q,k,v: [B, T, H*D] (packed heads). ``bias``: None, the additive
    ``[B, 1, 1, Tk]`` / ``[B, Tk]`` key mask, or (CPU only) any bias
    broadcastable to ``[B, H, Tq, Tk]``. When ``dropout_rate > 0`` and a
    ``generator`` is given, the attention weights are dropped with a seed
    drawn from it. Returns [B, T, H*D]."""
    b, _, _ = q.shape
    t_k = k.shape[1]
    seed = None
    if dropout_rate > 0.0 and generator is not None:
        seed = draw_seed(generator, q.device)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, bias, causal,
                               dropout_rate, seed)[0]
    kb = key_bias(bias, b, t_k) if bias is not None else None
    if bias is not None and kb is None:
        raise NotImplementedError(
            "flash_attention on CUDA: bias of shape %s; the kernel takes "
            "only the per-key [B|1,1,1,Tk] / [B|1,Tk] padding mask"
            % (tuple(bias.shape),))
    if not torch.is_grad_enabled():  # no tape: skip the Function's cost
        return flash_attention_fwd(q, k, v, num_heads, kb, causal,
                                   dropout_rate, seed)[0]
    return _FlashAttention.apply(q, k, v, kb, seed, num_heads, causal,
                                 float(dropout_rate))
