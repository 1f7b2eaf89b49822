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
layout choice has no counterpart here. See the sources' headers for what
bounds them and what their designs do about it.

The kernels take every head dim up to :data:`MAX_HEAD_DIM` (512) and any
bias broadcastable to ``[B, H, Tq, Tk]``. A head dim that is a multiple of
8 is rounded up to the next instantiated width of ``_WIDTHS``, the extra
columns zero-filled in shared memory; any other is padded with zero
columns to the next multiple of 8 by the wrappers (zero columns change no
score, and the padded output columns are cut off). A padding mask (one row
of keys per batch and head) rides the kernels' K/V ring; any other bias is
read by each logit through its strides, and its gradient is the kernel's
dS, summed over what the bias broadcasts over. :func:`kernel_choice` is
``paddle_tpu``'s gate (``kernel_plan``) reduced to this card, decided by
shape before any launch: CPU tensors take the plain version, a head dim
above 512 raises, and everything else runs the kernels (where the
reference sends a rich bias or an unaligned head dim to
``mha_reference``, these kernels take both). The op records the decision
in ``op.attrs["_kernel_choice"]``.

The public entry :func:`flash_attention` keeps ``paddle_tpu``'s signature
and semantics (``mha_reference``: end-anchored causal mask, masked logits at
``finfo(f32).min``, dropout on the attention weights). For a CUDA tensor,
while autograd may record, it is a ``torch.autograd.Function`` whose
forward and backward are the kernels (saving ``out`` and the row ``lse``);
with grad disabled (serving, under ``inference_mode``) it launches the
forward kernel alone, since the Function's own host cost is tens of
microseconds a call and a served dispatch makes one call per layer
(``PERF.md``). For a CPU tensor the same Function runs the plain
versions of both (:func:`attention_plain`, :func:`attention_bwd_plain`),
which round where the kernels round. A CUDA tensor always launches the
kernels; a failed build or launch raises.

bf16 (AMP): both kernels take bf16 q/k/v. The forward rounds the
normalised weights (after dropout) to bf16 for P.V and stores out in bf16,
as ``paddle_tpu``'s whole-sequence kernel does (:1043-1053). It has two
forms, chosen by shape (:func:`fwd_form`, recorded by :func:`kernel_choice`
and counted by ``flash_attention_fwd.wgmma_launches``): up to
:data:`WGMMA_MAX_KEYS` keys, a padded head dim that is a multiple of 16 up
to :data:`WGMMA_MAX_HEAD_DIM` and no bias or a per-key one, a single pass
on warpgroup products (``flash_fwd_wgmma_kernel``: every score of a 64-row
tile in registers); otherwise the ``mma.sync`` form, which walks the
keys twice (the rows' max and sum first). Both are checked kernels: a
route by shape, not a fallback. The backward
rounds P (after dropout) and dS to bf16 for its products, sums dq in f32
and rounds it once, and stores dk and dv in bf16, as ``paddle_tpu``'s
``_packed_bwd_kernel`` (:724-736, :898-899). lse, delta and the bias and
its gradient stay f32. It has two forms too (:func:`bwd_form`, recorded by
:func:`kernel_choice` as ``bwd_form`` and counted by
``flash_attention_bwd.wgmma_launches``): a padded head dim that is a
multiple of 16 up to :data:`WGMMA_MAX_HEAD_DIM` and no bias or a per-key
one, at any Tq and Tk, runs on warpgroup products
(``flash_bwd_wgmma_kernel``: 64 keys a block, Q and dO through a TMA
ring, delta and the zeroed dq from a prep kernel); every other bf16 call
runs the ``mma.sync`` form.

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
           "mha_plain", "mha_bwd_plain", "attention_plain",
           "attention_bwd_plain", "dropout_keep",
           "draw_seed", "kernel_choice", "fwd_form", "bwd_form",
           "MAX_HEAD_DIM",
           "WGMMA_MAX_KEYS", "WGMMA_MAX_HEAD_DIM"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' instantiated head-dim widths (the sources' dispatch_width)
_WIDTHS = (16, 32, 64, 128, 256, 512)
MAX_HEAD_DIM = _WIDTHS[-1]
# the bf16 single-pass form (csrc/flash_attention_fwd.cu
# flash_fwd_wgmma_kernel): the key slots a block holds and its widest head
WGMMA_MAX_KEYS = 256
WGMMA_MAX_HEAD_DIM = 128
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


def mha_plain(q, k, v, bias=None, causal=False, scale=None,
              dropout_rate=0.0, seed=None):
    """q,k,v: [B, H, T, D]; bias broadcastable to [B, H, Tq, Tk]. The
    arithmetic of ``paddle_tpu``'s ``mha_reference``; returns (out, lse)
    with lse = logsumexp of the masked logits in f32, [B, H, Tq]. With
    ``dropout_rate > 0`` and a ``seed`` tensor, the weights are dropped by
    :func:`dropout_keep`, the kernels' mask.

    bf16 rounds where the CUDA forward and ``paddle_tpu``'s
    whole-sequence kernel (``_dense_fwd_kernel``, :1034-1053) do: the
    logits are f32 from the bf16 operands, the softmax is f32, the
    normalised weights (after dropout) are rounded to bf16 for P.V, which
    sums in f32 and rounds once."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    low = q.dtype in (torch.bfloat16, torch.float16)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale \
        if low else torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        logits = logits.masked_fill(~_causal_keep(logits),
                                    torch.finfo(logits.dtype).min)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    probs = torch.softmax(lf, dim=-1)
    if not low:
        probs = probs.to(q.dtype)
    if dropout_rate > 0.0 and seed is not None:
        probs = probs * _keep(seed, probs, dropout_rate) / (1.0 - dropout_rate)
    if low:
        out = torch.matmul(probs.to(q.dtype).float(), v.float())
        return out.to(q.dtype), lse
    return torch.matmul(probs, v), lse


def _causal_keep(logits):
    """The end-anchored causal mask of a [.., Tq, Tk] tensor, bool."""
    t_q, t_k = logits.shape[-2], logits.shape[-1]
    return torch.ones(t_q, t_k, dtype=torch.bool,
                      device=logits.device).tril(t_k - t_q)


def _keep(seed, probs, rate):
    b, h, t_q, t_k = probs.shape
    return dropout_keep(seed.to(probs.device), b, h, t_q, t_k, rate)


def mha_bwd_plain(q, k, v, out, lse, dout, bias=None, causal=False,
                  scale=None, dropout_rate=0.0, seed=None):
    """The kernels' backward on [B, H, T, D]: (dq, dk, dv in q's dtype,
    dS [B, H, Tq, Tk] f32 for the bias). From the forward's f32 lse and
    delta = rowsum(dO * O) in f32: P = exp(logit - lse) (1/Tk in a row
    with no allowed key), dP = dO . V^T, dS = P * (dP - delta), 0 at a
    masked logit; P after dropout and dS are rounded to q's dtype before
    the dV, dK and dQ products, which sum in f32 and round once (the
    rounding points of ``paddle_tpu``'s ``_packed_bwd_kernel``,
    :724-736)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lo = q.dtype
    acc = torch.float64 if lo == torch.float64 else torch.float32
    qf, kf, vf, dof = (x.to(acc) for x in (q, k, v, dout))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(acc)
    keep = None
    if causal:
        keep = _causal_keep(logits)
        logits = logits.masked_fill(~keep, torch.finfo(acc).min)
    p = torch.exp(logits - lse[..., None])
    if keep is not None:  # a row with no allowed key averaged V uniformly
        p = torch.where(keep.any(-1, keepdim=True), p, 1.0 / p.shape[-1])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    if dropout_rate > 0.0 and seed is not None:
        kd = _keep(seed, p, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(kd, p * inv, 0.0)
        dp = torch.where(kd, dp * inv, 0.0)
    else:
        pd = p
    delta = (dof * out.to(acc)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    dsl = ds.to(lo).to(acc)
    dv = torch.matmul(pd.to(lo).to(acc).transpose(-1, -2), dof)
    dk = torch.matmul(dsl.transpose(-1, -2), qf) * scale
    dq = torch.matmul(dsl, kf) * scale
    return dq.to(lo), dk.to(k.dtype), dv.to(v.dtype), ds


def _split(x, num_heads):
    b, t, hd = x.shape
    return x.reshape(b, t, num_heads, hd // num_heads).transpose(1, 2)


def attention_plain(q, k, v, num_heads, bias=None, causal=False,
                    dropout_rate=0.0, seed=None):
    """The plain version on the packed layout: q,k,v [B, T, H*D] ->
    (out [B, T, H*D], lse [B, H, Tq])."""
    b, t, hd = q.shape
    out, lse = mha_plain(_split(q, num_heads), _split(k, num_heads),
                         _split(v, num_heads), _plain_bias(bias), causal,
                         dropout_rate=dropout_rate, seed=seed)
    return out.transpose(1, 2).reshape(b, t, hd), lse


def _plain_bias(bias):
    if bias is not None and bias.dim() == 2:
        return bias[:, None, None, :]  # lift [B, Tk] onto [B, H, Tq, Tk]
    return bias


def attention_bwd_plain(q, k, v, out, lse, dout, num_heads, bias=None,
                        causal=False, dropout_rate=0.0, seed=None,
                        want_dbias=False):
    """The plain version of :func:`flash_attention_bwd` on the packed
    layout (:func:`mha_bwd_plain`): (dq, dk, dv, dbias or None)."""
    b, t_q, hd = q.shape
    t_k = k.shape[1]
    dq, dk, dv, ds = mha_bwd_plain(
        *(_split(x, num_heads) for x in (q, k, v, out)), lse,
        _split(dout, num_heads), _plain_bias(bias), causal,
        dropout_rate=dropout_rate, seed=seed)
    dbias = _sum_to_bias(ds, bias) if want_dbias and bias is not None \
        else None
    return (dq.transpose(1, 2).reshape(b, t_q, hd),
            dk.transpose(1, 2).reshape(b, t_k, hd),
            dv.transpose(1, 2).reshape(b, t_k, hd), dbias)


def _c_fn(name, entry=None):
    fn = getattr(_build.load(name), entry or name)
    if fn.argtypes is None:
        if entry == "flash_attention_bwd_wgmma":
            fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 12
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                              ctypes.c_float, ctypes.c_void_p])
        elif entry == "flash_attention_fwd_wgmma":
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 10
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
        elif name == "flash_attention_fwd":
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 11
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 11
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                              ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(q, k, v, num_heads, what, dtypes):
    """Validate the packed layout; returns (b, t_q, t_k, hd, d) for head dims
    up to :data:`MAX_HEAD_DIM`."""
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
    if d > MAX_HEAD_DIM:
        raise NotImplementedError("%s: head dim %d; the kernels take up to %d"
                                  % (what, d, MAX_HEAD_DIM))
    if t_q == 0 or t_k == 0 or d == 0:
        raise ValueError("%s: empty sequence or head" % what)
    return b, t_q, t_k, hd, d


def kernel_choice(q, num_heads, k=None, bias=None):
    """The gate: ``{"kernel": "cuda_flash" | "plain", "reasons": [...]}``
    for q ``[B, T, H*D]``, decided by shape alone, before any launch
    (``paddle_tpu``'s ``kernel_plan``, ``ops/flash_attention.py:1359``,
    reduced to this card). CPU tensors take the plain version (reason
    ``device``); on a device every bias and head dim runs the CUDA kernels,
    and a head dim above :data:`MAX_HEAD_DIM` raises. Given the keys ``k``
    (and the bias), a device choice also names the forward's form
    (:func:`fwd_form`): ``"form": "wgmma" | "mma_sync"``, and for
    ``mma_sync`` in bf16 the check that kept it off the wgmma form
    (``"form_reason"``); and the backward's (:func:`bwd_form`) as
    ``"bwd_form"`` and ``"bwd_form_reason"``."""
    if q.device.type == "cpu":
        return {"kernel": "plain", "reasons": [{
            "check": "device",
            "detail": "CPU tensors take the plain version"}]}
    d = q.shape[-1] // num_heads
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(
            "flash_attention on %s: head dim %d is above the kernels' "
            "limit of %d" % (q.device, d, MAX_HEAD_DIM))
    choice = {"kernel": "cuda_flash", "reasons": []}
    if k is not None:
        for key, route in (("form", fwd_form), ("bwd_form", bwd_form)):
            form, why = route(q, k, num_heads, bias)
            choice[key] = form
            if why is not None:
                choice[key + "_reason"] = why
    return choice


def _per_key(bias):
    """Whether ``bias`` is absent or one row of keys per (b, h): what the
    wgmma form reads (a padding mask)."""
    return bias is None or _lift_bias(bias).shape[2] == 1


def fwd_form(q, k, num_heads, bias=None):
    """The forward's form for a device call, by shape: ``("wgmma", None)``
    for bf16 with at most :data:`WGMMA_MAX_KEYS` keys, a padded head dim
    (the next multiple of 8) that is a multiple of 16 up to
    :data:`WGMMA_MAX_HEAD_DIM`, and no bias or a per-key one; else
    ``("mma_sync", reason)``, reason None for f32 (its only form) or the
    check that failed."""
    if q.dtype != torch.bfloat16:
        return "mma_sync", None
    if k.shape[1] > WGMMA_MAX_KEYS:
        return "mma_sync", "keys %d > %d" % (k.shape[1], WGMMA_MAX_KEYS)
    return _wgmma_width_and_bias(q, num_heads, bias)


def bwd_form(q, k, num_heads, bias=None):
    """The backward's form for a device call, by shape: ``("wgmma",
    None)`` for bf16 with a padded head dim (the next multiple of 8) that
    is a multiple of 16 up to :data:`WGMMA_MAX_HEAD_DIM` and no bias or a
    per-key one, at any Tq and Tk (``flash_bwd_wgmma_kernel`` walks the
    query tiles of 64 keys a block); else ``("mma_sync", reason)``,
    reason None for f32 (its only form) or the check that failed."""
    if q.dtype != torch.bfloat16:
        return "mma_sync", None
    return _wgmma_width_and_bias(q, num_heads, bias)


def _wgmma_width_and_bias(q, num_heads, bias):
    """The checks both wgmma forms share: the padded head dim and the
    bias."""
    dp = -(-(q.shape[-1] // num_heads) // 8) * 8
    if dp % 16 or dp > WGMMA_MAX_HEAD_DIM:
        return "mma_sync", "head dim %d (padded) not a multiple of 16 up " \
            "to %d" % (dp, WGMMA_MAX_HEAD_DIM)
    if not _per_key(bias):
        return "mma_sync", "a bias per query"
    return "wgmma", None


def _rows16(x):
    """``x`` where the kernels can copy its rows in 16-byte pieces (a
    contiguous feature dim; data pointer and batch and row strides
    multiples of 16 bytes), else a contiguous copy, which is."""
    es = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and \
            (x.stride(0) * es) % 16 == 0 and (x.stride(1) * es) % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _lift_bias(bias):
    """A bias's 4-d form: ``[B|1, Tk]`` is the per-key padding mask (as
    :func:`attention_plain` reads it), any other broadcasts to
    ``[B, H, Tq, Tk]`` from the right."""
    if bias.dim() == 2:
        return bias[:, None, None, :]
    return bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))


def _bias_args(bias, b, h, t_q, t_k, what):
    """The f32 bias the kernels read as ``[B, H, Tq, Tk]`` and its element
    strides (batch, head, query; 0 broadcasts), the key dim contiguous; or
    (None, (0, 0, 0))."""
    if bias is None:
        return None, (0, 0, 0)
    lifted = _lift_bias(bias)
    if lifted.dim() != 4:
        raise ValueError("%s: bias of shape %s" % (what, tuple(bias.shape)))
    if any(n > 1 and st == 0 for n, st in zip(lifted.shape, lifted.stride())):
        lifted = lifted.contiguous()  # an expanded view: its grad has rows
    try:
        full = lifted.to(torch.float32).expand(b, h, t_q, t_k)
    except RuntimeError:
        raise ValueError("%s: bias of shape %s does not broadcast to %s"
                         % (what, tuple(bias.shape), (b, h, t_q, t_k)))
    if full.stride(-1) != 1:  # broadcast over the keys: made whole
        full = full.contiguous()
    return full, tuple(full.stride()[:3])


def _pad_heads(x, num_heads, d, dp):
    """``[B, T, H*d]`` -> ``[B, T, H*dp]``, each head's columns followed by
    ``dp - d`` zero columns."""
    b, t, _ = x.shape
    return torch.nn.functional.pad(x.reshape(b, t, num_heads, d),
                                   (0, dp - d)).reshape(b, t, num_heads * dp)


def _cut_heads(x, num_heads, d, dp):
    """The inverse of :func:`_pad_heads`."""
    b, t, _ = x.shape
    return x.reshape(b, t, num_heads, dp)[..., :d].reshape(
        b, t, num_heads * d)


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
    CUDA device, f32 or bf16, head dim D up to 512 (any batch/row strides
    whose rows can be copied in 16 bytes; others are copied contiguous
    first, and a D that is not a multiple of 8 is padded); bias: None, the
    per-key ``[B|1, Tk]`` form, or any bias broadcastable to
    ``[B, H, Tq, Tk]``; seed: one int64 on the device (dropout is on iff
    ``dropout_rate > 0`` and a seed is given). bf16 runs the form
    :func:`fwd_form` names (``wgmma_launches`` counts the single-pass one).
    Returns (out [B, Tq, H*D] in q.dtype, lse [B, H, Tq] f32)."""
    b, t_q, t_k, hd, d = _check_qkv(q, k, v, num_heads,
                                    "flash_attention_fwd", _DTYPE_CODES)
    dp = -(-d // 8) * 8
    if dp != d:
        q, k, v = (_pad_heads(x, num_heads, d, dp) for x in (q, k, v))
    q, k, v = (_rows16(x) for x in (q, k, v))
    form = fwd_form(q, k, num_heads, bias)[0]
    bias, (bias_sb, bias_sh, bias_st) = _bias_args(
        bias, b, num_heads, t_q, t_k, "flash_attention_fwd")
    seed, thresh, inv_keep = _dropout_args(dropout_rate, seed)
    _same_device(q, k, v, bias, seed)
    out = torch.empty(b, t_q, num_heads * dp, device=q.device, dtype=q.dtype)
    lse = torch.empty(b, num_heads, t_q, device=q.device,
                      dtype=torch.float32)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), lse.data_ptr())
    tail = (1.0 / math.sqrt(d), int(bool(causal)),
            seed.data_ptr() if seed is not None else None, thresh, inv_keep)
    if form == "wgmma":
        if min(x.stride(i) for x in (q, k, v) for i in (0, 1)) <= 0:
            # a broadcast batch or row: the tensor maps want real strides
            q, k, v = (x.contiguous() for x in (q, k, v))
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr()) + ptrs[3:]
        _build.launch(_c_fn("flash_attention_fwd",
                            "flash_attention_fwd_wgmma"),
                      "flash_attention_fwd", q.device, *ptrs,
                      b, num_heads, t_q, t_k, dp,
                      q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                      v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                      bias_sb, bias_sh, *tail)
        flash_attention_fwd.wgmma_launches += 1
    else:
        _build.launch(_c_fn("flash_attention_fwd"), "flash_attention_fwd",
                      q.device, *ptrs, _DTYPE_CODES[q.dtype],
                      b, num_heads, t_q, t_k, dp,
                      q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                      v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                      bias_sb, bias_sh, bias_st, *tail)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.bf16_launches += q.dtype == torch.bfloat16
    if dp != d:
        out = _cut_heads(out, num_heads, d, dp)
    return out, lse


flash_attention_fwd.launches = flash_attention_fwd.bf16_launches = 0
flash_attention_fwd.wgmma_launches = 0  # of them, the bf16 single pass


def flash_attention_bwd(q, k, v, out, lse, dout, num_heads, bias=None,
                        causal=False, dropout_rate=0.0, seed=None,
                        want_dbias=False):
    """Launch the CUDA backward. q/k/v and bias as for the forward (f32 or
    bf16); out and lse are the forward's; dout: [B, Tq, H*D] in q's dtype.
    bf16 runs the form :func:`bwd_form` names (``wgmma_launches`` counts
    the warpgroup-product one). Returns (dq, dk, dv, dbias) in the packed
    layout: dq summed in f32 and rounded to q's dtype, dk and dv in k's
    and v's, dbias f32 in the bias's shape or None."""
    b, t_q, t_k, hd, d = _check_qkv(q, k, v, num_heads,
                                    "flash_attention_bwd", _DTYPE_CODES)
    if dout.dtype != q.dtype or out.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: dout %s / out %s against q %s"
                        % (dout.dtype, out.dtype, q.dtype))
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError("flash_attention_bwd: dout %s / out %s against q %s"
                         % (tuple(dout.shape), tuple(out.shape),
                            tuple(q.shape)))
    bias_in = bias
    form = bwd_form(q, k, num_heads, bias)[0]
    bias, (bias_sb, bias_sh, bias_st) = _bias_args(
        bias, b, num_heads, t_q, t_k, "flash_attention_bwd")
    seed, thresh, inv_keep = _dropout_args(dropout_rate, seed)
    _same_device(q, k, v, dout, out, lse, bias, seed)
    dp = -(-d // 8) * 8
    hdp = num_heads * dp
    if form == "wgmma":
        # the C entry computes delta = rowsum(dO * O) (a kernel of its own,
        # into this scratch) and zeroes dq before the products
        delta = torch.empty(b, num_heads, t_q, device=q.device,
                            dtype=torch.float32)
        dq = torch.empty(b, t_q, hdp, device=q.device, dtype=torch.float32)
    else:
        # delta per (b, h, t), as paddle_tpu's _packed_stream_bwd_impl
        # computes it outside the kernel (:840-843)
        delta = (dout.float() * out.float()).reshape(
            b, t_q, num_heads, d).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(b, t_q, hdp, device=q.device, dtype=torch.float32)
    if dp != d:
        q, k, v, dout, out = (_pad_heads(x, num_heads, d, dp)
                              for x in (q, k, v, dout, out))
    q, k, v, dout, out = (_rows16(x) for x in (q, k, v, dout, out))
    lse = lse.contiguous()
    dk = torch.empty(b, t_k, hdp, device=q.device, dtype=q.dtype)
    dv = torch.empty(b, t_k, hdp, device=q.device, dtype=q.dtype)
    dbias = None
    if want_dbias and bias is not None:
        # a padding mask: per-head sums over the queries; else dS itself
        dbias = (torch.empty(b, num_heads, 1, t_k, device=q.device,
                             dtype=torch.float32) if bias_st == 0 else
                 torch.zeros(b, num_heads, t_q, t_k, device=q.device,
                             dtype=torch.float32))
    ptrs = (lse.data_ptr(), delta.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            seed.data_ptr() if seed is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr() if dbias is not None else None)
    tail = (1.0 / math.sqrt(d), int(bool(causal)), thresh, inv_keep)
    if form == "wgmma":
        if min(x.stride(i) for x in (q, k, v, out, dout)
               for i in (0, 1)) <= 0:
            # a broadcast batch or row: the tensor maps want real strides
            q, k, v, out, dout = (x.contiguous()
                                  for x in (q, k, v, out, dout))
        _build.launch(_c_fn("flash_attention_bwd",
                            "flash_attention_bwd_wgmma"),
                      "flash_attention_bwd", q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      dout.data_ptr(), *ptrs, b, num_heads, t_q, t_k, dp,
                      *(x.stride(i) for x in (q, k, v, out, dout)
                        for i in (0, 1)), bias_sb, bias_sh, *tail)
        flash_attention_bwd.wgmma_launches += 1
    else:
        _build.launch(_c_fn("flash_attention_bwd"), "flash_attention_bwd",
                      q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      dout.data_ptr(), *ptrs, _DTYPE_CODES[q.dtype], b,
                      num_heads, t_q, t_k, dp,
                      *(x.stride(i) for x in (q, k, v, dout) for i in (0, 1)),
                      bias_sb, bias_sh, bias_st, *tail)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.bf16_launches += q.dtype == torch.bfloat16
    dq = dq.to(q.dtype)
    if dp != d:
        dq, dk, dv = (_cut_heads(x, num_heads, d, dp) for x in (dq, dk, dv))
    if dbias is not None:
        dbias = _sum_to_bias(dbias, bias_in)
    return dq, dk, dv, dbias


flash_attention_bwd.launches = flash_attention_bwd.bf16_launches = 0
flash_attention_bwd.wgmma_launches = 0  # of them, on warpgroup products


def _sum_to_bias(g, bias):
    """The kernel's dbias (``[B, H, Tq|1, Tk]``) summed over what ``bias``
    broadcasts over, in ``bias``'s shape."""
    return g.sum_to_size(_lift_bias(bias).shape).reshape(bias.shape)


class _FlashAttention(torch.autograd.Function):
    """The kernels on a CUDA tensor, their plain versions on a CPU one;
    the gradients come back in the inputs' dtypes (the bias's f32)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, num_heads, causal, dropout_rate):
        fwd = attention_plain if q.device.type == "cpu" \
            else flash_attention_fwd
        out, lse = fwd(q, k, v, num_heads, bias, causal, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, seed, out, lse)
        ctx.cfg = (num_heads, causal, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, seed, out, lse = ctx.saved_tensors
        num_heads, causal, dropout_rate = ctx.cfg
        bwd = attention_bwd_plain if q.device.type == "cpu" \
            else flash_attention_bwd
        dq, dk, dv, dbias = bwd(
            q, k, v, out, lse, dout.to(q.dtype), num_heads, bias, causal,
            dropout_rate, seed, want_dbias=ctx.needs_input_grad[3])
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention(q, k, v, num_heads, bias=None, causal=False,
                    dropout_rate=0.0, op=None, seed=None):
    """q,k,v: [B, T, H*D] (packed heads). ``bias``: None, the additive
    ``[B, 1, 1, Tk]`` / ``[B, Tk]`` key mask, or any bias broadcastable to
    ``[B, H, Tq, Tk]``. When ``dropout_rate > 0`` and a ``seed`` (an int64
    [1] tensor, :func:`draw_seed`) is given, the attention weights are
    dropped with it.
    ``op``: the op to record :func:`kernel_choice`'s decision in
    (``_kernel_choice``). Returns [B, T, H*D]."""
    choice = kernel_choice(q, num_heads, k, bias)
    if op is not None:
        op.attrs["_kernel_choice"] = choice
    if not torch.is_grad_enabled():  # no tape: skip the Function's cost
        fwd = attention_plain if choice["kernel"] == "plain" \
            else flash_attention_fwd
        return fwd(q, k, v, num_heads, bias, causal, dropout_rate, seed)[0]
    return _FlashAttention.apply(q, k, v, bias, seed, num_heads, causal,
                                 float(dropout_rate))
