"""Fused conv + batch_norm (+ residual add)(+ relu): the hand-written CUDA
kernels (``csrc/fused_conv.cu``), their plain PyTorch versions, and the
autograd wiring.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/fused_conv.py``:

* ``conv_moments`` — ``_conv_moments_kernel`` (:159, driver
  ``_conv_moments`` :231): the conv output ``co`` plus the per-channel
  sum and sum of squares of the stored ``co``, the BN statistics read
  pass folded into the conv's epilogue;
* ``bn_apply`` — ``_apply_kernel`` (:187, driver ``_apply`` :260):
  ``y = co * scale[o] + shift[o]`` (+ residual)(+ relu), one read of
  ``co`` and one write of ``y``;
* ``conv_apply`` — ``_conv_apply_kernel`` (:198, driver ``_conv_apply``
  :292): the inference form, the BN affine (+ residual)(+ relu) in the
  conv's epilogue, ``co`` never stored.

Arithmetic. The two conv kernels are one implicit GEMM on Hopper's tensor
cores. In f32 each operand splits into two TF32 parts, ``big`` and
``small``, and three TF32 products (``small*big + big*small + big*big``)
accumulate in f32 ("3xTF32"), which keeps the conv at f32-level accuracy
with TF32 off. :func:`conv_3xtf32_emulated` repeats that split on the CPU
for the tests; it is not on any path. In bf16 (ResNet-50 under
``fluid.amp``: the reference casts a fused site's x and w to bf16, its
``nn_ops.py:282``) one bf16 product per product accumulates in f32 (a
product of two bf16 values is exact in f32), and the kernels round where
the reference's do: ``co`` is stored in bf16 and the moments are taken from
the rounded ``co`` (:167-176); the apply rounds ``y`` to bf16 before the
residual add (:190-191); ``conv_apply`` rounds the conv through bf16 before
the affine (:205). ``scale`` and ``shift`` stay f32. The plain versions
round at the same points (:func:`conv_rounded`: the conv in f32, rounded
once), and apply the affine as a product then a sum, each rounded to f32,
as the bf16 kernels do.

The geometries are the reference's (``supported_geometry``): groups 1,
dilation 1, 1x1 stride 1 or 2 (the kernel reads ``x[n, c, 2i, 2j]`` by
strides, the same function as the reference's pre-slice at :491-493,
without the copy) and 3x3 pad 1 stride 1. ``scale``/``shift`` are [O]
vectors computed with torch ops from the moments, as the reference
computes them outside Pallas (:393-398, :442-444).

Gradients. The reference's backward is not a kernel: ``_fused_train_bwd``
(:409-430) is the vjp of the plain epilogue (statistics recomputed from
the saved ``co``, so the BN coupling terms are exact) composed with the
vjp of the plain conv. :class:`_FusedTrain` does the same: its forward is
``conv_moments`` + ``bn_apply``; its backward recomputes the epilogue
differentiably from ``co`` and takes the conv's input and weight
gradients through ``aten.convolution_backward`` (cuDNN on the card).
:class:`_FusedInfer` (``use_global_stats`` in training) has
``conv_apply`` as its forward and the plain composition as its backward
(:458-471). Without a tape (the eval pass under ``inference_mode``) the
kernels launch directly, without the Functions' host cost.

bf16 ``conv_apply`` and ``conv_moments`` have two forms each, chosen by
shape (:func:`apply_form`, :func:`moments_form`, one rule; counted by
``wgmma_launches`` on each wrapper): at the fused geometries with C and O
multiples of 64, Wo up to 256 and 16-byte aligned pointers (every site of
ResNet-50), an implicit GEMM on warpgroup products
(``csrc/fused_conv_wgmma.cu``, one mainloop with the affine or the
moments as its epilogue) that copies x channels last (for a 1x1 stride-2
conv only the pixels it reads) and reads the copy through TMA boxes,
under the tile plan :func:`wgmma_tile_plan`; every other bf16 call the
``mma.sync`` form of ``csrc/fused_conv.cu``. Both are checked kernels: a
route by shape, not a fallback.

Devices. A CUDA tensor launches the kernels or raises; a CPU tensor takes
the plain versions. Neither falls back to the other, and a kernel that
fails to build or launch never gives way to the unfused replay.

The gate keeps the reference's ``supported_geometry`` as its only refusal:
a declined geometry replays the original ops on either device. Its
``_VMEM_BUDGET``/``_fits_vmem`` check and the ``PADDLE_TPU_NO_FUSED_CONV``
switch were TPU measurements and do not carry over. An admitted site on a
tensor that the kernels cannot take (another device, a dtype other than
f32 or bf16) raises in the wrapper; f16 raises in the gate, as the
reference's AMP is bf16 only.
"""

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["supported_geometry", "gate", "fused_conv_bn_act",
           "conv_moments", "bn_apply", "conv_apply", "apply_form",
           "moments_form", "wgmma_tile_plan", "ConvTilePlan",
           "conv_moments_plain",
           "bn_apply_plain", "conv_apply_plain", "conv_rounded", "bn_stats",
           "epilogue_reference", "tf32_round", "conv_3xtf32_emulated"]

_BN = 128  # output pixels per block of the conv kernels (csrc/fused_conv.cu)


def supported_geometry(x_shape, w_shape, strides, paddings, dilations,
                       groups):
    """True when the kernels cover this conv geometry (the reference's
    ``supported_geometry``, unchanged)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if any(d is None or int(d) <= 0 for d in tuple(x_shape) + tuple(w_shape)):
        return False
    if groups != 1 or tuple(dilations) != (1, 1):
        return False
    o, c, kh, kw = w_shape
    s = tuple(strides)
    p = tuple(paddings)
    if (kh, kw) == (1, 1):
        return p == (0, 0) and s in ((1, 1), (2, 2))
    if (kh, kw) == (3, 3):
        return p == (1, 1) and s == (1, 1)
    return False


def gate(x_shape, w_shape, strides, paddings, dilations, groups, x=None):
    """The path a ``fused_conv2d`` site takes, as the dict its op records in
    ``op.attrs["_kernel_choice"]``: ``admitted``, ``kernel`` and ``reason``
    (None when admitted). Only the geometry declines a site (the
    reference's ``supported_geometry``; it then replays its original ops).
    An admitted site runs the plain versions when ``x`` lies on the CPU and
    the CUDA kernels otherwise (3xTF32 tensor-core products for f32 ``x``,
    bf16 ones for bf16 ``x``, both with f32 accumulation), whose wrappers
    raise for a tensor they cannot take. f16 ``x`` raises
    ``NotImplementedError``: the reference's AMP is bf16 only."""
    if not supported_geometry(x_shape, w_shape, strides, paddings,
                              dilations, groups):
        return {"admitted": False, "kernel": "unfused_replay",
                "reason": "unsupported conv geometry: filter %s strides %s "
                "paddings %s dilations %s groups %s (the kernels cover the "
                "1x1 s1/s2 and 3x3 s1 p1 bottleneck shapes)"
                % (list(w_shape), list(strides), list(paddings),
                   list(dilations), groups)}
    if x is not None and x.dtype == torch.float16:
        raise NotImplementedError(
            "fused_conv2d: float16 activations; mixed precision is bf16 "
            "(fluid.amp), as in the reference")
    on_cpu = x is not None and x.device.type == "cpu"
    return {"admitted": True,
            "kernel": "plain_fused_conv" if on_cpu else "cuda_fused_conv",
            "reason": None}


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the card is held against)
# ---------------------------------------------------------------------------

def _geometry(x, w, stride):
    n, c, h, wd = x.shape
    o, c2, kh, kw = w.shape
    if c2 != c or kh != kw or kh not in (1, 3) or stride not in (1, 2) \
            or (kh == 3 and stride != 1):
        raise ValueError("fused conv: unsupported geometry x %s w %s stride "
                         "%s" % (tuple(x.shape), tuple(w.shape), stride))
    pad = (kh - 1) // 2
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    return n, c, h, wd, o, kh, pad, ho, wo


def _conv_plain(x, w, stride):
    return F.conv2d(x, w, stride=stride, padding=(w.shape[2] - 1) // 2)


def conv_rounded(x, w, stride):
    """The conv computed in f32 and rounded once to ``x``'s dtype (the
    bf16 kernels' accumulator, rounded where they store it; for f32 the
    plain conv)."""
    if x.dtype == torch.float32:
        return _conv_plain(x, w, stride)
    return _conv_plain(x.float(), w.float(), stride).to(x.dtype)


def conv_moments_plain(x, w, stride):
    """x [N, C, H, W], w [O, C, K, K] -> (co [N, O, Ho, Wo] in x.dtype,
    sum co [O] f32, sum co^2 [O] f32), the moments over N, Ho, Wo of the
    stored (rounded) values (the reference's :167-176)."""
    co = conv_rounded(x, w, stride)
    cof = co.float()
    return co, cof.sum(dim=(0, 2, 3)), (cof * cof).sum(dim=(0, 2, 3))


def tf32_round(t):
    """f32 ``t`` rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero on the bit pattern, as ``cvt.rna.tf32.f32`` rounds
    on the card. Finite values only."""
    bits = t.float().contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def conv_3xtf32_emulated(x, w, stride, passes=3):
    """The conv kernels' products on the CPU, for the tests: x and w split
    into ``big = tf32(a)`` and ``small = tf32(a - big)``; ``passes=3`` sums
    ``small*big + big*small + big*big`` (the kernels' 3xTF32), ``passes=1``
    takes ``big*big`` alone (a single TF32 product). The products and their
    sum are exact in float64, so the result differs from the exact conv only
    by the split and the final rounding to f32."""
    xb, wb = tf32_round(x), tf32_round(w)

    def conv(a, b):
        return _conv_plain(a.double(), b.double(), stride)

    if passes == 1:
        return conv(xb, wb).float()
    xs, ws = tf32_round(x.float() - xb), tf32_round(w.float() - wb)
    return (conv(xs, wb) + conv(xb, ws) + conv(xb, wb)).float()


def _affine(y, scale, shift):
    """y * scale[o] + shift[o] in f32: a product, then a sum (the bf16
    kernels round each in turn, as here)."""
    return y.float() * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)


def _residual_relu(y, residual, relu):
    if residual is not None:
        y = y + residual.to(y.dtype)
    return torch.relu(y) if relu else y


def bn_apply_plain(co, scale, shift, residual, relu):
    """y = co * scale[o] + shift[o] in f32, cast to co's dtype BEFORE the
    residual add (the unfused bn.Y -> add chain), then relu."""
    return _residual_relu(_affine(co, scale, shift).to(co.dtype), residual,
                          relu)


def conv_apply_plain(x, w, scale, shift, residual, relu, stride):
    """The inference form: conv rounded to x's dtype (the reference's
    :205), BN affine (+ residual)(+ relu)."""
    return bn_apply_plain(conv_rounded(x, w, stride), scale, shift, residual,
                          relu)


def bn_stats(co):
    """Per-channel batch mean and biased variance of [N, O, H, W] in f32,
    one pass (the unfused ``batch_norm`` formulation)."""
    cof = co.float()
    n = co.shape[0] * co.shape[2] * co.shape[3]
    bm = cof.sum(dim=(0, 2, 3)) / n
    bv = torch.clamp_min((cof * cof).sum(dim=(0, 2, 3)) / n - bm * bm, 0.0)
    return bm, bv


def epilogue_reference(co, gamma, beta, residual, bm, bv, eps, relu):
    """normalize (+ residual)(+ relu) on a conv output, the unfused
    batch_norm -> elementwise_add -> relu arithmetic (the reference's
    ``_epilogue_reference``). ``bm``/``bv`` None: training, statistics from
    ``co``, differentiably."""
    if bm is None:
        bm, bv = bn_stats(co)
    c = (1, -1, 1, 1)
    inv = torch.rsqrt(bv.reshape(c) + eps)
    y = (co.float() - bm.reshape(c)) * inv * gamma.float().reshape(c) \
        + beta.float().reshape(c)
    return _residual_relu(y.to(co.dtype), residual, relu)


def _scale_shift(gamma, beta, mean, var, eps):
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def _moments_to_stats(s1, s2, count):
    bm = s1 / count
    return bm, torch.clamp_min(s2 / count - bm * bm, 0.0)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _fn(entry, n_ptr, n_int, lib="fused_conv"):
    fn = getattr(_build.load(lib), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_DTYPES = (torch.float32, torch.bfloat16)


def _check(name, acts, f32=()):
    """Raise unless every tensor lies on one CUDA device and is contiguous,
    ``acts`` (x, w, co, residual; None skipped) are all f32 or all bf16
    and ``f32`` (scale, shift) are f32. Returns the dtype of ``acts``."""
    dtype = acts[0].dtype
    dev = acts[0].device
    for t in list(acts) + list(f32):
        if t is None:
            continue
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("%s: tensors must share one CUDA device, got %s "
                             "and %s" % (name, dev, t.device))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % name)
    if dtype not in _DTYPES or any(t is not None and t.dtype != dtype
                                   for t in acts):
        raise TypeError("%s takes f32 or bf16 activations and weights of "
                        "one dtype, got %s" % (name, [
                            t.dtype for t in acts if t is not None]))
    if any(t is not None and t.dtype != torch.float32 for t in f32):
        raise TypeError("%s takes f32 scale and shift" % name)
    return dtype


def _suffix(dtype):
    return "_bf16" if dtype == torch.bfloat16 else ""


def _w_taps(w):
    """[O, C, K, K] -> [O, K*K*C], k tap-major (k = (dy*K + dx)*C + c), the
    layout the bf16 kernels read W in (the reference's ``_w_taps`` :224
    does the same outside its kernel); a view for 1x1."""
    o, c, kh, kw = w.shape
    if kh == kw == 1:
        return w.reshape(o, c)
    return w.permute(0, 2, 3, 1).reshape(o, kh * kw * c).contiguous()


def _conv_args(name, x, w, stride, f32=(), residual=None):
    dtype = _check(name, (x, w, residual), f32)
    n, c, h, wd, o, k, _, ho, wo = _geometry(x, w, stride)
    if n * c * h * wd >= 2 ** 31 or n * o * ho * wo >= 2 ** 31:
        raise ValueError("%s: tensors of 2^31 elements or more" % name)
    if dtype == torch.bfloat16:
        w = _w_taps(w)
    return dtype, w, (n, c, h, wd, o, k, ho, wo)


def conv_moments(x, w, stride):
    """Launch the training kernel (row 10). x: CUDA [N, C, H, W]; w:
    [O, C, K, K], both f32 (3xTF32) or both bf16 (AMP). Returns (co
    [N, O, Ho, Wo] in x's dtype, sum co [O], sum co^2 [O], both f32).
    bf16 runs the form :func:`moments_form` names (``wgmma_launches``
    counts the warpgroup-product one, whose partial sums are one row a
    pixel tile of :func:`wgmma_tile_plan`)."""
    dtype, wk, (n, c, h, wd, o, k, ho, wo) = _conv_args("conv_moments", x,
                                                       w, stride)
    co = torch.empty(n, o, ho, wo, device=x.device, dtype=dtype)
    sums = torch.empty(2, o, device=x.device, dtype=torch.float32)
    if moments_form(x, w, stride)[0] == "wgmma":
        plan = wgmma_tile_plan(n, h, wd, k, stride)
        xt = _channels_last_scratch(x, plan, ho, wo)
        partial = torch.empty(plan.tiles, 2, o, device=x.device,
                              dtype=torch.float32)
        _build.launch(_fn("conv_moments_bf16_wgmma", 6, 11,
                          "fused_conv_wgmma"), "fused_conv_wgmma", x.device,
                      x.data_ptr(), _ptr(xt), wk.data_ptr(), co.data_ptr(),
                      partial.data_ptr(), sums.data_ptr(), n, c, h, wd, o, k,
                      stride, *_plan_args(plan))
        conv_moments.wgmma_launches += 1
    else:
        tiles = -(-(n * ho * wo) // _BN)
        partial = torch.empty(tiles, 2, o, device=x.device,
                              dtype=torch.float32)
        _build.launch(_fn("conv_moments" + _suffix(dtype), 5, 8),
                      "fused_conv", x.device, x.data_ptr(), wk.data_ptr(),
                      co.data_ptr(), partial.data_ptr(), sums.data_ptr(), n,
                      c, h, wd, o, k, stride, tiles)
    conv_moments.launches += 1
    conv_moments.bf16_launches += dtype == torch.bfloat16
    return co, sums[0], sums[1]


conv_moments.launches = conv_moments.bf16_launches = 0
conv_moments.wgmma_launches = 0  # of them, on warpgroup products


def bn_apply(co, scale, shift, residual, relu):
    """Launch the apply kernel (row 11). co: CUDA [N, O, H, W], f32 or
    bf16; scale/shift: f32 [O]; residual: like co, or None. y in co's
    dtype."""
    dtype = _check("bn_apply", (co, residual), (scale, shift))
    n, o, h, wd = co.shape
    if scale.numel() != o or shift.numel() != o or (
            residual is not None and residual.shape != co.shape):
        raise ValueError("bn_apply: scale %s, shift %s, residual %s against "
                         "co %s" % (tuple(scale.shape), tuple(shift.shape),
                                    None if residual is None
                                    else tuple(residual.shape),
                                    tuple(co.shape)))
    if co.numel() >= 2 ** 31:
        raise ValueError("bn_apply: tensors of 2^31 elements or more")
    y = torch.empty_like(co)
    if co.numel():
        _build.launch(_fn("bn_apply" + _suffix(dtype), 5, 4), "fused_conv",
                      co.device, co.data_ptr(), scale.data_ptr(),
                      shift.data_ptr(),
                      residual.data_ptr() if residual is not None else None,
                      y.data_ptr(), co.numel(), h * wd, o, int(bool(relu)))
        bn_apply.launches += 1
        bn_apply.bf16_launches += dtype == torch.bfloat16
    return y


bn_apply.launches = bn_apply.bf16_launches = 0


# the wgmma form's tile: 256 pixel slots (the N of its m64n256k16
# products), so its widest output row is 256
WGMMA_NPIX = 256

ConvTilePlan = collections.namedtuple("ConvTilePlan",
                                      "nchw width rows bh bn tiles")


def _wgmma_form(x, w, stride, others):
    if x.dtype != torch.bfloat16:
        return "mma_sync", None
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    if c % 64 or o % 64:
        return "mma_sync", "C %d or O %d not a multiple of 64" % (c, o)
    wo = (wd + 2 * ((k - 1) // 2) - k) // stride + 1
    if wo > WGMMA_NPIX:
        return "mma_sync", "Wo %d > %d" % (wo, WGMMA_NPIX)
    if any(t is not None and t.data_ptr() % 16 for t in (x, w) + others):
        return "mma_sync", "a pointer not 16-byte aligned"
    return "wgmma", None


def apply_form(x, w, stride, residual=None):
    """The bf16 ``conv_apply``'s form for a device call, by shape:
    ``("wgmma", None)`` at the fused geometries with C and O multiples of
    64 (a 64-channel chunk is one 128-byte row of the channels-last copy,
    a TMA box's swizzle row), Wo up to :data:`WGMMA_NPIX` and x, w and
    the residual 16-byte aligned; else ``("mma_sync", reason)``, reason
    None for f32 (its only form) or the check that failed."""
    return _wgmma_form(x, w, stride, (residual,))


def moments_form(x, w, stride):
    """The bf16 ``conv_moments``' form for a device call, by the rule of
    :func:`apply_form` (the two share one mainloop): ``("wgmma", None)``
    or ``("mma_sync", reason)``."""
    return _wgmma_form(x, w, stride, ())


def wgmma_tile_plan(n, h, w, k, stride):
    """The wgmma form's tiles of the output of an [n, C, h, w] input under
    a k x k conv at ``stride``: a :class:`ConvTilePlan` ``(nchw, width,
    rows, bh, bn, tiles)``. A tile is ``bh`` rows of ``width`` slots of
    ``bn`` images, at most :data:`WGMMA_NPIX` slots, one TMA box of
    64 x width x bh x bn bf16 a 64-channel chunk. ``nchw``: a 1x1
    stride-1 conv with h*w a multiple of 8 reads x in NCHW itself (a TMA
    stride is a multiple of 16 bytes), its rows 256 pixels wide (the last
    one ragged); else the rows are the output's (``width`` = Wo, ``rows``
    = Ho) in a channels-last copy: whole images, as many as fit, or the
    rows of one image in the fewest even row tiles. ``tiles``: the pixel
    tiles, ceil(n / bn) * ceil(rows / bh), one partial row each for
    ``conv_moments``. The C entries refuse a plan that does not tile the
    output."""
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    if k == 1 and stride == 1 and (h * w) % 8 == 0:
        rows = -(-(ho * wo) // WGMMA_NPIX)
        return ConvTilePlan(True, WGMMA_NPIX, rows, 1, 1, n * rows)
    if ho * wo <= WGMMA_NPIX:  # whole images
        bh, bn = ho, min(WGMMA_NPIX // (ho * wo), n)
    else:  # rows of one image, the row tiles of an image made even
        per = -(-ho // (WGMMA_NPIX // wo))
        bh, bn = -(-ho // per), 1
    return ConvTilePlan(False, wo, ho, bh, bn, -(-n // bn) * -(-ho // bh))


def _channels_last_scratch(x, plan, ho, wo):
    """The wgmma form's scratch for x's channels-last copy (the pixels the
    conv reads), or None where it reads x in NCHW. The caller holds it
    until the launch."""
    if plan.nchw:
        return None
    n, c = x.shape[:2]
    return torch.empty(n, ho, wo, c, device=x.device, dtype=x.dtype)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _plan_args(plan):
    """The plan as the wgmma C entries take it (nchw, bh, bn, tiles)."""
    return int(plan.nchw), plan.bh, plan.bn, plan.tiles


def conv_apply(x, w, scale, shift, residual, relu, stride):
    """Launch the inference kernel (row 12): conv with the BN affine
    (+ residual)(+ relu) in its epilogue. x, w, residual: f32 or bf16; y
    in x's dtype. bf16 runs the form :func:`apply_form` names
    (``wgmma_launches`` counts the warpgroup-product one, which first
    copies the pixels it reads channels last into scratch allocated
    here, under :func:`wgmma_tile_plan`)."""
    dtype, wk, (n, c, h, wd, o, k, ho, wo) = _conv_args(
        "conv_apply", x, w, stride, (scale, shift), residual)
    form = apply_form(x, w, stride, residual)[0]
    if scale.numel() != o or shift.numel() != o or (
            residual is not None and tuple(residual.shape) != (n, o, ho, wo)):
        raise ValueError("conv_apply: scale/shift must be [%d] and the "
                         "residual [%d, %d, %d, %d]" % (o, n, o, ho, wo))
    y = torch.empty(n, o, ho, wo, device=x.device, dtype=dtype)
    tail = (scale.data_ptr(), shift.data_ptr(),
            _ptr(residual), y.data_ptr(), n, c, h, wd, o, k, stride,
            int(bool(relu)))
    if form == "wgmma":
        plan = wgmma_tile_plan(n, h, wd, k, stride)
        xt = _channels_last_scratch(x, plan, ho, wo)
        _build.launch(_fn("conv_apply_bf16_wgmma", 7, 12, "fused_conv_wgmma"),
                      "fused_conv_wgmma", x.device, x.data_ptr(), _ptr(xt),
                      wk.data_ptr(), *tail, *_plan_args(plan))
        conv_apply.wgmma_launches += 1
    else:
        _build.launch(_fn("conv_apply" + _suffix(dtype), 6, 8), "fused_conv",
                      x.device, x.data_ptr(), wk.data_ptr(), *tail)
    conv_apply.launches += 1
    conv_apply.bf16_launches += dtype == torch.bfloat16
    return y


conv_apply.launches = conv_apply.bf16_launches = 0
conv_apply.wgmma_launches = 0  # of them, on warpgroup products


# ---------------------------------------------------------------------------
# forward passes and autograd wiring
# ---------------------------------------------------------------------------

def _train_forward(x, w, gamma, beta, residual, stride, eps, relu):
    """(y, batch mean, batch var, co): their plain versions on the CPU,
    rows 10 + 11 on any other device (the wrappers raise off CUDA)."""
    if x.device.type != "cpu":
        co, s1, s2 = conv_moments(x, w.contiguous(), stride)
    else:
        co, s1, s2 = conv_moments_plain(x, w, stride)
    bm, bv = _moments_to_stats(s1, s2, co.shape[0] * co.shape[2]
                               * co.shape[3])
    scale, shift = _scale_shift(gamma, beta, bm, bv, eps)
    if x.device.type != "cpu":
        y = bn_apply(co, scale, shift, residual, relu)
    else:
        y = bn_apply_plain(co, scale, shift, residual, relu)
    return y, bm, bv, co


def _infer_forward(x, w, gamma, beta, mean, var, residual, stride, eps,
                   relu):
    scale, shift = _scale_shift(gamma, beta, mean, var, eps)
    if x.device.type != "cpu":
        return conv_apply(x, w.contiguous(), scale, shift, residual, relu,
                          stride)
    return conv_apply_plain(x, w, scale, shift, residual, relu, stride)


def _conv_grads(x, w, dco, stride, mask):
    """The conv's input and weight gradients (cuDNN on the card), as the
    reference takes ``jax.vjp`` of the plain lax conv."""
    pad = (w.shape[2] - 1) // 2
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dco.contiguous(), x, w, None, [stride, stride], [pad, pad], [1, 1],
        False, [0, 0], 1, [mask[0], mask[1], False])
    return dx, dw


def _leaves(*ts):
    return [t.detach().requires_grad_(True) if t is not None else None
            for t in ts]


class _FusedTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, residual, stride, eps, relu):
        y, bm, bv, co = _train_forward(x, w, gamma, beta, residual, stride,
                                       eps, relu)
        ctx.save_for_backward(x, w, gamma, beta, residual, co)
        ctx.cfg = (stride, eps, relu)
        ctx.mark_non_differentiable(bm, bv)
        return y, bm, bv

    @staticmethod
    def backward(ctx, dy, _dbm, _dbv):
        x, w, gamma, beta, residual, co = ctx.saved_tensors
        stride, eps, relu = ctx.cfg
        need = ctx.needs_input_grad
        with torch.enable_grad():
            co_, g_, b_, r_ = _leaves(co, gamma, beta, residual)
            y = epilogue_reference(co_, g_, b_, r_, None, None, eps, relu)
            wrt = [co_, g_, b_] + ([r_] if r_ is not None else [])
            grads = torch.autograd.grad(y, wrt, dy)
        dco, dgamma, dbeta = grads[:3]
        dres = grads[3] if residual is not None else None
        dx, dw = _conv_grads(x, w, dco.to(co.dtype), stride, need[:2])
        return dx, dw, dgamma, dbeta, dres, None, None, None


class _FusedInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, mean, var, residual, stride, eps,
                relu):
        ctx.save_for_backward(x, w, gamma, beta, mean, var, residual)
        ctx.cfg = (stride, eps, relu)
        return _infer_forward(x, w, gamma, beta, mean, var, residual, stride,
                              eps, relu)

    @staticmethod
    def backward(ctx, dy):
        x, w, gamma, beta, mean, var, residual = ctx.saved_tensors
        stride, eps, relu = ctx.cfg
        with torch.enable_grad():
            x_, w_, g_, b_, r_ = _leaves(x, w, gamma, beta, residual)
            y = epilogue_reference(conv_rounded(x_, w_, stride), g_, b_, r_,
                                   mean.float(), var.float(), eps, relu)
            wrt = [x_, w_, g_, b_] + ([r_] if r_ is not None else [])
            grads = torch.autograd.grad(y, wrt, dy)
        dres = grads[4] if residual is not None else None
        return (grads[0], grads[1], grads[2], grads[3], None, None, dres,
                None, None, None)


def _taped(*ts):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def fused_conv_bn_act(x, w, gamma, beta, mean, var, *, strides, paddings,
                      eps, momentum, act=None, residual=None,
                      is_test=False, use_global_stats=False):
    """NCHW conv + BN + optional residual/relu through the kernels (CUDA)
    or their plain versions (CPU). Returns ``(y, mean_out, var_out,
    saved_mean, saved_var)`` with the unfused ops' semantics (saved_* are
    None on the inference path). Callers have checked :func:`gate`;
    ``paddings`` is implied by the supported geometry."""
    stride = int(strides[0])
    relu = act == "relu"
    x = x.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    if is_test or use_global_stats:
        args = (x, w, gamma, beta, mean, var, residual, stride, float(eps),
                relu)
        y = _FusedInfer.apply(*args) if _taped(x, w, gamma, beta, residual) \
            else _infer_forward(*args)
        return y, mean, var, None, None
    args = (x, w, gamma, beta, residual, stride, float(eps), relu)
    if _taped(x, w, gamma, beta, residual):
        y, bm, bv = _FusedTrain.apply(*args)
    else:
        y, bm, bv, _ = _train_forward(*args)
    mean_out = momentum * mean + (1 - momentum) * bm
    var_out = momentum * var + (1 - momentum) * bv
    return y, mean_out, var_out, bm, bv
