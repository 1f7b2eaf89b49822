"""Fused vocabulary projection + label-smoothed softmax cross-entropy: the
hand-written CUDA forward kernel (``csrc/fused_ce_fwd.cu``), its split plan,
its chunked backward, its plain PyTorch version and a CPU emulation of its
arithmetic.

Replaces the Pallas TPU forward ``_fwd_kernel`` of
``paddle_tpu/ops/fused_ce.py`` (:57, via ``_fwd_impl`` :106): the [T, V]
logits never reach device memory. The kernel is a 3xTF32 tensor-core GEMM
(``mma.sync``, each f32 operand split into two TF32 parts) whose epilogue
keeps the online (max, sum exp, sum z, z[y]) statistics; when the row tiles
alone do not fill the card, the vocabulary is split (:func:`split_plan`) and
a second launch combines the splits per row in a fixed order.
:func:`linear_smooth_ce_3xtf32_emulated` repeats that arithmetic on the CPU
for the tests; it is not on any path.

The backward is the chunked recompute of ``_bwd_impl`` (:180-217), which
``paddle_tpu`` computes outside Pallas, so its products are
``torch.matmul``: per chunk of rows,
``dz = g * (softmax(z) - (1 - eps) * onehot(y) - eps / V)``, then
``dx = dz W^T``, ``dW += x^T dz`` and ``db += sum(dz)``. A chunk's
``[chunk, V]`` f32 tile stays under about 0.5 GB.

``linear_smooth_ce`` takes the kernel for every CUDA tensor (the TPU
package's size gate ``_FUSED_MIN_LOGITS`` and its ``PADDLE_TPU_*`` switches
were TPU measurements) and the plain version for a CPU tensor, with the
chunked backward on both. Neither falls back to the other.

bf16 (AMP): x, W and the bias arrive in bf16. The kernel's bf16 forms
take one bf16 tensor-core product per f32 one (each product of two bf16
values is exact in f32) and keep the f32 statistics of the 3xTF32 form;
loss and lse are f32. Two forms, chosen by shape (:func:`ce_form`, counted
by ``fused_ce_fwd.wgmma_launches``): warpgroup products fed by TMA
(``fused_ce_wgmma_kernel``, x's 64-deep slices streamed beside W's through
one ring) for every call whose D is a multiple of 8 from a 16-byte
aligned x, at any V (BERT's MLM head: D 768, V 30522), W read through
:func:`wgmma_w_operand`; the ``mma.sync`` form otherwise. Both are checked
kernels: a route by shape, not a fallback. Each plans its own grid
(:func:`split_plan` with the form's tile). The plain version computes f32
logits from the same bf16 operands, and the backward rounds where
``_bwd_impl`` does.
"""

import ctypes
import functools

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["linear_smooth_ce", "fused_ce_fwd", "linear_smooth_ce_bwd",
           "linear_smooth_ce_plain", "split_plan", "ce_form",
           "linear_smooth_ce_3xtf32_emulated", "wgmma_w_operand",
           "MMA_SYNC_TILE", "WGMMA_TILE", "WGMMA_CHUNK_K"]

_CHUNK_BYTES = 512 * 1024 * 1024  # one [chunk, V] f32 tile at most
# the mma.sync forms' tile (csrc/fused_ce_fwd.cu BM, BN): rows per block,
# and vocabulary columns per step of a block's walk
_BM = 128
_BN = 128
# Each form's tile for split_plan: (rows per block, columns per tile, what
# starting a block costs in tiles of work). mma.sync (f32 3xTF32 and PR
# 10's bf16): filling its ring and writing its partials; with 0.25 the plan
# picks the fastest of the split counts tools/kernel_plans.py times on an
# H100 at 4,096 rows (4 splits) and within 0.1% of it at 32,768 rows (17
# splits; one split is 2.9% slower).
MMA_SYNC_TILE = (_BM, _BN, 0.25)
# wgmma (csrc/fused_ce_fwd.cu wgce::BM, BN): the same block cost. On an
# H100 tools/kernel_plans.py times the earlier x-resident form under 1, 2,
# 3, 4 and 8 splits at 32,768 rows 2.594, 2.569, 2.539, 2.518 and 2.487 ms
# (the blocks' x loads cost less than the tail of two waves of
# whole-vocabulary blocks), and at 4,096 rows 4 splits fastest (PERF.md)
WGMMA_TILE = (128, 128, 0.25)
# the depth of the wgmma form's chunk sums (k per fresh tensor-core
# accumulator, a multiple of its 64-deep ring stages): the deepest whose
# loss and lse errors against f64 stay within 1.1x the plain version's at
# D 768 and D 512 (tools/wgmma_variants.py --ce on an H100: 128 reads at
# most 1.03x and 1.10x and is 5.5% and 7.6% faster than 64; 256 reads
# 1.21x at D 512); chip_smoke.py's fused_ce_f64 holds it to 1.5x (PERF.md)
WGMMA_CHUNK_K = 128


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


@functools.lru_cache(maxsize=64)
def split_plan(t, v, sms, tile=MMA_SYNC_TILE):
    """A form's grid for T rows and V columns on ``sms`` SMs (one block an
    SM), for its ``tile`` (:data:`MMA_SYNC_TILE` or :data:`WGMMA_TILE`:
    rows per block, columns per tile, block cost): ``(nsplit,
    cols_per_split, rows_per_block)``. The vocabulary's ``ceil(V / cols)``
    tiles are cut into ``nsplit`` splits of whole tiles (the last may be
    shorter, none is empty); each of the ``ceil(T / rows)`` row tiles runs
    one block per split. Of every split count, the plan takes the one
    whose waves of blocks end first, each block costing its tiles plus the
    tile's block cost; ties go to fewer splits."""
    if t <= 0 or v <= 0 or sms <= 0:
        raise ValueError("split_plan: T, V and SMs must be positive, got "
                         "%d, %d, %d" % (t, v, sms))
    rows, cols, block_cost = tile
    row_tiles = -(-t // rows)
    tiles = -(-v // cols)
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)      # tiles per split
        nsplit = -(-tiles // per)    # no empty split
        waves = -(-row_tiles * nsplit // sms)
        cost = waves * (per + block_cost)
        if best is None or cost < best[0]:
            best = (cost, nsplit, per * cols)
    return best[1], best[2], rows


def ce_form(x, w):
    """The bf16 form for x [T, D] and w [D, V] as the kernel gets them
    (contiguous): ``"wgmma"`` where D is a multiple of 8 and x is 16-byte
    aligned (the tensor map of x needs 16-byte rows and base; any V: W is
    read through :func:`wgmma_w_operand`); else ``"mma_sync"`` (the
    mma.sync form, and the f32 one)."""
    if x.dtype != torch.bfloat16 or w.shape[0] % 8 or x.data_ptr() % 16:
        return "mma_sync"
    return "wgmma"


def wgmma_w_operand(w):
    """W [D, V] (contiguous) as the wgmma form's tensor map reads it:
    ``(tensor, ldw)``, rows of ``ldw`` elements of which the first V are
    W's. W itself where its rows are whole 16-byte pieces (V a multiple
    of 8) from a 16-byte aligned pointer; else a copy into [D, V rounded
    up to 8] from ``torch.empty``, whose pad columns are never written:
    the map's dimensions stop at V, so TMA reads zeros past them and no
    pad column reaches a logit. The copy is counted in the kernel's time
    (0.063 ms of BERT's [768, 30522] on an H100, PERF.md)."""
    d, v = w.shape
    if v % 8 == 0 and w.data_ptr() % 16 == 0:
        return w, v
    ldw = -(-v // 8) * 8
    padded = torch.empty(d, ldw, dtype=w.dtype, device=w.device)
    padded[:, :v].copy_(w)
    return padded, ldw


def _merge(m, s, mo, so):
    """The kernel's merge of two (max, sum exp) pairs, elementwise; a pair
    that saw no column (max -inf) adds nothing."""
    mn = torch.maximum(m, mo)
    live = mn != float("-inf")
    ref = torch.where(live, mn, torch.zeros_like(mn))
    s = torch.where(live, s * torch.exp(m - ref) + so * torch.exp(mo - ref),
                    torch.zeros_like(s))
    return mn, s


def linear_smooth_ce_3xtf32_emulated(x, w, b, y, eps, plan, passes=3):
    """The CUDA kernel's arithmetic on the CPU, for the tests: (loss, lse).

    The product: x and w split into ``big = tf32(a)`` and ``small = tf32(a
    - big)`` (``fused_conv.tf32_round``); ``passes=3`` sums ``small*big +
    big*small + big*big`` (3xTF32), ``passes=1`` takes ``big*big`` alone (a
    single TF32 product). The products and their sum are exact in float64
    and z is rounded to f32 once: the tensor cores' truncating additions,
    which the kernel confines to 32-deep chunks, are not modelled.

    The statistics, in f32 and in the kernel's order: for the plan
    ``(nsplit, cols_per_split, rows_per_block)`` each split walks its
    128-column tiles; in each tile, per row, each of the 16 threads (4 warp
    columns x 4 lanes of a quad) owns columns ``32 * wn + 8 * j + 2 * tq +
    c`` (j 0-3, c 0-1) and folds them into its running (max, sum exp, sum
    z): the tile max, one rescale, then the exps added in (j, c) order.
    Then the lanes of a quad merge (xor 1, then xor 2), the warp columns in
    order, and the splits in order, as the kernel's second launch does."""
    from .fused_conv import tf32_round

    nsplit, per, rows = plan
    if rows != _BM or per % _BN or nsplit != -(-w.shape[1] // per):
        raise ValueError("linear_smooth_ce_3xtf32_emulated: bad plan %s"
                         % (plan,))
    x, w = x.float(), w.float()
    t, v = x.shape[0], w.shape[1]
    xb, wb = tf32_round(x), tf32_round(w)
    z = torch.matmul(xb.double(), wb.double())
    if passes == 3:
        xs, ws = tf32_round(x - xb), tf32_round(w - wb)
        z = (torch.matmul(xs.double(), wb.double())
             + torch.matmul(xb.double(), ws.double())) + z
    elif passes != 1:
        raise ValueError("passes is 3 (3xTF32) or 1 (single TF32)")
    z = z.float()
    if b is not None:
        z = z + b.float()
    y = y.long()
    ninf = float("-inf")
    loss_m, loss_s, loss_z, loss_y = [], [], [], []
    for k in range(nsplit):
        v_end = min(v, (k + 1) * per)
        m = torch.full((t, 4, 4), ninf)   # [row, warp column, lane]
        s = torch.zeros(t, 4, 4)
        sz = torch.zeros(t, 4, 4)
        zy = torch.zeros(t)
        for v0 in range(k * per, v_end, _BN):
            tile = torch.full((t, _BN), ninf)
            n = min(_BN, v_end - v0)
            tile[:, :n] = z[:, v0:v0 + n]
            # [row, wn, j, tq, c] -> [row, wn, tq, (j, c)]
            own = tile.reshape(t, 4, 4, 4, 2).permute(0, 1, 3, 2, 4)
            own = own.reshape(t, 4, 4, 8)
            mn = torch.maximum(m, own.max(dim=-1).values)
            ref = torch.where(mn == ninf, torch.zeros_like(mn), mn)
            e = torch.zeros(t, 4, 4)
            zsum = torch.zeros(t, 4, 4)
            for c in range(8):
                e = e + torch.exp(own[..., c] - ref)
                valid = own[..., c] != ninf
                zsum = zsum + torch.where(valid, own[..., c],
                                          torch.zeros_like(e))
            s = s * torch.exp(m - ref) + e
            m = mn
            sz = sz + zsum
            hit = (y >= v0) & (y < v0 + n)
            zy = torch.where(hit, z.gather(1, y.clamp(0, v - 1)[:, None])[:, 0],
                             zy)
        for o in (1, 2):  # the lanes of a quad
            perm = [q ^ o for q in range(4)]
            m, s = _merge(m, s, m[:, :, perm], s[:, :, perm])
            sz = sz + sz[:, :, perm]
        mr, sr, zr = m[:, 0, 0], s[:, 0, 0], sz[:, 0, 0]
        for c in range(1, 4):  # the warp columns, in order
            mr, sr = _merge(mr, sr, m[:, c, 0], s[:, c, 0])
            zr = zr + sz[:, c, 0]
        loss_m.append(mr)
        loss_s.append(sr)
        loss_z.append(zr)
        loss_y.append(zy)
    # the combine launch: max over the splits, then the sums in split order
    mx = loss_m[0]
    for mk in loss_m[1:]:
        mx = torch.maximum(mx, mk)
    s = torch.zeros(t)
    sz = torch.zeros(t)
    zy = torch.zeros(t)
    for mk, sk, zk, yk in zip(loss_m, loss_s, loss_z, loss_y):
        s = s + torch.where(sk > 0, sk * torch.exp(mk - mx),
                            torch.zeros_like(sk))
        sz = sz + zk
        zy = zy + yk
    lse = mx + torch.log(s)
    loss = lse - (1.0 - eps) * zy
    if eps:
        loss = loss - eps * sz / v
    return loss, lse


def _chunk_rows(t, v):
    rows = max(1, _CHUNK_BYTES // (4 * v))
    return min(t, 1 << (rows.bit_length() - 1))  # a power of two


def _mm_f32(a, b):
    """a @ b summed and stored in f32 (the bf16 operands' products are
    exact in f32): ``paddle_tpu``'s ``preferred_element_type=f32``."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def linear_smooth_ce_bwd(x, w, b, y, lse, g, eps):
    """The chunked recompute backward (``paddle_tpu``'s ``_bwd_impl``,
    :180-217) on any device: returns (dx, dw, db or None) for the loss
    cotangent g [T], each in its input's dtype. For bf16 x and w it
    rounds where the reference does: the logits are f32 from the bf16
    operands, dz is rounded to bf16 for dx = dz W^T (stored bf16) and
    dW = x^T dz (summed in f32 over the chunks, stored bf16); db sums the
    f32 dz."""
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
        z = _mm_f32(xc, w)
        if bf is not None:
            z = z + bf
        dz = torch.exp(z - lse[r0:r0 + ct, None])
        if eps:
            dz = dz - eps / v
        dz = dz * gc
        dz.scatter_add_(1, y[r0:r0 + ct].long()[:, None], -(1.0 - eps) * gc)
        dzc = dz.to(x.dtype)
        dx[r0:r0 + ct] = torch.matmul(dzc, w.t())
        dw += _mm_f32(xc.t(), dzc)
        if db is not None:
            db += dz.sum(dim=0)
    return dx, dw.to(w.dtype), db.to(b.dtype) if b is not None else None


# the C entries' int arguments after their 7 pointers
_C_INTS = {"fused_ce_fwd": 7, "fused_ce_fwd_wgmma": 8}


def _c_fn(entry="fused_ce_fwd"):
    fn = getattr(_build.load("fused_ce_fwd"), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * _C_INTS[
            entry] + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_ce_fwd(x, w, b, y, eps):
    """Launch the CUDA kernel. x: CUDA [T, D]; w: [D, V], both f32 (the
    3xTF32 form) or both bf16 (the bf16 form :func:`ce_form` names); b:
    [V] in x's dtype or f32, or None; y: int [T]. Returns (loss [T], lse [T]) in
    f32."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("fused_ce_fwd wants x [T, D] and w [D, V], got %s "
                         "and %s" % (tuple(x.shape), tuple(w.shape)))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError("fused_ce_fwd takes f32 or bf16 x, got %s" % x.dtype)
    for a in (x, w) + ((b,) if b is not None else ()):
        # the kernels add an f32 bias to the f32 logits: b may be f32 with
        # bf16 x and w (the dygraph BERT's MLM head, as the reference's)
        if a.dtype != x.dtype and not (a is b and a.dtype == torch.float32):
            raise TypeError("fused_ce_fwd: x and w (and b, or an f32 b) of "
                            "one dtype, got %s and %s" % (x.dtype, a.dtype))
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
    b = b.float().contiguous() if b is not None else None  # the kernels
    # add the bias to the f32 logits
    y = y.to(device=x.device, dtype=torch.int32).contiguous()
    loss = torch.empty(t, device=x.device, dtype=torch.float32)
    lse = torch.empty(t, device=x.device, dtype=torch.float32)
    if t == 0:
        return loss, lse
    sms = _build.sm_count(x.device.index)
    form = ce_form(x, w)
    nsplit, per, rows = split_plan(
        t, v, sms, MMA_SYNC_TILE if form == "mma_sync" else WGMMA_TILE)
    partial = torch.empty(nsplit, t, 4, device=x.device,
                          dtype=torch.float32)
    if form == "mma_sync":
        entry, wm = "fused_ce_fwd", w
        ints = (_DTYPE_CODES[x.dtype], t, d, v, rows, nsplit, per)
    else:
        entry, (wm, ldw) = "fused_ce_fwd_wgmma", wgmma_w_operand(w)
        ints = (t, d, v, ldw, rows, nsplit, per, WGMMA_CHUNK_K)
    _build.launch(_c_fn(entry), "fused_ce_fwd", x.device, x.data_ptr(),
                  wm.data_ptr(), b.data_ptr() if b is not None else None,
                  y.data_ptr(), loss.data_ptr(), lse.data_ptr(),
                  partial.data_ptr(), *ints, float(eps))
    fused_ce_fwd.wgmma_launches += form == "wgmma"
    fused_ce_fwd.launches += 1
    fused_ce_fwd.bf16_launches += x.dtype == torch.bfloat16
    return loss, lse


fused_ce_fwd.launches = fused_ce_fwd.bf16_launches = 0
fused_ce_fwd.wgmma_launches = 0  # of them, the warpgroup-product form


class _FusedCE(torch.autograd.Function):
    """The kernel on a CUDA tensor, the plain version on a CPU one; the
    chunked backward on either."""

    @staticmethod
    def forward(ctx, x, w, b, y, eps):
        fwd = linear_smooth_ce_plain if x.device.type == "cpu" \
            else fused_ce_fwd
        loss, lse = fwd(x, w, b, y, eps)
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
    loss = _FusedCE.apply(x2, w, b, y2, float(eps))
    return loss.reshape(lead)
