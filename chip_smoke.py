#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (Hopper):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc/``, checks
in their SASS that the conv, flash and fused CE kernels run on the tensor
cores, holds each kernel against its plain PyTorch version on the card (the
conv kernels also against an f64 conv, beside cuDNN's f32 one, and for
bitwise equal moments across two runs; the flash kernels at head dims 12 to
512, with a rich bias, and against an f64 attention, beside the plain
version's f32 one; the fused CE kernel at ragged T, D and V, for bitwise
equal results across two runs, and against an f64 projection and CE, beside
the plain version's f32 one), times
it (the conv kernels at each of ResNet-50's distinct fused geometries,
read from the fusion's record of the built program; the flash forward at
the served and the training shape), and then drives the port's main paths
at full width, each with the kernels' launch counts set to 0 just before
it and read just after:

* serving BERT-base (vocab 30522, seq 128, d_model 768, d_ff 3072, 12
  heads, 12 layers; random weights from seed 11): layers -> Program ->
  Executor (startup on the card) -> io.save_inference_model ->
  ServingEngine -> Predictor -> op interpreter -> kernels;
* training Transformer-base (vocab 30000/30000, seq 256, d_model 512,
  d_ff 2048, 8 heads, 6+6 layers, dropout 0.1, Adam 1e-4, 128 x 256 tokens
  per step; random weights from seed 11): layers -> Program ->
  optimizer.minimize (autodiff + adam ops) -> Executor -> forward ops ->
  torch.autograd backward through the kernels' autograd Functions ->
  adam, for 3 warm-up and 20 timed steps on one fixed batch;
* training ResNet-50 (224 x 224 x 3, 1000 classes, batch 128, Adam 1e-4;
  random weights from seed 11) the same way, with the executor's epilogue
  fusion turning 49 of its 53 conv -> BN (+ add)(+ relu) chains into the
  fused-conv kernels, for 3 warm-up and 10 timed steps;
* evaluating ResNet-50 through ``main.clone(for_test=True)`` at batch 128
  (the inference kernel at the same 49 sites);
* training DeepFM (100,000 x 32 fused table, 26 fields, K = 16, MLP 400 x
  3, 13 dense features, batch 32768, Adam 1e-4; random weights from seed
  11) the same way: its ``embedding(is_sparse=True)`` gives a (rows,
  values) gradient, which Adam densifies through the row scatter-add
  kernel, once per step, for 3 warm-up and 20 timed steps.

Before each training path, ``train_check``, ``resnet_train_check`` and
``deepfm_train_check`` run one full-width step (at batch 2, 2 and 64) on
the card and the same step with the port on the CPU from the same weights
and feed. Each phase prints one JSON
line; any failure raises and exits non-zero. The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``. Without CUDA, or
outside the repository, it exits non-zero and prints no result.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, f32 FLOP/s on the CUDA
# cores (the LayerNorm and scatter kernels do their arithmetic there, in
# f32), and TF32 FLOP/s on the tensor cores, where the conv, flash and fused
# CE kernels run each f32 product as three TF32 products (3xTF32)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12

BERT = dict(vocab=30522, seq=128, d_model=768, d_ff=3072, heads=12,
            layers=12)
# Transformer-base as paddle_tpu's bench.py trains it (:174-177, :229)
TRANSFORMER = dict(src_vocab=30000, trg_vocab=30000, seq_len=256,
                   d_model=512, d_ff=2048, n_head=8, n_layer=6)
TRAIN_BATCH = 128
# ResNet-50 as paddle_tpu's bench.py trains it (BASELINE config 2,
# :200-207, :229), in f32 (the port has no AMP yet)
RESNET = dict(depth=50, class_num=1000, image_shape=(3, 224, 224))
RESNET_BATCH = 128
# DeepFM as paddle_tpu's bench.py trains it (BASELINE config 5, :208-214,
# :229), in f32 (the port has no AMP yet); the fused table is 32 wide
DEEPFM = dict(sparse_feature_dim=100000, num_fields=26, embedding_size=16,
              dense_dim=13, hidden_sizes=(400, 400, 400))
DEEPFM_WIDTH = 32
DEEPFM_BATCH = 32768
SEED = 11
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "layer_norm_fwd",
           "layer_norm_bwd", "fused_ce_fwd", "conv_moments", "bn_apply",
           "conv_apply", "scatter_add")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def time_ms(fn, iters=50, warmup=5):
    """Median device time of ``fn`` over ``iters`` runs, each between its
    own pair of CUDA events. A sleep kernel queued first keeps the stream
    busy while the host enqueues every run, so host-side launch overhead
    stays out of the intervals."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def kernel_fns():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fce
    from paddle_tpu_torch.ops import fused_conv as fc
    from paddle_tpu_torch.ops import fused_layer_norm as fln
    from paddle_tpu_torch.ops import scatter as sc

    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "layer_norm_fwd": fln.layer_norm_fwd,
            "layer_norm_bwd": fln.layer_norm_bwd,
            "fused_ce_fwd": fce.fused_ce_fwd,
            "conv_moments": fc.conv_moments, "bn_apply": fc.bn_apply,
            "conv_apply": fc.conv_apply, "scatter_add": sc.scatter_add}


def reset_counts():
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def per_run(**counts):
    """Launches of every kernel in one run of a path (0 unless named)."""
    return dict(dict.fromkeys(KERNELS, 0), **counts)


def max_err(got, want):
    """(max abs error, max abs error / max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def check_close(phase, case, pairs, tol, **extra):
    """Emit one line per case with each tensor's max abs and relative
    error; fail if any max abs error exceeds tol * max(1, max |want|)."""
    errs, ok = {}, True
    for name, got, want in pairs:
        a, r = max_err(got, want)
        errs[name] = {"max_abs_err": a, "max_rel_err": r}
        ok = ok and a <= tol * max(1.0, want.abs().max().item())
    emit(dict({"phase": phase, "case": case, "errors": errs,
               "tol": "%g * max(1, max|plain|)" % tol}, **extra))
    check(ok, "%s %s: errors %s above tolerance" % (phase, case, errs))
    return max(e["max_abs_err"] for e in errs.values())


def bound(nbytes, flops, flops_s=F32_FLOPS):
    """(least ms, "bytes" or "operations"): nbytes at the HBM rate against
    flops at ``flops_s``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flops_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def tensor_core_bound(nbytes, flops):
    """The bound of the conv, flash and fused CE kernels (rows 1-6, 9, 10,
    12): their 3 x flops TF32 tensor-core operations (3xTF32) or their bytes, and
    beside it the bound of the same work on the f32 FMA pipes."""
    bnd, by = bound(nbytes, 3 * flops, TF32_FLOPS)
    return bnd, by, bound(nbytes, flops)[0]


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, "nvidia-smi failed: " + smi.stderr)
    line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": line,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_lib = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": per_lib, "nvcc": _build.nvcc_path()})
    _sass_check(_build)


# library, kernel template, instantiations it has: the kernels whose
# products must run on the tensor cores
SASS_KERNELS = (("fused_conv", "conv_kernel", 2),
                ("flash_attention_fwd", "flash_fwd_kernel", 36),
                ("flash_attention_bwd", "flash_bwd_kernel", 12),
                ("fused_ce_fwd", "fused_ce_kernel", 4))


def _sass_check(_build):
    """Every instantiation of the conv kernel (conv_moments' and
    conv_apply's), of the flash forward and backward kernels (every
    head-dim width, f32 and bf16, padding-mask and per-query bias) and of
    the fused CE kernel (16- or 4-byte copies of x and of W) must carry its
    products on the tensor cores: cuobjdump's SASS of each built library
    shows HMMA instructions in each."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    for lib, kernel, n_inst in SASS_KERNELS:
        sass = subprocess.run([tool, "-sass", _build._lib_path(lib)],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0,
              "cuobjdump failed: " + sass.stderr[-2000:])
        hmma = {}
        for fn in sass.stdout.split("Function : ")[1:]:
            name = fn.split(None, 1)[0]
            if kernel in name:
                hmma[name] = sum(ln.split()[1].startswith("HMMA")
                                 for ln in fn.splitlines()
                                 if len(ln.split()) > 1)
        emit({"phase": "sass", "library": lib, "kernel": kernel,
              "instantiations": len(hmma), "hmma_per_instantiation": hmma})
        check(len(hmma) >= n_inst and all(hmma.values()),
              "%s instantiations without HMMA: %s" % (kernel, hmma))


def _padding_bias(torch, gen, b, tk, dev):
    lengths = torch.randint(1, tk + 1, (b,), generator=gen)
    return torch.where(torch.arange(tk)[None] < lengths[:, None], 0.0,
                       -1e9).to(dev)


def _rich_bias(torch, gen, b, h, tq, tk, dev):
    """A bias with one offset per (b, h, t, j), as relative positions give:
    the kernels read it by strides."""
    return torch.randn(b, h, tq, tk, generator=gen).to(dev)


def phase_flash_check(torch, dev):
    """Kernel vs plain version at the served shape and the causal cases.
    bf16: the plain version runs in f32 on the same bf16 inputs."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED)
    b, t, h = 8, BERT["seq"], BERT["heads"]
    d = BERT["d_model"] // h
    cases = [
        # name, B, Tq, Tk, H, D, causal, bias (None, "key" padding mask,
        # "full" one offset per logit), dtype, tolerance
        ("bert_f32", b, t, t, h, d, False, "key", torch.float32, 1e-4),
        ("bert_bf16", b, t, t, h, d, False, "key", torch.bfloat16, 2e-2),
        ("causal_square", 2, 128, 128, 4, 64, True, None, torch.float32,
         1e-4),
        ("causal_tq_lt_tk", 2, 64, 128, 4, 64, True, None, torch.float32,
         1e-4),
        ("causal_tq_gt_tk", 2, 128, 64, 4, 64, True, None, torch.float32,
         1e-4),
        # head dims 16 (width 16) and 512 (the columns split over 4 warps)
        ("d16_causal_129", 2, 129, 129, 4, 16, True, None, torch.float32,
         1e-4),
        ("d16_bf16", 2, 65, 65, 4, 16, False, "key", torch.bfloat16, 2e-2),
        ("d512_padded", 2, 65, 100, 2, 512, False, "key", torch.float32,
         1e-4),
        ("d512_bf16_causal", 1, 96, 96, 1, 512, True, None, torch.bfloat16,
         2e-2),
        # a rich bias, and head dim 12 (padded to 16 by the wrapper)
        ("d12_full_bias_causal", 2, 65, 100, 3, 12, True, "full",
         torch.float32, 1e-4),
        ("d64_full_bias_bf16", 2, 128, 128, 4, 64, False, "full",
         torch.bfloat16, 2e-2),
    ]
    errs = {}
    for name, b_, tq, tk, h_, d_, causal, bias_kind, dtype, tol in cases:
        q, k, v = (torch.randn(b_, n, h_ * d_, generator=gen).to(dev, dtype)
                   for n in (tq, tk, tk))
        bias = None
        if bias_kind == "key":
            bias = _padding_bias(torch, gen, b_, tk, dev)[:, None, None, :]
        elif bias_kind == "full":
            bias = _rich_bias(torch, gen, b_, h_, tq, tk, dev)
        out, lse = fa.flash_attention_fwd(q, k, v, h_, bias, causal)
        want, want_lse = fa.attention_plain(q.float(), k.float(), v.float(),
                                            h_, bias, causal)
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        live = want_lse > -1e30  # rows that see at least one key
        lse_err = (lse - want_lse)[live].abs().max().item()
        check(torch.equal(lse <= -1e30, ~live), name + ": masked rows differ")
        emit({"phase": "flash_attention_fwd", "case": name,
              "shape": [b_, tq, tk, h_, d_], "causal": causal,
              "bias": bias_kind, "dtype": str(dtype), "max_abs_err": err,
              "lse_err": lse_err, "tol": tol})
        check(err <= tol and lse_err <= max(tol, 1e-4),
              "flash %s error %g (lse %g) > %g" % (name, err, lse_err, tol))
        errs[name] = err
    return errs


def phase_ln_check(torch, dev):
    """Kernel vs plain version (in f32 on the same inputs). f32: y within
    1e-5 absolute. bf16: y within one bf16 ulp (2^-8 relative to |y|, at
    least 2^-8 absolute), since the kernel rounds y once to bf16. Mean and
    var are f32 in both: 1e-4 absolute."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    d = BERT["d_model"]
    g = torch.randn(d, generator=gen).to(dev)
    bb = torch.randn(d, generator=gen).to(dev)
    errs = {}
    for rows in (1024, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(dev, dtype)
            y, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
            wy, wm, wv = fln.layer_norm_plain(x.float(), g, bb, 1e-5)
            torch.cuda.synchronize()
            dy = (y.float() - wy).abs()
            if dtype == torch.float32:
                y_ok = dy.max().item() <= 1e-5
            else:
                y_ok = bool((dy <= 2.0 ** -8 * wy.abs().clamp_min(1.0)).all())
            e = (dy.max().item(), (mean - wm).abs().max().item(),
                 (var - wv).abs().max().item())
            name = "%dx%d_%s" % (rows, d, str(dtype).split(".")[1])
            emit({"phase": "layer_norm_fwd", "case": name,
                  "max_abs_err_y": e[0], "max_abs_err_mean": e[1],
                  "max_abs_err_var": e[2], "y_within_tol": y_ok,
                  "tol_y": "1e-5 abs" if dtype == torch.float32
                  else "2^-8 rel", "tol_stats": 1e-4})
            check(y_ok and e[1] <= 1e-4 and e[2] <= 1e-4,
                  "layer_norm %s errors %s" % (name, e))
            errs[name] = max(e)
    return errs


def phase_flash_bwd_check(torch, dev):
    """The flash kernels through their autograd Function (forward with
    dropout, backward) against autograd of the plain version on the same
    inputs and the same dropout seed, f32, TF32 off: first at the training
    path's own shape and configurations (B=128, T=Tk=256, H=8, D=64; the
    encoder self, decoder self and cross calls with dropout 0.1, and
    without dropout with the key bias requiring grad), then at ragged
    extras. dq is summed across key tiles with atomics, in no fixed order;
    tolerance 2e-4 * max(1, max|plain|) on out, dq, dk, dv and dbias."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED)
    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    h = TRANSFORMER["n_head"]
    d = TRANSFORMER["d_model"] // h
    cases = [
        # name, B, Tq, Tk, H, D, causal, bias ("key", "key1" broadcast
        # over B, "full" one offset per logit, "+grad": it requires grad),
        # dropout rate
        ("enc_self_bias_grad", b, t, t, h, d, False, "key+grad", 0.0),
        ("dec_self_causal", b, t, t, h, d, True, None, 0.0),
        ("enc_self_dropout_0.1", b, t, t, h, d, False, "key+grad", 0.1),
        ("dec_self_causal_dropout_0.1", b, t, t, h, d, True, None, 0.1),
        ("dec_cross_dropout_0.1", b, t, t, h, d, False, "key", 0.1),
        ("causal_tq_lt_tk", 2, 64, 128, 4, 64, True, None, 0.0),
        ("causal_tq_gt_tk", 2, 128, 64, 4, 64, True, "key", 0.0),
        ("ragged_100x77_d32", 3, 100, 77, 2, 32, False, "key1+grad", 0.0),
        ("causal_d128_dropout_0.1", 2, 96, 96, 2, 128, True, "key", 0.1),
        ("d16_causal_tq_gt_tk", 2, 129, 64, 4, 16, True, None, 0.0),
        ("d16_bias_grad_dropout_0.1", 2, 65, 65, 4, 16, False, "key+grad",
         0.1),
        ("d512_bias_grad", 1, 70, 129, 2, 512, False, "key+grad", 0.0),
        ("d512_causal_dropout_0.1", 1, 96, 96, 1, 512, True, None, 0.1),
        ("d12_full_bias_grad_dropout_0.1", 2, 65, 100, 3, 12, False,
         "full+grad", 0.1),
        ("causal_full_bias_grad", 4, 256, 256, 8, 64, True, "full+grad",
         0.0),
    ]
    errs = {}
    for i, (name, b_, tq, tk, h_, d_, causal, bias_kind, rate) in \
            enumerate(cases):
        q, k, v, dout = (torch.randn(b_, n, h_ * d_, generator=gen).to(dev)
                         for n in (tq, tk, tk, tq))
        kb = None
        if bias_kind is not None and bias_kind.startswith("full"):
            kb = _rich_bias(torch, gen, b_, h_, tq, tk, dev)
        elif bias_kind is not None:
            kb = _padding_bias(torch, gen, b_, tk, dev)
            if bias_kind.startswith("key1"):
                kb = kb[:1]
        bias_grad = bias_kind is not None and bias_kind.endswith("+grad")
        seed = (torch.tensor([1000 + i], dtype=torch.int64, device=dev)
                if rate > 0 else None)
        inputs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        kbk = kb.clone().requires_grad_(bias_grad) if kb is not None \
            else None
        out = fa._FlashAttention.apply(*inputs, kbk, seed, h_, causal, rate)
        wrt = inputs + ([kbk] if bias_grad else [])
        grads = torch.autograd.grad(out, wrt, dout)
        plain_in = [x.clone().requires_grad_(True) for x in (q, k, v)]
        kbp = kb.clone().requires_grad_(bias_grad) if kb is not None \
            else None
        want, _ = fa.attention_plain(*plain_in, h_, kbp, causal, rate, seed)
        pwrt = plain_in + ([kbp] if bias_grad else [])
        want_grads = torch.autograd.grad(want, pwrt, dout)
        torch.cuda.synchronize()
        pairs = [("out", out, want)] + list(zip(
            ("dq", "dk", "dv", "dbias"), grads, want_grads))
        errs[name] = check_close(
            "flash_attention_bwd", name, pairs, 2e-4,
            shape=[b_, tq, tk, h_, d_], causal=causal, bias=bias_kind,
            dropout=rate)
        del out, grads, want, want_grads, plain_in, inputs
    _flash_f64_check(torch, dev)
    return errs


def _flash_f64_check(torch, dev):
    """At the training shape (the encoder self-attention call, key
    padding bias) the kernels' out, dq, dk and dv and the plain version's
    f32 ones (cuBLAS, TF32 off) against the plain version in f64 on the
    same f32 inputs, by max abs and relative L2 error; fails if the
    kernels' error is more than twice the plain f32 one in either (a
    single TF32 pass would be about 1000 times off)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED + 2)
    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    h = TRANSFORMER["n_head"]
    d = TRANSFORMER["d_model"] // h
    q, k, v, dout = (torch.randn(b, t, h * d, generator=gen).to(dev)
                     for _ in range(4))
    kb = _padding_bias(torch, gen, b, t, dev)

    def run(fn, dtype):
        ins = [x.to(dtype).clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(ins, kb.to(dtype))
        return [out.detach()] + list(torch.autograd.grad(
            out, ins, dout.to(dtype)))

    def plain(ins, bias):
        return fa.attention_plain(*ins, h, bias)[0]

    exact = run(plain, torch.float64)
    ref = run(plain, torch.float32)
    got = run(lambda ins, bias: fa._FlashAttention.apply(
        *ins, bias, None, h, False, 0.0), torch.float32)
    torch.cuda.synchronize()

    def errs(x, want):
        dd = x.double() - want
        return {"max_abs_err": dd.abs().max().item(),
                "rel_l2": (dd.norm() / want.norm()).item()}

    names = ("out", "dq", "dk", "dv")
    kernel = {n: errs(g, e) for n, g, e in zip(names, got, exact)}
    plain_f32 = {n: errs(r, e) for n, r, e in zip(names, ref, exact)}
    emit({"phase": "flash_attention_f64", "shape": [b, t, t, h, d],
          "bias": "key", "kernel": kernel, "plain_f32": plain_f32,
          "ratio": {n: {e: kernel[n][e] / plain_f32[n][e]
                        for e in kernel[n]} for n in names},
          "tol": "kernel <= 2 x plain f32, each error"})
    check(all(kernel[n][e] <= 2 * plain_f32[n][e] for n in names
              for e in kernel[n]),
          "flash errors against f64 %s, plain f32 %s" % (kernel, plain_f32))


def phase_ln_bwd_check(torch, dev):
    """The LayerNorm kernels through their autograd Function against
    autograd of the plain version, f32: dx, dgamma, dbeta within 1e-4 *
    max(1, max|plain|) (dgamma/dbeta sum all rows, in another order)."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    rows = TRAIN_BATCH * TRANSFORMER["seq_len"]
    cases = [("train_%dx512" % rows, rows, 512, (True, True)),
             ("ragged_1000x768_gamma", 1000, 768, (True, False)),
             ("rows3x512_no_affine", 3, 512, (False, False))]
    errs = {}
    for name, n, d, affine in cases:
        x = (torch.randn(n, d, generator=gen) * 2 + 0.5).to(dev)
        dy = torch.randn(n, d, generator=gen).to(dev)
        g = torch.randn(d, generator=gen).to(dev) if affine[0] else None
        bb = torch.randn(d, generator=gen).to(dev) if affine[1] else None
        outs = []
        for via_kernel in (True, False):
            xs = x.clone().requires_grad_(True)
            gs = g.clone().requires_grad_(True) if g is not None else None
            bs = bb.clone().requires_grad_(True) if bb is not None else None
            if via_kernel:
                y = fln._FusedLN.apply(xs, gs, bs, 1e-5)[0]
            else:
                y = fln.layer_norm_plain(xs, gs, bs, 1e-5)[0]
            wrt = [t for t in (xs, gs, bs) if t is not None]
            outs.append(torch.autograd.grad(y, wrt, dy))
        torch.cuda.synchronize()
        names = ["dx"] + (["dgamma"] if g is not None else []) + (
            ["dbeta"] if bb is not None else [])
        errs[name] = check_close("layer_norm_bwd", name,
                                 list(zip(names, outs[0], outs[1])), 1e-4,
                                 shape=[n, d])
    return errs


# the fused CE kernel's ragged cases: name, T, D, V, bias, eps. T is never a
# multiple of the 128-row tile; V % 4 != 0 takes the 4-byte W copies, D %
# 4 != 0 the 4-byte x copies, D % 32 != 0 a ragged k chunk
CE_CASES = [("bias_1000x512x1000", 1000, 512, 1000, True, 0.1),
            ("eps0_777x72x300", 777, 72, 300, True, 0.0),
            ("v30001_1000x512x30001", 1000, 512, 30001, True, 0.1),
            ("v999_333x72x999", 333, 72, 999, False, 0.1),
            ("d75_200x75x1000", 200, 75, 1000, False, 0.1),
            ("d37_129x37x257", 129, 37, 257, True, 0.1)]


def _ce_inputs(torch, gen, dev, t, d, v, with_bias):
    """x, w, b (or None) and y on the card, with the labels of rows 0 and 1
    at 0 and V - 1 and row 2 of x zero (all its logits equal without a
    bias)."""
    x = torch.randn(t, d, generator=gen)
    x[2] = 0.0
    w = torch.randn(d, v, generator=gen) / d ** 0.5
    b = torch.randn(v, generator=gen).to(dev) if with_bias else None
    y = torch.randint(0, v, (t,), generator=gen)
    y[0], y[1] = 0, v - 1
    return x.to(dev), w.to(dev), b, y.to(dev)


def phase_ce_check(torch, dev):
    """The fused CE kernel against the plain projection + closed-form CE
    (loss and lse, within 2e-5 * max(1, max|plain|)), at the slice's shape
    and at the ragged ``CE_CASES``, each run twice for bitwise equal
    results; its autograd Function (kernel forward, chunked backward)
    against autograd of the plain version (dx, dW within 1e-4 *
    max(1, max|plain|)); then ``fused_ce_f64``."""
    from paddle_tpu_torch.ops import fused_ce as fce

    gen = torch.Generator().manual_seed(SEED)
    rows = TRAIN_BATCH * TRANSFORMER["seq_len"]
    d, v = TRANSFORMER["d_model"], TRANSFORMER["trg_vocab"]
    cases = [("train_%dx%dx%d" % (rows, d, v), rows, d, v, False, 0.1)]
    errs = {}
    for name, t, d_, v_, with_bias, eps in cases + CE_CASES:
        x, w, b, y = _ce_inputs(torch, gen, dev, t, d_, v_, with_bias)
        loss, lse = fce.fused_ce_fwd(x, w, b, y, eps)
        again = fce.fused_ce_fwd(x, w, b, y, eps)
        want, want_lse = fce.linear_smooth_ce_plain(x, w, b, y, eps)
        torch.cuda.synchronize()
        same = torch.equal(loss, again[0]) and torch.equal(lse, again[1])
        errs[name] = check_close("fused_ce_fwd", name,
                                 [("loss", loss, want), ("lse", lse,
                                                         want_lse)],
                                 2e-5, shape=[t, d_, v_], eps=eps,
                                 bias=with_bias, bitwise_repeat=same,
                                 plan=list(fce.split_plan(
                                     t, v_, torch.cuda.get_device_properties(
                                         dev).multi_processor_count)))
        check(same, "fused_ce_fwd %s: two runs differ" % name)
        del want, want_lse, x, w, b, y, loss, lse, again
    # the Function: kernel forward + chunked backward, at 4,096 rows
    t = 4096
    x = torch.randn(t, d, generator=gen).to(dev)
    w = (torch.randn(d, v, generator=gen) / d ** 0.5).to(dev)
    y = torch.randint(0, v, (t,), generator=gen).to(dev)
    g = torch.randn(t, generator=gen).to(dev)
    grads = []
    for via_kernel in (True, False):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if via_kernel:
            loss = fce._FusedCE.apply(xs, ws, None, y, 0.1)
        else:
            loss = fce.linear_smooth_ce_plain(xs, ws, None, y, 0.1)[0]
        grads.append(torch.autograd.grad(loss, (xs, ws), g))
    torch.cuda.synchronize()
    check_close("fused_ce_fwd", "function_grads_%dx%dx%d" % (t, d, v),
                list(zip(("dx", "dw"), grads[0], grads[1])), 1e-4,
                shape=[t, d, v])
    del grads
    _ce_f64_check(torch, dev)
    return errs


def _ce_f64(torch, x, w, b, y, eps):
    """The projection and the closed-form smoothed CE in float64."""
    z = torch.matmul(x.double(), w.double())
    if b is not None:
        z = z + b.double()
    lse = torch.logsumexp(z, dim=-1)
    zy = z.gather(1, y.long()[:, None])[:, 0]
    return lse - (1.0 - eps) * zy - eps * z.mean(dim=-1), lse


def _ce_f64_check(torch, dev):
    """The kernel's loss and lse and the plain version's f32 ones (cuBLAS,
    TF32 off) against the projection and CE in f64 on the same f32 inputs,
    by max abs and relative L2 error, at 4,096 rows of the training width
    (D 512, V 30000) and at 4,097 rows of each ragged case; fails if the
    kernel's error is more than twice the plain f32 one in either (a single
    TF32 product would be 54-530 times off, as the CPU emulation shows)."""
    from paddle_tpu_torch.ops import fused_ce as fce

    gen = torch.Generator().manual_seed(SEED + 3)
    d, v = TRANSFORMER["d_model"], TRANSFORMER["trg_vocab"]
    cases = [("train_4096x%dx%d" % (d, v), 4096, d, v, False, 0.1)] + [
        (name.split("_")[0] + "_4097x%dx%d" % (d_, v_), 4097, d_, v_, bias,
         eps) for name, _, d_, v_, bias, eps in CE_CASES]
    for name, t, d_, v_, with_bias, eps in cases:
        x, w, b, y = _ce_inputs(torch, gen, dev, t, d_, v_, with_bias)
        exact = _ce_f64(torch, x, w, b, y, eps)
        got = fce.fused_ce_fwd(x, w, b, y, eps)
        ref = fce.linear_smooth_ce_plain(x, w, b, y, eps)
        torch.cuda.synchronize()

        def errs(out, want):
            dd = out.double() - want
            return {"max_abs_err": dd.abs().max().item(),
                    "rel_l2": (dd.norm() / want.norm()).item()}

        names = ("loss", "lse")
        kernel = {n: errs(g, e) for n, g, e in zip(names, got, exact)}
        plain = {n: errs(r, e) for n, r, e in zip(names, ref, exact)}
        ratio = {n: {e: kernel[n][e] / max(plain[n][e], 1e-30)
                     for e in kernel[n]} for n in names}
        emit({"phase": "fused_ce_f64", "case": name, "shape": [t, d_, v_],
              "bias": with_bias, "eps": eps, "kernel": kernel,
              "plain_f32": plain, "ratio": ratio,
              "tol": "kernel <= 2 x plain f32, each error"})
        check(all(kernel[n][e] <= 2 * plain[n][e] for n in names
                  for e in kernel[n]),
              "fused_ce %s errors against f64 %s, plain f32 %s"
              % (name, kernel, plain))
        del x, w, b, y, exact, got, ref


def phase_timing(torch, dev):
    """Each kernel at the served shapes (the top batch rung, 8 x 128
    tokens, f32), beside its plain version, one PyTorch library call as a
    yardstick (timed here only; the port never calls it), and its bound."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    rows = flash_kernel_timing(torch, dev, gen)
    b, t, hd = 8, BERT["seq"], BERT["d_model"]
    n_rows = b * t
    x = torch.randn(n_rows, hd, generator=gen).to(dev)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    nbytes = 4 * (2 * n_rows * hd + 2 * hd + 2 * n_rows)
    flops = 8 * n_rows * hd
    bnd, by = bound(nbytes, flops)
    rows["layer_norm_fwd"] = dict(
        ms=time_ms(lambda: fln.layer_norm_fwd(x, g, bb, 1e-5)),
        plain_ms=time_ms(lambda: fln.layer_norm_plain(x, g, bb, 1e-5)),
        library_ms=time_ms(lambda: F.layer_norm(x, (hd,), g, bb, 1e-5)),
        bound_ms=bnd, bound_by=by, shape=[n_rows, hd], bytes=nbytes,
        flops=flops)
    train = _train_kernel_timing(torch, dev, gen)
    rows["layer_norm_fwd"]["trained_shape"] = train.pop("layer_norm_fwd")
    rows.update(train)
    rows.update(_conv_kernel_timing(torch, dev))
    rows.update(_scatter_kernel_timing(torch, dev))
    for name, r in rows.items():
        emit(dict({"phase": "timing", "kernel": name}, **r))
    return rows


def flash_kernel_timing(torch, dev, gen):
    """The flash kernels (rows 1-6), f32, key padding bias, each beside its
    plain version, ``F.scaled_dot_product_attention`` as a yardstick (timed
    here only; the port never calls it) and its bound: the forward at
    BERT-base's served shape (8 x 128 tokens, 12 heads of 64) with the
    training shape's row in ``trained_shape``, and the backward at
    Transformer-base's training shape (128 x 256 tokens, 8 heads of 64,
    the encoder self-attention call). ``tools/flash_ab.py`` times another
    checkout's kernels through this function."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    rows = {}
    b, t, h = 8, BERT["seq"], BERT["heads"]
    hd = BERT["d_model"]
    d = hd // h
    q, k, v = (torch.randn(b, t, hd, generator=gen).to(dev) for _ in range(3))
    kb = _padding_bias(torch, gen, b, t, dev)
    bias4 = kb[:, None, None, :]
    qh, kh, vh = (x.view(b, t, h, d).transpose(1, 2) for x in (q, k, v))
    nbytes = 4 * (4 * b * t * hd + b * t + b * h * t)
    flops = 4 * b * h * t * t * d
    bnd, by, bnd_fma = tensor_core_bound(nbytes, flops)
    rows["flash_attention_fwd"] = dict(
        ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, h, kb)),
        plain_ms=time_ms(lambda: fa.attention_plain(q, k, v, h, bias4)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias4)),
        bound_ms=bnd, bound_by=by, bound_ms_f32_fma=bnd_fma,
        shape=[b, t, t, h, d], bytes=nbytes, flops=flops)

    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    h, hd = TRANSFORMER["n_head"], TRANSFORMER["d_model"]
    d = hd // h
    q, k, v, dout = (torch.randn(b, t, hd, generator=gen).to(dev)
                     for _ in range(4))
    kb = _padding_bias(torch, gen, b, t, dev)
    out, lse = fa.flash_attention_fwd(q, k, v, h, kb)
    plain_in = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain_out, _ = fa.attention_plain(*plain_in, h, kb)

    def split(x):
        return x.view(b, t, h, d).transpose(1, 2)

    lib_in = [split(x).detach().requires_grad_(True) for x in (q, k, v)]
    mask = kb[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=mask)
    lib_dout = split(dout)

    # flash forward at the same shape: the step launches it 18 times
    nbytes = 4 * (4 * b * t * hd + b * t + b * h * t)
    flops = 4 * b * h * t * t * d
    bnd, by, bnd_fma = tensor_core_bound(nbytes, flops)
    rows["flash_attention_fwd"]["trained_shape"] = dict(
        ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, h, kb), iters=20),
        plain_ms=time_ms(lambda: fa.attention_plain(q, k, v, h, kb),
                         iters=20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=mask), iters=20),
        library="F.scaled_dot_product_attention",
        bound_ms=bnd, bound_by=by, bound_ms_f32_fma=bnd_fma,
        shape=[b, t, t, h, d], bytes=nbytes, flops=flops)

    nbytes = 4 * (8 * b * t * hd + b * h * t + b * t)
    flops = 10 * b * h * t * t * d
    bnd, by, bnd_fma = tensor_core_bound(nbytes, flops)
    rows["flash_attention_bwd"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, h,
                                                  kb), iters=20),
        plain_ms=time_ms(lambda: torch.autograd.grad(
            plain_out, plain_in, dout, retain_graph=True), iters=20),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, lib_in, lib_dout, retain_graph=True), iters=20),
        library="F.scaled_dot_product_attention backward (autograd)",
        bound_ms=bnd, bound_by=by, bound_ms_f32_fma=bnd_fma,
        shape=[b, t, t, h, d], bytes=nbytes, flops=flops)
    return rows


def _train_kernel_timing(torch, dev, gen):
    """The LayerNorm forward and backward and fused CE kernels at
    Transformer-base's training shapes (128 x 256 tokens, f32), each beside
    its plain version, one PyTorch call as a yardstick (timed here only; the
    port never calls it) and its bound. The CE's yardstick is its projection
    alone, ``torch.matmul(x, w)`` (cuBLAS SGEMM, TF32 off); no single call
    computes the fused function."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_ce as fce
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    rows = {}
    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    hd = TRANSFORMER["d_model"]

    # LayerNorm forward and backward: one [B*T, 512] normalisation (the
    # step launches each 32 times at this shape)
    n = b * t
    x = torch.randn(n, hd, generator=gen).to(dev)
    dy = torch.randn(n, hd, generator=gen).to(dev)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    nbytes = 4 * (2 * n * hd + 2 * hd + 2 * n)
    flops = 8 * n * hd
    bnd, by = bound(nbytes, flops)
    rows["layer_norm_fwd"] = dict(
        ms=time_ms(lambda: fln.layer_norm_fwd(x, g, bb, 1e-5)),
        plain_ms=time_ms(lambda: fln.layer_norm_plain(x, g, bb, 1e-5)),
        library_ms=time_ms(lambda: F.layer_norm(x, (hd,), g, bb, 1e-5)),
        library="F.layer_norm", bound_ms=bnd, bound_by=by, shape=[n, hd],
        bytes=nbytes, flops=flops)
    _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
    p_in = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
            bb.clone().requires_grad_(True)]
    p_out = fln.layer_norm_plain(*p_in, 1e-5)[0]
    l_in = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
            bb.clone().requires_grad_(True)]
    l_out = F.layer_norm(l_in[0], (hd,), l_in[1], l_in[2], 1e-5)
    nbytes = 4 * (3 * n * hd + 2 * n + 3 * hd)
    flops = 12 * n * hd
    bnd, by = bound(nbytes, flops)
    rows["layer_norm_bwd"] = dict(
        ms=time_ms(lambda: fln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)),
        plain_ms=time_ms(lambda: torch.autograd.grad(p_out, p_in, dy,
                                                      retain_graph=True)),
        library_ms=time_ms(lambda: torch.autograd.grad(l_out, l_in, dy,
                                                       retain_graph=True)),
        library="F.layer_norm backward (autograd)",
        bound_ms=bnd, bound_by=by, shape=[n, hd], bytes=nbytes, flops=flops)
    del p_out, p_in, l_out, l_in

    # fused CE forward: the loss head, [B*T, 512] x [512, 30000]
    v = TRANSFORMER["trg_vocab"]
    x = torch.randn(n, hd, generator=gen).to(dev)
    w = (torch.randn(hd, v, generator=gen) / hd ** 0.5).to(dev)
    y = torch.randint(0, v, (n,), generator=gen).to(dev)
    nbytes = 4 * (n * hd + hd * v + n + 2 * n)
    flops = 2 * n * hd * v
    bnd, by, bnd_fma = tensor_core_bound(nbytes, flops)
    rows["fused_ce_fwd"] = dict(
        ms=time_ms(lambda: fce.fused_ce_fwd(x, w, None, y, 0.1), iters=10,
                   warmup=2),
        plain_ms=time_ms(lambda: fce.linear_smooth_ce_plain(x, w, None, y,
                                                            0.1),
                         iters=10, warmup=2),
        library_ms=time_ms(lambda: torch.matmul(x, w), iters=10, warmup=2),
        library="torch.matmul(x, w), projection only (cuBLAS SGEMM, TF32 "
                "off)",
        bound_ms=bnd, bound_by=by, bound_ms_f32_fma=bnd_fma,
        plan=list(fce.split_plan(n, v, torch.cuda.get_device_properties(
            dev).multi_processor_count)),
        shape=[n, hd, v], bytes=nbytes, flops=flops)
    return rows


def build_bert_classifier(fluid):
    """The served model: BERT-base encoder + [CLS] classifier head
    (user code, as in ``paddle_tpu/models/bert.py:90-93``)."""
    L = fluid.layers
    s = BERT["seq"]
    input_ids = L.data("input_ids", shape=[s], dtype="int64")
    segment_ids = L.data("segment_ids", shape=[s], dtype="int64")
    input_len = L.data("input_len", shape=[], dtype="int64")
    x = fluid.models.bert.bert_encoder(
        input_ids, segment_ids, input_len, s, BERT["vocab"], BERT["d_model"],
        BERT["d_ff"], BERT["heads"], BERT["layers"], dropout_rate=0.0)
    cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    pooled = L.fc(cls, size=BERT["d_model"], act="tanh", name="pooler")
    return L.softmax(L.fc(pooled, size=2, name="cls_out"))


def phase_serve(torch, smi_line, n_requests=1000, in_flight=32):
    """The main path. ``n_requests`` requests of 1-4 rows arrive in a
    closed loop that keeps ``in_flight`` of them outstanding (a few seconds
    of traffic, so the rate and p99 rest on a thousand samples). Launch
    counts are zeroed just before it and read just after; the CPU
    comparison runs the plain versions and launches nothing."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(SEED)
    s = BERT["seq"]
    feeds = []
    for _ in range(n_requests):
        n = int(rng.randint(1, 5))
        feeds.append({
            "input_ids": rng.randint(0, BERT["vocab"], (n, s)),
            "segment_ids": rng.randint(0, 2, (n, s)),
            "input_len": rng.randint(1, s + 1, (n,))})

    reset_counts()
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        prob = build_bert_classifier(fluid)
    startup.random_seed = SEED
    exe = fluid.Executor()  # default place: CUDAPlace(0)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        model_dir = tempfile.mkdtemp(prefix="bert_base_")
        fluid.io.save_inference_model(
            model_dir, ["input_ids", "segment_ids", "input_len"], [prob],
            exe, main_program=main)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    del scope
    t_setup = time.perf_counter() - t0

    engine = fluid.serving.ServingEngine(model_dir, num_replicas=1,
                                         max_batch_size=8)
    try:
        t0 = time.perf_counter()
        warmed = engine.warmup()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        futures = []
        for i, f in enumerate(feeds):
            if i >= in_flight:
                futures[i - in_flight].result(timeout=300)
            futures.append(engine.submit(f))
        results = [f.result(timeout=300)[0] for f in futures]
        wall = time.perf_counter() - t0
        snap = engine.metrics()
    finally:
        engine.shutdown()
    launches = read_counts()
    dispatches = warmed + snap["batches"]

    for f, r in zip(feeds, results):
        check(r.shape == (f["input_ids"].shape[0], 2),
              "served shape %s" % (r.shape,))
        check(np.isfinite(r).all(), "non-finite probabilities")
        check(np.abs(r.sum(1) - 1.0).max() <= 1e-5, "rows do not sum to 1")

    # two requests against the port on the CPU, same weights (plain versions)
    config = fluid.inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    cpu = fluid.inference.Predictor(config)
    cpu_err = 0.0
    for i in (0, n_requests - 1):
        want, = cpu.run(feeds[i])
        cpu_err = max(cpu_err, float(np.abs(results[i] - want).max()))
    check(read_counts() == launches, "the CPU check launched a kernel")
    phase_profile(torch, fluid, model_dir, feeds)
    shutil.rmtree(model_dir)

    lat = snap["latency_s"]
    emit({"phase": "serve", "model": "bert_base_classifier", "config": BERT,
          "params": n_params, "requests": n_requests,
          "arrival": "closed loop", "in_flight": in_flight,
          "rows": int(sum(f["input_ids"].shape[0] for f in feeds)),
          "requests_per_s": n_requests / wall, "wall_s": wall,
          "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3,
          "batches": snap["batches"], "avg_batch_size": snap["avg_batch_size"],
          "batch_occupancy": snap["batch_occupancy"], "warmup_runs": warmed,
          "warmup_s": t_warm, "setup_s": t_setup, "dispatches": dispatches,
          "launches": launches, "cpu_max_abs_err": cpu_err,
          "device": smi_line})
    check(snap["requests_completed"] == n_requests
          and snap["requests_failed"] == 0, "requests failed: %s" % snap)
    check(cpu_err <= 1e-4, "served vs CPU error %g > 1e-4" % cpu_err)
    check(launches["flash_attention_fwd"] == BERT["layers"] * dispatches,
          "flash launches %d != %d layers x %d dispatches"
          % (launches["flash_attention_fwd"], BERT["layers"], dispatches))
    check(launches["layer_norm_fwd"] == (2 * BERT["layers"] + 1) * dispatches,
          "layer_norm launches %d != %d x %d dispatches"
          % (launches["layer_norm_fwd"], 2 * BERT["layers"] + 1,
             dispatches))
    return launches


def phase_profile(torch, fluid, model_dir, feeds, runs=20):
    """Where one 8-row dispatch's time goes: device time of every CUDA
    kernel by kind (torch.profiler), against the host wall time of the
    same number of runs made without the profiler, whose CPU tracing
    slows the host; after the main path, so its launches are not
    counted."""
    from torch.profiler import ProfilerActivity, profile

    pred = fluid.inference.Predictor(model_dir)
    batch = {k: np.concatenate([f[k] for f in feeds])[:8] for k in feeds[0]}
    pred.run(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        pred.run(batch)  # fetches to numpy: ends synchronised
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            pred.run(batch)
        prof_wall = time.perf_counter() - t0
    kinds = {"flash_attention_fwd": 0.0, "layer_norm_fwd": 0.0, "gemm": 0.0,
             "other": 0.0}
    n_kernels = 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        n_kernels += e.count
        name = e.key.lower()
        kind = ("flash_attention_fwd" if "flash_fwd_kernel" in name
                else "layer_norm_fwd" if "layer_norm_fwd_kernel" in name
                else "gemm" if ("gemm" in name or "cutlass" in name
                                or "xmma" in name) else "other")
        kinds[kind] += us
    per_run = {k: v / runs / 1e3 for k, v in kinds.items()}
    busy = sum(per_run.values())
    wall_ms = wall / runs * 1e3
    emit({"phase": "profile", "rows": 8, "runs": runs,
          "wall_ms_per_dispatch": wall_ms,
          "profiled_wall_ms_per_dispatch": prof_wall / runs * 1e3,
          "device_ms_per_dispatch": per_run,
          "kernels_per_dispatch": n_kernels / runs,
          "device_busy_share": busy / wall_ms if wall_ms else None})


def build_transformer(fluid, dropout_rate):
    """Transformer-base with Adam(1e-4), as paddle_tpu's bench.py trains
    it, in fresh programs. Returns (main, startup, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.transformer.transformer_base(
            dropout_rate=dropout_rate, **TRANSFORMER)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(spec.loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, spec


PER_STEP = per_run(flash_attention_fwd=3 * TRANSFORMER["n_layer"],
                   flash_attention_bwd=3 * TRANSFORMER["n_layer"],
                   layer_norm_fwd=5 * TRANSFORMER["n_layer"] + 2,
                   layer_norm_bwd=5 * TRANSFORMER["n_layer"] + 2,
                   fused_ce_fwd=1)


def phase_train_check(torch, smi_line, batch=2):
    """One full-width step (dropout 0) on the card and the same step with
    the port on the CPU (plain versions), from the same weights and feed
    (f32, TF32 off): loss, the global grad norm and five named parameters'
    grad norms agree within 1e-4 relative, and every parameter's gradient
    within 1e-2 in relative L2 error (|card - CPU| / |CPU|), which a wrong
    direction or a wrong gradient in any parameter exceeds by far. An
    element-wise bound cannot hold across the whole net: a ReLU input
    within rounding of 0 may take another sign on the card than on the
    CPU, which moves that unit's column of the FFN weight gradient by one
    token's whole contribution. It reports those sign flips and the
    largest element-wise error (over the parameter's max |CPU grad|)."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_transformer(fluid, dropout_rate=0.0)
    names = [p.name for p in main.all_parameters()]
    gb = main.global_block()
    relu_in = [op.input("X").name for op in gb.ops if op.type == "relu"]
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in names] + relu_in
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    seq = TRANSFORMER["seq_len"]
    feed["src_len"] = np.array([seq, seq * 3 // 4][:batch], "int64")
    feed["trg_len"] = np.array([seq, seq * 2 // 3][:batch], "int64")

    gpu_scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    reset_counts()
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = read_counts()
    check(counts == PER_STEP, "train_check launches %s != %s"
          % (counts, PER_STEP))

    cpu_scope = fluid.Scope()
    cexe = fluid.Executor(fluid.CPUPlace())
    cexe.run(startup, scope=cpu_scope)
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    t0 = time.perf_counter()
    cpu = cexe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    check(read_counts() == counts, "the CPU step launched a kernel")

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    n_p = len(names)
    gnorm = [float(np.sqrt(sum(float(np.square(g.astype("f8")).sum())
                               for g in run[1:1 + n_p])))
             for run in (gpu, cpu)]
    last = TRANSFORMER["n_layer"] - 1
    named = ["src_word_emb", "enc0_attn.q", "dec%d_cross.k" % last,
             "dec%d_ffn_fc1.w" % last, "out_proj.w"]
    norms = {}
    for n in named:
        i = 1 + names.index(n)
        norms[n] = [float(np.linalg.norm(run[i].astype("f8")))
                    for run in (gpu, cpu)]
    l2, elem = {}, {}
    for n, g, c in zip(names, gpu[1:1 + n_p], cpu[1:1 + n_p]):
        diff = np.abs(g.astype("f8") - c)
        l2[n] = float(np.linalg.norm(diff)) / max(
            float(np.linalg.norm(c.astype("f8"))), 1e-30)
        elem[n] = (float(diff.max()) / max(float(np.abs(c).max()), 1e-30),
                   [int(i) for i in np.unravel_index(diff.argmax(),
                                                     diff.shape)])
    worst_l2 = max(l2, key=l2.get)
    worst_elem = max(elem, key=lambda n: elem[n][0])
    flips = {}
    for n, a, c in zip(relu_in, gpu[1 + n_p:], cpu[1 + n_p:]):
        at = np.argwhere((a > 0) != (c > 0))
        if len(at):
            flips[n] = {"count": len(at), "units": sorted(
                {int(i[-1]) for i in at}), "max_abs_input": max(
                max(abs(float(a[tuple(i)])), abs(float(c[tuple(i)])))
                for i in at)}
    errs = {"loss": rel(float(gpu[0]), float(cpu[0])),
            "grad_norm": rel(*gnorm)}
    errs.update({"grad_norm:" + n: rel(*v) for n, v in norms.items()})
    emit({"phase": "train_check", "batch": batch, "config": TRANSFORMER,
          "dropout": 0.0, "loss_gpu": float(gpu[0]),
          "loss_cpu": float(cpu[0]), "grad_norm_gpu": gnorm[0],
          "grad_norm_cpu": gnorm[1], "named_grad_norms": norms,
          "rel_errors": errs, "tol_rel": 1e-4, "grads_compared": n_p,
          "grad_rel_l2_max": l2[worst_l2], "grad_rel_l2_param": worst_l2,
          "tol_rel_l2": 1e-2, "grad_max_elem": elem[worst_elem][0],
          "grad_max_elem_param": worst_elem,
          "grad_max_elem_index": elem[worst_elem][1],
          "relu_sign_flips": flips, "launches": counts,
          "cpu_step_s": cpu_s, "device": smi_line})
    check(np.isfinite([float(gpu[0]), gnorm[0]]).all(),
          "non-finite loss or grads on the card")
    check(max(errs.values()) <= 1e-4, "train_check errors %s" % errs)
    check(l2[worst_l2] <= 1e-2, "train_check: %s gradient off by %g (rel L2)"
          % (worst_l2, l2[worst_l2]))
    return errs


_MARKS = (("flash_fwd_kernel", "flash_attention_fwd"),
          ("flash_bwd_kernel", "flash_attention_bwd"),
          ("layer_norm_fwd_kernel", "layer_norm_fwd"),
          ("layer_norm_bwd_", "layer_norm_bwd"),
          ("fused_ce_", "fused_ce_fwd"),
          ("moments_reduce", "conv_moments"),
          ("bn_apply_kernel", "bn_apply"),
          ("scatter_add_kernel", "scatter_add"))
_CUDNN_MARKS = ("convolve", "conv2d", "_conv", "dgrad", "wgrad", "fprop",
                "winograd", "implicit_gemm", "cudnn")


def _kernel_kind(name):
    """The kind of a device kernel by its (lower-case) name: one of the
    port's kernels (``conv_kernel<BM, KS, STRIDE, VEC, APPLY>``: APPLY false
    is conv_moments' main launch, true conv_apply's), a cuDNN convolution, a
    GEMM, a row gather (``index_select``, indexing), or other."""
    if "conv_kernel<" in name:
        args = name.split("conv_kernel<", 1)[1].split(">", 1)[0]
        apply = args.replace(" ", "").split(",")[-1]
        check(apply in ("true", "false"), "conv kernel name %r" % name)
        return "conv_apply" if apply == "true" else "conv_moments"
    kind = next((k for m, k in _MARKS if m in name), None)
    if kind is not None:
        return kind
    if any(m in name for m in _CUDNN_MARKS):
        return "cudnn_conv"
    if "gemm" in name or "cutlass" in name or "xmma" in name:
        return "gemm"
    if "indexselect" in name or "gather" in name or "index_kernel" in name:
        return "gather"
    return "other"


def _profile_steps(torch, run_step, steps):
    """Device ms per step by kind over ``steps`` training steps under
    torch.profiler, kernels per step, the profiled wall per step, and the
    eight costliest kernels of kind "other" as [name, ms, launches] per
    step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        wall = time.perf_counter() - t0
    kinds = dict.fromkeys(("gemm", "cudnn_conv", "gather") + KERNELS
                          + ("other",), 0.0)
    n_kernels = 0
    other = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        n_kernels += e.count
        kind = _kernel_kind(e.key.lower())
        kinds[kind] += us
        if kind == "other":
            other.append([e.key[:120], us / steps / 1e3, e.count / steps])
    return ({k: v / steps / 1e3 for k, v in kinds.items()},
            n_kernels / steps, wall / steps * 1e3,
            sorted(other, key=lambda r: -r[1])[:8])


def phase_train(torch, smi_line, flash_ms, warmup=3, steps=20,
                prof_steps=3):
    """The main path: Transformer-base trained with dropout 0.1 and
    Adam(1e-4) at 128 x 256 tokens per step on one fixed batch (an
    overfit check). Launch counts are zeroed just before the first step
    and read after the last; every step must launch each kernel exactly
    PER_STEP times. The flash kernels' profiled ms per step is printed
    beside ``flash_ms`` (the ``timing`` phase's ms at the training shape)
    times their launches per step."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    main, startup, spec = build_transformer(fluid, dropout_rate=0.1)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(TRAIN_BATCH, np.random.RandomState(SEED))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, step_s = [], []

    def run_step():
        before = read_counts()
        t = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                        scope=scope)  # to numpy: ends synchronised
        dt = time.perf_counter() - t
        after = read_counts()
        per = {k: after[k] - before[k] for k in after}
        check(per == PER_STEP, "step %d launches %s != %s"
              % (len(losses), per, PER_STEP))
        losses.append(float(loss))
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        dt = run_step()
        if i >= warmup:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    device_ms, kernels_per_step, prof_wall_ms, top_other = _profile_steps(
        torch, run_step, prof_steps)
    launches = read_counts()

    tokens = TRAIN_BATCH * TRANSFORMER["seq_len"]
    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    flops = spec.flops_per_example * TRAIN_BATCH
    emit({"phase": "train", "model": "transformer_base",
          "config": dict(TRANSFORMER, dropout_rate=0.1), "params": n_params,
          "batch": TRAIN_BATCH, "tokens_per_step": tokens,
          "optimizer": "Adam(1e-4)", "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "tokens_per_s": tokens / med,
          "model_tflops_per_s": flops / med / 1e12,
          "losses": losses, "peak_memory_bytes": peak,
          "device_ms_per_step": device_ms,
          "kernels_per_step": kernels_per_step,
          "top_other_kernels": top_other,
          "profiled_wall_ms_per_step": prof_wall_ms,
          "device_busy_share": busy / (med * 1e3),
          "fused_ce_share_of_device": device_ms["fused_ce_fwd"] / busy,
          "flash_ms_per_step": {
              name: {"profiled": device_ms[name],
                     "timing_x_launches": flash_ms[name] * PER_STEP[name]}
              for name in ("flash_attention_fwd", "flash_attention_bwd")},
          "launches": launches, "launches_per_step": PER_STEP,
          "setup_s": setup_s, "device": smi_line})
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(device_ms["flash_attention_fwd"] > 0
          and device_ms["flash_attention_bwd"] > 0,
          "profiled flash kernels not recognised: %s" % device_ms)
    n_steps = warmup + steps + prof_steps
    check(launches == {k: n * n_steps for k, n in PER_STEP.items()},
          "train launches %s" % launches)
    return launches


# ---------------------------------------------------------------------------
# ResNet-50: the fused conv + BN (+ residual)(+ relu) kernels
# ---------------------------------------------------------------------------

# ResNet-50's own conv -> BN geometries at batch 128: name, C_in, C_out, k,
# stride, H = W, residual, relu
CONV_GEOMS = [
    ("reduce_1x1_256to64_56", 256, 64, 1, 1, 56, False, True),
    ("body_3x3_64to64_56", 64, 64, 3, 1, 56, False, True),
    ("expand_1x1_64to256_56_res", 64, 256, 1, 1, 56, True, True),
    ("shortcut_1x1s2_256to512_56", 256, 512, 1, 2, 56, False, False),
    ("body_3x3_512to512_7", 512, 512, 3, 1, 7, False, True),
]
RESNET_PER_STEP = per_run(conv_moments=49, bn_apply=49)
RESNET_PER_EVAL = per_run(conv_apply=49)
# the four chains outside supported_geometry, which replay their ops
RESNET_DECLINED = [((64, 3, 7, 7), [2, 2]), ((128, 128, 3, 3), [2, 2]),
                   ((256, 256, 3, 3), [2, 2]), ((512, 512, 3, 3), [2, 2])]


def _conv_case(torch, gen, dev, c, o, k, stride, hw, residual,
               n=RESNET_BATCH):
    """x, w (He-scaled), gamma, beta, moving mean, moving var, residual."""
    ho = (hw - 1) // stride + 1

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    return (randn(n, c, hw, hw), randn(o, c, k, k) * (2.0 / (c * k * k))
            ** 0.5, rand(o) + 0.5, randn(o) * 0.1, randn(o) * 0.1,
            rand(o) + 0.5, randn(n, o, ho, ho) if residual else None)


def phase_fused_conv_check(torch, dev, eps=1e-5, momentum=0.9, tol=1e-4):
    """The three fused-conv kernels against their plain versions at
    ResNet-50's geometries, batch 128, f32, TF32 off: conv_moments (co, and
    the moments as mean and mean square), bn_apply on the plain co, the
    training forward through ``fused_conv_bn_act`` (y, mean_out, var_out,
    saved mean and variance) against the unfused math, ``_FusedTrain``'s
    backward (dx, dw, dgamma, dbeta, dres) against autograd through the
    plain composition (cuDNN's conv), with dy zeroed on both sides where
    the two forwards' relu masks differ (their count is emitted), and
    conv_apply (inference). Tolerance tol * max(1, max|plain|): the conv
    sums up to 4,608 products per output and the moments 401,408 outputs
    per channel, in other orders than cuDNN and torch.sum. Then the moments
    must be bitwise equal across two runs, and at the 3x3 geometries the
    conv's error against an f64 conv at most twice cuDNN's f32 one
    (:func:`_conv_f64_check`)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = dict.fromkeys(("conv_moments", "bn_apply", "conv_apply"), 0.0)
    for name, c, o, k, stride, hw, residual, relu in CONV_GEOMS:
        x, w, g, b, mean, var, res = _conv_case(torch, gen, dev, c, o, k,
                                                stride, hw, residual)
        pad = (k - 1) // 2
        shape = dict(x=list(x.shape), w=list(w.shape), stride=stride,
                     residual=residual, relu=relu)
        co, s1, s2 = fc.conv_moments(x, w, stride)
        wco, ws1, ws2 = fc.conv_moments_plain(x, w, stride)
        count = wco.numel() // o
        torch.cuda.synchronize()
        errs["conv_moments"] = max(errs["conv_moments"], check_close(
            "fused_conv_check", name, [("co", co, wco),
                                   ("mean", s1 / count, ws1 / count),
                                   ("mean_sq", s2 / count, ws2 / count)],
            tol, check="conv_moments", **shape))
        again = fc.conv_moments(x, w, stride)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((co, s1, s2), again)),
              "%s: conv_moments differs between two runs" % name)
        del co, again
        if k == 3:
            _conv_f64_check(torch, name, x[:8], w)
        bm, bv = fc.bn_stats(wco)
        scale, shift = fc._scale_shift(g, b, bm, bv, eps)
        y = fc.bn_apply(wco, scale, shift, res, relu)
        want = fc.bn_apply_plain(wco, scale, shift, res, relu)
        torch.cuda.synchronize()
        errs["bn_apply"] = max(errs["bn_apply"], check_close(
            "fused_conv_check", name, [("y", y, want)], tol,
            check="bn_apply", **shape))
        del y, want

        outs = fc.fused_conv_bn_act(
            x, w, g, b, mean, var, strides=(stride, stride),
            paddings=(pad, pad), eps=eps, momentum=momentum,
            act="relu" if relu else None, residual=res)
        want = [fc.epilogue_reference(wco, g, b, res, None, None, eps, relu),
                momentum * mean + (1 - momentum) * bm,
                momentum * var + (1 - momentum) * bv, bm, bv]
        torch.cuda.synchronize()
        check_close("fused_conv_check", name, list(zip(
            ("y", "mean_out", "var_out", "saved_mean", "saved_var"), outs,
            want)), tol, check="fused_conv_bn_act_train", **shape)
        del outs, want

        # both forwards first: the kernel's co differs from cuDNN's in the
        # last bits, which flips a few relus, and a flip moves one gradient
        # element by its whole dy; dy is zeroed on both sides where the two
        # relu masks differ, so the rest is held element-wise. The kernel's
        # mask is the one its backward applies: the epilogue recomputed on
        # its co (bn_apply's forward output may round the other way)
        outs = []
        for kernel in (True, False):
            ins = [t.clone().requires_grad_(True)
                   for t in (x, w, g, b, res) if t is not None]
            r = ins[4] if residual else None
            if kernel:
                out = fc._FusedTrain.apply(ins[0], ins[1], ins[2], ins[3], r,
                                           stride, eps, relu)[0]
            else:
                out = fc.epilogue_reference(
                    F.conv2d(ins[0], ins[1], stride=stride, padding=pad),
                    ins[2], ins[3], r, None, None, eps, relu)
            outs.append((out, ins))
        dy = torch.randn(wco.shape, generator=gen, device=dev)
        flips = None
        if relu:
            co = fc.conv_moments(x, w, stride)[0]  # bit-equal to the saved
            keep = (fc.epilogue_reference(co, g, b, res, None, None, eps,
                                          relu) > 0) == (outs[1][0] > 0)
            del co
            flips = int((~keep).sum())
            dy = dy * keep
            del keep
        grads = [torch.autograd.grad(out, ins, dy) for out, ins in outs]
        del outs
        torch.cuda.synchronize()
        check_close("fused_conv_check", name, list(zip(
            ("dx", "dw", "dgamma", "dbeta", "dres"), *grads)), tol,
            check="_FusedTrain_backward", relu_flips=flips,
            elements=dy.numel(), **shape)
        del grads, dy, wco

        scale, shift = fc._scale_shift(g, b, mean, var, eps)
        y = fc.conv_apply(x, w, scale, shift, res, relu, stride)
        want = fc.conv_apply_plain(x, w, scale, shift, res, relu, stride)
        torch.cuda.synchronize()
        errs["conv_apply"] = max(errs["conv_apply"], check_close(
            "fused_conv_check", name, [("y", y, want)], tol,
            check="conv_apply", **shape))
        del x, y, want, res
    return errs


def _conv_f64_check(torch, name, x, w):
    """The conv kernel's co and cuDNN's f32 conv (TF32 off) against
    F.conv2d in float64 on the same f32 inputs, by max abs error and
    relative L2 error; fails if the kernel's error is more than twice
    cuDNN's in either (3xTF32 with f32 accumulation should match f32; a
    single TF32 product would be about 1000 times off)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    pad = (w.shape[2] - 1) // 2
    exact = F.conv2d(x.double(), w.double(), padding=pad)

    def errs(t):
        d = t.double() - exact
        return {"max_abs_err": d.abs().max().item(),
                "rel_l2": (d.norm() / exact.norm()).item()}

    got = errs(fc.conv_moments(x, w, 1)[0])
    lib = errs(F.conv2d(x, w, padding=pad))
    emit({"phase": "fused_conv_check", "case": name, "check": "f64",
          "x": list(x.shape), "w": list(w.shape),
          "K": w.shape[1] * w.shape[2] * w.shape[3], "kernel": got,
          "cudnn_f32": lib, "tol": "kernel <= 2 x cuDNN f32, each error"})
    check(all(got[e] <= 2 * lib[e] for e in got),
          "%s: conv error %s against f64, cuDNN f32 %s" % (name, got, lib))


def resnet_conv_geometries():
    """ResNet-50's distinct fused-conv geometries, read from the epilogue
    fusion's record of the built training program: {(C, O, k, stride, H):
    {"sites", "residual", "relu"}} over the sites the gate admits, in the
    order they first appear (H is the input's height and width)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import fused_ops
    from paddle_tpu_torch.ops import fused_conv as fc

    main, _, _, spec = build_resnet(fluid)
    ops, _ = fused_ops(main, [spec.loss.name])
    geoms = {}
    for op in ops:
        if op.type != "fused_conv2d":
            continue
        xs = (RESNET_BATCH,) + tuple(op.input("Input").shape[1:])
        ws = op.input("Filter").shape
        if not fc.gate(xs, ws, op.attr("strides"), op.attr("paddings"),
                       op.attr("dilations"), op.attr("groups"))["admitted"]:
            continue
        key = (int(xs[1]), int(ws[0]), int(ws[2]), int(op.attr("strides")[0]),
               int(xs[2]))
        g = geoms.setdefault(key, {"sites": 0, "residual": 0, "relu": 0})
        g["sites"] += 1
        g["residual"] += op.input("Residual") is not None
        g["relu"] += op.attr("act") == "relu"
    return geoms


def _conv_geometry_timing(torch, dev, gen):
    """Rows 10 and 12 at every distinct fused geometry of ResNet-50 at batch
    128 beside their plain versions, F.conv2d (cuDNN, TF32 off) and the
    bound; one line per geometry and one with the sums weighted by sites.
    conv_apply takes a residual and relu where any site of the geometry
    does. Returns (the body's timings, the site-weighted sums)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    geoms = resnet_conv_geometries()
    n = RESNET_BATCH
    names = ("conv_moments", "conv_apply", "conv_moments_plain",
             "conv_apply_plain", "f_conv2d", "bound")
    total = dict.fromkeys(names, 0.0)
    body = None
    for (c, o, k, stride, hw), g in geoms.items():
        residual, relu = g["residual"] > 0, g["relu"] > 0
        x, w, gm, b, mean, var, res = _conv_case(torch, gen, dev, c, o, k,
                                                 stride, hw, residual)
        scale, shift = fc._scale_shift(gm, b, mean, var, 1e-5)
        pad = (k - 1) // 2
        ho = (hw - 1) // stride + 1
        out = n * o * ho * ho
        conv_flops = 2 * out * c * k * k
        nbytes = 4 * (x.numel() + w.numel() + out + 2 * o)
        bnd, by, bnd_fma = tensor_core_bound(nbytes, conv_flops)
        t = dict(
            conv_moments=time_ms(lambda: fc.conv_moments(x, w, stride),
                                 iters=20),
            conv_apply=time_ms(lambda: fc.conv_apply(
                x, w, scale, shift, res, relu, stride), iters=20),
            conv_moments_plain=time_ms(
                lambda: fc.conv_moments_plain(x, w, stride), iters=20),
            conv_apply_plain=time_ms(lambda: fc.conv_apply_plain(
                x, w, scale, shift, res, relu, stride), iters=20),
            f_conv2d=time_ms(lambda: F.conv2d(x, w, stride=stride,
                                              padding=pad), iters=20),
            bound=bnd)
        for key in names:
            total[key] += g["sites"] * t[key]
        emit(dict({"phase": "conv_geometry",
                   "geometry": "%dx%d%s %d->%d @%d" % (
                       k, k, " s2" if stride == 2 else "", c, o, hw),
                   "x": [n, c, hw, hw], "w": [o, c, k, k], "stride": stride,
                   "sites": g["sites"], "residual_sites": g["residual"],
                   "relu_sites": g["relu"], "apply_residual": residual,
                   "apply_relu": relu, "bound_by": by,
                   "bound_ms_f32_fma": bnd_fma, "flops": conv_flops,
                   "bytes": nbytes,
                   "conv_moments_tflops": conv_flops / t["conv_moments"]
                   / 1e9,
                   "moments_over_f_conv2d": t["conv_moments"]
                   / t["f_conv2d"],
                   "apply_over_f_conv2d": t["conv_apply"] / t["f_conv2d"]},
                  **t))
        if (c, o, k, stride, hw) == (64, 64, 3, 1, 56):
            body = dict(t, bound_by=by, bound_ms_f32_fma=bnd_fma,
                        shape=[n, c, hw, hw, o, k], bytes=nbytes,
                        flops=conv_flops)
        del x, w, res
    sites = sum(g["sites"] for g in geoms.values())
    emit({"phase": "conv_geometry_sum", "geometries": len(geoms),
          "sites": sites, "site_weighted_ms": total})
    check(sites == RESNET_PER_STEP["conv_moments"] and body is not None,
          "fused-conv geometries: %d sites, body found %s" % (
              sites, body is not None))
    return body, total


def _conv_kernel_timing(torch, dev):
    """The three fused-conv kernels, batch 128, f32: rows 10 and 12 on the
    3x3 64 -> 64 body at 56x56 (and at every fused geometry of ResNet-50,
    see :func:`_conv_geometry_timing`), row 11 on the 256-channel expand at
    56x56 with residual and relu. The library yardstick of rows 10 and 12
    is cuDNN's F.conv2d alone (TF32 off): no single PyTorch call computes
    the conv with its moments or with a folded BN. Their bound is the
    tensor cores' (3xTF32), the f32 FMA bound beside it."""
    from paddle_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    body, total = _conv_geometry_timing(torch, dev, gen)
    rows = {}
    for name, lib in (("conv_moments", "moments"),
                      ("conv_apply", "folded BN")):
        rows[name] = dict(
            ms=body[name], plain_ms=body[name + "_plain"],
            library_ms=body["f_conv2d"],
            library="F.conv2d alone (cuDNN, TF32 off): conv only, no " + lib,
            bound_ms=body["bound"], bound_by=body["bound_by"],
            bound_ms_f32_fma=body["bound_ms_f32_fma"], shape=body["shape"],
            bytes=body["bytes"], flops=body["flops"],
            site_weighted_ms=total[name])
    n, hw = RESNET_BATCH, 56
    o = 256
    co = torch.randn(n, o, hw, hw, generator=gen, device=dev)
    res = torch.randn(n, o, hw, hw, generator=gen, device=dev)
    scale = torch.rand(o, generator=gen, device=dev) + 0.5
    shift = torch.randn(o, generator=gen, device=dev)
    nbytes = 4 * (3 * co.numel() + 2 * o)
    bnd, by = bound(nbytes, 3 * co.numel())
    rows["bn_apply"] = dict(
        ms=time_ms(lambda: fc.bn_apply(co, scale, shift, res, True)),
        plain_ms=time_ms(lambda: fc.bn_apply_plain(co, scale, shift, res,
                                                   True)),
        library_ms=None, library="none: no single PyTorch call applies a "
        "per-channel affine, a residual add and relu",
        bound_ms=bnd, bound_by=by, shape=[n, o, hw, hw], bytes=nbytes,
        flops=3 * co.numel())
    return rows


# ---------------------------------------------------------------------------
# DeepFM: sparse (rows, values) gradients and the row scatter-add kernel
# ---------------------------------------------------------------------------

DEEPFM_PER_STEP = per_run(scatter_add=1)


def _deepfm_rows(torch, kind, n, v, seed):
    """int32 ids for ``n`` slots of a ``v``-row table: uniform, in
    [-2v, 2v) (wrap and drop), all on row 7, or Zipf-skewed (exponent 1.2,
    folded into [0, v): the shape of real CTR id traffic)."""
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        r = rng.randint(0, v, n)
    elif kind == "wrap_drop":
        r = rng.randint(-2 * v, 2 * v, n)
    elif kind == "one_row":
        r = np.full(n, 7)
    else:
        r = (rng.zipf(1.2, n) - 1) % v
    return torch.from_numpy(r.astype("i4"))


def phase_scatter_check(torch, dev, tol=1e-5):
    """The scatter kernel against its plain version (``index_add``, f32) on
    the card at the DeepFM shape (851,968 slots into a 100000 x 32 table):
    the densify form into zeros, the SGD form into a non-zero table, rows
    in [-2V, 2V), every slot on one row, and Zipf-skewed rows. Both sum a
    row's duplicates with atomics in no fixed order, so they are held to
    tol * max(1, sum over the row's slots of |vals|), the scale of a few
    ulp per duplicate; each is also measured against an f64 sum."""
    from paddle_tpu_torch.ops import scatter as sc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    v, k = DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH
    n = DEEPFM_BATCH * DEEPFM["num_fields"]
    errs = {}
    cases = [("deepfm_densify_uniform", "uniform", False),
             ("sgd_nonzero_base", "uniform", True),
             ("wrap_drop", "wrap_drop", False),
             ("one_row", "one_row", False),
             ("zipf_1.2", "zipf", False)]
    for i, (name, kind, nonzero) in enumerate(cases):
        rows = _deepfm_rows(torch, kind, n, v, SEED + i).to(dev)
        vals = torch.randn(n, k, generator=gen, device=dev)
        base = (torch.randn(v, k, generator=gen, device=dev) if nonzero
                else torch.zeros(v, k, device=dev))
        got = sc.scatter_add_rows(base, rows, vals)
        want = sc.scatter_add_plain(base, rows, vals)
        exact = sc.scatter_add_plain(base.double(), rows, vals.double())
        mass = sc.scatter_add_plain(torch.zeros(v, k, device=dev), rows,
                                    vals.abs())
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = (err / mass.clamp_min(1.0)).max().item()
        r = rows.long()
        r = torch.where(r < 0, r + v, r)
        hot = torch.bincount(r[(r >= 0) & (r < v)], minlength=v).max().item()
        errs[name] = err.max().item()
        emit({"phase": "scatter_check", "case": name, "rows": kind,
              "shape": [v, k, n], "nonzero_base": nonzero,
              "max_abs_err": errs[name], "max_err_over_row_mass": rel,
              "kernel_vs_f64": (got.double() - exact).abs().max().item(),
              "plain_vs_f64": (want.double() - exact).abs().max().item(),
              "hottest_row_slots": hot,
              "tol": "%g * max(1, sum over the row's slots of |vals|)" % tol})
        check(rel <= tol, "scatter %s: error %g of the row mass > %g"
              % (name, rel, tol))
        del got, want, exact, mass
    return errs


def _scatter_kernel_timing(torch, dev):
    """Row 13 at the DeepFM shape: 851,968 uniform ids into the 100000 x
    32 f32 table, added in place as the densify adds them (the table stays
    allocated, so every run adds into it). Beside it the plain version,
    one ``index_add_`` on the in-range int64 rows as the library
    yardstick (timed here only; the port never calls it), the bound, and
    the kernel on Zipf-skewed ids."""
    from paddle_tpu_torch.ops import scatter as sc

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    v, k = DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH
    n = DEEPFM_BATCH * DEEPFM["num_fields"]
    rows = _deepfm_rows(torch, "uniform", n, v, SEED).to(dev)
    zipf = _deepfm_rows(torch, "zipf", n, v, SEED).to(dev)
    rows64 = rows.long()
    vals = torch.randn(n, k, generator=gen, device=dev)
    out = torch.zeros(v, k, device=dev)
    nbytes = 4 * (n * k + n + 2 * v * k)
    bnd, by = bound(nbytes, n * k)
    return {"scatter_add": dict(
        ms=time_ms(lambda: sc.scatter_add(out, rows, vals)),
        plain_ms=time_ms(lambda: sc.scatter_add_plain(out, rows, vals,
                                                      inplace=True)),
        library_ms=time_ms(lambda: out.index_add_(0, rows64, vals)),
        library="Tensor.index_add_ (int64 rows, all in range)",
        zipf_ms=time_ms(lambda: sc.scatter_add(out, zipf, vals)),
        bound_ms=bnd, bound_by=by, shape=[v, k, n], bytes=nbytes,
        flops=n * k)}


def build_deepfm(fluid):
    """DeepFM with Adam(1e-4), as paddle_tpu's bench.py trains it, in fresh
    programs. Returns (main, startup, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.deepfm.deepfm(**DEEPFM)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(spec.loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, spec


def phase_deepfm_train_check(torch, smi_line, batch=64, lr=1e-4,
                             grad_tol=1e-5):
    """One full-width DeepFM step at batch 64 on the card and with the
    port on the CPU from the same weights and feed (f32, TF32 off): the
    loss within 1e-5 relative, ``prob`` within 1e-5 absolute; the sparse
    grad of the table with equal rows and its values within ``grad_tol``
    in relative L2, and each parameter's Adam first moment after the step
    ((1 - beta1) * g, the table's being the kernel's densify) within
    ``grad_tol`` in relative L2: these see the gradient's magnitude, which
    Adam's first update all but drops. Each parameter's update (after -
    before) within 1e-3 in relative L2 and within lr on every element:
    that update is about lr * sign(g), so an element whose gradient is
    within rounding of zero may part by up to lr. The padding columns
    17..31 of the table must stay exactly zero on both."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_deepfm(fluid)
    gb = main.global_block()
    names = [p.name for p in main.all_parameters()]
    moment1 = {o.input("Param").name: o.input("Moment1").name
               for o in gb.ops if o.type == "adam"}
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    fetch = [spec.loss, spec.fetches["prob"], gb.var("fm_table@GRAD@ROWS"),
             gb.var("fm_table@GRAD")]
    gpu_scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    reset_counts()
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = read_counts()
    check(counts == DEEPFM_PER_STEP, "deepfm_train_check launches %s != %s"
          % (counts, DEEPFM_PER_STEP))
    gpu_after = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    gpu_m1 = {n: gpu_scope.get(m).cpu().numpy() for n, m in moment1.items()}

    cpu_scope = fluid.Scope()
    cexe = fluid.Executor(fluid.CPUPlace())
    cexe.run(startup, scope=cpu_scope)
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    t0 = time.perf_counter()
    cpu = cexe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    check(read_counts() == counts, "the CPU step launched a kernel")
    cpu_after = {n: cpu_scope.get(n).numpy() for n in names}
    cpu_m1 = {n: cpu_scope.get(m).numpy() for n, m in moment1.items()}

    upd = {}
    for n in names:
        du_g, du_c = gpu_after[n] - params[n], cpu_after[n] - params[n]
        upd[n] = (float(np.linalg.norm(du_g - du_c)) / max(
            float(np.linalg.norm(du_c)), 1e-30),
            float(np.abs(du_g - du_c).max()))
    m1 = {n: _rel_l2(gpu_m1[n], cpu_m1[n]) for n in moment1}
    rows_equal = bool(np.array_equal(gpu[2], cpu[2]))
    errs = {"loss": abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            "prob": float(np.abs(gpu[1] - cpu[1]).max()),
            "sparse_grad_rel_l2": _rel_l2(gpu[3], cpu[3]),
            "moment1_rel_l2_max": max(m1.values())}
    used = DEEPFM["embedding_size"] + 1
    pad_zero = [not a["fm_table"][:, used:].any()
                for a in (gpu_after, cpu_after)]
    worst = max(upd, key=lambda n: upd[n][0])
    emit({"phase": "deepfm_train_check", "batch": batch, "config": DEEPFM,
          "loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
          "errors": errs, "sparse_grad_rows_equal": rows_equal,
          "sparse_grad_slots": int(cpu[2].shape[0]),
          "moment1_rel_l2": m1,
          "update_rel_l2": {n: e[0] for n, e in upd.items()},
          "update_max_abs": {n: e[1] for n, e in upd.items()},
          "worst_update_param": worst, "padding_zero": pad_zero,
          "tol": "loss 1e-5 rel, prob 1e-5 abs, sparse grad and first "
                 "moments %g rel L2, updates 1e-3 rel L2 and lr per "
                 "element" % grad_tol, "launches": counts,
          "cpu_step_s": cpu_s, "device": smi_line})
    check(np.isfinite(gpu[1]).all(), "non-finite prob on the card")
    check(errs["loss"] <= 1e-5 and errs["prob"] <= 1e-5,
          "deepfm_train_check errors %s" % errs)
    check(rows_equal, "the sparse grad's rows differ")
    check(errs["sparse_grad_rel_l2"] <= grad_tol
          and errs["moment1_rel_l2_max"] <= grad_tol,
          "deepfm_train_check gradients %s, moments %s" % (errs, m1))
    check(all(e[0] <= 1e-3 and e[1] <= lr for e in upd.values()),
          "deepfm_train_check updates %s" % upd)
    check(all(pad_zero), "padding columns moved: %s" % pad_zero)
    return errs


def _op_kind(op):
    if op.attr("is_optimizer_op"):
        return "optimizer_ops"
    return "autodiff" if op.type == "autodiff" else "forward_ops"


def _profile_by_op_kind(torch, run_step, steps, device_ms):
    """Device ms per step of the forward ops and of the optimizer ops (Adam,
    the densify's scatter included): the kernels launched inside a
    torch.profiler range around each op the executor runs. The backward
    runs on autograd's device thread, outside those ranges, so the
    autodiff op's share is the rest of ``device_ms`` (the per-kernel total
    of the same number of steps). Also the host ops with the most self CPU
    time, as [name, ms per step, calls per step]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import paddle_tpu_torch.core.executor as ex

    run_op = ex.run_op

    def traced(env, op):
        with record_function("ptt_ops/" + _op_kind(op)):
            run_op(env, op)

    ex.run_op = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run_step()
    finally:
        ex.run_op = run_op
    by_op = dict.fromkeys(("forward_ops", "optimizer_ops"), 0.0)
    for e in prof.events():
        kind = e.name[len("ptt_ops/"):]
        if kind in by_op and e.device_type == DeviceType.CPU:
            by_op[kind] += e.device_time_total / steps / 1e3
    by_op["autodiff"] = sum(device_ms.values()) - sum(by_op.values())
    host = sorted(((e.key[:80], e.self_cpu_time_total / steps / 1e3,
                    e.count / steps) for e in prof.key_averages()
                   if not e.key.startswith("ptt_ops/")),
                  key=lambda r: -r[1])[:10]
    return by_op, [list(r) for r in host]


def phase_deepfm_train(torch, smi_line, warmup=3, steps=20, prof_steps=2):
    """The main path: DeepFM (BASELINE config 5) trained with Adam(1e-4) at
    batch 32768 on one fixed batch from ``spec.sample_batch(32768,
    RandomState(0))``, staged on the card once. Launch counts are zeroed
    just before the first step and read after the last; every step must
    launch the scatter kernel exactly once and nothing else of the
    port's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.framework import torch_dtype

    t0 = time.perf_counter()
    main, startup, spec = build_deepfm(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    gb = main.global_block()
    # one fixed batch, staged on the card once in the vars' dtypes (ids
    # and labels int32 under the port's 32-bit convention)
    feed = {name: torch.from_numpy(a).to(exe.device,
                                         torch_dtype(gb.var(name).dtype))
            for name, a in spec.sample_batch(
                DEEPFM_BATCH, np.random.RandomState(0)).items()}
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, step_s = [], []

    def run_step():
        before = read_counts()
        t = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                        scope=scope)  # to numpy: ends synchronised
        dt = time.perf_counter() - t
        after = read_counts()
        per = {k: after[k] - before[k] for k in after}
        check(per == DEEPFM_PER_STEP, "deepfm step %d launches %s != %s"
              % (len(losses), per, DEEPFM_PER_STEP))
        losses.append(float(loss))
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        dt = run_step()
        if i >= warmup:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    device_ms, kernels_per_step, prof_wall_ms, top_other = _profile_steps(
        torch, run_step, prof_steps)
    by_op, top_host = _profile_by_op_kind(torch, run_step, prof_steps,
                                          device_ms)
    launches = read_counts()

    adam = [o for o in gb.ops if o.type == "adam"
            and o.input("Param").name == "fm_table"][0]
    table = scope.get("fm_table")
    used = DEEPFM["embedding_size"] + 1
    pad_zero = not bool(table[:, used:].any())
    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    flops = spec.flops_per_example * DEEPFM_BATCH
    emit({"phase": "deepfm_train", "model": "deepfm", "config": DEEPFM,
          "table": [DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH],
          "params": n_params, "batch": DEEPFM_BATCH, "dtype": "float32",
          "optimizer": "Adam(1e-4)", "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "examples_per_s": DEEPFM_BATCH / med,
          "model_tflops_per_s": flops / med / 1e12,
          "losses": losses, "peak_memory_bytes": peak,
          "device_ms_per_step": device_ms,
          "device_ms_per_step_by_op_kind": by_op,
          "top_host_ops_ms_per_step": top_host,
          "kernels_per_step": kernels_per_step,
          "top_other_kernels": top_other,
          "profiled_wall_ms_per_step": prof_wall_ms,
          "device_busy_share": busy / (med * 1e3),
          "kernel_choice": adam.attrs.get("_kernel_choice"),
          "padding_zero": pad_zero,
          "launches": launches, "launches_per_step": DEEPFM_PER_STEP,
          "setup_s": setup_s, "device": smi_line})
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(adam.attrs.get("_kernel_choice", {}).get("kernel")
          == "cuda_scatter_add", "adam's kernel choice %s"
          % adam.attrs.get("_kernel_choice"))
    check(pad_zero, "the table's padding columns moved")
    n_steps = warmup + steps + 2 * prof_steps
    check(launches == {k: n * n_steps for k, n in DEEPFM_PER_STEP.items()},
          "deepfm_train launches %s" % launches)
    return launches


def build_resnet(fluid):
    """ResNet-50 with Adam(1e-4), as paddle_tpu's bench.py trains it, in
    fresh programs, and its for_test clone. Returns (main, startup, test,
    spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.resnet.resnet_imagenet(**RESNET)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(spec.loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, main.clone(for_test=True), spec


def _rel_l2(a, b):
    return float(np.linalg.norm(a.astype("f8") - b)) / max(
        float(np.linalg.norm(b.astype("f8"))), 1e-30)


def _elem_err(a, b):
    return float(np.abs(a.astype("f8") - b).max()) / max(
        float(np.abs(b).max()), 1.0)


def phase_resnet_train_check(torch, smi_line, batch=2):
    """One full-width ResNet-50 step (224 x 224, 1000 classes, batch 2) on
    the card and with the port on the CPU from the same weights and feed
    (f32, TF32 off), plus a second CPU step on the input scaled by
    1 + 2^-20 (a few ulps), which measures how far f32 rounding alone moves
    each quantity. Randomly initialised ResNet-50 with batch statistics has
    an exploding input-to-gradient Jacobian, so each quantity is held to
    the larger of its stated tolerance and 5x that rounding sensitivity:
    the loss to 1e-4 relative, every gradient to 1e-2 in relative L2 error,
    the BN moving statistics after the step to 1e-4 of max(1, max|CPU|).
    ReLU sign flips between card and CPU are counted at every ReLU
    output."""
    import paddle_tpu_torch as fluid

    main, startup, _, spec = build_resnet(fluid)
    names = [p.name for p in main.all_parameters()]
    trainable = [p.name for p in main.all_parameters() if p.trainable]
    moving = [n for n in names if n not in set(trainable)]
    gb = main.global_block()
    relu_out = [op.output("Out").name for op in gb.ops if op.type == "relu"]
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in trainable] + relu_out
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))

    gpu_scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    reset_counts()
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = read_counts()
    check(counts == RESNET_PER_STEP, "resnet_train_check launches %s != %s"
          % (counts, RESNET_PER_STEP))
    gpu_moving = [gpu_scope.get(n).cpu().numpy() for n in moving]

    cpu_runs, cpu_s = [], []
    for scale in (1.0, 1.0 + 2.0 ** -20):
        cpu_scope = fluid.Scope()
        cexe = fluid.Executor(fluid.CPUPlace())
        cexe.run(startup, scope=cpu_scope)
        fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
        f = dict(feed, img=(feed["img"] * np.float32(scale)).astype("f4"))
        t0 = time.perf_counter()
        out = cexe.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
        cpu_s.append(time.perf_counter() - t0)
        cpu_runs.append((out, [cpu_scope.get(n).numpy() for n in moving]))
    check(read_counts() == counts, "the CPU steps launched a kernel")
    (cpu, cpu_moving), (pert, pert_moving) = cpu_runs

    n_t = len(trainable)
    loss = (abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            abs(float(pert[0]) - float(cpu[0])) / abs(float(cpu[0])))
    grads = {n: (_rel_l2(g, c), _rel_l2(p, c)) for n, g, c, p in zip(
        trainable, gpu[1:1 + n_t], cpu[1:1 + n_t], pert[1:1 + n_t])}
    stats = {n: (_elem_err(g, c), _elem_err(p, c)) for n, g, c, p in zip(
        moving, gpu_moving, cpu_moving, pert_moving)}
    flips = {"card_vs_cpu": 0, "perturbed_cpu_vs_cpu": 0, "elements": 0}
    for g, c, p in zip(gpu[1 + n_t:], cpu[1 + n_t:], pert[1 + n_t:]):
        flips["card_vs_cpu"] += int(((g > 0) != (c > 0)).sum())
        flips["perturbed_cpu_vs_cpu"] += int(((p > 0) != (c > 0)).sum())
        flips["elements"] += int(c.size)

    def over(errs, tol):
        return sorted(n for n, (e, s) in errs.items() if e > max(tol, 5 * s))

    worst_g = max(grads, key=lambda n: grads[n][0])
    worst_s = max(stats, key=lambda n: stats[n][0])
    bad = over({"loss": loss}, 1e-4) + over(grads, 1e-2) + over(stats, 1e-4)
    emit({"phase": "resnet_train_check", "batch": batch, "config": RESNET,
          "loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
          "loss_rel_err": loss[0], "loss_rel_sensitivity": loss[1],
          "grads_compared": n_t,
          "grad_rel_l2_max": grads[worst_g][0], "grad_rel_l2_param": worst_g,
          "grad_rel_l2_median": float(np.median([e for e, _ in
                                                 grads.values()])),
          "grad_sensitivity_max": max(s for _, s in grads.values()),
          "grad_sensitivity_median": float(np.median([s for _, s in
                                                      grads.values()])),
          "grads_past_1e-2": sum(e > 1e-2 for e, _ in grads.values()),
          "moving_stats_compared": len(moving),
          "moving_err_max": stats[worst_s][0], "moving_err_param": worst_s,
          "moving_sensitivity_max": max(s for _, s in stats.values()),
          "relu_sign_flips": flips,
          "tol": "max(stated, 5 x sensitivity): loss 1e-4 rel, grads 1e-2 "
                 "rel L2, moving stats 1e-4 of max(1, max|cpu|)",
          "over_tolerance": bad, "launches": counts, "cpu_step_s": cpu_s,
          "device": smi_line})
    check(np.isfinite(float(gpu[0])), "non-finite loss on the card")
    check(not bad, "resnet_train_check: over tolerance: %s" % bad)
    return loss[0]


def phase_resnet_train(torch, smi_line, conv_site_ms, warmup=3, steps=10,
                       prof_steps=2):
    """The main path: ResNet-50 trained with Adam(1e-4) at batch 128 (224
    x 224 x 3, 1000 classes, f32) on one fixed batch. Launch counts are
    zeroed just before the first step and read after the last; every step
    must launch conv_moments and bn_apply 49 times each and nothing else of
    the port's. The fusion report must hold 53 sites, the four declined
    ones those of RESNET_DECLINED, each for its geometry. The profiled
    conv_moments ms per step is printed beside ``conv_site_ms``, the sum of
    its per-geometry times weighted by sites (phase ``conv_geometry``)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import fused_ops

    t0 = time.perf_counter()
    main, startup, test, spec = build_resnet(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(RESNET_BATCH, np.random.RandomState(SEED))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters()
                   if p.trainable)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, step_s = [], []

    def run_step():
        before = read_counts()
        t = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                        scope=scope)  # to numpy: ends synchronised
        dt = time.perf_counter() - t
        after = read_counts()
        per = {k: after[k] - before[k] for k in after}
        check(per == RESNET_PER_STEP, "resnet step %d launches %s != %s"
              % (len(losses), per, RESNET_PER_STEP))
        losses.append(float(loss))
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        dt = run_step()
        if i >= warmup:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    device_ms, kernels_per_step, prof_wall_ms, top_other = _profile_steps(
        torch, run_step, prof_steps)
    launches = read_counts()

    ops, report = fused_ops(main, [spec.loss.name])
    sites = [o for o in ops if o.type == "fused_conv2d"]
    declined = [(tuple(o.input("Filter").shape), list(o.attr("strides")))
                for o in sites if not o.attrs["_kernel_choice"]["admitted"]]
    reasons = [o.attrs["_kernel_choice"]["reason"] for o in sites
               if not o.attrs["_kernel_choice"]["admitted"]]
    kernels_used = sorted({o.attrs["_kernel_choice"]["kernel"]
                           for o in sites})

    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    flops = spec.flops_per_example * RESNET_BATCH
    emit({"phase": "resnet_train", "model": "resnet50",
          "config": RESNET, "params": n_params, "batch": RESNET_BATCH,
          "dtype": "float32", "optimizer": "Adam(1e-4)",
          "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "images_per_s": RESNET_BATCH / med,
          "model_tflops_per_s": flops / med / 1e12,
          "losses": losses, "peak_memory_bytes": peak,
          "device_ms_per_step": device_ms,
          "kernels_per_step": kernels_per_step,
          "top_other_kernels": top_other,
          "profiled_wall_ms_per_step": prof_wall_ms,
          "device_busy_share": busy / (med * 1e3),
          "conv_moments_ms_per_step": {
              "profiled": device_ms["conv_moments"],
              "site_weighted_timing": conv_site_ms},
          "fusion": {"sites": len(report.fused), "refused":
                     [str(r) for r in report.refused],
                     "kernel_sites": len(sites) - len(declined),
                     "declined": declined, "declined_reasons": reasons,
                     "kernels": kernels_used},
          "launches": launches, "launches_per_step": RESNET_PER_STEP,
          "setup_s": setup_s, "device": smi_line})
    check(len(report.fused) == len(sites) == 53 and not report.refused,
          "fusion report: %s" % report.summary())
    check(declined == RESNET_DECLINED
          and kernels_used == ["cuda_fused_conv", "unfused_replay"],
          "declined sites %s, kernels %s" % (declined, kernels_used))
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(device_ms["conv_moments"] > 0 and device_ms["conv_apply"] == 0,
          "profiled conv kernels not recognised: %s" % device_ms)
    n_steps = warmup + steps + prof_steps
    check(launches == {k: n * n_steps for k, n in RESNET_PER_STEP.items()},
          "resnet_train launches %s" % launches)
    return launches, (exe, scope, main, test, spec, feed)


def phase_resnet_eval(torch, smi_line, trained, passes=5, small=2):
    """The main path: the trained model's ``main.clone(for_test=True)`` at
    batch 128 (moving statistics, the inference kernel at the 49 admitted
    sites), each pass launching conv_apply 49 times and nothing else of
    the port's; then the same clone at batch 2 on the card and with the
    port on the CPU from the card's trained weights: logits within 1e-4 of
    max(1, max|CPU|), loss within 1e-4 relative, accuracy equal."""
    import paddle_tpu_torch as fluid

    exe, scope, main, test, spec, feed = trained
    logits = [op.input("X").name for op in test.global_block().ops
              if op.type == "softmax"][0]
    fetch = [spec.loss.name, spec.fetches["acc"].name, logits]
    pass_s = []
    reset_counts()
    for _ in range(passes + 1):
        before = read_counts()
        t = time.perf_counter()
        exe.run(test, feed=feed, fetch_list=fetch[:2], scope=scope)
        pass_s.append(time.perf_counter() - t)
        after = read_counts()
        per = {k: after[k] - before[k] for k in after}
        check(per == RESNET_PER_EVAL, "eval pass launches %s != %s"
              % (per, RESNET_PER_EVAL))
    launches = read_counts()

    small_feed = {k: v[:small] for k, v in feed.items()}
    gpu = exe.run(test, feed=small_feed, fetch_list=fetch, scope=scope)
    params = {p.name: scope.get(p.name).cpu().numpy()
              for p in main.all_parameters()}
    cpu_scope = fluid.Scope()
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    before = read_counts()
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=small_feed, fetch_list=fetch, scope=cpu_scope)
    check(read_counts() == before, "the CPU eval launched a kernel")
    errs = {"loss": abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            "logits": _elem_err(gpu[2], cpu[2])}
    med = statistics.median(pass_s[1:])
    emit({"phase": "resnet_eval", "model": "resnet50", "config": RESNET,
          "batch": RESNET_BATCH, "passes": passes,
          "pass_ms_median": med * 1e3, "pass_ms": [x * 1e3 for x in pass_s],
          "images_per_s": RESNET_BATCH / med,
          "small_batch": small, "loss_gpu": float(gpu[0]),
          "loss_cpu": float(cpu[0]), "acc_gpu": float(gpu[1]),
          "acc_cpu": float(cpu[1]), "errors": errs, "tol": 1e-4,
          "launches": launches, "launches_per_pass": RESNET_PER_EVAL,
          "device": smi_line})
    check(max(errs.values()) <= 1e-4, "resnet_eval errors %s" % errs)
    check(float(gpu[1]) == float(cpu[1]), "accuracy differs")
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "precision",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    dev = torch.device("cuda", 0)

    smi_line = phase_device(torch)
    phase_build()
    errs = {"flash_attention_fwd": phase_flash_check(torch, dev)["bert_f32"],
            "layer_norm_fwd": phase_ln_check(torch, dev)["1024x768_float32"]}
    errs["flash_attention_bwd"] = phase_flash_bwd_check(
        torch, dev)["enc_self_bias_grad"]
    errs["layer_norm_bwd"] = phase_ln_bwd_check(
        torch, dev)["train_%dx512" % (TRAIN_BATCH * TRANSFORMER["seq_len"])]
    errs["fused_ce_fwd"] = phase_ce_check(torch, dev)["train_%dx%dx%d" % (
        TRAIN_BATCH * TRANSFORMER["seq_len"], TRANSFORMER["d_model"],
        TRANSFORMER["trg_vocab"])]
    errs.update(phase_fused_conv_check(torch, dev))
    errs["scatter_add"] = phase_scatter_check(
        torch, dev)["deepfm_densify_uniform"]
    times = phase_timing(torch, dev)
    paths = {"serve": phase_serve(torch, smi_line)}
    phase_train_check(torch, smi_line)
    paths["train"] = phase_train(torch, smi_line, {
        "flash_attention_fwd": times["flash_attention_fwd"][
            "trained_shape"]["ms"],
        "flash_attention_bwd": times["flash_attention_bwd"]["ms"]})
    phase_resnet_train_check(torch, smi_line)
    paths["resnet_train"], trained = phase_resnet_train(
        torch, smi_line, times["conv_moments"]["site_weighted_ms"])
    paths["resnet_eval"] = phase_resnet_eval(torch, smi_line, trained)
    del trained
    phase_deepfm_train_check(torch, smi_line)
    paths["deepfm_train"] = phase_deepfm_train(torch, smi_line)

    src = {"flash_attention_fwd": ("flash_attention_fwd.cu",
                                   "paddle_tpu/ops/flash_attention.py:1001"),
           "flash_attention_bwd": ("flash_attention_bwd.cu",
                                   "paddle_tpu/ops/flash_attention.py:1058"),
           "layer_norm_fwd": ("layer_norm_fwd.cu",
                              "paddle_tpu/ops/fused_layer_norm.py:42"),
           "layer_norm_bwd": ("layer_norm_bwd.cu",
                              "paddle_tpu/ops/fused_layer_norm.py:57"),
           "fused_ce_fwd": ("fused_ce_fwd.cu",
                            "paddle_tpu/ops/fused_ce.py:57"),
           "conv_moments": ("fused_conv.cu",
                            "paddle_tpu/ops/fused_conv.py:159"),
           "bn_apply": ("fused_conv.cu", "paddle_tpu/ops/fused_conv.py:187"),
           "conv_apply": ("fused_conv.cu",
                          "paddle_tpu/ops/fused_conv.py:198"),
           "scatter_add": ("scatter_add.cu",
                           "paddle_tpu/ops/scatter.py:163")}
    kernels = []
    for name in KERNELS:
        source, replaces = src[name]
        r = times[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/csrc/" + source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library": r.get("library")})
        for key in ("bound_ms_f32_fma", "trained_shape"):
            if key in r:
                kernels[-1][key] = r[key]
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
