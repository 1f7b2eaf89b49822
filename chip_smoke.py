#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (Hopper):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc/``, checks
in their SASS that the conv, flash and fused CE kernels run on the tensor
cores (the bf16 forms of the flash, CE and conv kernels on bf16 m16n8k16
HMMAs, the conv's fed by ldmatrix; the warpgroup-product forms of the bf16
flash forward and backward, CE, conv_moments and conv_apply on bf16 HGMMAs
and no HMMA), holds each kernel
against its plain
PyTorch version on the card, f32 and, for every kernel but the scatter,
bf16 (AMP; the bf16 forms also against f64, beside the plain bf16
version's error) (the
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
  adam, for 3 warm-up and 20 timed steps on one fixed batch, in f32
  (phase ``train``) and under ``fluid.amp.decorate`` (``amp_train``: bf16
  products, the bf16 forms of the flash, LayerNorm and fused CE kernels,
  f32 parameters and Adam state);
* training ResNet-50 (224 x 224 x 3, 1000 classes, batch 128, Adam 1e-4;
  random weights from seed 11) the same way, with the executor's epilogue
  fusion turning 49 of its 53 conv -> BN (+ add)(+ relu) chains into the
  fused-conv kernels, for 3 warm-up and 10 timed steps;
* evaluating ResNet-50 through ``main.clone(for_test=True)`` at batch 128
  (the inference kernel at the same 49 sites);
* both again under ``fluid.amp.decorate`` (``resnet_amp_train``,
  ``resnet_amp_eval``: the clone marked with ``fluid.amp.enable_bf16``;
  bf16 convs and activations through the bf16 forms of the three
  fused-conv kernels, f32 parameters, statistics and Adam state);
* training DeepFM (100,000 x 32 fused table, 26 fields, K = 16, MLP 400 x
  3, 13 dense features, batch 32768, Adam 1e-4; random weights from seed
  11) the same way: its ``embedding(is_sparse=True)`` gives a (rows,
  values) gradient, which Adam densifies through the row scatter-add
  kernel, once per step, for 3 warm-up and 20 timed steps, in f32
  (``deepfm_train``) and under ``fluid.amp.decorate``
  (``deepfm_amp_train``: bf16 MLP products, the f32 table and scatter);
* serving generation at GPT-2 small's widths (the repo's ``transformer_lm``:
  vocab 50257, d_model 768, d_ff 3072, 12 heads, 12 layers, 1024
  positions, 163,000,320 parameters; random weights from seed 11): the
  step program saved with ``save_inference_model`` and its
  ``decode_spec.json`` -> ``ServingEngine(dir, decode=True, ...)`` ->
  ``DecodeBatcher`` (slot recycling; in a second arm chunked prefill,
  speculative decode with the full program as draft, and the prefix
  cache) -> step and chunk dispatches -> the LayerNorm forward kernel, and
  the flash forward in the draft's passes; 64 requests in a closed loop
  of 16.

Before each training path, ``train_check``, ``amp_train_check``,
``resnet_train_check``, ``resnet_amp_train_check``, ``deepfm_train_check``
and ``deepfm_amp_train_check`` run one full-width step (at batch 2, 2, 2,
2, 64 and 64) on the card and the same step with the port on the CPU from
the same weights and feed (the AMP checks also f32 steps on the CPU and on
the card: the loss and each quantity that separates AMP from f32 must lie
within half the CPU's AMP-vs-f32 distance of its AMP step, where the
card's f32 step must not, and every kernel with a bf16 form must have
launched in bf16, the flash forward and CE on their wgmma forms;
ResNet-50's AMP step, chaotic at random init, is held
so op by op, each op run on the CPU AMP chain's own inputs); before
decode, ``decode_check`` holds four step
dispatches and
a chunk against the CPU, out-of-range cache positions, and the ids of
solo, batched, chunked and speculative decode. Each phase prints one JSON
line; any failure raises and exits non-zero. The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``. Without CUDA, or
outside the repository, it exits non-zero and prints no result.
"""

import contextlib
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
# bf16 tensor-core FLOP/s (dense): the AMP forms of the flash and fused CE
# kernels run one bf16 product per product
BF16_FLOPS = 989e12

BERT = dict(vocab=30522, seq=128, d_model=768, d_ff=3072, heads=12,
            layers=12)
# Transformer-base as paddle_tpu's bench.py trains it (:174-177, :229)
TRANSFORMER = dict(src_vocab=30000, trg_vocab=30000, seq_len=256,
                   d_model=512, d_ff=2048, n_head=8, n_layer=6)
TRAIN_BATCH = 128
# ResNet-50 as paddle_tpu's bench.py trains it (BASELINE config 2,
# :200-207, :229), in f32 and under AMP (bench.py:225-231)
RESNET = dict(depth=50, class_num=1000, image_shape=(3, 224, 224))
RESNET_BATCH = 128
# DeepFM as paddle_tpu's bench.py trains it (BASELINE config 5, :208-214,
# :229), in f32 and under AMP (bench.py:225-231); the fused table is 32
# wide
DEEPFM = dict(sparse_feature_dim=100000, num_fields=26, embedding_size=16,
              dense_dim=13, hidden_sizes=(400, 400, 400))
DEEPFM_WIDTH = 32
DEEPFM_BATCH = 32768
SEED = 11
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "layer_norm_fwd",
           "layer_norm_bwd", "fused_ce_fwd", "conv_moments", "bn_apply",
           "conv_apply", "scatter_add")
BF16_FORMS = KERNELS[:8]  # the kernels with a bf16 form (not the scatter)
# the kernels whose bf16 form has a second, warpgroup-product (wgmma) form,
# routed by shape; ``wgmma_launches`` on each wrapper counts it
WGMMA_FORMS = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd",
               "conv_moments", "conv_apply")


# the main paths that run under fluid.amp: every launch of a kernel with a
# bf16 form is a bf16 launch there (their phases check it)
AMP_PATHS = ("amp_train", "resnet_amp_train", "resnet_amp_eval",
             "deepfm_amp_train")


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
    """name -> the wrapper whose ``launches`` counts that kernel (and,
    for BF16_FORMS, whose ``bf16_launches`` counts its bf16 form)."""
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
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    for name in BF16_FORMS:
        fns[name].bf16_launches = 0
    for name in WGMMA_FORMS:
        fns[name].wgmma_launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def read_bf16_counts():
    fns = kernel_fns()
    return {name: fns[name].bf16_launches for name in BF16_FORMS}


def read_wgmma_counts():
    fns = kernel_fns()
    return {name: fns[name].wgmma_launches for name in WGMMA_FORMS}


def wgmma_part(counts, amp):
    """The launches of WGMMA_FORMS that a run of ``counts`` launches makes
    in their wgmma form: all of them on the AMP paths (every flash forward
    of the AMP Transformer has 256 keys and heads of 64, every flash
    backward heads of 64 and a padding mask or none, every CE D 512 and V
    30000; every conv_moments of ResNet-50's AMP training step and every
    conv_apply of its AMP eval C and O multiples of 64 and Wo <= 56), none
    in f32."""
    return {name: counts[name] if amp else 0 for name in WGMMA_FORMS}


def bf16_part(counts, amp):
    """The launches of BF16_FORMS that a run of ``counts`` launches makes
    in bf16: all of them under AMP, none in f32."""
    return {name: counts[name] if amp else 0 for name in BF16_FORMS}


def per_run(**counts):
    """Launches of every kernel in one run of a path (0 unless named)."""
    return dict(dict.fromkeys(KERNELS, 0), **counts)


@contextlib.contextmanager
def mma_sync_route(mod, route):
    """``mod``'s bf16 route function ``route`` (fwd_form, bwd_form,
    apply_form, moments_form, ce_form) sending every call to the mma.sync
    form while the block runs: both forms of a kernel in one call, for
    checks and timings."""
    saved = getattr(mod, route)
    setattr(mod, route, lambda *a, **k: (
        "mma_sync" if route == "ce_form" else ("mma_sync", "forced")))
    try:
        yield
    finally:
        setattr(mod, route, saved)


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


def bf16_bound(nbytes, flops):
    """The bound of a bf16 form (rows 1-6, 9 under AMP): its flops at the
    bf16 tensor-core rate or its bytes."""
    return bound(nbytes, flops, BF16_FLOPS)


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
                ("flash_attention_bwd", "flash_bwd_kernel", 24),
                ("fused_ce_fwd", "fused_ce_kernel", 8))
# library, kernel template, bf16 instantiations, and whether each must load
# its fragments by ldmatrix (LDSM): each must run its products as bf16
# m16n8k16 HMMAs with f32 accumulators
SASS_BF16 = (("flash_attention_fwd", "flash_fwd_kernel", 18, False),
             ("flash_attention_bwd", "flash_bwd_kernel", 12, False),
             ("fused_ce_fwd", "fused_ce_kernel", 4, False),
             ("fused_conv", "conv_kernel", 8, True))
BF16_HMMA = "HMMA.16816.F32.BF16"
# library, kernel stem, instantiations: the warpgroup-product forms of the
# bf16 flash forward and backward (head-dim widths 64 and 128), fused CE,
# conv_apply and conv_moments (one or two consumer warpgroups, x read in
# NCHW or from its channels-last copy). Each must
# run its products as bf16 HGMMAs (wgmma) and hold no HMMA.16816 of its
# own: an mma.sync left in the hot loop would hide behind a passing count
SASS_WGMMA = (("flash_attention_fwd", "flash_fwd_wgmma_kernel", 2),
              ("flash_attention_bwd", "flash_bwd_wgmma_kernel", 2),
              ("fused_ce_fwd", "fused_ce_wgmma_kernel", 1),
              ("fused_conv_wgmma", "conv_apply_wgmma_kernel", 4),
              ("fused_conv_wgmma", "conv_moments_wgmma_kernel", 4))


# library, the mangled stem of the instantiations that move 16 bytes a
# lane, how many there are, the kind of instruction and the mark of its
# 128-bit form each must hold: the scatter's float4 reduction (VEC 4;
# REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU on sm_90a), the LayerNorm forward's
# 16-byte loads (f32 and bf16, every VPL; LDG.E.128.CONSTANT) and the bf16
# LayerNorm backward's register-resident form's 16-byte loads of x and dy
# and stores of dx (every VPL)
SASS_WIDE = (("scatter_add", "scatter_add_kernelILi4E", 1, "RED", "F32x4"),
             ("layer_norm_fwd", "layer_norm_fwd_kernelIfLb1E", 7, "LDG",
              ".128"),
             ("layer_norm_fwd", "layer_norm_fwd_kernelI13__nv_bfloat16Lb1E",
              7, "LDG", ".128"),
             ("layer_norm_bwd", "layer_norm_bwd_regs", 4, "LDG", ".128"),
             ("layer_norm_bwd", "layer_norm_bwd_regs", 4, "STG", ".128"))


def _sass_functions(_build, lib):
    """{mangled kernel name: [mnemonics]} from cuobjdump's SASS of ``lib``."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build._lib_path(lib)],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, "cuobjdump failed: " + sass.stderr[-2000:])
    fns = {}
    for fn in sass.stdout.split("Function : ")[1:]:
        ops = []
        for ln in fn.splitlines()[1:]:
            tok = ln.split()
            if len(tok) > 1 and tok[0].startswith("/*"):
                ops.append(tok[2] if tok[1].startswith("@") and len(tok) > 2
                           else tok[1])
        fns[fn.split(None, 1)[0]] = ops
    return fns


def _sass_check(_build):
    """Every instantiation of the conv kernel (conv_moments' and
    conv_apply's), of the flash forward and backward kernels (every
    head-dim width, f32 and bf16, padding-mask and per-query bias) and of
    the fused CE kernel (16- or 4-byte copies of x and of W) must carry its
    products on the tensor cores: cuobjdump's SASS of each built library
    shows HMMA instructions in each. Every float4 instantiation of the
    scatter kernel must hold a 128-bit reduction, and every 16-byte
    instantiation of the LayerNorm forward a 128-bit global load, and
    every register-resident instantiation of the bf16 LayerNorm backward
    128-bit global loads and stores (``SASS_WIDE``); the mnemonics found
    are printed. Every bf16
    instantiation of the flash kernels, of the fused CE kernel and of the
    conv kernel must hold ``HMMA.16816.F32.BF16``, the conv kernel's also
    ``LDSM`` (ldmatrix) (``SASS_BF16``); the warpgroup-product forms of the
    flash forward and backward, the fused CE, conv_apply and conv_moments
    must hold bf16 ``HGMMA`` and no ``HMMA.16816`` (``SASS_WGMMA``)."""
    for lib, kernel, n_inst in SASS_KERNELS:
        hmma = {name: sum(op.startswith("HMMA") for op in ops)
                for name, ops in _sass_functions(_build, lib).items()
                if kernel in name}
        emit({"phase": "sass", "library": lib, "kernel": kernel,
              "instantiations": len(hmma), "hmma_per_instantiation": hmma})
        check(len(hmma) >= n_inst and all(hmma.values()),
              "%s instantiations without HMMA: %s" % (kernel, hmma))
    for lib, kernel, n_inst, ldsm in SASS_BF16:
        fns = {name: ops for name, ops in _sass_functions(_build, lib).items()
               if kernel in name and "__nv_bfloat16" in name}
        bf16 = {name: sum(op.startswith(BF16_HMMA) for op in ops)
                for name, ops in fns.items()}
        ldsms = {name: sum(op.startswith("LDSM") for op in ops)
                 for name, ops in fns.items()}
        emit({"phase": "sass", "library": lib, "kernel": kernel,
              "dtype": "bf16", "instantiations": len(bf16),
              "mnemonic": BF16_HMMA, "count_per_instantiation": bf16,
              "ldsm_per_instantiation": ldsms})
        check(len(bf16) == n_inst and all(bf16.values()),
              "%s bf16 instantiations without %s: %s"
              % (kernel, BF16_HMMA, bf16))
        check(not ldsm or all(ldsms.values()),
              "%s bf16 instantiations without LDSM: %s" % (kernel, ldsms))
    for lib, kernel, n_inst in SASS_WGMMA:
        fns = {name: ops for name, ops in _sass_functions(_build, lib).items()
               if kernel in name}
        hgmma = {name: sum(op.startswith("HGMMA") and ".BF16" in op
                           for op in ops) for name, ops in fns.items()}
        hmma = {name: sum(op.startswith("HMMA.16816") for op in ops)
                for name, ops in fns.items()}
        emit({"phase": "sass", "library": lib, "kernel": kernel,
              "dtype": "bf16", "instantiations": len(fns),
              "hgmma_bf16_per_instantiation": hgmma,
              "hmma_16816_per_instantiation": hmma})
        check(len(fns) == n_inst and all(hgmma.values())
              and not any(hmma.values()),
              "%s instantiations without bf16 HGMMA or with HMMA.16816: "
              "%s, %s" % (kernel, hgmma, hmma))
    for lib, stem, n_inst, kind, wide in SASS_WIDE:
        fns = _sass_functions(_build, lib)
        found = {name: sorted({op for op in ops if op.startswith(kind)})
                 for name, ops in fns.items() if stem in name}
        others = sorted({op for name, ops in fns.items() if stem not in name
                         for op in ops if op.startswith(kind)})
        emit({"phase": "sass", "library": lib, "kernel": stem,
              "instantiations": len(found), kind.lower(): found,
              "other_instantiations": others})
        check(len(found) == n_inst and all(
            any(wide in op for op in ops) for ops in found.values()),
            "%s instantiations without a 128-bit %s: %s"
            % (stem, kind, found))


def _padding_bias(torch, gen, b, tk, dev):
    lengths = torch.randint(1, tk + 1, (b,), generator=gen)
    return torch.where(torch.arange(tk)[None] < lengths[:, None], 0.0,
                       -1e9).to(dev)


def _rich_bias(torch, gen, b, h, tq, tk, dev):
    """A bias with one offset per (b, h, t, j), as relative positions give:
    the kernels read it by strides."""
    return torch.randn(b, h, tq, tk, generator=gen).to(dev)


def phase_flash_check(torch, dev, lse_tol=1e-4):
    """Kernel vs plain version at the served shape and the causal cases.
    bf16: the plain version runs in f32 on the same bf16 inputs. lse is f32
    in every form (f32 sums of the same products) and is held to
    ``lse_tol`` absolute in each."""
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
        # the decode tier's draft pass: GPT-2 small's heads over the
        # draft's 16 positions at the top batch rung
        ("draft_causal_16", 8, DRAFT_SEQ, DRAFT_SEQ, GPT2["n_head"],
         GPT2["d_model"] // GPT2["n_head"], True, None, torch.float32,
         1e-4),
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
              "lse_err": lse_err, "tol": tol, "lse_tol": lse_tol})
        check(err <= tol and lse_err <= lse_tol,
              "flash %s error %g (lse %g) > %g" % (name, err, lse_err, tol))
        errs[name] = err
    # bf16 (AMP) at the training shape, the encoder's call: key padding
    # bias and dropout 0.1, against the plain version on the same bf16
    # inputs and seed, which rounds the same normalised weights: 2^-7 *
    # max(1, max|plain|) for out (a sum in another order may round the
    # other way), lse_tol for lse
    b, t, h = TRAIN_BATCH, TRANSFORMER["seq_len"], TRANSFORMER["n_head"]
    d = TRANSFORMER["d_model"] // h
    q, k, v = (torch.randn(b, t, h * d, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    bias = _padding_bias(torch, gen, b, t, dev)
    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, h, bias, False, 0.1, seed)
    want, want_lse = fa.attention_plain(q, k, v, h, bias, False, 0.1, seed)
    torch.cuda.synchronize()
    lse_err = (lse - want_lse).abs().max().item()
    errs["train_bf16_dropout_0.1"] = check_close(
        "flash_attention_fwd", "train_bf16_dropout_0.1",
        [("out", out, want)], 2.0 ** -7, shape=[b, t, t, h, d], bias="key",
        dropout=0.1, dtype="bf16", lse_err=lse_err, lse_tol=lse_tol)
    check(lse_err <= lse_tol, "flash train_bf16_dropout_0.1: lse error %g"
          % lse_err)
    return errs


# the LayerNorm forward's timed shapes, (rows, D): BERT-base served at the
# top batch rung (8 x 128 tokens), and Transformer-base trained (32
# launches a step)
LN_SERVED = (8 * BERT["seq"], BERT["d_model"])
LN_TRAINED = (TRAIN_BATCH * TRANSFORMER["seq_len"], TRANSFORMER["d_model"])
# (rows, D, gamma and beta, x 16-byte aligned): the two timed shapes, a
# ragged count at the served width, then every instantiation family of
# the kernel (ops/fused_layer_norm.py ln_fwd_plan): register-resident
# 16-byte at 512 and 1000, single-element at 1, 3 and 37, looped at 4096
# and 5000, single-element and looped from an unaligned x
LN_CASES = [LN_SERVED + (True, True), LN_TRAINED + (True, True),
            (1000, 768, True, True),
            (1000, 512, True, True), (1000, 512, False, True),
            (1000, 1, True, True), (1000, 3, True, True),
            (1000, 37, False, True), (1000, 1000, True, True),
            (1000, 4096, True, True), (1000, 5000, True, True),
            (1000, 768, True, False)]


def _ln_f64(x, g, b, eps):
    """LayerNorm over the last axis in float64 (the yardstick of the f32
    check)."""
    x = x.double()
    xc = x - x.mean(dim=-1, keepdim=True)
    y = xc / (((xc * xc).mean(dim=-1, keepdim=True) + eps) ** 0.5)
    if g is not None:
        y = y * g.double()
    if b is not None:
        y = y + b.double()
    return y


def phase_ln_check(torch, dev):
    """Kernel vs plain version (in f32 on the same inputs), f32 and bf16,
    at each of ``LN_CASES``. f32: y against an f64 LayerNorm of the same
    inputs, within 1e-5 absolute or, where the plain version's own
    rounding is larger (a row whose mean is large against its spread),
    within the plain version's error against f64; the distance to the
    plain version is printed beside. bf16: y within one bf16 ulp of the
    plain version (2^-8 relative to |y|, at least 2^-8 absolute), since the
    kernel rounds y once to bf16. Mean and var are f32 in both: 1e-4
    absolute. Fails unless the plans ``_ln_fwd_timing`` times (f32, at
    ``LN_SERVED`` and ``LN_TRAINED``) are among those checked."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs, checked = {}, set()
    for rows, d, affine, aligned in LN_CASES:
        g = torch.randn(d, generator=gen).to(dev) if affine else None
        bb = torch.randn(d, generator=gen).to(dev) if affine else None
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows * d + 1, generator=gen) * 2 + 0.5).to(
                dev, dtype)
            x = (x[:-1] if aligned else x[1:]).view(rows, d)
            y, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
            wy, wm, wv = fln.layer_norm_plain(x.float(), g, bb, 1e-5)
            torch.cuda.synchronize()
            dy = (y.float() - wy).abs()
            f64 = {}
            if dtype == torch.float32:
                exact = _ln_f64(x, g, bb, 1e-5)
                f64 = {"kernel": (y.double() - exact).abs().max().item(),
                       "plain": (wy.double() - exact).abs().max().item()}
                y_ok = f64["kernel"] <= max(1e-5, f64["plain"])
                del exact
            else:
                y_ok = bool((dy <= 2.0 ** -8 * wy.abs().clamp_min(1.0)).all())
            e = (dy.max().item(), (mean - wm).abs().max().item(),
                 (var - wv).abs().max().item())
            name = "%dx%d_%s%s%s" % (rows, d, str(dtype).split(".")[1],
                                     "" if affine else "_noaffine",
                                     "" if aligned else "_unaligned")
            plan = fln.ln_fwd_plan(rows, d, dtype, sms, aligned)
            checked.add((rows, d, dtype, plan))
            emit({"phase": "layer_norm_fwd", "case": name,
                  "plan": list(plan),
                  "max_abs_err_y": e[0], "max_abs_err_mean": e[1],
                  "max_abs_err_var": e[2], "y_within_tol": y_ok,
                  "max_abs_err_y_vs_f64": f64 or None,
                  "tol_y": "against f64: kernel <= max(1e-5, plain)"
                  if dtype == torch.float32 else "2^-8 rel",
                  "tol_stats": 1e-4})
            check(y_ok and e[1] <= 1e-4 and e[2] <= 1e-4,
                  "layer_norm %s errors %s" % (name, e))
            errs[name] = max(e)
            del x, y, mean, var, wy, wm, wv, dy
    for rows, d in (LN_SERVED, LN_TRAINED):
        timed = fln.ln_fwd_plan(rows, d, torch.float32, sms)
        check((rows, d, torch.float32, timed) in checked,
              "layer_norm %dx%d: the timed plan %s is not checked"
              % (rows, d, list(timed)))
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
    errs.update(_flash_bf16_check(torch, dev, gen))
    _flash_f64_check(torch, dev)
    return errs


# the flash kernels' bf16 (AMP) cases: name, B, Tq, Tk, H, D, causal, bias,
# dropout, the forward's form, the backward's form: the training path's
# three calls, then every width family, then the wgmma forms' route
# boundaries (Tk 16, 255, 256, 257, 512; causal Tq < Tk, and Tq > Tk with
# rows that see no key; D 16, 64, 128, 136; padding and rich bias; dropout
# on and off)
FLASH_BF16_CASES = [
    ("enc_self_bf16_dropout_0.1", TRAIN_BATCH, 256, 256, 8, 64, False,
     "key+grad", 0.1, "wgmma", "wgmma"),
    ("dec_self_causal_bf16_dropout_0.1", TRAIN_BATCH, 256, 256, 8, 64, True,
     None, 0.1, "wgmma", "wgmma"),
    ("dec_cross_bf16_dropout_0.1", TRAIN_BATCH, 256, 256, 8, 64, False, "key",
     0.1, "wgmma", "wgmma"),
    ("d16_causal_tq_gt_tk_bf16", 2, 129, 64, 4, 16, True, None, 0.0,
     "wgmma", "wgmma"),
    ("d128_bf16_dropout_0.1", 2, 96, 96, 2, 128, True, "key", 0.1, "wgmma",
     "wgmma"),
    ("d512_bias_grad_bf16", 1, 70, 129, 2, 512, False, "key+grad", 0.0,
     "mma_sync", "mma_sync"),
    ("d12_full_bias_grad_bf16", 2, 65, 100, 3, 12, False, "full+grad", 0.1,
     "mma_sync", "mma_sync"),
    ("tk16_bf16", 2, 100, 16, 4, 64, False, "key", 0.0, "wgmma", "wgmma"),
    ("tk255_bf16_dropout_0.1", 2, 100, 255, 4, 64, False, "key", 0.1,
     "wgmma", "wgmma"),
    ("tk257_bf16_dropout_0.1", 2, 100, 257, 4, 64, False, "key", 0.1,
     "mma_sync", "wgmma"),
    ("causal_tq_lt_tk256_bf16", 2, 64, 256, 4, 64, True, None, 0.0,
     "wgmma", "wgmma"),
    ("d16_tk256_bias_grad_bf16", 2, 100, 256, 4, 16, False, "key+grad", 0.0,
     "wgmma", "wgmma"),
    ("d128_tk256_causal_bf16_dropout_0.1", 2, 256, 256, 2, 128, True, None,
     0.1, "wgmma", "wgmma"),
    ("d136_tk256_bf16", 2, 100, 256, 2, 136, False, "key", 0.0, "mma_sync",
     "mma_sync"),
    ("tk512_bias_grad_bf16_dropout_0.1", 2, 100, 512, 4, 64, False,
     "key+grad", 0.1, "mma_sync", "wgmma"),
    ("d64_causal_tq_gt_tk_bf16_dropout_0.1", 2, 300, 100, 2, 64, True, None,
     0.1, "wgmma", "wgmma"),
    ("d128_tk512_causal_tq_lt_tk_bf16", 2, 200, 512, 2, 128, True, "key",
     0.0, "mma_sync", "wgmma"),
    ("d64_full_bias_grad_bf16", 2, 100, 256, 2, 64, False, "full+grad", 0.0,
     "mma_sync", "mma_sync"),
]


def _flash_bf16_check(torch, dev, gen):
    """The bf16 forms (AMP) against the plain versions on the same bf16
    inputs and seed: the forward kernel against ``attention_plain``, the
    backward kernel against ``attention_bwd_plain`` from the kernel
    forward's out and lse. out, dq, dk and dv within 2^-7 * max(1,
    max|plain|) (one bf16 step either way: the products sum in f32 in
    other orders and may round the other way), the f32 dbias within 1e-4
    * max(1, max|plain|), the forward's lse within 1e-4 where a row sees
    a key. Each case's forward and backward must run the forms it names
    (``wgmma_launches``). Returns the cases' largest errors."""
    from paddle_tpu_torch.ops import flash_attention as fa

    errs = {}
    for i, (name, b_, tq, tk, h_, d_, causal, bias_kind, rate, form,
            bwd) in enumerate(FLASH_BF16_CASES):
        q, k, v, dout = (torch.randn(b_, n, h_ * d_, generator=gen).to(
            dev, torch.bfloat16) for n in (tq, tk, tk, tq))
        kb = None
        if bias_kind is not None and bias_kind.startswith("full"):
            kb = _rich_bias(torch, gen, b_, h_, tq, tk, dev)
        elif bias_kind is not None:
            kb = _padding_bias(torch, gen, b_, tk, dev)
        want_db = bias_kind is not None and bias_kind.endswith("+grad")
        seed = (torch.tensor([2000 + i], dtype=torch.int64, device=dev)
                if rate > 0 else None)
        n_wgmma = fa.flash_attention_fwd.wgmma_launches
        out, lse = fa.flash_attention_fwd(q, k, v, h_, kb, causal, rate, seed)
        ran = ("wgmma" if fa.flash_attention_fwd.wgmma_launches > n_wgmma
               else "mma_sync")
        check(ran == form, "flash bf16 %s ran the %s form, not %s"
              % (name, ran, form))
        want, want_lse = fa.attention_plain(q, k, v, h_, kb, causal, rate,
                                            seed)
        n_wgmma = fa.flash_attention_bwd.wgmma_launches
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, h_, kb, causal,
                                     rate, seed, want_dbias=want_db)
        ran_bwd = ("wgmma" if fa.flash_attention_bwd.wgmma_launches > n_wgmma
                   else "mma_sync")
        check(ran_bwd == bwd, "flash bf16 %s: the backward ran the %s form, "
              "not %s" % (name, ran_bwd, bwd))
        ref = fa.attention_bwd_plain(q, k, v, out, lse, dout, h_, kb, causal,
                                     rate, seed, want_dbias=want_db)
        torch.cuda.synchronize()
        check(all(x.dtype == torch.bfloat16 for x in (out,) + got[:3]),
              "flash bf16 %s: dtypes %s" % (name, [x.dtype
                                                   for x in got[:3]]))
        pairs = [("out", out, want)] + list(zip(("dq", "dk", "dv"), got[:3],
                                                ref[:3]))
        live = want_lse > -1e30
        lse_err = (lse - want_lse)[live].abs().max().item()
        errs[name] = check_close(
            "flash_attention_bwd", name, pairs, 2.0 ** -7,
            shape=[b_, tq, tk, h_, d_], causal=causal, bias=bias_kind,
            dropout=rate, dtype="bf16", forward_form=ran,
            backward_form=ran_bwd, lse_err=lse_err)
        check(lse_err <= 1e-4 and torch.equal(lse <= -1e30, ~live),
              "flash bf16 %s: lse error %g" % (name, lse_err))
        if want_db:
            check_close("flash_attention_bwd", name + "_dbias",
                        [("dbias", got[3], ref[3])], 1e-4, dtype="f32")
        del q, k, v, dout, out, lse, want, want_lse, got, ref
    return errs


def _flash_f64_check(torch, dev):
    """At the training shape (the encoder self-attention call, key
    padding bias) the kernels' out, dq, dk and dv and the plain version's
    f32 ones (cuBLAS, TF32 off) against the plain version in f64 on the
    same f32 inputs, by max abs and relative L2 error; fails if the
    kernels' error is more than twice the plain f32 one in either (a
    single TF32 pass would be about 1000 times off). Then the bf16 forms
    (the backward's wgmma form) on the same inputs rounded to bf16,
    against f64 on those: the kernels' errors at most 1.5 times the plain
    bf16 version's."""
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

    # bf16 (AMP): the same call on the inputs rounded to bf16, the bf16
    # kernels and the plain bf16 version against f64 on those inputs
    qb, kbf, vb, db = (x.to(torch.bfloat16) for x in (q, k, v, dout))
    ins = [x.double().requires_grad_(True) for x in (qb, kbf, vb)]
    o64 = fa.attention_plain(*ins, h, kb.double())[0]
    exact = [o64.detach()] + list(torch.autograd.grad(o64, ins,
                                                      db.double()))
    runs = []
    n_wgmma = fa.flash_attention_bwd.wgmma_launches
    for fwd, bwd in ((fa.attention_plain, fa.attention_bwd_plain),
                     (fa.flash_attention_fwd, fa.flash_attention_bwd)):
        o, lse = fwd(qb, kbf, vb, h, kb)
        runs.append([o] + list(bwd(qb, kbf, vb, o, lse, db, h, kb)[:3]))
    torch.cuda.synchronize()
    check(fa.flash_attention_bwd.wgmma_launches == n_wgmma + 1,
          "flash bf16 f64: the backward did not run its wgmma form")
    plain_bf = {n: errs(r, e) for n, r, e in zip(names, runs[0], exact)}
    kernel = {n: errs(g, e) for n, g, e in zip(names, runs[1], exact)}
    emit({"phase": "flash_attention_f64", "shape": [b, t, t, h, d],
          "bias": "key", "dtype": "bf16", "kernel": kernel,
          "plain_bf16": plain_bf,
          "ratio": {n: {e: kernel[n][e] / plain_bf[n][e]
                        for e in kernel[n]} for n in names},
          "tol": "kernel <= 1.5 x plain bf16, each error"})
    check(all(kernel[n][e] <= 1.5 * plain_bf[n][e] for n in names
              for e in kernel[n]),
          "flash bf16 errors against f64 %s, plain bf16 %s"
          % (kernel, plain_bf))


def phase_ln_bwd_check(torch, dev):
    """The LayerNorm kernels through their autograd Function against
    autograd of the plain version, f32: dx, dgamma, dbeta within 1e-4 *
    max(1, max|plain|) (dgamma/dbeta sum all rows, in another order); then
    bf16, one case per form of the backward's plan."""
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
    # bf16 (AMP) x and dy with f32 gamma and beta: dx is bf16, rounded once
    # from f32 by both (2^-8 * max(1, max|plain|)); dgamma, dbeta f32
    # (1e-4); two kernel runs bitwise equal. One case per form of
    # ln_bwd_plan: the row in registers at 2, 3 and 4 vectors a lane (D =
    # 1000: 125 of 128 vectors), the looped form on 16-byte vectors (D =
    # 2048, wider than 4 a lane) and on single elements (D = 77).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, n, d, vec, vpl in (
            ("train_%dx512_bf16" % rows, rows, 512, 8, 2),
            ("ragged_1000x768_bf16", 1000, 768, 8, 3),
            ("ragged_1000x1000_bf16", 1000, 1000, 8, 4),
            ("looped_1000x2048_bf16", 1000, 2048, 8, 0),
            ("ragged_1000x77_bf16", 1000, 77, 1, 0)):
        plan = fln.ln_bwd_plan(n, d, torch.bfloat16, sms)
        check(plan[:2] == (vec, vpl), "ln_bwd_plan %s: %s" % (name, plan))
        x = (torch.randn(n, d, generator=gen) * 2 + 0.5).to(dev,
                                                            torch.bfloat16)
        dy = torch.randn(n, d, generator=gen).to(dev, torch.bfloat16)
        g = torch.randn(d, generator=gen).to(dev)
        bb = torch.randn(d, generator=gen).to(dev)
        outs = []
        for via_kernel in (True, False):
            ins = [t.clone().requires_grad_(True) for t in (x, g, bb)]
            fn = fln._FusedLN.apply if via_kernel else fln.layer_norm_plain
            y = fn(*ins, 1e-5)[0]
            outs.append(torch.autograd.grad(y, ins, dy))
        _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
        runs = [fln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)
                for _ in range(2)]
        torch.cuda.synchronize()
        check(outs[0][0].dtype == torch.bfloat16, "layer_norm_bwd bf16 dx")
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              "layer_norm_bwd %s differs between two runs" % name)
        errs[name] = check_close("layer_norm_bwd", name,
                                 [("dx", outs[0][0], outs[1][0])], 2.0 ** -8,
                                 shape=[n, d], dtype="bf16",
                                 plan=list(plan))
        check_close("layer_norm_bwd", name + "_params",
                    list(zip(("dgamma", "dbeta"), outs[0][1:], outs[1][1:])),
                    1e-4, shape=[n, d], dtype="f32", plan=list(plan))
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


# the bf16 cases beside CE_CASES at the wgmma form's route boundaries (D
# not a multiple of 64, one 8-column slab, D above the resident x's 512)
CE_BF16_CASES = [("v304_777x72x304", 777, 72, 304, True, 0.0),
                 ("d40_129x40x256", 129, 40, 256, False, 0.1),
                 ("v8_300x512x8", 300, 512, 8, True, 0.1),
                 ("d520_257x520x1000", 257, 520, 1000, True, 0.1)]


def _ce_form_ran(fce, n_wgmma, calls):
    """The bf16 form the last ``calls`` launches ran, from the wgmma
    count before them."""
    got = fce.fused_ce_fwd.wgmma_launches - n_wgmma
    check(got in (0, calls), "fused_ce_fwd: %d of %d launches on wgmma"
          % (got, calls))
    return "wgmma" if got else "mma_sync"


def _ce_wants_wgmma(d, v):
    """The shapes the wgmma form takes (contiguous, aligned tensors)."""
    return d % 8 == 0 and v % 8 == 0 and d <= 512


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
    # bf16 (AMP) x, W and b: the bf16 forms against the plain version,
    # which forms f32 logits from the same bf16 operands, at the training
    # shape and the ragged cases (the wgmma form where D and V are
    # multiples of 8 and D is at most 512; else the mma.sync form, whose
    # D % 8 != 0 and V % 8 != 0 take element-wise copies), loss and lse
    # within 2e-5 * max(1, max|plain|), each twice, each on the form the
    # route names
    for name, t, d_, v_, with_bias, eps in cases + CE_CASES + CE_BF16_CASES:
        x, w, b, y = _ce_inputs(torch, gen, dev, t, d_, v_, with_bias)
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        b = b.to(torch.bfloat16) if b is not None else None
        n_wgmma = fce.fused_ce_fwd.wgmma_launches
        loss, lse = fce.fused_ce_fwd(x, w, b, y, eps)
        again = fce.fused_ce_fwd(x, w, b, y, eps)
        ran = _ce_form_ran(fce, n_wgmma, 2)
        want, want_lse = fce.linear_smooth_ce_plain(x, w, b, y, eps)
        torch.cuda.synchronize()
        same = torch.equal(loss, again[0]) and torch.equal(lse, again[1])
        errs[name + "_bf16"] = check_close(
            "fused_ce_fwd", name + "_bf16",
            [("loss", loss, want), ("lse", lse, want_lse)], 2e-5,
            shape=[t, d_, v_], eps=eps, bias=with_bias, dtype="bf16",
            bitwise_repeat=same, form=ran)
        check(same, "fused_ce_fwd %s bf16: two runs differ" % name)
        check(ran == ("wgmma" if _ce_wants_wgmma(d_, v_) else "mma_sync"),
              "fused_ce_fwd %s bf16 ran the %s form" % (name, ran))
        del want, want_lse, x, w, b, y, loss, lse, again
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
    TF32 product would be 54-530 times off, as the CPU emulation shows).
    Then the bf16 forms on x and W rounded to bf16, against f64 on those
    values: at most 1.5 times the plain version's errors (f32 logits from
    the same bf16 operands): the wgmma form at the training width (the
    case that chose its chunk depth, ``fused_ce.WGMMA_CHUNK_K``) and with a
    bias at 4,097 rows, and the mma.sync form at V 30001 (V % 8 != 0)."""
    from paddle_tpu_torch.ops import fused_ce as fce

    gen = torch.Generator().manual_seed(SEED + 3)
    d, v = TRANSFORMER["d_model"], TRANSFORMER["trg_vocab"]
    cases = [("train_4096x%dx%d" % (d, v), 4096, d, v, False, 0.1)] + [
        (name.split("_")[0] + "_4097x%dx%d" % (d_, v_), 4097, d_, v_, bias,
         eps) for name, _, d_, v_, bias, eps in CE_CASES]
    cases += [(cases[0][0] + "_bf16",) + cases[0][1:],
              ("bias_4097x%dx1000_bf16" % d, 4097, d, 1000, True, 0.1),
              ("v30001_4097x%dx30001_bf16" % d, 4097, d, 30001, True, 0.1)]
    for name, t, d_, v_, with_bias, eps in cases:
        x, w, b, y = _ce_inputs(torch, gen, dev, t, d_, v_, with_bias)
        bf16 = name.endswith("_bf16")
        if bf16:  # the f64 reference takes the same bf16 values
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
            b = b.to(torch.bfloat16) if b is not None else None
        exact = _ce_f64(torch, x, w, b, y, eps)
        n_wgmma = fce.fused_ce_fwd.wgmma_launches
        got = fce.fused_ce_fwd(x, w, b, y, eps)
        ran = _ce_form_ran(fce, n_wgmma, 1)
        check(ran == ("wgmma" if bf16 and _ce_wants_wgmma(d_, v_)
                      else "mma_sync"),
              "fused_ce_f64 %s ran the %s form" % (name, ran))
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
        limit = 1.5 if bf16 else 2.0
        emit({"phase": "fused_ce_f64", "case": name, "shape": [t, d_, v_],
              "bias": with_bias, "eps": eps, "form": ran,
              "chunk_k": fce.WGMMA_CHUNK_K if ran == "wgmma" else None,
              "kernel": kernel,
              "plain_bf16" if bf16 else "plain_f32": plain, "ratio": ratio,
              "tol": "kernel <= %g x plain, each error" % limit})
        check(all(kernel[n][e] <= limit * plain[n][e] for n in names
                  for e in kernel[n]),
              "fused_ce %s errors against f64 %s, plain %s"
              % (name, kernel, plain))
        del x, w, b, y, exact, got, ref


def phase_timing(torch, dev):
    """Each kernel at the served shapes (the top batch rung, 8 x 128
    tokens, f32), beside its plain version, one PyTorch library call as a
    yardstick (timed here only; the port never calls it), and its bound."""
    gen = torch.Generator().manual_seed(SEED)
    rows = flash_kernel_timing(torch, dev, gen)
    rows.update(_train_kernel_timing(torch, dev, gen))
    rows.update(_conv_kernel_timing(torch, dev))
    rows.update(bandwidth_kernel_timing(torch, dev))
    _add_bandwidth_plans(torch, dev, rows)
    for name, r in _bf16_kernel_timing(torch, dev, gen).items():
        rows[name]["bf16"] = r
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


def _bf16_kernel_timing(torch, dev, gen, only=None):
    """The bf16 forms (AMP) of rows 1-9 at Transformer-base's training
    shapes, each beside its plain version on the same bf16 inputs, one
    PyTorch call on bf16 as a yardstick (timed here only; the port never
    calls it) and its bound: the flash kernels (encoder call, key padding
    bias) against ``F.scaled_dot_product_attention`` forward and backward,
    the LayerNorm kernels against ``F.layer_norm`` forward and backward,
    and the fused CE against the bf16 projection alone. The flash and CE
    bounds take their products at the bf16 tensor-core rate, the
    LayerNorm's their f32 arithmetic on the FMA pipes, all against their
    bytes (each input read once, each output written once). The flash
    forward, flash backward and CE rows also time the mma.sync form on the
    same inputs (``mma_sync_ms``). ``only``: the rows to time (all by default; the
    inputs are drawn alike either way). ``tools/flash_ab.py`` times
    another checkout's flash forward and CE through this function."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fce
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    def want(name):
        return only is None or name in only

    def on_mma_sync(mod, route, fn, **kw):
        """fn's time with ``mod``'s bf16 route (``route``: fwd_form,
        bwd_form or ce_form) sending it to the mma.sync form, for the two
        forms in one call; None where the package has no such route."""
        if getattr(mod, route, None) is None:
            return None
        with mma_sync_route(mod, route):
            return time_ms(fn, **kw)

    bf = torch.bfloat16
    rows = {}
    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    h, hd = TRANSFORMER["n_head"], TRANSFORMER["d_model"]
    d = hd // h
    q, k, v, dout = (torch.randn(b, t, hd, generator=gen).to(dev, bf)
                     for _ in range(4))
    kb = _padding_bias(torch, gen, b, t, dev)
    out, lse = fa.flash_attention_fwd(q, k, v, h, kb)
    mask = kb[:, None, None, :].to(bf)

    def split(x):
        return x.view(b, t, h, d).transpose(1, 2)

    lib_in = [split(x).detach().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=mask)
    nbytes = 2 * 4 * b * t * hd + 4 * (b * t + b * h * t)
    bnd, by = bf16_bound(nbytes, 4 * b * h * t * t * d)
    if want("flash_attention_fwd"):
        rows["flash_attention_fwd"] = dict(
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, h, kb),
                       iters=20),
            plain_ms=time_ms(lambda: fa.attention_plain(q, k, v, h, kb),
                             iters=20),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                split(q), split(k), split(v), attn_mask=mask), iters=20),
            library="F.scaled_dot_product_attention (bf16)",
            mma_sync_ms=on_mma_sync(
                fa, "fwd_form",
                lambda: fa.flash_attention_fwd(q, k, v, h, kb), iters=20),
            bound_ms=bnd, bound_by=by, shape=[b, t, t, h, d], bytes=nbytes)
    nbytes = 2 * 8 * b * t * hd + 4 * (b * h * t + b * t)
    bnd, by = bf16_bound(nbytes, 10 * b * h * t * t * d)
    if want("flash_attention_bwd"):
        rows["flash_attention_bwd"] = dict(
            ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                      dout, h, kb),
                       iters=20),
            mma_sync_ms=on_mma_sync(
                fa, "bwd_form", lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, dout, h, kb), iters=20),
            plain_ms=time_ms(lambda: fa.attention_bwd_plain(
                q, k, v, out, lse, dout, h, kb), iters=10),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, lib_in, split(dout), retain_graph=True), iters=20),
            library="F.scaled_dot_product_attention backward (bf16, autograd)",
            bound_ms=bnd, bound_by=by, shape=[b, t, t, h, d], bytes=nbytes)
    del q, k, v, dout, out, lse, lib_in, lib_out

    n = b * t
    x = torch.randn(n, hd, generator=gen).to(dev, bf)
    dy = torch.randn(n, hd, generator=gen).to(dev, bf)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
    nbytes = 2 * 2 * n * hd + 4 * (2 * n + 2 * hd)
    bnd, by = bound(nbytes, 8 * n * hd)
    if want("layer_norm_fwd"):
        rows["layer_norm_fwd"] = dict(
            ms=time_ms(lambda: fln.layer_norm_fwd(x, g, bb, 1e-5)),
            plain_ms=time_ms(lambda: fln.layer_norm_plain(x, g, bb, 1e-5)),
            library_ms=time_ms(lambda: F.layer_norm(x, (hd,), g.to(bf),
                                                    bb.to(bf), 1e-5)),
            library="F.layer_norm (bf16)", bound_ms=bnd, bound_by=by,
            shape=[n, hd], bytes=nbytes)
    p_in = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
            bb.clone().requires_grad_(True)]
    p_out = fln.layer_norm_plain(*p_in, 1e-5)[0]
    l_in = [x.clone().requires_grad_(True),
            g.to(bf).clone().requires_grad_(True),
            bb.to(bf).clone().requires_grad_(True)]
    l_out = F.layer_norm(l_in[0], (hd,), l_in[1], l_in[2], 1e-5)
    nbytes = 2 * 3 * n * hd + 4 * (2 * n + 3 * hd)
    bnd, by = bound(nbytes, 12 * n * hd)
    if want("layer_norm_bwd"):
        rows["layer_norm_bwd"] = dict(
            ms=time_ms(lambda: fln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)),
            plain_ms=time_ms(lambda: torch.autograd.grad(p_out, p_in, dy,
                                                          retain_graph=True)),
            library_ms=time_ms(lambda: torch.autograd.grad(l_out, l_in, dy,
                                                           retain_graph=True)),
            library="F.layer_norm backward (bf16, autograd)",
            bound_ms=bnd, bound_by=by, shape=[n, hd], bytes=nbytes)
    del x, dy, p_in, p_out, l_in, l_out

    vv = TRANSFORMER["trg_vocab"]
    x = torch.randn(n, hd, generator=gen).to(dev, bf)
    w = (torch.randn(hd, vv, generator=gen) / hd ** 0.5).to(dev, bf)
    y = torch.randint(0, vv, (n,), generator=gen).to(dev)
    nbytes = 2 * (n * hd + hd * vv) + 4 * 3 * n
    bnd, by = bf16_bound(nbytes, 2 * n * hd * vv)
    if want("fused_ce_fwd"):
        rows["fused_ce_fwd"] = dict(
            ms=time_ms(lambda: fce.fused_ce_fwd(x, w, None, y, 0.1), iters=10,
                       warmup=2),
            plain_ms=time_ms(lambda: fce.linear_smooth_ce_plain(x, w, None, y,
                                                                0.1),
                             iters=10, warmup=2),
            library_ms=time_ms(lambda: torch.matmul(x, w), iters=10, warmup=2),
            library="torch.matmul(x, w) on bf16, projection only",
            mma_sync_ms=on_mma_sync(
                fce, "ce_form",
                lambda: fce.fused_ce_fwd(x, w, None, y, 0.1), iters=10,
                warmup=2),
            bound_ms=bnd, bound_by=by, shape=[n, hd, vv], bytes=nbytes)
    return rows


def _train_kernel_timing(torch, dev, gen):
    """The LayerNorm backward and fused CE kernels at
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

    # LayerNorm backward: one [B*T, 512] normalisation (the step launches
    # it 32 times at this shape; the forward is _ln_fwd_timing's)
    n = b * t
    x = torch.randn(n, hd, generator=gen).to(dev)
    dy = torch.randn(n, hd, generator=gen).to(dev)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
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
        kind = ("flash_attention_fwd" if "flash_fwd_" in name
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


def _optimizer(fluid, amp):
    """Adam(1e-4), under ``fluid.amp.decorate`` when ``amp`` (as
    paddle_tpu's bench.py:225-231 wraps it)."""
    opt = fluid.optimizer.Adam(learning_rate=1e-4)
    return fluid.amp.decorate(opt) if amp else opt


def build_transformer(fluid, dropout_rate, amp=False):
    """Transformer-base with Adam(1e-4), as paddle_tpu's bench.py trains
    it, in fresh programs, in f32 or under ``amp.decorate``. Returns
    (main, startup, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.transformer.transformer_base(
            dropout_rate=dropout_rate, **TRANSFORMER)
        _optimizer(fluid, amp).minimize(spec.loss)
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


# An AMP check compares, per fetched quantity (a scalar by its relative
# difference, an array by its relative L2), the card's AMP step with the
# port's CPU AMP step, beside the CPU's AMP-vs-f32 distance and the CPU AMP
# step's own rounding sensitivity (its distance from the step on the
# parameters scaled by 1 + 2^-20, a few f32 ulps). A quantity separates
# AMP from f32 where AMP_SENSITIVITY_FACTOR x that sensitivity is below
# AMP_MARGIN x the AMP-vs-f32 distance, and so does the loss, which the
# card's forward reproduces far closer than the sensitivity (0.0 against
# it at 1.2e-6 on Transformer-base): the card must lie within AMP_MARGIN x
# the distance, where an f32 step lands at about the whole of it. Where
# the sensitivity is as large as the distance (a bf16 step at 12 layers is
# chaotic) the card is held to the larger of the distance and
# AMP_SENSITIVITY_FACTOR x the sensitivity. The card's f32 step, put
# through the same verdict, must fail it.
AMP_SENSITIVITY_FACTOR = 3.0
AMP_MARGIN = 0.5


def _amp_verdict(names, gpu, amp, f32, pert):
    """The verdict on a card step's fetches ``gpu`` against the CPU AMP
    step's ``amp``, as the comment above sets out: {"card", "ref",
    "sens"}: {name: the card's distance, the CPU's AMP-vs-f32 distance,
    the CPU AMP step's sensitivity}; "separating": the names held within
    AMP_MARGIN of the AMP-vs-f32 distance; "not_nearer_than_f32": the
    names whose card distance is not below it; "outside": the names
    outside their limit."""
    def dist(xs):
        return {n: _rel_l2(np.asarray(x), np.asarray(a))
                for n, x, a in zip(names, xs, amp)}

    card, ref, sens = dist(gpu), dist(f32), dist(pert)
    sep = [n for n in names if n == "loss" or
           AMP_SENSITIVITY_FACTOR * sens[n] < AMP_MARGIN * ref[n]]
    limit = {n: AMP_MARGIN * ref[n] if n in sep
             else max(ref[n], AMP_SENSITIVITY_FACTOR * sens[n])
             for n in names}
    return {"card": card, "ref": ref, "sens": sens, "separating": sep,
            "not_nearer_than_f32": sorted(n for n in names
                                          if not card[n] < ref[n]),
            "outside": sorted(n for n in names if not card[n] <= limit[n])}


def _amp_report(v, control):
    """The fields a check phase prints of its verdict ``v`` and of the
    card f32 step's ``control``: the three distances, the separating
    names with their distances, medians and maxima of the card's over the
    other two, and what the control's verdict found outside."""
    card, ref, sens = v["card"], v["ref"], v["sens"]
    names = list(card)
    out = {"card_vs_cpu_amp": card, "cpu_amp_vs_f32": ref,
           "cpu_amp_sensitivity": sens,
           "separating": {n: {"card": card[n], "amp_vs_f32": ref[n],
                              "control_f32_card": control["card"][n]}
                          for n in v["separating"]},
           "not_nearer_than_f32": v["not_nearer_than_f32"],
           "outside_tol": v["outside"],
           "control_f32_card_outside": control["outside"],
           "tol": "separating (loss; %g x sensitivity < %g x AMP-vs-f32): "
                  "card <= %g x CPU AMP vs f32; else card <= max(CPU AMP "
                  "vs f32, %g x sensitivity); the card's f32 step must "
                  "fail" % (AMP_SENSITIVITY_FACTOR, AMP_MARGIN, AMP_MARGIN,
                            AMP_SENSITIVITY_FACTOR)}
    for key, base in (("card_over_amp_vs_f32", ref),
                      ("card_over_sensitivity", sens)):
        r = [card[n] / max(base[n], 1e-30) for n in names]
        out[key] = {"median": float(np.median(r)), "max": max(r),
                    "max_name": names[int(np.argmax(r))]}
    for key, d in (("card_vs_cpu_amp", card), ("cpu_amp_vs_f32", ref),
                   ("cpu_amp_sensitivity", sens)):
        out[key + "_median"] = float(np.median(list(d.values())))
    return out


def _amp_checks(phase, v, control):
    check(not v["outside"], "%s: outside tolerance: %s"
          % (phase, v["outside"]))
    check(control["outside"], "%s: the card's f32 step passed the AMP "
          "check" % phase)


def _float_state_dtypes(torch, scope):
    """The dtypes of the floating tensors a scope holds (parameters and
    optimizer state)."""
    return sorted({str(scope.get(n).dtype) for n in scope.var_names()
                   if isinstance(scope.get(n), torch.Tensor)
                   and scope.get(n).is_floating_point()})


def _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                   want_counts):
    """One step of the AMP-marked ``main`` on the card, then from the same
    parameters one f32 step on the card (the control), one AMP and one
    f32 step with the port on the CPU, and one CPU AMP step on the
    parameters scaled by 1 + 2^-20. The card's AMP step must launch
    ``want_counts``, its kernels with a bf16 form all in bf16; its f32
    step the same counts, none in bf16. Returns a dict of the fetches
    ("gpu", "gpu_f32", "amp", "f32", "pert"), the card scope's floating
    dtypes after its AMP step ("dtypes"), the AMP step's launches
    ("counts", "bf16_counts") and the CPU steps' seconds ("cpu_s")."""
    params, out, cpu_s = None, {}, {}
    for key, amp in (("gpu", True), ("gpu_f32", False)):
        (fluid.amp.enable_bf16 if amp else fluid.amp.disable_bf16)(main)
        scope = fluid.Scope()
        exe = fluid.Executor()  # CUDAPlace(0)
        exe.run(startup, scope=scope)
        if params is None:
            params = {n: scope.get(n).cpu().numpy() for n in names}
        else:
            fluid.bridge.load_program_params(scope, params, main)
        reset_counts()
        out[key] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        counts, bf16 = read_counts(), read_bf16_counts()
        wgmma = read_wgmma_counts()
        check(counts == want_counts and bf16 == bf16_part(counts, amp)
              and wgmma == wgmma_part(counts, amp),
              "AMP check %s launches %s (bf16 %s, wgmma %s) != %s" % (
                  key, counts, bf16, wgmma, want_counts))
        if amp:
            out.update(dtypes=_float_state_dtypes(torch, scope),
                       counts=counts, bf16_counts=bf16, wgmma_counts=wgmma)
    for key, amp, scale in (("amp", True, 1.0), ("f32", False, 1.0),
                            ("pert", True, 1.0 + 2.0 ** -20)):
        (fluid.amp.enable_bf16 if amp else fluid.amp.disable_bf16)(main)
        cpu_scope = fluid.Scope()
        cexe = fluid.Executor(fluid.CPUPlace())
        cexe.run(startup, scope=cpu_scope)
        fluid.bridge.load_program_params(
            cpu_scope, {n: (v * np.float32(scale)).astype(v.dtype)
                        for n, v in params.items()}, main, "cpu")
        t0 = time.perf_counter()
        out[key] = cexe.run(main, feed=feed, fetch_list=fetch,
                            scope=cpu_scope)
        cpu_s[key] = time.perf_counter() - t0
    fluid.amp.enable_bf16(main)
    check(read_counts() == counts, "a CPU step launched a kernel")
    out["cpu_s"] = cpu_s
    return out


def phase_amp_train_check(torch, smi_line, batch=2):
    """One full-width Transformer-base step under ``fluid.amp.decorate``
    (dropout 0, batch 2) on the card, and from the same weights and feed
    the same step in f32 on the card and with the port on the CPU under
    AMP, in f32, and under AMP on the parameters scaled by 1 + 2^-20. The
    card runs the bf16 forms of the flash, LayerNorm and fused CE kernels
    (counted per dtype), the CPU their plain versions, which round where
    the kernels do. The loss and every parameter's gradient are held as
    the comment above ``AMP_SENSITIVITY_FACTOR`` sets out, and the card's
    f32 step must fail that verdict. Every parameter and Adam moment must
    still be f32 after the step."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_transformer(fluid, dropout_rate=0.0,
                                            amp=True)
    names = [p.name for p in main.all_parameters()]
    gb = main.global_block()
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in names]
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    seq = TRANSFORMER["seq_len"]
    feed["src_len"] = np.array([seq, seq * 3 // 4][:batch], "int64")
    feed["trg_len"] = np.array([seq, seq * 2 // 3][:batch], "int64")
    r = _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                       PER_STEP)
    runs = [r[k] for k in ("amp", "f32", "pert")]
    v = _amp_verdict(["loss"] + names, r["gpu"], *runs)
    control = _amp_verdict(["loss"] + names, r["gpu_f32"], *runs)
    gpu = r["gpu"]
    emit(dict({"phase": "amp_train_check", "batch": batch,
               "config": TRANSFORMER, "dropout": 0.0,
               "precision": "bf16 (fluid.amp.decorate)",
               "loss_gpu": float(gpu[0]), "loss_gpu_f32": float(
                   r["gpu_f32"][0]), "loss_cpu_amp": float(r["amp"][0]),
               "loss_cpu_f32": float(r["f32"][0]),
               "loss_cpu_amp_perturbed": float(r["pert"][0]),
               "state_dtypes": r["dtypes"], "launches": r["counts"],
               "bf16_launches": r["bf16_counts"],
               "wgmma_launches": r["wgmma_counts"],
               "cpu_amp_step_s": r["cpu_s"]["amp"],
               "cpu_f32_step_s": r["cpu_s"]["f32"], "device": smi_line},
              **_amp_report(v, control)))
    check(np.isfinite([float(gpu[0])]).all() and all(
        np.isfinite(g).all() for g in gpu[1:]),
        "non-finite loss or grads on the card")
    _amp_checks("amp_train_check", v, control)
    check(r["dtypes"] == ["torch.float32"], "AMP state dtypes %s"
          % r["dtypes"])
    return v["card"]


_MARKS = (("flash_fwd_", "flash_attention_fwd"),  # both forms' kernels
          ("flash_bwd_", "flash_attention_bwd"),  # both forms, the prep
          ("conv_apply_wgmma_kernel", "conv_apply"),
          ("conv_moments_wgmma_kernel", "conv_moments"),
          # the wgmma forms' channels-last copy, named for its reader
          ("nchw_to_nhwc_kernel<false>", "conv_apply"),
          ("nchw_to_nhwc_kernel<true>", "conv_moments"),
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
    is conv_moments' main launch, true conv_apply's; the wgmma forms' own
    kernels count with their wrapper's), a cuDNN convolution, a
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
    if ("gemm" in name or "cutlass" in name or "xmma" in name
            or "nvjet" in name):  # nvjet: cuBLAS's Hopper bf16 GEMMs
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
                prof_steps=3, amp=False):
    """The main path: Transformer-base trained with dropout 0.1 and
    Adam(1e-4) at 128 x 256 tokens per step on one fixed batch (an
    overfit check), in f32 (phase ``train``) or under
    ``fluid.amp.decorate`` (``amp_train``: the bf16 forms of the flash,
    LayerNorm and fused CE kernels). Launch counts are zeroed just before
    the first step and read after the last; every step must launch each
    kernel exactly PER_STEP times, under AMP all of them in bf16 and in
    f32 none (counted per dtype). The flash kernels' profiled ms per step
    is printed beside ``flash_ms`` (the ``timing`` phase's ms at the
    training shape, in the run's dtype) times their launches per step."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    main, startup, spec = build_transformer(fluid, dropout_rate=0.1,
                                            amp=amp)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(TRAIN_BATCH, np.random.RandomState(SEED))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, step_s = [], []

    def run_step():
        before = read_counts(), read_bf16_counts(), read_wgmma_counts()
        t = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                        scope=scope)  # to numpy: ends synchronised
        dt = time.perf_counter() - t
        after = read_counts(), read_bf16_counts(), read_wgmma_counts()
        per, per_bf16, per_wgmma = ({k: a[k] - b[k] for k in a}
                                    for a, b in zip(after, before))
        check(per == PER_STEP and per_bf16 == bf16_part(PER_STEP, amp)
              and per_wgmma == wgmma_part(PER_STEP, amp),
              "step %d launches %s (bf16 %s, wgmma %s) != %s"
              % (len(losses), per, per_bf16, per_wgmma, PER_STEP))
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
    q1, _, q3 = statistics.quantiles(step_s, n=4)
    emit({"phase": "amp_train" if amp else "train",
          "model": "transformer_base",
          "precision": "bf16 (fluid.amp.decorate)" if amp else "f32",
          "config": dict(TRANSFORMER, dropout_rate=0.1), "params": n_params,
          "batch": TRAIN_BATCH, "tokens_per_step": tokens,
          "optimizer": "Adam(1e-4)", "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "tokens_per_s": tokens / med,
          "tokens_per_s_range": [tokens / max(step_s), tokens / min(step_s)],
          "tokens_per_s_iqr": [tokens / q3, tokens / q1],
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
          "launches": launches, "bf16_launches": read_bf16_counts(),
          "wgmma_launches": read_wgmma_counts(),
          "launches_per_step": PER_STEP, "setup_s": setup_s,
          "device": smi_line})
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(device_ms["flash_attention_fwd"] > 0
          and device_ms["flash_attention_bwd"] > 0,
          "profiled flash kernels not recognised: %s" % device_ms)
    n_steps = warmup + steps + prof_steps
    check(launches == {k: n * n_steps for k, n in PER_STEP.items()},
          "train launches %s" % launches)
    if amp:
        dtypes = _float_state_dtypes(torch, scope)
        check(dtypes == ["torch.float32"], "AMP state dtypes %s" % dtypes)
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
    (:func:`_conv_f64_check`). Each geometry also checks the bf16 forms
    (:func:`_fused_conv_bf16_check`), and the bf16 conv_apply's wgmma form
    runs at every fused geometry of ResNet-50
    (:func:`_conv_apply_geometry_check`). Returns the f32 and the bf16
    forms' max abs errors, each {kernel: error}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = dict.fromkeys(("conv_moments", "bn_apply", "conv_apply"), 0.0)
    bf16 = dict(errs)
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
            _conv_f64_check(torch, name, x[:8], w, stride)
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
        del y, want
        _fused_conv_bf16_check(torch, name, shape, x, w, g, b, mean, var,
                               res, stride, relu, eps, bf16)
        del x, res
    _conv_apply_geometry_check(torch, dev, bf16)
    return errs, bf16


def _moments_bf16_check(torch, name, xb, wb, stride, errs, shape):
    """The bf16 conv_moments on bf16 inputs in the form its route names
    and, where that is the wgmma form, in the mma.sync form too, against
    its plain version (the f32 conv rounded once, the moments of the
    rounded co): co within one bf16 ulp, 2^-7 of max(1, max|plain|); the
    moments within 1e-5 of an f64 sum over the kernel's own stored co
    (relative to sum |co| and to sum co^2); co and the moments bitwise
    equal across two runs. ``shape``: the geometry's keys for each line.
    Updates ``errs`` (kernel -> max abs error); returns the plain co and
    the route's form."""
    from paddle_tpu_torch.ops import fused_conv as fc

    wco = fc.conv_moments_plain(xb, wb, stride)[0]
    form = fc.moments_form(xb, wb, stride)[0]
    for run in ((form, "mma_sync") if form == "wgmma" else (form,)):
        n_wgmma = fc.conv_moments.wgmma_launches
        with (mma_sync_route(fc, "moments_form") if run != form
              else contextlib.nullcontext()):
            co, s1, s2 = fc.conv_moments(xb, wb, stride)
            again = fc.conv_moments(xb, wb, stride)
        torch.cuda.synchronize()
        check(fc.conv_moments.wgmma_launches - n_wgmma
              == (2 if run == "wgmma" else 0),
              "%s bf16 conv_moments did not run its %s form" % (name, run))
        c = co.double()
        sums = (c.sum((0, 2, 3)), (c * c).sum((0, 2, 3)))
        rel = [((got.double() - want).abs() / scale_).max().item()
               for got, want, scale_ in (
                   (s1, sums[0], c.abs().sum((0, 2, 3))),
                   (s2, sums[1], sums[1]))]
        emit(dict({"phase": "fused_conv_check", "case": name + "_bf16",
                   "check": "conv_moments_bf16_sums_" + run,
                   "sum_rel_err": rel[0], "sum_sq_rel_err": rel[1],
                   "tol": "1e-5 of sum|co| and of sum co^2, f64 over the "
                          "kernel's own co"}, **shape))
        check(max(rel) <= 1e-5, "%s bf16 moments (%s) %s" % (name, run,
                                                              rel))
        check(all(torch.equal(p, q) for p, q in zip((co, s1, s2), again)),
              "%s: bf16 conv_moments (%s) differs between two runs"
              % (name, run))
        del c, sums, again
        errs["conv_moments"] = max(errs["conv_moments"], check_close(
            "fused_conv_check", name + "_bf16", [("co", co, wco)], 2.0 ** -7,
            check="conv_moments_bf16_" + run, **shape))
        del co
    return wco, form


def _fused_conv_bf16_check(torch, name, shape, x, w, g, b, mean, var, res,
                           stride, relu, eps, errs):
    """The bf16 forms (ResNet-50 under fluid.amp) of the three kernels on
    the bf16 roundings of one geometry's inputs, against their plain
    versions (the f32 conv rounded once; the affine, then the residual add,
    each rounded to bf16): co and y within one bf16 ulp, 2^-7 of
    max(1, max|plain|); the moments within 1e-5 of an f64 sum over the
    kernel's own stored co (relative to sum |co| and to sum co^2), bitwise
    equal across two runs; co against an f64 conv of the same bf16 inputs
    at most 1.5x the plain bf16 version's error (:func:`_conv_f64_check`);
    conv_moments and conv_apply in both their forms (the wgmma form their
    routes name here, and the mma.sync form). Updates ``errs`` (kernel ->
    max abs error)."""
    from paddle_tpu_torch.ops import fused_conv as fc

    tol = 2.0 ** -7
    xb, wb = x.bfloat16(), w.bfloat16()
    rb = res.bfloat16() if res is not None else None
    wco = _moments_bf16_check(torch, name, xb, wb, stride, errs, shape)[0]
    _conv_f64_check(torch, name + "_bf16", xb[:8], wb, stride)
    bm, bv = fc.bn_stats(wco)
    scale, shift = fc._scale_shift(g, b, bm, bv, eps)
    y = fc.bn_apply(wco, scale, shift, rb, relu)
    want = fc.bn_apply_plain(wco, scale, shift, rb, relu)
    torch.cuda.synchronize()
    errs["bn_apply"] = max(errs["bn_apply"], check_close(
        "fused_conv_check", name + "_bf16", [("y", y, want)], tol,
        check="bn_apply_bf16", **shape))
    del y, want, wco
    scale, shift = fc._scale_shift(g, b, mean, var, eps)
    want = fc.conv_apply_plain(xb, wb, scale, shift, rb, relu, stride)
    for form in ("wgmma", "mma_sync"):
        n_wgmma = fc.conv_apply.wgmma_launches
        if form == "wgmma":
            y = fc.conv_apply(xb, wb, scale, shift, rb, relu, stride)
        else:
            with mma_sync_route(fc, "apply_form"):
                y = fc.conv_apply(xb, wb, scale, shift, rb, relu, stride)
        torch.cuda.synchronize()
        check((fc.conv_apply.wgmma_launches > n_wgmma) == (form == "wgmma"),
              "%s bf16 conv_apply did not run its %s form" % (name, form))
        errs["conv_apply"] = max(errs["conv_apply"], check_close(
            "fused_conv_check", name + "_bf16", [("y", y, want)], tol,
            check="conv_apply_bf16_" + form, **shape))


def _conv_f64_check(torch, name, x, w, stride, apply=False):
    """The conv kernel's co against F.conv2d in float64 on the same inputs,
    by max abs error and relative L2 error, beside a yardstick on the same
    inputs. f32: cuDNN's f32 conv (TF32 off), and the kernel's error at
    most twice its in either (3xTF32 with f32 accumulation should match
    f32; a single TF32 product would be about 1000 times off). bf16: the
    plain bf16 version (the f32 conv rounded once), and the kernel's error
    at most 1.5x its (both are the bf16 rounding of co). ``apply``: the
    kernel is conv_apply with scale 1 and shift 0 (no residual, no relu),
    whose y is then its rounded conv, in the form its route names."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    pad = (w.shape[2] - 1) // 2
    exact = F.conv2d(x.double(), w.double(), stride=stride, padding=pad)

    def errs(t):
        d = t.double() - exact
        return {"max_abs_err": d.abs().max().item(),
                "rel_l2": (d.norm() / exact.norm()).item()}

    if apply:
        o = w.shape[0]
        ones = torch.ones(o, device=x.device)
        got = errs(fc.conv_apply(x, w, ones, ones * 0, None, False, stride))
    else:
        got = errs(fc.conv_moments(x, w, stride)[0])
    if x.dtype == torch.bfloat16:
        lib, what, factor = errs(fc.conv_moments_plain(x, w, stride)[0]), \
            "plain_bf16", 1.5
    else:
        lib, what, factor = errs(F.conv2d(x, w, stride=stride,
                                          padding=pad)), "cudnn_f32", 2.0
    emit({"phase": "fused_conv_check", "case": name, "check": "f64",
          "kernel_name": "conv_apply" if apply else "conv_moments",
          "x": list(x.shape), "w": list(w.shape),
          "K": w.shape[1] * w.shape[2] * w.shape[3], "kernel": got,
          what: lib, "ratio": {e: got[e] / max(lib[e], 1e-300) for e in got},
          "tol": "kernel <= %g x %s, each error" % (factor, what)})
    check(all(got[e] <= factor * lib[e] for e in got),
          "%s: conv error %s against f64, %s %s" % (name, got, what, lib))


# the wgmma conv_moments' masking cases beside ResNet-50's geometries:
# name, N, C, O, k, stride, H = W. Slots of a tile that no output pixel
# fills hold values that are not zero, and the moments must skip them:
# rows past Ho in the last row tile (30x30: rows of 8, rows 30-31 read
# input row 29 through the dy = 0 tap), images past N in the last image
# tile (7x7: tiles of 5 images), a stage's slots past the box (14x14:
# 196 of 256, read through the channels-last copy, 196 % 8 != 0), pixels
# past H*W in the last 256-pixel tile of the NCHW path (28x28: 784 = 3 x
# 256 + 16), and a 1x1 stride-2 conv's copy of every other pixel
WGMMA_MOMENTS_CASES = [
    ("rows_past_ho_3x3_64to64_30", 4, 64, 64, 3, 1, 30),
    ("images_past_n_3x3_512to512_7_n7", 7, 512, 512, 3, 1, 7),
    ("copy_path_1x1_1024to256_14", 3, 1024, 256, 1, 1, 14),
    ("nchw_ragged_1x1_512to128_28", 3, 512, 128, 1, 1, 28),
    ("stride2_1x1s2_256to512_56", 3, 256, 512, 1, 2, 56),
]


def _conv_apply_geometry_check(torch, dev, errs):
    """The bf16 conv_apply and conv_moments at every distinct fused
    geometry of ResNet-50 (read from the fusion's record, batch 128, a
    residual and relu where a site of the geometry has them), in the form
    their routes name, which must be the wgmma form at every one:
    conv_apply's y against the plain bf16 version within one bf16 ulp,
    2^-7 of max(1, max|plain|), and its rounded conv against an f64 conv
    of the same bf16 inputs (8 images) at most 1.5x the plain bf16
    version's error (:func:`_conv_f64_check`); conv_moments in both its
    forms (:func:`_moments_bf16_check`), there and at
    ``WGMMA_MOMENTS_CASES``. Updates ``errs`` (kernel -> max abs error)."""
    from paddle_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for name, n, c, o, k, stride, hw in WGMMA_MOMENTS_CASES:
        x, w = _conv_case(torch, gen, dev, c, o, k, stride, hw, False,
                          n=n)[:2]
        xb, wb = x.bfloat16(), w.bfloat16()
        del x, w
        form = _moments_bf16_check(torch, name, xb, wb, stride, errs, dict(
            x=list(xb.shape), w=list(wb.shape), stride=stride))[1]
        check(form == "wgmma", "conv_moments %s: form %s" % (name, form))
        del xb, wb
    geoms = resnet_conv_geometries()
    for (c, o, k, stride, hw), g in geoms.items():
        residual, relu = g["residual"] > 0, g["relu"] > 0
        x, w, gm, b, mean, var, res = _conv_case(torch, gen, dev, c, o, k,
                                                 stride, hw, residual)
        xb, wb = x.bfloat16(), w.bfloat16()
        rb = res.bfloat16() if res is not None else None
        del x, w, res
        scale, shift = fc._scale_shift(gm, b, mean, var, 1e-5)
        name = "%dx%d%s_%dto%d_%d" % (k, k, "s2" if stride == 2 else "", c,
                                      o, hw)
        form = fc.apply_form(xb, wb, stride, rb)
        check(form[0] == "wgmma", "conv_apply %s: form %s" % (name, form))
        n_wgmma = fc.conv_apply.wgmma_launches
        y = fc.conv_apply(xb, wb, scale, shift, rb, relu, stride)
        want = fc.conv_apply_plain(xb, wb, scale, shift, rb, relu, stride)
        torch.cuda.synchronize()
        check(fc.conv_apply.wgmma_launches == n_wgmma + 1,
              "conv_apply %s did not launch its wgmma form" % name)
        errs["conv_apply"] = max(errs["conv_apply"], check_close(
            "fused_conv_check", name + "_bf16", [("y", y, want)], 2.0 ** -7,
            check="conv_apply_bf16_wgmma", x=list(xb.shape),
            w=list(wb.shape), stride=stride, residual=residual, relu=relu,
            sites=g["sites"]))
        del y, want
        _conv_f64_check(torch, name + "_bf16_wgmma", xb[:8], wb, stride,
                        apply=True)
        form = _moments_bf16_check(torch, name, xb, wb, stride, errs, dict(
            x=list(xb.shape), w=list(wb.shape), stride=stride,
            sites=g["sites"]))[1]
        check(form == "wgmma", "conv_moments %s: form %s" % (name, form))
        del xb, wb, rb


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


def _on_mma_sync(route, fn):
    """fn's time with the bf16 fused conv's ``route`` (apply_form,
    moments_form) sending it to its mma.sync form."""
    from paddle_tpu_torch.ops import fused_conv as fc

    with mma_sync_route(fc, route):
        return time_ms(fn, iters=20)


def _conv_geometry_timing(torch, dev, gen):
    """Rows 10 and 12 at every distinct fused geometry of ResNet-50 at batch
    128 beside their plain versions, F.conv2d (cuDNN, TF32 off) and the
    bound, in f32 and in bf16 (the AMP forms, beside cuDNN's bf16 conv and
    the bf16 bound: products at 989 TFLOP/s against bf16 x, w and out;
    the bf16 conv_moments and conv_apply in both their forms, the wgmma
    form their routes name and the mma.sync form); one line per geometry
    and one with the sums weighted by sites.
    conv_apply takes a residual and relu where any site of the geometry
    does. Returns (the body's timings, the site-weighted sums)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    geoms = resnet_conv_geometries()
    n = RESNET_BATCH
    names = ("conv_moments", "conv_apply", "conv_moments_plain",
             "conv_apply_plain", "f_conv2d", "bound", "conv_moments_bf16",
             "conv_moments_mma_sync_bf16", "conv_apply_bf16",
             "conv_apply_mma_sync_bf16",
             "conv_moments_plain_bf16", "conv_apply_plain_bf16",
             "f_conv2d_bf16", "bound_bf16")
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
        xb, wb = x.bfloat16(), w.bfloat16()
        rb = res.bfloat16() if res is not None else None
        nbytes_bf16 = 2 * (x.numel() + w.numel() + out) + 4 * 2 * o
        t.update(
            conv_moments_bf16=time_ms(lambda: fc.conv_moments(xb, wb, stride),
                                      iters=20),
            conv_moments_mma_sync_bf16=_on_mma_sync(
                "moments_form", lambda: fc.conv_moments(xb, wb, stride)),
            conv_apply_bf16=time_ms(lambda: fc.conv_apply(
                xb, wb, scale, shift, rb, relu, stride), iters=20),
            conv_apply_mma_sync_bf16=_on_mma_sync(
                "apply_form", lambda: fc.conv_apply(
                    xb, wb, scale, shift, rb, relu, stride)),
            conv_moments_plain_bf16=time_ms(
                lambda: fc.conv_moments_plain(xb, wb, stride), iters=20),
            conv_apply_plain_bf16=time_ms(lambda: fc.conv_apply_plain(
                xb, wb, scale, shift, rb, relu, stride), iters=20),
            f_conv2d_bf16=time_ms(lambda: F.conv2d(xb, wb, stride=stride,
                                                   padding=pad), iters=20),
            bound_bf16=bf16_bound(nbytes_bf16, conv_flops)[0])
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
                   "apply_over_f_conv2d": t["conv_apply"] / t["f_conv2d"],
                   "bytes_bf16": nbytes_bf16,
                   "bound_by_bf16": bf16_bound(nbytes_bf16, conv_flops)[1],
                   "moments_bf16_over_f_conv2d_bf16":
                       t["conv_moments_bf16"] / t["f_conv2d_bf16"],
                   "apply_bf16_over_f_conv2d_bf16":
                       t["conv_apply_bf16"] / t["f_conv2d_bf16"],
                   "moments_form_bf16": fc.moments_form(xb, wb, stride)[0],
                   "apply_form_bf16": fc.apply_form(xb, wb, stride, rb)[0]},
                  **t))
        if (c, o, k, stride, hw) == (64, 64, 3, 1, 56):
            body = dict(t, bound_by=by, bound_ms_f32_fma=bnd_fma,
                        shape=[n, c, hw, hw, o, k], bytes=nbytes,
                        flops=conv_flops, bytes_bf16=nbytes_bf16,
                        bound_by_bf16=bf16_bound(nbytes_bf16,
                                                 conv_flops)[1])
        del x, w, res, xb, wb, rb
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
            site_weighted_ms=total[name],
            bf16=dict(ms=body[name + "_bf16"],
                      plain_ms=body[name + "_plain_bf16"],
                      library_ms=body["f_conv2d_bf16"],
                      library="F.conv2d alone on bf16 (cuDNN): conv only, "
                              "no " + lib,
                      bound_ms=body["bound_bf16"],
                      bound_by=body["bound_by_bf16"], shape=body["shape"],
                      bytes=body["bytes_bf16"], flops=body["flops"],
                      site_weighted_ms=total[name + "_bf16"],
                      site_weighted_library_ms=total["f_conv2d_bf16"],
                      site_weighted_bound_ms=total["bound_bf16"]))
    for name in ("conv_moments", "conv_apply"):
        rows[name]["bf16"].update(
            mma_sync_ms=body[name + "_mma_sync_bf16"],
            site_weighted_mma_sync_ms=total[name + "_mma_sync_bf16"])
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
    cob, resb = co.bfloat16(), res.bfloat16()
    nbytes = 2 * 3 * co.numel() + 4 * 2 * o
    bnd, by = bound(nbytes, 3 * co.numel())
    rows["bn_apply"]["bf16"] = dict(
        ms=time_ms(lambda: fc.bn_apply(cob, scale, shift, resb, True)),
        plain_ms=time_ms(lambda: fc.bn_apply_plain(cob, scale, shift, resb,
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {}
    # name, ids, non-zero table, K, table 16-byte aligned, merged first
    # (sort=True: duplicates summed, their slots parked on the sentinel V)
    cases = [("deepfm_densify_uniform", "uniform", False, k, True, False),
             ("sgd_nonzero_base", "uniform", True, k, True, False),
             ("wrap_drop", "wrap_drop", False, k, True, False),
             ("one_row", "one_row", False, k, True, False),
             ("zipf_1.2", "zipf", False, k, True, False),
             ("zipf_1.2_sorted", "zipf", False, k, True, True),
             ("zipf_1.2_k4_unaligned", "zipf", True, 4, False, False),
             ("zipf_1.2_k33", "zipf", True, 33, True, False)]
    for i, (name, kind, nonzero, k, aligned, sort) in enumerate(cases):
        rows = _deepfm_rows(torch, kind, n, v, SEED + i).to(dev)
        vals = torch.randn(n, k, generator=gen, device=dev)
        base = (torch.randn(v, k, generator=gen, device=dev) if nonzero
                else torch.zeros(v, k, device=dev))
        if aligned:
            got = sc.scatter_add_rows(base, rows, vals, sort=sort)
        else:  # added in place into a table one float past an alignment
            got = torch.empty(v * k + 1, device=dev)[1:].view(v, k)
            got.copy_(base)
            sc.scatter_add_rows(got, rows, vals, sort=sort, inplace=True)
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
              "shape": [v, k, n], "nonzero_base": nonzero, "sort": sort,
              "plan": list(sc.scatter_plan(n, k, aligned, sms)),
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
    the kernel on Zipf-skewed ids with their own bound (the bytes of the
    rows they touch)."""
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
    touched = int(torch.unique(zipf).numel())
    z_bytes = 4 * (n * k + n + 2 * touched * k)
    z_bnd, _ = bound(z_bytes, n * k)
    row = dict(
        ms=time_ms(lambda: sc.scatter_add(out, rows, vals)),
        plain_ms=time_ms(lambda: sc.scatter_add_plain(out, rows, vals,
                                                      inplace=True)),
        library_ms=time_ms(lambda: out.index_add_(0, rows64, vals)),
        library="Tensor.index_add_ (int64 rows, all in range)",
        zipf_ms=time_ms(lambda: sc.scatter_add(out, zipf, vals)),
        zipf_bound_ms=z_bnd, zipf_rows_touched=touched, zipf_bytes=z_bytes,
        bound_ms=bnd, bound_by=by, shape=[v, k, n], bytes=nbytes,
        flops=n * k)
    return {"scatter_add": row}


def _ln_fwd_timing(torch, dev):
    """Row 7, f32, at the served shape ``LN_SERVED`` with the training
    shape ``LN_TRAINED`` in ``trained_shape``: each beside its plain
    version, ``F.layer_norm`` as a yardstick (timed here only; the port
    never calls it) and its bound."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED + 3)
    out = {}
    for key, (n, hd) in (("served", LN_SERVED), ("trained", LN_TRAINED)):
        x = torch.randn(n, hd, generator=gen).to(dev)
        g = torch.randn(hd, generator=gen).to(dev)
        bb = torch.randn(hd, generator=gen).to(dev)
        nbytes = 4 * (2 * n * hd + 2 * hd + 2 * n)
        flops = 8 * n * hd
        bnd, by = bound(nbytes, flops)
        out[key] = dict(
            ms=time_ms(lambda: fln.layer_norm_fwd(x, g, bb, 1e-5)),
            plain_ms=time_ms(lambda: fln.layer_norm_plain(x, g, bb, 1e-5)),
            library_ms=time_ms(lambda: F.layer_norm(x, (hd,), g, bb, 1e-5)),
            library="F.layer_norm", bound_ms=bnd, bound_by=by,
            shape=[n, hd], bytes=nbytes, flops=flops)
    out["served"]["trained_shape"] = out["trained"]
    return {"layer_norm_fwd": out["served"]}


def bandwidth_kernel_timing(torch, dev):
    """Rows 7 and 13, the kernels bound by bytes: ``_ln_fwd_timing`` and
    ``_scatter_kernel_timing``, through the wrappers' own API only, so
    ``tools/bandwidth_ab.py`` times another checkout's kernels through this
    function."""
    rows = _ln_fwd_timing(torch, dev)
    rows.update(_scatter_kernel_timing(torch, dev))
    return rows


def ln_bwd_bf16_timing(torch, dev):
    """Row 8's bf16 form at Transformer-base's training shape
    ``LN_TRAINED`` (bf16 x and dy, f32 gamma), through the wrappers' own
    API only, beside ``F.layer_norm``'s backward on the same bf16 inputs:
    ``tools/bandwidth_ab.py`` times another checkout's kernel through this
    function."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED + 4)
    n, hd = LN_TRAINED
    bf = torch.bfloat16
    x = torch.randn(n, hd, generator=gen).to(dev, bf)
    dy = torch.randn(n, hd, generator=gen).to(dev, bf)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
    l_in = [x.clone().requires_grad_(True),
            g.to(bf).clone().requires_grad_(True),
            bb.to(bf).clone().requires_grad_(True)]
    l_out = F.layer_norm(l_in[0], (hd,), l_in[1], l_in[2], 1e-5)
    return {"ms": time_ms(lambda: fln.layer_norm_bwd(x, g, mean, var, dy,
                                                     1e-5)),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                l_out, l_in, dy, retain_graph=True)),
            "shape": [n, hd]}


def _add_bandwidth_plans(torch, dev, rows):
    """The plans rows 7 and 13 ran under in ``bandwidth_kernel_timing``,
    into their rows (``plan``)."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln
    from paddle_tpu_torch.ops import scatter as sc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ln = rows["layer_norm_fwd"]
    for r, (n, hd) in ((ln, LN_SERVED), (ln["trained_shape"], LN_TRAINED)):
        r["plan"] = list(fln.ln_fwd_plan(n, hd, torch.float32, sms))
    v, k, n = rows["scatter_add"]["shape"]
    rows["scatter_add"]["plan"] = list(sc.scatter_plan(n, k, True, sms))


def build_deepfm(fluid, amp=False):
    """DeepFM with Adam(1e-4), as paddle_tpu's bench.py trains it, in fresh
    programs, in f32 or under ``amp.decorate``. Returns (main, startup,
    spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.deepfm.deepfm(**DEEPFM)
        _optimizer(fluid, amp).minimize(spec.loss)
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


def phase_deepfm_amp_train_check(torch, smi_line, batch=64):
    """One full-width DeepFM step under ``fluid.amp.decorate`` (batch 64)
    on the card, and from the same weights and feed the same step in f32
    on the card and with the port on the CPU under AMP, in f32 and under
    AMP on the parameters scaled by 1 + 2^-20: the MLP's products run bf16
    through ``mul``, the gathered rows go on in bf16, and the table's
    (rows, values) gradient and the scatter-add kernel stay f32. The
    loss, ``prob``, the sparse gradient's values and each dense
    parameter's gradient are held as ``amp_train_check`` holds its
    quantities, and the card's f32 step must fail that verdict; the
    sparse rows must be equal; every parameter and Adam moment must still
    be f32 after the step."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_deepfm(fluid, amp=True)
    gb = main.global_block()
    names = [p.name for p in main.all_parameters()]
    dense = [n for n in names if n != "fm_table"]
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    fetch = [spec.loss, spec.fetches["prob"], gb.var("fm_table@GRAD@ROWS"),
             gb.var("fm_table@GRAD")] + [gb.var(n + "@GRAD") for n in dense]
    r = _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                       DEEPFM_PER_STEP)
    keep = [i for i in range(len(fetch)) if i != 2]  # not the sparse rows
    quantities = ["loss", "prob", "fm_table@GRAD"] + [
        n + "@GRAD" for n in dense]
    runs = [[r[k][i] for i in keep] for k in ("amp", "f32", "pert")]
    v = _amp_verdict(quantities, [r["gpu"][i] for i in keep], *runs)
    control = _amp_verdict(quantities, [r["gpu_f32"][i] for i in keep],
                           *runs)
    gpu = r["gpu"]
    rows_equal = bool(np.array_equal(gpu[2], r["amp"][2]))
    emit(dict({"phase": "deepfm_amp_train_check", "batch": batch,
               "config": DEEPFM, "precision": "bf16 (fluid.amp.decorate)",
               "loss_gpu": float(gpu[0]),
               "loss_gpu_f32": float(r["gpu_f32"][0]),
               "loss_cpu_amp": float(r["amp"][0]),
               "loss_cpu_f32": float(r["f32"][0]),
               "sparse_grad_rows_equal": rows_equal,
               "state_dtypes": r["dtypes"], "launches": r["counts"],
               "cpu_amp_step_s": r["cpu_s"]["amp"],
               "cpu_f32_step_s": r["cpu_s"]["f32"], "device": smi_line},
              **_amp_report(v, control)))
    check(np.isfinite(gpu[1]).all(), "non-finite prob on the card")
    check(rows_equal, "the sparse grad's rows differ")
    _amp_checks("deepfm_amp_train_check", v, control)
    check(r["dtypes"] == ["torch.float32"], "AMP state dtypes %s"
          % r["dtypes"])
    return v["card"]


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


def phase_deepfm_train(torch, smi_line, warmup=3, steps=20, prof_steps=2,
                       amp=False):
    """The main path: DeepFM (BASELINE config 5) trained with Adam(1e-4) at
    batch 32768 on one fixed batch from ``spec.sample_batch(32768,
    RandomState(0))``, staged on the card once, in f32 (phase
    ``deepfm_train``) or under ``fluid.amp.decorate`` (``deepfm_amp_train``:
    bf16 MLP products, the f32 table and scatter). Launch counts are zeroed
    just before the first step and read after the last; every step must
    launch the scatter kernel exactly once and nothing else of the
    port's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.framework import torch_dtype

    t0 = time.perf_counter()
    main, startup, spec = build_deepfm(fluid, amp=amp)
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
    emit({"phase": "deepfm_amp_train" if amp else "deepfm_train",
          "model": "deepfm", "config": DEEPFM,
          "table": [DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH],
          "params": n_params, "batch": DEEPFM_BATCH,
          "dtype": "bf16 (fluid.amp.decorate)" if amp else "float32",
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


def build_resnet(fluid, amp=False):
    """ResNet-50 with Adam(1e-4), as paddle_tpu's bench.py trains it, in
    fresh programs (under ``fluid.amp.decorate`` when ``amp``), and its
    for_test clone (which drops the AMP mark, as in the reference).
    Returns (main, startup, test, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.resnet.resnet_imagenet(**RESNET)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        (fluid.amp.decorate(opt) if amp else opt).minimize(spec.loss)
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


# A whole AMP step of randomly initialised ResNet-50 is chaotic: scaling
# the parameters by 1 + 2^-20 moves the CPU AMP step's gradients by 1.1
# relative L2 (median over the 161 gradients, 224 x 224 at batch 2 and
# 16) and its loss by 0.1-0.6%, as far as AMP moves them from f32 (1.25,
# 0.3-0.8%): every bf16 rounding flip is amplified through 53 batch-
# statistic BNs, and no quantity separates AMP from f32. So the card is
# held to the CPU op by op ("forced"): every forward op of the step runs
# once on the inputs the CPU's AMP chain gave it, with the VJP of one
# seeded cotangent, on the card and on the CPU, under AMP and (the control
# and the yardstick) in f32 on the widened inputs. Over all outputs, and
# over all input gradients, the card lies within AMP_MARGIN of the CPU's
# AMP-vs-f32 distance of the CPU's AMP values, and no single quantity
# further than max(its AMP-vs-f32 distance, FORCED_FLOOR); the card's f32
# control must fail.
FORCED_FLOOR = 1e-5  # relative L2: two f32 computations of one op


def _forced_chain(torch, main, fetch_names, params, feed):
    """The forward ops of ``main``'s step (fused as the executor runs them)
    and, for each, its inputs as the port's AMP chain on the CPU computes
    them from ``params`` and ``feed``."""
    from paddle_tpu_torch.core import op_registry as reg
    from paddle_tpu_torch.core.executor import fused_ops, to_tensor

    ops, _ = fused_ops(main, fetch_names)
    ops = ops[:[o.type for o in ops].index("autodiff")]
    gb = main.global_block()
    cpu = torch.device("cpu")
    env = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    env.update({n: to_tensor(v, cpu, gb.var(n)) for n, v in feed.items()})
    env[reg.DEVICE_KEY] = cpu
    env[reg.RNG_KEY] = torch.Generator().manual_seed(SEED)
    inputs = []
    with torch.no_grad(), reg.amp_scope(True):
        for op in ops:
            inputs.append({n: env[n] for n in op.input_arg_names
                           if n in env})
            reg.run_op(env, op)
    return ops, inputs


def _forced_run(torch, ops, inputs, device, amp, cts):
    """Each op once on its recorded inputs (on ``device``; floating inputs
    widened to f32 unless ``amp``), with the VJP of the cotangents ``cts``
    ({(op index, output name): CPU tensor}; filled with seeded normals in
    the outputs' dtypes on first use). Returns {(op index, type, "out" or
    "grad", name): f32 CPU tensor}."""
    from paddle_tpu_torch.core import op_registry as reg

    gen = torch.Generator().manual_seed(SEED + 7)
    out = {}
    for i, (op, ins) in enumerate(zip(ops, inputs)):
        env = {reg.DEVICE_KEY: device,
               reg.RNG_KEY: torch.Generator(device=device).manual_seed(SEED)}
        leaves = {}
        for n, t in ins.items():
            if isinstance(t, torch.Tensor):
                t = t.to(device)
                if t.is_floating_point():
                    t = (t if amp else t.float()).detach().requires_grad_(True)
                    leaves[n] = t
            env[n] = t
        with reg.amp_scope(amp):
            reg.run_op(env, op)
        outs = {n: env[n] for n in op.output_arg_names
                if isinstance(env.get(n), torch.Tensor)
                and env[n].is_floating_point()}
        pairs = []
        for n, t in outs.items():
            out[(i, op.type, "out", n)] = t.detach().float().cpu()
            if t.requires_grad:
                if (i, n) not in cts:
                    cts[(i, n)] = torch.randn(t.shape, generator=gen).to(
                        t.dtype)
                pairs.append((t, cts[(i, n)].to(device, t.dtype)))
        grads = torch.autograd.grad(
            [p[0] for p in pairs], list(leaves.values()),
            [p[1] for p in pairs], allow_unused=True) if pairs and leaves \
            else [None] * len(leaves)
        for (n, t), g in zip(leaves.items(), grads):
            out[(i, op.type, "grad", n)] = torch.zeros(t.shape) if g is None \
                else g.detach().float().cpu()
        del env, leaves, outs, pairs, grads
    return out


def _forced_verdict(card, amp, f32):
    """Distances (relative L2) of ``card`` and ``f32`` from ``amp`` per
    quantity and aggregated per kind ("out", "grad"), and the quantities
    and kinds outside their limits (see the comment above FORCED_FLOOR)."""
    per, agg = {}, {}
    for key, want in amp.items():
        wn = float(want.double().norm())
        dc = float((card[key].double() - want.double()).norm())
        df = float((f32[key].double() - want.double()).norm())
        per[key] = (dc / max(wn, 1e-30), df / max(wn, 1e-30))
        a = agg.setdefault(key[2], [0.0, 0.0, 0.0])
        a[0] += dc * dc
        a[1] += df * df
        a[2] += wn * wn
    agg = {k: {"card": (c / w) ** 0.5, "amp_vs_f32": (f / w) ** 0.5}
           for k, (c, f, w) in agg.items()}
    outside = ["%d:%s:%s:%s" % k for k, (c, f) in per.items()
               if not c <= max(f, FORCED_FLOOR)]
    outside += [k for k, a in agg.items()
                if not a["card"] <= AMP_MARGIN * a["amp_vs_f32"]]
    worst = max(per, key=lambda k: per[k][0] / max(per[k][1], FORCED_FLOOR))
    return {"aggregate": agg, "outside": outside, "quantities": len(per),
            "worst": {"name": "%d:%s:%s:%s" % worst, "card": per[worst][0],
                      "amp_vs_f32": per[worst][1]}}


def phase_resnet_amp_train_check(torch, smi_line, batch=2):
    """One full-width ResNet-50 step (224 x 224, 1000 classes, batch 2)
    under ``fluid.amp.decorate`` on the card against the port's CPU AMP
    step from the same weights and feed. The card's AMP step must launch
    conv_moments and bn_apply 49 times each, all in bf16, and its f32 step
    (the control) the same in f32; every parameter and Adam moment stays
    f32; the loss and gradients are finite. The whole step's distances
    (``_amp_verdict``: card vs CPU AMP, CPU AMP vs f32, CPU AMP vs
    CPU AMP on parameters scaled by 1 + 2^-20) are printed: the step is
    chaotic (see the comment above FORCED_FLOOR). The card is held op by
    op: ``_forced_verdict`` on the card's AMP ops, which must pass, and on
    its f32 ops, which must fail."""
    import paddle_tpu_torch as fluid

    main, startup, _, spec = build_resnet(fluid, amp=True)
    names = [p.name for p in main.all_parameters()]
    trainable = [p.name for p in main.all_parameters() if p.trainable]
    gb = main.global_block()
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in trainable]
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    t0 = time.perf_counter()
    r = _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                       RESNET_PER_STEP)
    step_s = time.perf_counter() - t0
    runs = [r[k] for k in ("amp", "f32", "pert")]
    v = _amp_verdict(["loss"] + trainable, r["gpu"], *runs)
    control = _amp_verdict(["loss"] + trainable, r["gpu_f32"], *runs)
    gpu = r["gpu"]
    check(np.isfinite([float(gpu[0])]).all() and all(
        np.isfinite(g).all() for g in gpu[1:]),
        "non-finite loss or grads on the card")
    check(r["dtypes"] == ["torch.float32"], "AMP state dtypes %s"
          % r["dtypes"])

    t0 = time.perf_counter()
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    params = {n: scope.get(n).numpy() for n in names}
    ops, inputs = _forced_chain(torch, main, [spec.loss.name], params,
                                feed)
    dev = fluid.CUDAPlace(0).torch_device()
    cts = {}
    cpu = torch.device("cpu")
    forced = {"amp": _forced_run(torch, ops, inputs, cpu, True, cts),
              "f32": _forced_run(torch, ops, inputs, cpu, False, cts),
              "card": _forced_run(torch, ops, inputs, dev, True, cts),
              "card_f32": _forced_run(torch, ops, inputs, dev, False, cts)}
    fv = _forced_verdict(forced["card"], forced["amp"], forced["f32"])
    fc_ = _forced_verdict(forced["card_f32"], forced["amp"], forced["f32"])
    forced_s = time.perf_counter() - t0
    del forced, inputs
    emit({"phase": "resnet_amp_train_check", "batch": batch,
          "config": RESNET, "precision": "bf16 (fluid.amp.decorate)",
          "loss_gpu": float(gpu[0]), "loss_gpu_f32": float(r["gpu_f32"][0]),
          "loss_cpu_amp": float(r["amp"][0]),
          "loss_cpu_f32": float(r["f32"][0]),
          "loss_cpu_amp_perturbed": float(r["pert"][0]),
          "state_dtypes": r["dtypes"], "launches": r["counts"],
          "bf16_launches": r["bf16_counts"],
          "cpu_amp_step_s": r["cpu_s"]["amp"],
          "cpu_f32_step_s": r["cpu_s"]["f32"], "whole_step_s": step_s,
          "whole_step": {k: w for k, w in _amp_report(v, control).items()
                         if k not in ("card_vs_cpu_amp", "cpu_amp_vs_f32",
                                      "cpu_amp_sensitivity")},
          "forced_ops": len(ops), "forced_s": forced_s,
          "forced_card": fv, "forced_card_f32_control": fc_,
          "tol": "forced: per kind card <= %g x CPU AMP vs f32, per "
                 "quantity card <= max(CPU AMP vs f32, %g); the card's f32 "
                 "ops must fail" % (AMP_MARGIN, FORCED_FLOOR),
          "device": smi_line})
    check(not fv["outside"], "resnet_amp_train_check: forced ops outside "
          "tolerance: %s" % fv["outside"][:20])
    check(fc_["outside"], "resnet_amp_train_check: the card's f32 ops "
          "passed the AMP check")
    return fv


def phase_resnet_train(torch, smi_line, conv_site_ms, warmup=3, steps=10,
                       prof_steps=2, amp=False, f32_step=None):
    """The main path: ResNet-50 trained with Adam(1e-4) at batch 128 (224
    x 224 x 3, 1000 classes) on one fixed batch, in f32 (phase
    ``resnet_train``) or under ``fluid.amp.decorate`` (``resnet_amp_train``:
    bf16 convs and activations, the bf16 forms of the fused-conv kernels,
    f32 parameters and Adam state). Launch counts are zeroed just before
    the first step and read after the last; every step must launch
    conv_moments and bn_apply 49 times each and nothing else of the port's,
    under AMP all in bf16, conv_moments all on its wgmma form, and in f32
    none. The fusion report must hold 53
    sites, the four declined ones those of RESNET_DECLINED, each for its
    geometry. The profiled conv_moments ms per step is printed beside
    ``conv_site_ms``, the sum of its per-geometry times weighted by sites
    (phase ``conv_geometry``), and under AMP the f32 step's summary
    ``f32_step`` beside the AMP one. Returns (launches, the trained model,
    the step's summary)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import fused_ops

    t0 = time.perf_counter()
    main, startup, test, spec = build_resnet(fluid, amp)
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
        before = read_counts(), read_bf16_counts(), read_wgmma_counts()
        t = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                        scope=scope)  # to numpy: ends synchronised
        dt = time.perf_counter() - t
        after = read_counts(), read_bf16_counts(), read_wgmma_counts()
        per, per_bf16, per_wgmma = ({k: a[k] - b[k] for k in a}
                                    for a, b in zip(after, before))
        check(per == RESNET_PER_STEP
              and per_bf16 == bf16_part(RESNET_PER_STEP, amp)
              and per_wgmma == wgmma_part(RESNET_PER_STEP, amp),
              "resnet step %d launches %s (bf16 %s, wgmma %s) != %s"
              % (len(losses), per, per_bf16, per_wgmma, RESNET_PER_STEP))
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
    q1, _, q3 = statistics.quantiles(step_s, n=4)
    summary = {"step_ms_median": med * 1e3,
               "images_per_s": RESNET_BATCH / med,
               "device_ms": busy, "device_ms_per_step": device_ms,
               "kernels_per_step": kernels_per_step,
               "device_busy_share": busy / (med * 1e3),
               "peak_memory_bytes": peak}
    emit({"phase": "resnet_amp_train" if amp else "resnet_train",
          "model": "resnet50",
          "config": RESNET, "params": n_params, "batch": RESNET_BATCH,
          "dtype": "bf16 (fluid.amp.decorate)" if amp else "float32",
          "optimizer": "Adam(1e-4)",
          "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "images_per_s": RESNET_BATCH / med,
          "images_per_s_range": [RESNET_BATCH / max(step_s),
                                 RESNET_BATCH / min(step_s)],
          "images_per_s_iqr": [RESNET_BATCH / q3, RESNET_BATCH / q1],
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
          "launches": launches, "bf16_launches": read_bf16_counts(),
          "wgmma_launches": read_wgmma_counts(),
          "launches_per_step": RESNET_PER_STEP, "f32_step": f32_step,
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
    if amp:
        dtypes = _float_state_dtypes(torch, scope)
        check(dtypes == ["torch.float32"], "AMP state dtypes %s" % dtypes)
    return launches, (exe, scope, main, test, spec, feed), summary


def phase_resnet_eval(torch, smi_line, trained, passes=5, small=2,
                      amp=False):
    """The main path: the trained model's ``main.clone(for_test=True)`` at
    batch 128 (moving statistics, the inference kernel at the 49 admitted
    sites), each pass launching conv_apply 49 times and nothing else of
    the port's; then the same clone at batch 2 on the card and with the
    port on the CPU from the card's trained weights. f32 (``resnet_eval``):
    logits within 1e-4 of max(1, max|CPU|), loss within 1e-4 relative,
    accuracy equal. Under AMP (``resnet_amp_eval``) the clone, which drops
    the mark as in the reference, is marked with ``fluid.amp.enable_bf16``:
    conv_apply launches in bf16, every launch in its wgmma form
    (``wgmma_launches``), and the logits and loss lie within
    AMP_MARGIN of the CPU's bf16-vs-f32 eval distance of the CPU's bf16
    eval (relative L2). Returns (launches, wgmma launches) of the
    passes."""
    import paddle_tpu_torch as fluid

    exe, scope, main, test, spec, feed = trained
    if amp:
        check(not getattr(test, "_amp_bf16", False),
              "the for_test clone kept the AMP mark")
        fluid.amp.enable_bf16(test)
    logits = [op.input("X").name for op in test.global_block().ops
              if op.type == "softmax"][0]
    fetch = [spec.loss.name, spec.fetches["acc"].name, logits]
    pass_s = []
    reset_counts()
    for _ in range(passes + 1):
        before = read_counts(), read_bf16_counts(), read_wgmma_counts()
        t = time.perf_counter()
        exe.run(test, feed=feed, fetch_list=fetch[:2], scope=scope)
        pass_s.append(time.perf_counter() - t)
        after = read_counts(), read_bf16_counts(), read_wgmma_counts()
        per, per_bf16, per_wgmma = ({k: a[k] - b[k] for k in a}
                                    for a, b in zip(after, before))
        check(per == RESNET_PER_EVAL
              and per_bf16 == bf16_part(RESNET_PER_EVAL, amp)
              and per_wgmma == wgmma_part(RESNET_PER_EVAL, amp),
              "eval pass launches %s (bf16 %s, wgmma %s) != %s"
              % (per, per_bf16, per_wgmma, RESNET_PER_EVAL))
    launches, bf16_launches = read_counts(), read_bf16_counts()
    wgmma_launches = read_wgmma_counts()

    small_feed = {k: v[:small] for k, v in feed.items()}
    gpu = exe.run(test, feed=small_feed, fetch_list=fetch, scope=scope)
    params = {p.name: scope.get(p.name).cpu().numpy()
              for p in main.all_parameters()}
    cpu_scope = fluid.Scope()
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    cexe = fluid.Executor(fluid.CPUPlace())
    before = read_counts()
    cpu = cexe.run(test, feed=small_feed, fetch_list=fetch, scope=cpu_scope)
    cpu_f32 = None
    if amp:
        fluid.amp.disable_bf16(test)
        cpu_f32 = cexe.run(test, feed=small_feed, fetch_list=fetch,
                           scope=cpu_scope)
        fluid.amp.enable_bf16(test)
    check(read_counts() == before, "the CPU eval launched a kernel")
    med = statistics.median(pass_s[1:])
    line = {"phase": "resnet_amp_eval" if amp else "resnet_eval",
            "model": "resnet50", "config": RESNET,
            "precision": "bf16 (clone + fluid.amp.enable_bf16)" if amp
            else "f32", "batch": RESNET_BATCH, "passes": passes,
            "pass_ms_median": med * 1e3,
            "pass_ms": [x * 1e3 for x in pass_s],
            "images_per_s": RESNET_BATCH / med,
            "small_batch": small, "loss_gpu": float(gpu[0]),
            "loss_cpu": float(cpu[0]), "acc_gpu": float(gpu[1]),
            "acc_cpu": float(cpu[1]), "launches": launches,
            "bf16_launches": bf16_launches, "wgmma_launches": wgmma_launches,
            "launches_per_pass": RESNET_PER_EVAL, "device": smi_line}
    if amp:
        card = {"loss": _rel_l2(gpu[0], cpu[0]),
                "logits": _rel_l2(gpu[2], cpu[2])}
        ref = {"loss": _rel_l2(cpu_f32[0], cpu[0]),
               "logits": _rel_l2(cpu_f32[2], cpu[2])}
        emit(dict(line, card_vs_cpu_bf16=card, cpu_bf16_vs_f32=ref,
                  loss_cpu_f32=float(cpu_f32[0]),
                  tol="card <= %g x CPU bf16 vs f32 (rel L2)" % AMP_MARGIN))
        check(all(card[n] <= AMP_MARGIN * ref[n] for n in card),
              "resnet_amp_eval: card %s, CPU bf16 vs f32 %s" % (card, ref))
        return launches, wgmma_launches
    errs = {"loss": abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            "logits": _elem_err(gpu[2], cpu[2])}
    emit(dict(line, errors=errs, tol=1e-4))
    check(max(errs.values()) <= 1e-4, "resnet_eval errors %s" % errs)
    check(float(gpu[1]) == float(cpu[1]), "accuracy differs")
    return launches, wgmma_launches


# GPT-2 small's published widths (Radford et al. 2019, the ``gpt2`` config:
# n_embd 768, n_head 12, n_layer 12, n_inner 3072, vocab_size 50257,
# n_positions 1024) on the repo's transformer_lm architecture (pre-norm,
# ReLU FFN, untied bias-free output projection)
GPT2 = dict(vocab=50257, d_model=768, d_ff=3072, n_head=12, n_layer=12,
            ctx_cap=1024, pos_cap=1024)
GPT2_PARAMS = 163000320
DRAFT_SEQ = 16
# launches of one step or chunk dispatch, and of one draft pass (the full
# causal program: its 12 attention layers take the flash forward)
PER_DISPATCH = per_run(layer_norm_fwd=2 * GPT2["n_layer"] + 1)
PER_DRAFT_PASS = per_run(layer_norm_fwd=2 * GPT2["n_layer"] + 1,
                         flash_attention_fwd=GPT2["n_layer"])
SYSTEM_PREFIX = 128


def build_lm_family(fluid, place):
    """The weight-sharing ``transformer_lm`` family at GPT-2-small widths
    in one scope on ``place``, random weights from seed 11 (the full
    program's startup): predictors of the step and chunk programs and the
    draft (the full program at seq 16, pruned to its logits, so no loss is
    computed), the specs, and the programs for the CPU copy."""
    from paddle_tpu_torch.inference import ProgramPredictor

    tr = fluid.models.transformer
    full_cfg = {k: v for k, v in GPT2.items() if k != "ctx_cap"}
    built = {}
    for name, build in (
            ("full", lambda: tr.transformer_lm(seq_len=DRAFT_SEQ, **full_cfg)),
            ("step", lambda: tr.transformer_lm_step(**GPT2)),
            ("chunk", lambda: tr.transformer_lm_chunk(**GPT2))):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            built[name] = (main, startup, build())
    full_main, full_start, spec = built["full"]
    full_start.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(place).run(full_start, scope=scope)
    logits = spec.extras["logits"]
    draft_main = full_main.prune([logits])
    op_types = [op.type for op in draft_main.global_block().ops]
    check("softmax_with_cross_entropy" not in op_types
          and op_types.count("flash_attention") == GPT2["n_layer"],
          "the pruned draft program's ops: %s" % sorted(set(op_types)))
    fam = {"scope": scope, "place": place, "programs": {},
           "n_params": sum(int(np.prod(p.shape))
                           for p in full_main.all_parameters()),
           "param_names": [p.name for p in full_main.all_parameters()]}
    for name in ("step", "chunk"):
        main, _startup, (fetch_vars, dspec) = built[name]
        feeds = [dspec["token_feed"], dspec["pos_feed"]] \
            + [c["feed"] for c in dspec["cache_feeds"]]
        fam["programs"][name] = (main, feeds, fetch_vars)
        fam[name] = ProgramPredictor(main, feeds, fetch_vars, scope=scope,
                                     place=place)
        fam[name + "_spec"] = dspec
    fam["programs"]["draft"] = (draft_main, ["ids"],
                                [draft_main.global_block().var(logits)])
    fam["draft"] = ProgramPredictor(*fam["programs"]["draft"], scope=scope,
                                    place=place)
    fam["logits"] = logits
    return fam


def _dispatch(pred, spec, caches, tokens, pos):
    """One step or chunk dispatch: (logits, the updated caches)."""
    feed = dict(caches)
    feed[spec["token_feed"]] = tokens
    feed[spec["pos_feed"]] = pos
    outs = pred.run(feed, return_numpy=False)
    return outs[0], {cf["feed"]: o
                     for cf, o in zip(spec["cache_feeds"], outs[1:])}


def _zero_caches(torch, spec, b, c, device):
    return {cf["feed"]: torch.zeros(b, c, GPT2["d_model"], device=device)
            for cf in spec["cache_feeds"]}


def _rel_l2_t(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _greedy_run(fluid, fam, reqs, ctx, **kw):
    """Greedy ids of ``reqs`` [(prompt, max_new)] through one
    ``DecodeBatcher`` driven on the calling thread at batch rung 4."""
    bat = fluid.serving.DecodeBatcher(fam["step"], fam["step_spec"],
                                      ladder=(4,), ctx_ladder=(ctx,),
                                      start=False, **kw)
    futs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
    bat.drive()
    check(bat.draft_failures == 0, "a draft pass raised")
    return [[int(t) for t in f.result(0)] for f in futs], bat


def phase_decode_check(torch, smi_line, tol=1e-4):
    """The decode tier at GPT-2-small widths against the port on the CPU
    and against itself (f32, TF32 off):

    * four teacher-forced step dispatches and one chunk dispatch of K = 16
      on the card and on the CPU from the same weights: logits within
      ``tol`` in relative L2 (and the carried caches);
    * exact launches: 25 ``layer_norm_fwd`` a step or chunk dispatch, 25 +
      12 ``flash_attention_fwd`` a draft pass;
    * the draft (the pruned full program, whose causal attention is the
      flash forward) at [8, 16] over histories of at most 16 tokens, where
      its positions are the target's: logits within ``tol`` of the CPU's
      and of the target's step logits, and each proposal the plain
      chain's next token, or a miss at a position whose top-2 margin is
      within 10x their largest difference;
    * ``kv_cache_write`` at positions -1 (wraps), C and C + 3 (drop) on
      the card, bitwise as on the CPU, with no device assert;
    * a request decoded alone and batched with strangers: bitwise the
      same ids at one (batch rung, ctx rung);
    * plain step-only, chunked-prefill and speculative decode: the same
      greedy ids, or a divergence at a position whose top-2 margin is
      within 10x the largest step-vs-chunk logit difference (a tie under
      another product shape, not a fault)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.opimpl.attention_ops import cache_write

    t0 = time.perf_counter()
    fam = build_lm_family(fluid, fluid.CUDAPlace(0))
    dev = fam["place"].torch_device()
    check(fam["n_params"] == GPT2_PARAMS, "%d parameters, not %d"
          % (fam["n_params"], GPT2_PARAMS))
    cpu_scope = fluid.Scope()
    for n in fam["param_names"]:
        cpu_scope.set(n, fam["scope"].get(n).cpu())
    cpu = {name: fluid.inference.ProgramPredictor(
        *fam["programs"][name], scope=cpu_scope, place=fluid.CPUPlace())
        for name in ("step", "chunk", "draft")}
    setup_s = time.perf_counter() - t0

    # (1) four steps and a chunk of 16, card against CPU
    rng = np.random.RandomState(SEED)
    b, c, k = 4, 64, 16
    toks = rng.randint(0, GPT2["vocab"], (b, 4 + k)).astype("int64")
    sspec, cspec = fam["step_spec"], fam["chunk_spec"]
    side = {"gpu": (fam["step"], fam["chunk"], dev),
            "cpu": (cpu["step"], cpu["chunk"], torch.device("cpu"))}
    logits, caches, counts = {}, {}, []
    for key, (step, chunk, d) in side.items():
        cache = _zero_caches(torch, sspec, b, c, d)
        outs = []
        for t in range(4):
            reset_counts()
            lg, cache = _dispatch(step, sspec, cache, toks[:, t],
                                  np.full((b,), t, "int32"))
            outs.append(lg)
            counts.append((key, "step", read_counts()))
        reset_counts()
        lg, cache = _dispatch(chunk, cspec, cache, toks[:, 4:],
                              np.tile(np.arange(4, 4 + k, dtype="int32"),
                                      (b, 1)))
        outs.append(lg.reshape(b * k, -1))
        counts.append((key, "chunk", read_counts()))
        logits[key] = torch.cat([o.cpu() for o in outs])
        caches[key] = cache
    for key, kind, n in counts:
        want = PER_DISPATCH if key == "gpu" else per_run()
        check(n == want, "decode_check %s %s dispatch launched %s"
              % (key, kind, n))
    l2 = _rel_l2_t(logits["gpu"], logits["cpu"])
    max_abs = float((logits["gpu"] - logits["cpu"]).abs().max())
    cache_l2 = max(_rel_l2_t(caches["gpu"][n], caches["cpu"][n])
                   for n in caches["cpu"])
    check(bool(torch.isfinite(logits["gpu"]).all()), "non-finite logits")

    draft = fluid.serving.DraftLM(fam["draft"], fam["logits"], DRAFT_SEQ,
                                  lbl_feed=None)

    # (3) out-of-range cache positions on the card
    gen = torch.Generator().manual_seed(SEED)
    cache0 = torch.randn(4, c, GPT2["d_model"], generator=gen)
    rows = torch.randn(4, 3, GPT2["d_model"], generator=gen)
    pos = torch.tensor([[-1, 0, 1], [c, c, c], [c + 3, 2, c], [5, -c, 7]],
                       dtype=torch.int32)
    got = cache_write(cache0.to(dev), rows.to(dev), pos.to(dev))
    torch.cuda.synchronize()
    want = cache_write(cache0, rows, pos)
    check(torch.equal(got.cpu(), want), "kv_cache_write out of range: the "
          "card differs from the CPU")
    check(torch.equal(want[0, c - 1], rows[0, 0])
          and torch.equal(want[1], cache0[1])
          and torch.equal(want[2, 2], rows[2, 1])
          and torch.equal(want[3, 0], rows[3, 1]),
          "kv_cache_write did not wrap -1 and -C or drop C and C + 3")

    # (4) solo vs batched with strangers, one (batch rung, ctx rung)
    prompt = list(rng.randint(0, GPT2["vocab"], 40))
    strangers = [(list(rng.randint(0, GPT2["vocab"], n)), m)
                 for n, m in ((23, 9), (9, 16), (57, 5))]
    solo, _ = _greedy_run(fluid, fam, [(prompt, 16)], 128)
    batched, _ = _greedy_run(fluid, fam, [(prompt, 16)] + strangers, 128)
    check(batched[0] == solo[0], "solo %s != batched %s"
          % (solo[0], batched[0]))

    # (5) plain vs chunked prefill vs speculative decode
    reqs = [(prompt, 16)] + [(p, 16) for p, _m in strangers]
    ladder = {"ladder": (4, 8, 16, 32, 64)}
    prefill = dict(ladder, predictor=fam["chunk"], spec=cspec)
    plain, _ = _greedy_run(fluid, fam, reqs, 128)
    chunked, cb = _greedy_run(fluid, fam, reqs, 128, prefill=prefill)
    spec_ids, sb = _greedy_run(
        fluid, fam, reqs, 128, prefill=prefill,
        speculative={"draft": draft, "k": 4})
    # teacher-forced along the plain chain: every fed position through
    # step dispatches and through one chunk dispatch
    fed = [p + ids[:-1] for (p, _m), ids in zip(reqs, plain)]
    cap = 128
    step_lg = torch.zeros(len(fed), cap, GPT2["vocab"])
    cache = _zero_caches(torch, sspec, len(fed), cap, dev)
    for t in range(max(len(f) for f in fed)):
        tk = np.array([f[t] if t < len(f) else 0 for f in fed], "int64")
        ps = np.array([t if t < len(f) else cap for f in fed], "int32")
        lg, cache = _dispatch(fam["step"], sspec, cache, tk, ps)
        step_lg[:, t] = lg.cpu()
    tk = np.zeros((len(fed), cap), "int64")
    ps = np.full((len(fed), cap), cap, "int32")
    for r, f in enumerate(fed):
        tk[r, :len(f)] = f
        ps[r, :len(f)] = np.arange(len(f))
    chunk_lg, _ = _dispatch(fam["chunk"], cspec,
                            _zero_caches(torch, sspec, len(fed), cap, dev),
                            tk, ps)
    chunk_lg = chunk_lg.cpu()
    diffs = [float((step_lg[r, :len(f)] - chunk_lg[r, :len(f)]).abs().max())
             for r, f in enumerate(fed)]
    divergences = []
    for arm, ids in (("chunked", chunked), ("speculative", spec_ids)):
        for r, ((p, _m), want, got) in enumerate(zip(reqs, plain, ids)):
            if got == want:
                continue
            j = next(i for i, (a, w) in enumerate(zip(got, want)) if a != w)
            top2 = torch.topk(step_lg[r, len(p) - 1 + j], 2).values
            margin = float(top2[0] - top2[1])
            divergences.append({"arm": arm, "request": r, "token": j,
                                "margin": margin,
                                "step_vs_chunk_max_diff": diffs[r]})
            check(margin <= 10 * diffs[r],
                  "%s decode diverged from plain at request %d token %d "
                  "with top-2 margin %g > 10 x %g" % (arm, r, j, margin,
                                                       diffs[r]))

    # (6) the draft where its positions are the target's (histories of at
    # most DRAFT_SEQ tokens, here the 9-token request's along its plain
    # chain, one pass at the top rung of 8): its logits on the card
    # against the CPU and against the target's teacher-forced step logits,
    # and its proposals against the plain chain's next tokens
    r = 2
    chain = fed[r] + plain[r][-1:]
    hists = [chain[:n] for n in range(len(reqs[r][0]), DRAFT_SEQ + 1)]
    check(len(hists) == 8, "%d draft histories" % len(hists))
    ids = np.zeros((len(hists), DRAFT_SEQ), "int64")
    for j, h in enumerate(hists):
        ids[j, :len(h)] = h
    draft_lg = {key: torch.as_tensor(pred.run({"ids": ids},
                                              return_numpy=False)[0]).cpu()
                for key, pred in (("gpu", fam["draft"]),
                                  ("cpu", cpu["draft"]))}
    draft_l2 = _rel_l2_t(draft_lg["gpu"], draft_lg["cpu"])
    at = torch.tensor([len(h) - 1 for h in hists])
    last = draft_lg["gpu"][torch.arange(len(hists)), at]
    target = step_lg[r, at]
    draft_vs_target = _rel_l2_t(last, target)
    reset_counts()
    proposed = [t for t, in draft.propose(hists, 1)]
    draft_counts = read_counts()
    check(draft_counts == PER_DRAFT_PASS,
          "a draft pass launched %s" % draft_counts)
    draft_misses = []
    for j, h in enumerate(hists):
        if proposed[j] == chain[len(h)]:
            continue
        top2 = torch.topk(target[j], 2).values
        margin = float(top2[0] - top2[1])
        diff = float((last[j] - target[j]).abs().max())
        draft_misses.append({"history": len(h), "margin": margin,
                             "draft_vs_target_max_diff": diff})
        check(margin <= 10 * diff,
              "the draft proposed %d, not the plain chain's %d, after %d "
              "tokens with top-2 margin %g > 10 x %g"
              % (proposed[j], chain[len(h)], len(h), margin, diff))
    # speculative decode of that request alone, up to DRAFT_SEQ tokens:
    # the draft sees the target's positions (reported, not held)
    _ids, shb = _greedy_run(
        fluid, fam, [(reqs[r][0], DRAFT_SEQ - len(reqs[r][0]))], 128,
        prefill=prefill, speculative={"draft": draft, "k": 4})
    cm, sm, shm = cb.metrics(), sb.metrics(), shb.metrics()
    emit({"phase": "decode_check", "config": GPT2,
          "params": fam["n_params"], "batch": b, "ctx": c, "chunk": k,
          "logits_rel_l2": l2, "logits_max_abs_err": max_abs,
          "caches_rel_l2": cache_l2, "tol_rel_l2": tol,
          "launches_per_dispatch": PER_DISPATCH["layer_norm_fwd"],
          "draft_pass_launches": draft_counts,
          "draft_logits_rel_l2": draft_l2,
          "draft_logits_max_abs_err": float(
              (draft_lg["gpu"] - draft_lg["cpu"]).abs().max()),
          "draft_vs_target_rel_l2": draft_vs_target,
          "draft_proposals": proposed, "draft_misses": draft_misses,
          "short_spec_accepted": shm["spec_accepted"],
          "short_spec_rejected": shm["spec_rejected"],
          "solo_equals_batched": True, "plain_ids": plain,
          "chunked_equal": chunked == plain,
          "speculative_equal": spec_ids == plain,
          "divergences": divergences,
          "step_vs_chunk_max_diff": max(diffs),
          "chunked_dispatches": cm["decode_steps"],
          "spec_accepted": sm["spec_accepted"],
          "spec_rejected": sm["spec_rejected"],
          "setup_s": setup_s, "device": smi_line})
    check(l2 <= tol and cache_l2 <= tol and draft_l2 <= tol
          and draft_vs_target <= tol,
          "decode_check: card vs CPU rel L2 %g (caches %g, draft %g; draft "
          "vs target %g) > %g" % (l2, cache_l2, draft_l2, draft_vs_target,
                                  tol))
    return fam


def decode_workload(rng, n=64):
    """``n`` requests behind one 128-token system prefix: 80% bodies of
    16-64 tokens with max_new 32, every fifth a body of 256-512 with
    max_new 128 (random ids from ``rng``)."""
    prefix = list(rng.randint(0, GPT2["vocab"], SYSTEM_PREFIX))
    reqs = []
    for i in range(n):
        long = i % 5 == 4
        body = rng.randint(256, 513) if long else rng.randint(16, 65)
        reqs.append((prefix + list(rng.randint(0, GPT2["vocab"], body)),
                     128 if long else 32))
    return reqs


def _decode_kind(name):
    kind = _kernel_kind(name)
    if kind != "other":
        return kind
    for mark in ("copy", "softmax", "index", "reduce", "elementwise"):
        if mark in name:
            return mark
    return "other"


def _decode_profile(torch, make_batcher, reqs, skip, window):
    """Device ms per dispatch by kernel kind over dispatches [skip, skip +
    window) of ``reqs`` through a fresh batcher driven on this thread:
    once timed by the host clock, once more under torch.profiler (whose
    CPU tracing slows the host); busy share = device time / the
    unprofiled wall of the same dispatches."""
    from torch.profiler import ProfilerActivity, profile

    def drive(prof):
        bat = make_batcher()
        futs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
        bat.drive(max_steps=skip)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof is None:
            n = bat.drive(max_steps=window)
        else:
            with prof:
                n = bat.drive(max_steps=window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bat.drive()
        check(n == window and all(f.done() for f in futs),
              "profile window: %d dispatches of %d" % (n, window))
        return wall

    wall = drive(None)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof_wall = drive(prof)
    kinds, n_kernels = {}, 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kind = _decode_kind(e.key.lower())
        kinds[kind] = kinds.get(kind, 0.0) + us
        n_kernels += e.count
    device_ms = sum(kinds.values()) / 1e3
    return {"requests": len(reqs), "dispatches": [skip, skip + window],
            "wall_ms_per_dispatch": wall / window * 1e3,
            "profiled_wall_ms_per_dispatch": prof_wall / window * 1e3,
            "device_ms_per_dispatch": {k: v / window / 1e3
                                       for k, v in sorted(kinds.items())},
            "kernels_per_dispatch": n_kernels / window,
            "device_busy_share": device_ms / (wall * 1e3)}


def _decode_arm(torch, fluid, model_dir, reqs, in_flight, **engine_kw):
    """One engine over the saved step program serving ``reqs`` in a closed
    loop of ``in_flight`` outstanding requests, after ``warmup()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = fluid.serving.ServingEngine(model_dir, decode=True, **engine_kw)
    try:
        t0 = time.perf_counter()
        warmed = eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        futs = []
        t0 = time.perf_counter()
        for i, (p, n) in enumerate(reqs):
            if i >= in_flight:
                futs[i - in_flight].result(timeout=600)
            futs.append(eng.submit(p, max_new_tokens=n))
        outs = [[int(t) for t in f.result(timeout=600)] for f in futs]
        wall = time.perf_counter() - t0
        snap = eng.metrics()
        geometries = eng.compiled_shape_counts()
        draft_failures = eng.draft_failures
    finally:
        eng.shutdown()
    check(draft_failures == 0, "%d draft passes raised" % draft_failures)
    peak = torch.cuda.max_memory_allocated()
    for (p, n), ids in zip(reqs, outs):
        check(len(ids) == n and all(0 <= t < GPT2["vocab"] for t in ids),
              "a request returned %d ids, not %d in range" % (len(ids), n))
    tokens = sum(len(ids) for ids in outs)
    check(snap["requests_completed"] == len(reqs)
          and snap["requests_failed"] == 0, "decode requests failed: %s"
          % snap)
    return outs, {
        "requests": len(reqs), "in_flight": in_flight, "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall,
        "requests_per_s": len(reqs) / wall,
        "ttft_ms": {k: v * 1e3 for k, v in snap["ttft_s"].items()},
        "tpot_ms": {k: v * 1e3 for k, v in snap["tpot_s"].items()},
        "latency_ms": {k: v * 1e3 for k, v in snap["latency_s"].items()},
        "dispatches": snap["decode_steps"],
        "prefill_chunks": snap["prefill_chunks"],
        "prefill_tokens": snap["prefill_tokens"],
        "slot_occupancy": snap["slot_occupancy"],
        "prefix_hits": snap["prefix_hits"],
        "prefix_tokens_reused": snap["prefix_tokens_reused"],
        "prefix_evictions": snap["prefix_evictions"],
        "spec_accepted": snap["spec_accepted"],
        "spec_rejected": snap["spec_rejected"],
        "spec_accept_rate": snap["spec_accept_rate"],
        "warmup_dispatches": warmed, "warmup_s": warm_s,
        "geometries": geometries, "peak_memory_bytes": peak}


def phase_decode(torch, smi_line, fam, n_requests=64, in_flight=16):
    """The main path: ``ServingEngine(model_dir, decode=True, ...)`` over a
    ``save_inference_model`` directory of the step program with its
    ``decode_spec.json``, serving ``decode_workload`` in two arms: plain
    step-only decode, then chunked prefill + speculative decode (k = 4,
    the full program at seq 16 over the same weights as draft) + the
    prefix cache. Launch counts are zeroed just before the first engine
    and read after the second: every step or chunk dispatch (warmup
    included) launches 25 ``layer_norm_fwd``, every draft pass 25 more and
    12 ``flash_attention_fwd``. Then each arm's device time per dispatch
    by kind, over a window of a replay of 8 short requests (in the fast
    arm a dispatch is a chunk or a step, and the window's draft passes
    count in its time)."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(SEED + 1)
    reqs = decode_workload(rng, n_requests)
    model_dir = tempfile.mkdtemp(prefix="gpt2_step_")
    step_main, feeds, fetch_vars = fam["programs"]["step"]
    t0 = time.perf_counter()
    with fluid.scope_guard(fam["scope"]):
        fluid.io.save_inference_model(model_dir, feeds, fetch_vars,
                                      fluid.Executor(fam["place"]),
                                      main_program=step_main)
    fluid.serving.save_decode_spec(model_dir, fam["step_spec"])
    save_s = time.perf_counter() - t0
    prefill = {"predictor": fam["chunk"], "spec": fam["chunk_spec"]}
    draft = fluid.serving.DraftLM(fam["draft"], fam["logits"], DRAFT_SEQ,
                                  lbl_feed=None)
    fast = {"decode_prefill": prefill,
            "decode_speculative": {"draft": draft, "k": 4},
            "prefix_cache": {"max_bytes": 1 << 30}}

    reset_counts()
    plain_ids, plain = _decode_arm(torch, fluid, model_dir, reqs, in_flight)
    fast_ids, fast_arm = _decode_arm(torch, fluid, model_dir, reqs,
                                     in_flight, **fast)
    launches = read_counts()
    passes = draft.passes
    shutil.rmtree(model_dir)

    dispatches = (plain["warmup_dispatches"] + plain["dispatches"]
                  + fast_arm["warmup_dispatches"] + fast_arm["dispatches"])
    want = {k: dispatches * PER_DISPATCH[k] + passes * PER_DRAFT_PASS[k]
            for k in KERNELS}
    same = sum(a == b for a, b in zip(plain_ids, fast_ids))

    short = [r for i, r in enumerate(decode_workload(
        np.random.RandomState(SEED + 2), 10)) if i % 5 != 4]

    def batcher(**kw):
        return lambda: fluid.serving.DecodeBatcher(
            fam["step"], fam["step_spec"], ladder=(1, 2, 4, 8),
            start=False, **kw)

    plain["profile"] = _decode_profile(torch, batcher(), short, 8, 40)
    fast_arm["profile"] = _decode_profile(torch, batcher(
        prefill=prefill, speculative={"draft": draft, "k": 4},
        prefix_cache={"max_bytes": 1 << 30}), short, 4, 12)
    for name, arm in (("plain", plain), ("fast", fast_arm)):
        emit(dict({"phase": "decode", "arm": name, "config": GPT2,
                   "params": fam["n_params"], "ladder": [1, 2, 4, 8],
                   "system_prefix": SYSTEM_PREFIX, "device": smi_line},
                  **arm))
    emit({"phase": "decode", "launches": launches, "want": want,
          "dispatches": dispatches, "draft_passes": passes,
          "requests_with_equal_ids": same, "save_s": save_s})
    check(launches == want, "decode launches %s != %s" % (launches, want))
    check(passes > 0 and fast_arm["spec_accepted"] > 0
          and fast_arm["prefix_hits"] > 0
          and fast_arm["prefill_chunks"] > 0,
          "the fast arm skipped a fast path: %s" % fast_arm)
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
    # each kernel's error against its plain version at the path's shape,
    # f32 and (rows 1-9) bf16
    rows = TRAIN_BATCH * TRANSFORMER["seq_len"]
    ce_case = "train_%dx%dx%d" % (rows, TRANSFORMER["d_model"],
                                  TRANSFORMER["trg_vocab"])
    checked = {"flash_attention_fwd": phase_flash_check(torch, dev),
               "layer_norm_fwd": phase_ln_check(torch, dev),
               "flash_attention_bwd": phase_flash_bwd_check(torch, dev),
               "layer_norm_bwd": phase_ln_bwd_check(torch, dev),
               "fused_ce_fwd": phase_ce_check(torch, dev)}
    errs, bf16_errs = {}, {}
    for name, f32_case, bf16_case in (
            ("flash_attention_fwd", "bert_f32", "train_bf16_dropout_0.1"),
            ("layer_norm_fwd", "1024x768_float32", "%dx512_bfloat16" % rows),
            ("flash_attention_bwd", "enc_self_bias_grad",
             "enc_self_bf16_dropout_0.1"),
            ("layer_norm_bwd", "train_%dx512" % rows,
             "train_%dx512_bf16" % rows),
            ("fused_ce_fwd", ce_case, ce_case + "_bf16")):
        errs[name] = checked[name][f32_case]
        bf16_errs[name] = checked[name][bf16_case]
    conv_errs, conv_bf16_errs = phase_fused_conv_check(torch, dev)
    errs.update(conv_errs)
    bf16_errs.update(conv_bf16_errs)
    errs["scatter_add"] = phase_scatter_check(
        torch, dev)["deepfm_densify_uniform"]
    times = phase_timing(torch, dev)
    paths = {"serve": phase_serve(torch, smi_line)}
    phase_train_check(torch, smi_line)
    paths["train"] = phase_train(torch, smi_line, {
        "flash_attention_fwd": times["flash_attention_fwd"][
            "trained_shape"]["ms"],
        "flash_attention_bwd": times["flash_attention_bwd"]["ms"]})
    phase_amp_train_check(torch, smi_line)
    paths["amp_train"] = phase_train(torch, smi_line, {
        name: times[name]["bf16"]["ms"]
        for name in ("flash_attention_fwd", "flash_attention_bwd")},
        amp=True)
    # read at once: the path's wgmma launches (no launch comes between);
    # conv_moments' come from resnet_amp_train, conv_apply's from
    # resnet_amp_eval
    amp_wgmma = read_wgmma_counts()
    phase_resnet_train_check(torch, smi_line)
    paths["resnet_train"], trained, f32_step = phase_resnet_train(
        torch, smi_line, times["conv_moments"]["site_weighted_ms"])
    paths["resnet_eval"] = phase_resnet_eval(torch, smi_line, trained)[0]
    del trained
    phase_resnet_amp_train_check(torch, smi_line)
    paths["resnet_amp_train"], trained, _ = phase_resnet_train(
        torch, smi_line, times["conv_moments"]["bf16"]["site_weighted_ms"],
        amp=True, f32_step=f32_step)
    amp_wgmma["conv_moments"] = read_wgmma_counts()["conv_moments"]
    paths["resnet_amp_eval"], eval_wgmma = phase_resnet_eval(
        torch, smi_line, trained, amp=True)
    amp_wgmma["conv_apply"] = eval_wgmma["conv_apply"]
    del trained
    phase_deepfm_train_check(torch, smi_line)
    paths["deepfm_train"] = phase_deepfm_train(torch, smi_line)
    phase_deepfm_amp_train_check(torch, smi_line)
    paths["deepfm_amp_train"] = phase_deepfm_train(torch, smi_line, amp=True)
    fam = phase_decode_check(torch, smi_line)
    paths["decode"] = phase_decode(torch, smi_line, fam)
    del fam

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
        for key in ("bound_ms_f32_fma", "trained_shape", "plan", "zipf_ms",
                    "zipf_bound_ms"):
            if key in r:
                kernels[-1][key] = r[key]
        if "bf16" in r:  # rows 1-12: the bf16 form (AMP), training shape
            bf16_by_path = {path: paths[path][name] for path in AMP_PATHS}
            kernels[-1]["bf16"] = dict(r["bf16"],
                                       max_abs_err=bf16_errs[name],
                                       launches=sum(bf16_by_path.values()),
                                       launches_by_path=bf16_by_path)
            if name in WGMMA_FORMS:  # the warpgroup-product form
                kernels[-1]["bf16"].update(
                    form="wgmma", wgmma_launches=amp_wgmma[name],
                    header="paddle_tpu_torch/csrc/wgmma_bf16.cuh")
                if name in ("conv_moments", "conv_apply"):
                    kernels[-1]["bf16"]["wgmma_source"] = \
                        "paddle_tpu_torch/csrc/fused_conv_wgmma.cu"
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
