#!/usr/bin/env python3
"""Where the bf16 warpgroup-product (wgmma) forms spend their time, on one
CUDA card.

    python3 paddle_tpu_torch/tools/wgmma_variants.py [--flash] [--conv]
        [--moments]

Each variant is a copy of ``paddle_tpu_torch/csrc/<library>.cu`` with a few
text replacements, built with the package's nvcc flags into the
git-ignored ``build/variants/`` and called through the same C entry, at
``chip_smoke.py``'s shapes and inputs (CUDA events, ``chip_smoke.time_ms``).

``--flash``: the bf16 flash backward (``flash_bwd_wgmma_kernel``) at
Transformer-base's training shape (128 x 256 tokens, 8 heads of 64) in the
training path's three calls (the encoder's self-attention with the padding
mask, the decoder's causal self-attention, each with dropout 0.1) and
without dropout: the time of the form, of builds that skip one phase (P and
dS; the dV and dK products; dQ's product; dQ's reduction; timed without
dropout, each phase's result left stale), each phase's share of the
``clock()`` time of every block's thread 0, and the time of delta in
torch as the ``mma.sync`` form's wrapper computes it.

``--conv``: the bf16 ``conv_apply`` (``conv_apply_wgmma_kernel``) at
ResNet-50's 19 fused geometries (batch 128, a residual and relu where a
site has them): the time of the form, of a build without its epilogue, of
a build without the channels-last copy, of PyTorch's own channels-last
copy of x, and the shares of thread 0's ``clock()`` time waiting for a
stage, loading (its producer role), and in the epilogue.

``--moments``: the bf16 ``conv_moments`` (``conv_moments_wgmma_kernel``)
at the same 19 geometries: the time of the form (sums from the
accumulators in registers), of its ``mma.sync`` form and of cuDNN's conv,
of a build that takes the sums from the C tile in shared memory instead
(two threads a channel, after the tile is written), and of a build
without the sums; with the C-tile build's largest difference from the
form's sums, relative to the largest sum.

Prints one JSON line per measurement. The variants' results are not
checked: they time pieces, and some skip work the result needs."""

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_variants", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _build_variants(_build, lib, variants):
    """Compile csrc/<lib>.cu with each variant's replacements applied, one
    nvcc each, all at once, into build/variants/; returns {name: the
    loaded library}."""
    with open(os.path.join(_build.CSRC_DIR, lib + ".cu")) as f:
        src = f.read()
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, reps in variants.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit("wgmma_variants: %s/%s: anchor %r not found"
                                 % (lib, name, old[:60]))
            text = text.replace(old, new)
        path = os.path.join(out_dir, "%s_%s.cu" % (lib, name.replace(" ",
                                                                      "_")))
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path()] + _build.NVCC_FLAGS
            + ["-I", _build.CSRC_DIR, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit("wgmma_variants: nvcc failed for %s/%s:\n%s"
                             % (lib, name, out[-4000:]))
        with open(so + ".log", "w") as f:  # ptxas -v: registers, spills
            f.write(out)
        libs[name] = ctypes.CDLL(so)
    return libs


# clock() phases of thread 0: a running total per phase in registers,
# summed into a global array at the end, read back by a C entry
def _stamp(k, who):
    return ("if (%s) { const unsigned _t = (unsigned)clock(); "
            "prof_[%d] += _t - t_last_; t_last_ = _t; }\n" % (who, k))


_PROF_ENTRIES = (
    'const char* ptt_error_string(int err) {',
    'int variant_read_prof(void* out) {\n'
    '  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n'
    'int variant_zero_prof() {\n  unsigned long long z[8] = {};\n'
    '  return cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n'
    'const char* ptt_error_string(int err) {')
_PROF_INIT = ("  unsigned prof_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
              "  unsigned t_last_ = (unsigned)clock();\n")
_PROF_FLUSH = ("  if (tid == 0) for (int k_ = 0; k_ < 8; ++k_) "
               "atomicAdd(&g_prof[k_], (unsigned long long)prof_[k_]);\n")


def _read_prof(lib):
    buf = (ctypes.c_ulonglong * 8)()
    lib.variant_read_prof(buf)
    return list(buf)


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

FLASH_PHASES = ("K and V", "Q and dO", "S and dP", "P and dS",
                "dV, dK, dQ", "barrier", "dQ reduction", "dK, dV stores")


def _flash_variants(src):
    """{name: replacements} for csrc/flash_attention_bwd.cu."""
    def skip(begin, end, mode):
        seg = src[src.index(begin):src.index(end)]
        return (seg, "    if (a.keep_thresh != %d || a.seed) {\n%s\n    }\n"
                % (mode, seg))
    st = "tid == 0"
    prof = [
        ("// One block: one warpgroup, 64 keys of one (b, h)",
         "__device__ unsigned long long g_prof[8];\n"
         "// One block: one warpgroup, 64 keys of one (b, h)"),
        ("  const int col0 = h * a.d;  // the head's first column in "
         "[B, T, H*D]\n",
         "  const int col0 = h * a.d;  // the head's first column in "
         "[B, T, H*D]\n" + _PROF_INIT),
        ("  mbar_wait(&bar[0], 0);\n  for (int it = 0; it < n_visit; ++it) {",
         "  mbar_wait(&bar[0], 0);\n" + _stamp(0, st) +
         "  for (int it = 0; it < n_visit; ++it) {"),
        ("    mbar_wait(&bar[1 + st], (it >> 1) & 1);\n",
         "    mbar_wait(&bar[1 + st], (it >> 1) & 1);\n" + _stamp(1, st)),
        ("    wgmma_hold(dpt);\n", "    wgmma_hold(dpt);\n" + _stamp(2, st)),
        ("    fence_proxy_async();\n\n    // dV += Pd^T",
         "    fence_proxy_async();\n" + _stamp(3, st) + "\n    // dV += Pd^T"),
        ("    wgmma_hold(dk[0]);\n    wgmma_hold(dv[0]);\n",
         _stamp(4, st) + "    wgmma_hold(dk[0]);\n    wgmma_hold(dv[0]);\n"),
        ("    __syncthreads();  // the partial is staged\n",
         "    __syncthreads();  // the partial is staged\n" + _stamp(5, st)),
        ("      }\n    }\n  }\n\n  // dK (scaled) and dV",
         "      }\n    }\n" + _stamp(6, st) + "  }\n\n  // dK (scaled) and dV"),
        ("    if (a.dbias && tq == 0) a.dbias[(long long)bh * a.Tk + key] = "
         "db[hh];\n  }\n}",
         "    if (a.dbias && tq == 0) a.dbias[(long long)bh * a.Tk + key] = "
         "db[hh];\n  }\n" + _stamp(7, st) + _PROF_FLUSH + "}"),
        _PROF_ENTRIES]
    return {
        "phases": prof,
        "skip P and dS": [skip("    // Pd into s, dS into dpt",
                               "    // Pd and dS rounded", 1)],
        "skip dV and dK": [skip(
            "    wgmma_fence();\n#pragma unroll\n    for (int at = 0; at < NA;"
            " ++at)\n#pragma unroll\n      for (int kk = 0; kk < 4; ++kk)\n"
            "        wgmma_rs_n64<1>(dv[at]",
            "    wgmma_commit();\n    __syncthreads();  // the dS^T rows", 2)],
        "skip dQ product": [skip("    // dQ over this warpgroup's 64 keys",
                                 "    wgmma_hold(dk[0]);", 3)],
        "skip dQ reduction": [skip("    // dQ[q0 + row] += scale * partial",
                                   "\n  }\n\n  // dK (scaled) and dV", 4)],
    }


def flash(cs, torch, dev):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    with open(os.path.join(_build.CSRC_DIR, "flash_attention_bwd.cu")) as f:
        src = f.read()
    libs = _build_variants(_build, "flash_attention_bwd",
                           _flash_variants(src))
    base = _build.load("flash_attention_bwd")
    b, t = cs.TRAIN_BATCH, cs.TRANSFORMER["seq_len"]
    h, hd = cs.TRANSFORMER["n_head"], cs.TRANSFORMER["d_model"]
    d = hd // h
    gen = torch.Generator().manual_seed(cs.SEED)
    q, k, v, dout = (torch.randn(b, t, hd, generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    kb = cs._padding_bias(torch, gen, b, t, dev)
    seed = torch.tensor([cs.SEED], dtype=torch.int64, device=dev)
    calls = (("encoder self, padding mask", kb, False, 0.0),
             ("encoder self, padding mask, dropout 0.1", kb, False, 0.1),
             ("decoder self, causal, dropout 0.1", None, True, 0.1))
    try:
        for name, bias, causal, rate in calls:
            out, lse = fa.flash_attention_fwd(q, k, v, h, bias, causal, rate,
                                              seed)

            def run():
                return fa.flash_attention_bwd(q, k, v, out, lse, dout, h,
                                              bias, causal, rate, seed)
            line = {"kernel": "flash_attention_bwd", "call": name,
                    "ms": cs.time_ms(run, iters=20)}
            with cs.mma_sync_route(fa, "bwd_form"):
                line["mma_sync_ms"] = cs.time_ms(run, iters=20)
            _build._libs["flash_attention_bwd"] = libs["phases"]
            libs["phases"].variant_zero_prof()
            run()
            torch.cuda.synchronize()
            prof = _read_prof(libs["phases"])
            line["phase_share"] = {p: prof[i] / sum(prof)
                                   for i, p in enumerate(FLASH_PHASES)}
            _build._libs["flash_attention_bwd"] = base
            if rate == 0.0:  # the skip builds, called with a mode
                line["skip_ms"] = _flash_skips(cs, torch, fa, _build, libs,
                                               q, k, v, out, dout, lse, bias,
                                               b, h, t, d)
                # delta as the mma.sync form's wrapper computes it, in torch
                line["torch_delta_ms"] = cs.time_ms(lambda: (
                    dout.float() * out.float()).reshape(b, t, h, d).sum(
                        -1).transpose(1, 2).contiguous(), iters=20)
            print(json.dumps(line), flush=True)
    finally:
        _build._libs["flash_attention_bwd"] = base


def _flash_skips(cs, torch, fa, _build, libs, q, k, v, out, dout, lse, bias,
                 b, h, t, d):
    """Each skip build's time, its phase picked by keep_thresh (no seed,
    so no dropout reads it)."""
    delta = torch.empty(b, h, t, device=q.device)
    dq = torch.empty(b, t, h * d, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    full, (sb, sh, _) = fa._bias_args(bias, b, h, t, t, "variants")
    res = {}
    for mode, name in enumerate(("skip P and dS", "skip dV and dK",
                                 "skip dQ product", "skip dQ reduction"), 1):
        _build._libs["flash_attention_bwd"] = libs[name]
        fn = fa._c_fn("flash_attention_bwd", "flash_attention_bwd_wgmma")

        def run():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(),
                     full.data_ptr() if full is not None else None, None,
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None, b, h,
                     t, t, d, *(x.stride(i) for x in (q, k, v, out, dout)
                                for i in (0, 1)), sb, sh,
                     1.0 / math.sqrt(d), 0, mode, 1.0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError("variant launch failed: %d" % err)
        res[name] = cs.time_ms(run, iters=20)
    return res


# ---------------------------------------------------------------------------
# conv_apply
# ---------------------------------------------------------------------------

CONV_PHASES = ("waiting for a stage", "loading", "epilogue", "products")


def _conv_variants():
    st = "tid == 0"
    produce_in = "      if (tid == 0) produce_ahead(c_i + STAGES, 0);\n    }"
    produce_out = ("    if (tid == 0) produce_ahead(c_i + STAGES, 0);  "
                   "// the next tile's\n")
    return {
        "phases": [
            ("template <int NWG, bool NCHW, bool MOMENTS>\n__device__",
             "__device__ unsigned long long g_prof[8];\n"
             "template <int NWG, bool NCHW, bool MOMENTS>\n__device__"),
            ("  unsigned c_i = 0;  // chunks consumed\n",
             "  unsigned c_i = 0;  // chunks consumed\n" + _PROF_INIT),
            ("      mbar_wait(&full[s], (c_i / STAGES) & 1);\n",
             "      " + _stamp(3, st) +
             "      mbar_wait(&full[s], (c_i / STAGES) & 1);\n      "
             + _stamp(0, st)),
            (produce_in, "      " + _stamp(3, st) + produce_in[:-6] + "\n"
             "      " + _stamp(1, st) + "    }"),
            (produce_out, "    " + _stamp(3, st) + produce_out + "    "
             + _stamp(1, st)),
            ("      default: write_tile<1, !MOMENTS>(ct, a, o0, n0, h0, wt); "
             "break;\n    }\n  }\n}",
             "      default: write_tile<1, !MOMENTS>(ct, a, o0, n0, h0, wt); "
             "break;\n    }\n    " + _stamp(2, st) + "  }\n" + _PROF_FLUSH
             + "}"),
            _PROF_ENTRIES],
        # the products run (asm volatile), the epilogue does not
        "no epilogue": [(produce_out, produce_out + "    continue;\n")],
        "no copy": [("  nchw_to_nhwc_kernel<MOMENTS><<<cgrid, 256, 0, s>>>(",
                     "  if (0) nchw_to_nhwc_kernel<MOMENTS><<<cgrid, 256, 0, "
                     "s>>>(")],
    }


def _moments_variants(src):
    """{name: replacements} for the moments epilogue of
    csrc/fused_conv_wgmma.cu: the sums from the C tile, or none."""
    in_loop = src[src.index("        if constexpr (MOMENTS) {\n"
                            "          const int slot"):
                  src.index("      }\n    if constexpr (MOMENTS) {  // over "
                            "the quad")]
    quad = src[src.index("    if constexpr (MOMENTS) {  // over the quad"):
               src.index("    if (a.bh == a.Ho) {  // whole images")]
    from_tile = (
        "    named_sync(1 + wg, 128);\n"
        "    if constexpr (MOMENTS) {  // two threads a channel row\n"
        "      const int row = wt >> 1, half = wt & 1;\n"
        "      const unsigned* cr = reinterpret_cast<const unsigned*>(\n"
        "          ct + row * CLD) + 64 * half;\n"
        "      float t1 = 0.f, t2 = 0.f;\n"
        "#pragma unroll 8\n"
        "      for (int q = 0; q < 64; ++q) {\n"
        "        const int qq = (q + 2 * (row >> 3) + half) & 63;\n"
        "        const int slot = 128 * half + 2 * qq;\n"
        "        const unsigned p = cr[qq];\n"
        "        const float v0 = slot < slots ? bf_lo(p) : 0.f;\n"
        "        const float v1 = slot + 1 < slots ? bf_hi(p) : 0.f;\n"
        "        t1 += v0;\n        t2 = fmaf(v0, v0, t2);\n"
        "        t1 += v1;\n        t2 = fmaf(v1, v1, t2);\n      }\n"
        "      t1 += __shfl_xor_sync(0xffffffffu, t1, 1);\n"
        "      t2 += __shfl_xor_sync(0xffffffffu, t2, 1);\n"
        "      if (half == 0) {\n"
        "        float* pr = a.partial + (long long)pt * 2 * a.O + o0 + "
        "row;\n"
        "        pr[0] = t1;\n        pr[a.O] = t2;\n      }\n    }\n")
    return {"sums from the C tile": [(in_loop, ""), (quad, from_tile)],
            "no sums": [(in_loop, ""),
                        (quad, "    named_sync(1 + wg, 128);\n")]}


def moments(cs, torch, dev):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_conv as fc

    with open(os.path.join(_build.CSRC_DIR, "fused_conv_wgmma.cu")) as f:
        variants = _moments_variants(f.read())
    libs = _build_variants(_build, "fused_conv_wgmma", variants)
    base = _build.load("fused_conv_wgmma")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    totals = {}
    try:
        for (c, o, k, stride, hw), g in cs.resnet_conv_geometries().items():
            x, w = cs._conv_case(torch, gen, dev, c, o, k, stride, hw,
                                 False)[:2]
            xb, wb = x.bfloat16(), w.bfloat16()
            del x, w

            def run():
                return fc.conv_moments(xb, wb, stride)
            line = {"kernel": "conv_moments",
                    "geometry": "%dx%d%s %d->%d @%d" % (
                        k, k, " s2" if stride == 2 else "", c, o, hw),
                    "sites": g["sites"], "ms": cs.time_ms(run, iters=20)}
            want = run()
            with cs.mma_sync_route(fc, "moments_form"):
                line["mma_sync_ms"] = cs.time_ms(run, iters=20)
            line["cudnn_ms"] = cs.time_ms(lambda: F.conv2d(
                xb, wb, stride=stride, padding=(k - 1) // 2), iters=20)
            for name in variants:
                _build._libs["fused_conv_wgmma"] = libs[name]
                key = name.replace(" ", "_") + "_ms"
                line[key] = cs.time_ms(run, iters=20)
                if name == "sums from the C tile":
                    got = run()
                    line["c_tile_sums_rel_diff"] = max(
                        (a - b).abs().max().item()
                        / max(b.abs().max().item(), 1e-30)
                        for a, b in zip(got[1:], want[1:]))
            _build._libs["fused_conv_wgmma"] = base
            for key in ("ms", "mma_sync_ms", "cudnn_ms",
                        "sums_from_the_C_tile_ms", "no_sums_ms"):
                totals[key] = totals.get(key, 0.0) + g["sites"] * line[key]
            print(json.dumps(line), flush=True)
            del xb, wb, want
    finally:
        _build._libs["fused_conv_wgmma"] = base
    print(json.dumps({"kernel": "conv_moments", "site_weighted": totals}),
          flush=True)


def conv(cs, torch, dev):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_conv as fc

    libs = _build_variants(_build, "fused_conv_wgmma", _conv_variants())
    base = _build.load("fused_conv_wgmma")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    totals = {}
    try:
        for (c, o, k, stride, hw), g in cs.resnet_conv_geometries().items():
            residual, relu = g["residual"] > 0, g["relu"] > 0
            x, w, gm, bt, mean, var, res = cs._conv_case(
                torch, gen, dev, c, o, k, stride, hw, residual)
            xb, wb = x.bfloat16(), w.bfloat16()
            rb = res.bfloat16() if res is not None else None
            del x, w, res
            scale, shift = fc._scale_shift(gm, bt, mean, var, 1e-5)
            def run():
                return fc.conv_apply(xb, wb, scale, shift, rb, relu, stride)
            line = {"kernel": "conv_apply",
                    "geometry": "%dx%d%s %d->%d @%d" % (
                        k, k, " s2" if stride == 2 else "", c, o, hw),
                    "sites": g["sites"], "ms": cs.time_ms(run, iters=20)}
            with cs.mma_sync_route(fc, "apply_form"):
                line["mma_sync_ms"] = cs.time_ms(run, iters=20)
            line["cudnn_ms"] = cs.time_ms(lambda: F.conv2d(
                xb, wb, stride=stride, padding=(k - 1) // 2), iters=20)
            # the library's channels-last copy, which the form's own copy
            # kernel replaces
            line["torch_channels_last_ms"] = cs.time_ms(
                lambda: xb.contiguous(memory_format=torch.channels_last),
                iters=20)
            for name in ("no epilogue", "no copy"):
                _build._libs["fused_conv_wgmma"] = libs[name]
                line[name.replace(" ", "_") + "_ms"] = cs.time_ms(run,
                                                                  iters=20)
            _build._libs["fused_conv_wgmma"] = libs["phases"]
            libs["phases"].variant_zero_prof()
            run()
            torch.cuda.synchronize()
            prof = _read_prof(libs["phases"])[:4]
            line["thread0_share"] = {p: prof[i] / max(sum(prof), 1)
                                     for i, p in enumerate(CONV_PHASES)}
            _build._libs["fused_conv_wgmma"] = base
            for key in ("ms", "mma_sync_ms", "cudnn_ms", "no_epilogue_ms",
                        "no_copy_ms", "torch_channels_last_ms"):
                totals[key] = totals.get(key, 0.0) + g["sites"] * line[key]
            print(json.dumps(line), flush=True)
            del xb, wb, rb
    finally:
        _build._libs["fused_conv_wgmma"] = base
    print(json.dumps({"kernel": "conv_apply", "site_weighted": totals}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--conv", action="store_true")
    ap.add_argument("--moments", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_variants: no CUDA device")
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    from paddle_tpu_torch.ops import _build

    _build.build_all()  # the package's own libraries, at once
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    every = not (args.flash or args.conv or args.moments)
    if args.flash or every:
        flash(cs, torch, dev)
    if args.conv or every:
        conv(cs, torch, dev)
    if args.moments or every:
        moments(cs, torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
