#!/usr/bin/env python3
"""Where the bf16 LayerNorm backward's register-resident form spends its
time, on one CUDA card.

    python3 paddle_tpu_torch/tools/ln_bwd_variants.py

The form (``csrc/layer_norm_bwd.cu`` ``layer_norm_bwd_regs``) writes one
partial row of dgamma and dbeta a block, and a second launch
(``layer_norm_bwd_params``) adds the rows in a fixed order. Variant builds
(copies of the source with text replacements, built as
``tools/wgmma_variants.py`` builds its variants, into the git-ignored
``build/variants/``):

- ``one launch``: the last block to finish, found by a ticket taken after
  ``__threadfence``, adds the rows in order itself, into one more row of
  the partial buffer; no second launch;
- ``no final sum``: the second launch left out (the first launch alone);
- ``three blocks an SM``: the launch bounds of the forms of at most 2
  vectors a lane ask for 3 resident blocks of 8 warps, not 2 (85
  registers a thread).

Each build runs through the C entry on the same buffers under
``ops/fused_layer_norm.py`` ``ln_bwd_plan``'s plan with its blocks an SM
replaced by each of 1, 2 and 3, at Transformer-base's training shape
[32768, 512] and at [1000, 768] (bf16, ``chip_smoke.time_ms``: CUDA
events, median), with the one-launch sums against the form's. Prints one
JSON line a shape and the card's name.
"""

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_TICKET = [
    ("// partial: [gridDim.x, 2, d] (dgamma partials, then dbeta partials). "
     "Warp",
     "__device__ unsigned g_ticket = 0;\n\n"
     "// partial: [gridDim.x, 2, d] (dgamma partials, then dbeta partials). "
     "Warp"),
    ("    for (int w = 0; w < WARPS; ++w) s += acc[w * 2 * d + c];\n"
     "    out[c] = s;\n  }\n}",
     "    for (int w = 0; w < WARPS; ++w) s += acc[w * 2 * d + c];\n"
     "    out[c] = s;\n  }\n"
     "  __shared__ unsigned last_;\n"
     "  __threadfence();\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0)\n"
     "    last_ = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;\n"
     "  __syncthreads();\n"
     "  if (!last_) return;\n"
     "  __threadfence();\n"
     "  float* sums = partial + (long long)gridDim.x * 2 * d;\n"
     "  for (int c = threadIdx.x; c < 2 * d; c += WARPS * 32) {\n"
     "    float s = 0.f;\n"
     "    for (int b = 0; b < gridDim.x; ++b)\n"
     "      s += __ldcg(partial + (long long)b * 2 * d + c);\n"
     "    sums[c] = s;\n  }\n"
     "  if (threadIdx.x == 0) g_ticket = 0;\n}"),
    ("  if (err != cudaSuccess) return err;\n  const dim3 pgrid(",
     "  if (err != cudaSuccess || vpl > 0) return err;\n"
     "  const dim3 pgrid("),
]


def main():
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ln_bwd_variants: no CUDA device")
    cs = _load("chip_smoke_variants", os.path.join(ROOT, "chip_smoke.py"))
    wv = _load("wgmma_variants", os.path.join(HERE, "wgmma_variants.py"))
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = {"as built": _build.load("layer_norm_bwd")}
    libs.update(wv._build_variants(_build, "layer_norm_bwd", {
        "one launch": _TICKET,
        "no final sum": _TICKET[2:],
        "three blocks an SM": [("__launch_bounds__(WARPS * 32, VPL <= 2 ? 2 "
                                ": 1)", "__launch_bounds__(WARPS * 32, VPL "
                                "<= 2 ? 3 : 1)")]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    for rows, d in (cs.LN_TRAINED, (1000, 768)):
        x = torch.randn(rows, d, generator=gen).to(dev, torch.bfloat16)
        dy = torch.randn(rows, d, generator=gen).to(dev, torch.bfloat16)
        g = torch.randn(d, generator=gen).to(dev)
        _, mean, var = fln.layer_norm_fwd(x, g, None, 1e-5)
        picked = fln.ln_bwd_plan(rows, d, torch.bfloat16, sms)
        cap = -(-rows // picked.warps)
        dx = torch.empty_like(x)
        dg = torch.empty(d, device=dev)
        db = torch.empty(d, device=dev)
        partial = torch.empty(3 * sms + 1, 2, d, device=dev)
        line = {"shape": [rows, d], "plan": list(picked), "ms": {}}
        for name, lib in libs.items():
            fn = lib.layer_norm_bwd
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
                ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for per_sm in (1, 2, 3):
                plan = picked._replace(blocks=min(cap, per_sm * sms))

                def run(fn=fn, plan=plan):
                    err = fn(x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                             mean.data_ptr(), var.data_ptr(), dx.data_ptr(),
                             dg.data_ptr(), db.data_ptr(), partial.data_ptr(),
                             1, rows, d, 1e-5, *plan,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError("CUDA error %d" % err)
                line["ms"]["%s, %d blocks" % (name, plan.blocks)] = \
                    cs.time_ms(run)
                if name == "as built" and plan == picked:
                    run()
                    torch.cuda.synchronize()
                    want = torch.stack([dg, db])
                if name == "one launch" and plan == picked:
                    run()
                    torch.cuda.synchronize()
                    got = partial[plan.blocks]
                    line["one_launch_sums_rel_diff"] = (
                        (got - want).abs().max() / want.abs().max()).item()
        print(json.dumps(line), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
