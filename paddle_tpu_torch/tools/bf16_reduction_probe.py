#!/usr/bin/env python3
"""How many times cuBLAS rounds a bf16 product with a bf16 output, on one
CUDA card.

    python3 paddle_tpu_torch/tools/bf16_reduction_probe.py

The product is the fused CE backward's dx = dz W^T at BERT pretraining's
vocabulary (dz [T, 30522] with a -1 column, W [768, 30522]), at T = 256
(the check phase's batch of 2) and T = 16384 (its training batch). For
each of PyTorch's ``allow_bf16_reduced_precision_reduction`` settings it
prints one JSON line: the relative L2 and largest absolute distance from
the f64 product of ``torch.matmul`` (bf16 out), of ``torch.mm(...,
out_dtype=torch.float32)`` rounded once to bf16, and of the f64 product
itself rounded once (the reference's rounding: f32 sums, one rounding).
Restores the setting it found."""

import json

import torch


def _err(x, ref):
    x = x.double()
    return {"rel_l2": float((x - ref).norm() / ref.norm()),
            "max_abs": float((x - ref).abs().max())}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bf16_reduction_probe: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    v, d = 30522, 768
    try:
        for t in (256, 16384):
            dz = torch.randn(t, v, device="cuda", generator=gen) * 1e-4
            dz[:, 0] = -1.0
            dzc = dz.to(torch.bfloat16)
            w = (torch.randn(d, v, device="cuda", generator=gen)
                 / d ** 0.5).to(torch.bfloat16)
            ref = dzc.double() @ w.t().double()
            once = ref.to(torch.bfloat16)
            for flag in (True, False):
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = flag
                out = torch.matmul(dzc, w.t())
                f32 = torch.mm(dzc, w.t(), out_dtype=torch.float32)
                print(json.dumps({
                    "rows": t, "reduced_precision_reduction": flag,
                    "bf16_out": _err(out, ref),
                    "f32_out_rounded_once": _err(f32.to(torch.bfloat16),
                                                 ref),
                    "f64_rounded_once": _err(once, ref)}), flush=True)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved


if __name__ == "__main__":
    main()
