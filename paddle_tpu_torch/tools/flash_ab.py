#!/usr/bin/env python3
"""Flash-attention kernel A/B of another checkout of this repository
against this one, on one CUDA card.

    python3 paddle_tpu_torch/tools/flash_ab.py [--base DIR] [--rounds 2]

Each run is a worker process that imports ``paddle_tpu_torch`` from one
checkout, builds that checkout's flash kernels and times them through this
checkout's ``chip_smoke.flash_kernel_timing`` (the shapes and inputs of
``chip_smoke.py``'s timing rows 1-6, from ``chip_smoke.SEED``; CUDA events,
f32 with TF32 off): the forward at BERT-base's served shape, the forward
and the backward at Transformer-base's training shape, each beside
``F.scaled_dot_product_attention`` on the same inputs; then the bf16 (AMP)
forms of the flash forward and backward and the fused CE at the training
shapes through ``chip_smoke._bf16_kernel_timing`` (rows 1, 2 and 9 of its
bf16 column), beside SDPA forward and backward and the bf16
``torch.matmul`` projection.

With ``--base`` the runs alternate base, change, change, base for
``--rounds`` rounds, so a drift of the card over the call falls on both
sides alike; without it this checkout runs alone. Prints one JSON line per
run and a summary: per side the median of each time over its runs. Exits
non-zero if a worker fails.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHANGE = os.path.dirname(os.path.dirname(HERE))


def _worker(root):
    sys.path.insert(0, root)  # the package under test
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(CHANGE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rows = cs.flash_kernel_timing(torch, torch.device("cuda", 0),
                                  torch.Generator().manual_seed(cs.SEED))
    fwd, bwd = rows["flash_attention_fwd"], rows["flash_attention_bwd"]
    trained = fwd["trained_shape"]
    bf16 = cs._bf16_kernel_timing(
        torch, torch.device("cuda", 0), torch.Generator().manual_seed(cs.SEED),
        only=("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd"))
    bf_fwd, bf_ce = bf16["flash_attention_fwd"], bf16["fused_ce_fwd"]
    bf_bwd = bf16["flash_attention_bwd"]
    print(json.dumps({
        "root": root, "device": torch.cuda.get_device_name(0),
        "fwd_served": fwd["ms"], "sdpa_fwd_served": fwd["library_ms"],
        "fwd_trained": trained["ms"],
        "sdpa_fwd_trained": trained["library_ms"],
        "bwd_trained": bwd["ms"], "sdpa_bwd_trained": bwd["library_ms"],
        "bf16_fwd_trained": bf_fwd["ms"],
        "bf16_sdpa_fwd_trained": bf_fwd["library_ms"],
        "bf16_bwd_trained": bf_bwd["ms"],
        "bf16_sdpa_bwd_trained": bf_bwd["library_ms"],
        "bf16_ce_trained": bf_ce["ms"],
        "bf16_matmul_trained": bf_ce["library_ms"]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(os.path.abspath(args.worker))
        return 0
    order = [("change", CHANGE)]
    if args.base:
        base = os.path.abspath(args.base)
        order = [("base", base), ("change", CHANGE),
                 ("change", CHANGE), ("base", base)] * args.rounds
    runs = {"base": [], "change": []}
    for side, root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit("flash_ab: the %s worker failed" % side)
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["side"] = side
        runs[side].append(res)
        print(json.dumps(res), flush=True)
    summary = {side: {key: statistics.median(r[key] for r in rs)
                      for key in rs[0] if key not in ("root", "side",
                                                      "device")}
               for side, rs in runs.items() if rs}
    summary["runs"] = {side: len(rs) for side, rs in runs.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
