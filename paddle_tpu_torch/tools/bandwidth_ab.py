#!/usr/bin/env python3
"""A/B of another checkout's LayerNorm forward and backward and row
scatter-add kernels (rows 7, 8 and 13, the kernels bound by bytes) against
this one's, on one CUDA card.

    python3 paddle_tpu_torch/tools/bandwidth_ab.py [--base DIR] [--rounds 2]

Each run is a worker process that imports ``paddle_tpu_torch`` from one
checkout, builds that checkout's kernels and times them through this
checkout's ``chip_smoke.bandwidth_kernel_timing`` (the shapes and inputs of
``chip_smoke.py``'s timing rows 7 and 13; CUDA events, f32): the LayerNorm
forward at BERT-base's served shape [1024, 768] and Transformer-base's
training shape [32768, 512], each beside ``F.layer_norm``; the scatter at
the DeepFM shape (851,968 slots into 100000 x 32) on uniform and on
Zipf(1.2) ids, beside ``index_add_``; and ``chip_smoke.ln_bwd_bf16_timing``:
the bf16 LayerNorm backward (the AMP form of row 8) at [32768, 512],
beside ``F.layer_norm``'s backward on bf16.

With ``--base`` the runs alternate base, change, change, base for
``--rounds`` rounds, so a drift of the card over the call falls on both
sides alike (a process keeps its speed offset for life, hence several
processes a side); without it this checkout runs alone. Prints one JSON
line per run and a summary: per side the median of each time over its
runs. Exits non-zero if a worker fails.
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

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(CHANGE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    rows = cs.bandwidth_kernel_timing(torch, dev)
    ln, sc = rows["layer_norm_fwd"], rows["scatter_add"]
    trained = ln["trained_shape"]
    ln_bwd = cs.ln_bwd_bf16_timing(torch, dev)
    print(json.dumps({
        "root": root, "device": torch.cuda.get_device_name(0),
        "ln_served": ln["ms"], "f_layer_norm_served": ln["library_ms"],
        "ln_trained": trained["ms"],
        "f_layer_norm_trained": trained["library_ms"],
        "scatter_uniform": sc["ms"], "scatter_zipf": sc["zipf_ms"],
        "index_add": sc["library_ms"], "ln_bwd_bf16_trained": ln_bwd["ms"],
        "f_layer_norm_bwd_bf16_trained": ln_bwd["library_ms"]}),
        flush=True)


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
            raise SystemExit("bandwidth_ab: the %s worker failed" % side)
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
