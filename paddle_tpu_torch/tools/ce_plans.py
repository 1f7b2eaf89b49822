#!/usr/bin/env python3
"""Time the fused CE kernel under several vocabulary-split plans, on one
CUDA card.

    python3 paddle_tpu_torch/tools/ce_plans.py [--rows 32768,4096]
        [--splits 1,2,4,8,17,30]

At Transformer-base's loss-head width (D 512, V 30000, f32, no bias, eps
0.1; inputs from ``chip_smoke.SEED``), for each row count, the kernel runs
under each requested split count (``nsplit`` splits of whole 128-column
tiles, none empty) and under the plan ``ops/fused_ce.py`` ``split_plan``
picks, timed by ``chip_smoke.time_ms`` (CUDA events, median). The plans
run in order and then in reverse, so a drift of the card over the call
falls on all alike. Each line is one plan, with both times, their mean
and whether ``split_plan`` picks it; the last line names the card.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _plan(tiles, nsplit):
    per = -(-tiles // nsplit)
    return (-(-tiles // per), per * 128, 128)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="32768,4096")
    ap.add_argument("--splits", default="1,2,4,8,17,30")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from paddle_tpu_torch.ops import fused_ce as fce

    if not torch.cuda.is_available():
        sys.exit("ce_plans: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d, v = cs.TRANSFORMER["d_model"], cs.TRANSFORMER["trg_vocab"]
    tiles = -(-v // 128)
    picked_plan = fce.split_plan
    gen = torch.Generator().manual_seed(cs.SEED)
    w = (torch.randn(d, v, generator=gen) / d ** 0.5).to(dev)
    for t in (int(r) for r in args.rows.split(",")):
        x = torch.randn(t, d, generator=gen).to(dev)
        y = torch.randint(0, v, (t,), generator=gen).to(dev)
        picked = picked_plan(t, v, sms)
        plans = [_plan(tiles, int(n)) for n in args.splits.split(",")]
        plans = list(dict.fromkeys(plans + [picked]))
        times = {p: [] for p in plans}
        for order in (plans, plans[::-1]):
            for p in order:
                fce.split_plan = lambda *_a, _p=p: _p
                times[p].append(cs.time_ms(
                    lambda: fce.fused_ce_fwd(x, w, None, y, 0.1), iters=10,
                    warmup=2))
        fce.split_plan = picked_plan
        for p in plans:
            print(json.dumps({"rows": t, "d": d, "v": v, "plan": list(p),
                              "blocks": -(-t // 128) * p[0],
                              "ms": times[p],
                              "ms_mean": sum(times[p]) / len(times[p]),
                              "picked": p == picked}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms}))


if __name__ == "__main__":
    main()
