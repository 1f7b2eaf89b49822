#!/usr/bin/env python3
"""Time the kernels whose launch is planned in Python under several plans
beside the one their plan function picks, on one CUDA card.

    python3 paddle_tpu_torch/tools/kernel_plans.py
        [--kernels ce,scatter,layer_norm,layer_norm_bwd]
        [--ce-dtypes f32,bf16] [--ce-rows 32768,4096]
        [--splits 1,2,4,8,17,30] [--chunks 128,269,538,1024]
        [--warps 1,2,4,8] [--per-sm 1,2,3,4,8]

- ``ce``: the fused CE forward (row 9) at Transformer-base's loss-head
  width (D 512, V 30000, no bias, eps 0.1) for each of ``--ce-rows`` and
  ``--ce-dtypes`` (f32: the 3xTF32 form; bf16: the wgmma form), under each
  split count of ``--splits`` (whole tiles of the form, none empty) and
  under ``ops/fused_ce.py`` ``split_plan``'s with the form's tile.
- ``scatter``: the row scatter-add (row 13) at the DeepFM shape (851,968
  slots into 100000 x 32 f32) on uniform and on Zipf(1.2) ids, under each
  chunk of ``--chunks`` and under ``ops/scatter.py`` ``scatter_plan``'s.
- ``layer_norm``: the LayerNorm forward (row 7, f32) at BERT-base's served
  shape [1024, 768] and Transformer-base's training shape [32768, 512],
  under each count of ``--warps`` a block, in the planned
  register-resident form and in the looped form, beside
  ``ops/fused_layer_norm.py`` ``ln_fwd_plan``'s; and one row alone (what a
  launch costs whatever its size).
- ``layer_norm_bwd``: the bf16 LayerNorm backward (row 8 under AMP) at
  Transformer-base's training shape [32768, 512] and at [1000, 768], in
  the register-resident form under each count of ``--per-sm`` blocks an
  SM and in the looped form, beside ``ln_bwd_plan``'s.

Inputs come from ``chip_smoke.SEED`` and the shapes from ``chip_smoke.py``.
A plan runs by standing in for its module's plan function. Each time is
``chip_smoke.time_ms`` (CUDA events, median); the plans run in order and
then in reverse, so a drift of the card over the call falls on all alike.
Each line is one plan, with both times, their mean and whether the plan
function picks it; the last line names the card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _ce_cases(torch, cs, dev, sms, rows_list, splits, dtypes):
    from paddle_tpu_torch.ops import fused_ce as fce

    d, v = cs.TRANSFORMER["d_model"], cs.TRANSFORMER["trg_vocab"]
    gen = torch.Generator().manual_seed(cs.SEED)
    w32 = (torch.randn(d, v, generator=gen) / d ** 0.5).to(dev)
    cases = []
    for name in dtypes:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
        w = w32.to(dtype)
        for t in rows_list:
            x = torch.randn(t, d, generator=gen).to(dev, dtype)
            y = torch.randint(0, v, (t,), generator=gen).to(dev)
            form = fce.ce_form(x, w)
            tile = fce.WGMMA_TILE if form == "wgmma" else fce.MMA_SYNC_TILE
            rows, cols = tile[:2]
            tiles = -(-v // cols)
            picked = fce.split_plan(t, v, sms, tile)
            plans = []
            for n in splits:
                per = -(-tiles // n)
                plans.append((-(-tiles // per), per * cols, rows))
            for plan in dict.fromkeys(plans + [picked]):
                cases.append(dict(
                    label={"kernel": "fused_ce_fwd", "dtype": name,
                           "form": form, "rows": t, "d": d, "v": v,
                           "plan": list(plan),
                           "blocks": -(-t // rows) * plan[0]},
                    module=fce, attr="split_plan", plan=plan,
                    fn=lambda x=x, y=y, w=w: fce.fused_ce_fwd(x, w, None, y,
                                                              0.1),
                    picked=plan == picked, iters=10, warmup=2))
    return cases


def _scatter_cases(torch, cs, dev, sms, chunks):
    from paddle_tpu_torch.ops import scatter as sc

    v, k = cs.DEEPFM["sparse_feature_dim"], cs.DEEPFM_WIDTH
    n = cs.DEEPFM_BATCH * cs.DEEPFM["num_fields"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    vals = torch.randn(n, k, generator=gen, device=dev)
    out = torch.zeros(v, k, device=dev)
    picked = sc.scatter_plan(n, k, True, sms)
    plans = [picked._replace(chunk=c, blocks=-(-n // c)) for c in chunks]
    cases = []
    for kind in ("uniform", "zipf"):
        rows = cs._deepfm_rows(torch, kind, n, v, cs.SEED).to(dev)
        for plan in dict.fromkeys(plans + [picked]):
            cases.append(dict(
                label={"kernel": "scatter_add", "ids": kind,
                       "plan": list(plan)},
                module=sc, attr="scatter_plan", plan=plan,
                fn=lambda r=rows: sc.scatter_add(out, r, vals),
                picked=plan == picked))
    return cases


def _ln_cases(torch, cs, dev, sms, warps_list):
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(cs.SEED + 3)
    cases = []
    for shape, (rows_n, d) in (("served", cs.LN_SERVED),
                               ("trained", cs.LN_TRAINED)):
        x = torch.randn(rows_n, d, generator=gen).to(dev)
        g = torch.randn(d, generator=gen).to(dev)
        b = torch.randn(d, generator=gen).to(dev)
        picked = fln.ln_fwd_plan(rows_n, d, torch.float32, sms)
        plans = [fln.LnFwdPlan(picked.vec, vpl, w, -(-rows_n // w))
                 for vpl in (picked.vpl, 0) for w in warps_list]
        for plan in dict.fromkeys(plans + [picked]):
            cases.append(dict(
                label={"kernel": "layer_norm_fwd", "shape": [rows_n, d],
                       "plan": list(plan)},
                module=fln, attr="ln_fwd_plan", plan=plan,
                fn=lambda x=x, g=g, b=b: fln.layer_norm_fwd(x, g, b, 1e-5),
                picked=plan == picked))
        if shape == "served":
            one = fln.ln_fwd_plan(1, d, torch.float32, sms)
            cases.append(dict(
                label={"kernel": "layer_norm_fwd", "shape": [1, d],
                       "plan": list(one)},
                module=fln, attr="ln_fwd_plan", plan=one,
                fn=lambda x=x[:1], g=g, b=b: fln.layer_norm_fwd(x, g, b,
                                                                1e-5),
                picked=True))
    return cases


def _ln_bwd_cases(torch, cs, dev, sms, per_sm):
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(cs.SEED + 4)
    cases = []
    for rows_n, d in (cs.LN_TRAINED, (1000, 768)):
        x = torch.randn(rows_n, d, generator=gen).to(dev, torch.bfloat16)
        dy = torch.randn(rows_n, d, generator=gen).to(dev, torch.bfloat16)
        g = torch.randn(d, generator=gen).to(dev)
        _, mean, var = fln.layer_norm_fwd(x, g, None, 1e-5)
        picked = fln.ln_bwd_plan(rows_n, d, torch.bfloat16, sms)
        cap = -(-rows_n // picked.warps)
        plans = [picked._replace(blocks=min(cap, k * sms)) for k in per_sm]
        plans.append(picked._replace(vpl=0, blocks=min(cap, 4 * sms)))
        for plan in dict.fromkeys(plans + [picked]):
            cases.append(dict(
                label={"kernel": "layer_norm_bwd", "dtype": "bf16",
                       "shape": [rows_n, d], "plan": list(plan)},
                module=fln, attr="ln_bwd_plan", plan=plan,
                fn=lambda x=x, g=g, m=mean, v=var, dy=dy:
                    fln.layer_norm_bwd(x, g, m, v, dy, 1e-5),
                picked=plan == picked))
    return cases


def _ints(text):
    return [int(t) for t in text.split(",")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="ce,scatter,layer_norm,"
                                         "layer_norm_bwd")
    ap.add_argument("--ce-rows", default="32768,4096")
    ap.add_argument("--ce-dtypes", default="f32,bf16")
    ap.add_argument("--splits", default="1,2,4,8,17,30")
    ap.add_argument("--chunks", default="128,269,538,1024")
    ap.add_argument("--warps", default="1,2,4,8")
    ap.add_argument("--per-sm", default="1,2,3,4,8")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_plans: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    makers = {
        "ce": lambda: _ce_cases(torch, cs, dev, sms, _ints(args.ce_rows),
                                _ints(args.splits),
                                args.ce_dtypes.split(",")),
        "scatter": lambda: _scatter_cases(torch, cs, dev, sms,
                                          _ints(args.chunks)),
        "layer_norm": lambda: _ln_cases(torch, cs, dev, sms,
                                        _ints(args.warps)),
        "layer_norm_bwd": lambda: _ln_bwd_cases(torch, cs, dev, sms,
                                                _ints(args.per_sm))}
    cases = []
    for name in args.kernels.split(","):
        if name not in makers:
            sys.exit("kernel_plans: no kernel %r (of %s)"
                     % (name, ", ".join(makers)))
        cases += makers[name]()
    times = [[] for _ in cases]
    for order in (range(len(cases)), reversed(range(len(cases)))):
        for i in order:
            c = cases[i]
            picked = getattr(c["module"], c["attr"])
            setattr(c["module"], c["attr"], lambda *_a, _p=c["plan"]: _p)
            try:
                times[i].append(cs.time_ms(c["fn"], iters=c.get("iters", 50),
                                           warmup=c.get("warmup", 5)))
            finally:
                setattr(c["module"], c["attr"], picked)
    for c, ts in zip(cases, times):
        print(json.dumps(dict(c["label"], ms=ts, mean_ms=sum(ts) / len(ts),
                              picked=c["picked"])), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms,
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
