#!/usr/bin/env python3
"""Where the run-to-run differences of captured steps, and the kernel
records of the decode profile windows, come from (one CUDA card).

    python3 paddle_tpu_torch/tools/capture_diag.py noise [--root DIR]
        [--runs 4] [--plain-bwd [--deterministic]]
    python3 paddle_tpu_torch/tools/capture_diag.py window [--repeats 10]
    python3 paddle_tpu_torch/tools/capture_diag.py decode-windows

``noise``: imports ``paddle_tpu_torch`` and ``chip_smoke.py`` from the
checkout ``--root`` (default: the one holding this script), builds its
kernels and runs ``chip_smoke.py``'s capture cases of Transformer-base
(f32, dropout 0.1, batch 2; and, where the checkout has LR schedules,
under ``exponential_decay``): ``--runs`` interpreted runs
(``use_program_cache=False``) and as many captured ones, each from one
copied state and generator state. Prints, per case, the relative L2 of
every pair of runs (fetches of every step and the state after, as
``capture_check`` takes it): interpreted against interpreted, captured
against captured, captured against interpreted, and whether each pair is
bitwise equal. ``--plain-bwd``: the flash backward runs its plain PyTorch
version on the card (no atomics: dq is summed by a matrix product), so
that a difference left between two runs is not the dq atomics' order;
``--deterministic`` also sets ``torch.use_deterministic_algorithms(True,
warn_only=True)`` (its warnings name the other ops that sum in no fixed
order).

``window``: ``chip_smoke.phase_decode``'s profile window of the captured
plain arm (40 dispatches after 8 of the short workload) ``--repeats``
times, each with the profiler's Chrome trace: the ``layer_norm_fwd``
kernels by graph launch (correlation id), and for any window whose
profiler count is not 25 a dispatch, which launch is short, its place in
the window, its kernels against its graph's other launches, and the
window's edges (first kernel start and last kernel end against the
trace's host events).

``decode-windows``: ``chip_smoke.py``'s phases ``build``,
``decode_check`` and ``decode`` as the script runs them, with every
failed check reported instead of raised and the Chrome trace of each
profiled window analysed: the port's kernels by kind against what the
window's dispatches and draft passes launch, and which kernels of the
window went unrecorded (by name, against the most frequent count a
dispatch, and where in the window the dispatches short of them lie).

One JSON object a line; exits non-zero on an error.
"""

import argparse
import collections
import importlib.util
import itertools
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ROOT = os.path.dirname(os.path.dirname(HERE))


def _load(root):
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_diag", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _plain_bwd(torch):
    """The flash backward's plain version in place of the kernel, with the
    counters ``chip_smoke.read_counts`` reads."""
    from paddle_tpu_torch.ops import flash_attention as fa

    def bwd(*args, **kwargs):
        return fa.attention_bwd_plain(*args, **kwargs)

    bwd.launches = bwd.bf16_launches = bwd.wgmma_launches = 0
    fa.flash_attention_bwd = bwd


def _runs(torch, cs, fluid, main, startup, feed, fetch, n, steps):
    """``n`` interpreted and ``n`` captured runs of ``chip_smoke``'s
    ``_capture_runs`` from one state: {"i": [...], "c": [...]}, each (fetches
    per step, state)."""
    import inspect

    from paddle_tpu_torch.core.executor import RNG_KEY

    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    start = {v.name: scope.get(v.name).clone() for v in main.list_vars()
             if v.persistable and v.name in scope}
    gen_state = scope.get(RNG_KEY).get_state()
    kw = ({"steps": steps} if "steps" in
          inspect.signature(cs._capture_runs).parameters else {})
    out = {}
    for mode, cache in (("i", False), ("c", True)):
        out[mode] = []
        for _ in range(n):
            outs, state, report, _l = cs._capture_runs(
                torch, fluid, main, feed, fetch, scope, start, gen_state,
                cache, **kw)
            if cache:
                assert report["captured"], report
            out[mode].append((outs, state))
    return out, sorted(start)


def _dist(torch, a, b, names):
    """(relative L2 over every fetch of every step and every state tensor,
    bitwise equal)."""
    import numpy as np

    num = den = 0.0
    equal = True
    pairs = [(torch.from_numpy(x), torch.from_numpy(y))
             for sa, sb in zip(a[0], b[0]) for x, y in zip(sa, sb)]
    pairs += [(a[1][n].double(), b[1][n].double()) for n in names]
    for x, y in pairs:
        num += float(torch.square(x - y).sum())
        den += float(torch.square(y).sum())
        equal = equal and torch.equal(x, y)
    return float(np.sqrt(num / max(den, 1e-300))), equal


def noise(args):
    import inspect

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _load(args.root)
    import paddle_tpu_torch as fluid

    cs.phase_build()
    if args.plain_bwd:
        _plain_bwd(torch)
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    rng = np.random.RandomState(cs.SEED)
    cases = [("transformer", {}, getattr(cs, "CAPTURE_STEPS", 4))]
    if "schedule" in inspect.signature(cs.build_transformer).parameters:
        cases.append(("transformer_exp_decay", {
            "schedule": lambda L: L.exponential_decay(1e-4, 2, 0.5)}, 7))
    for name, kw, steps in cases:
        main, startup, spec = cs.build_transformer(fluid, 0.1, **kw)
        fetch = [spec.loss] + ([spec.extras["lr"]] if kw else [])
        runs, names = _runs(torch, cs, fluid, main, startup,
                            spec.sample_batch(2, rng), fetch, args.runs,
                            steps)
        out = {"ii": [], "cc": [], "ci": []}
        for key, pairs in (
                ("ii", itertools.combinations(runs["i"], 2)),
                ("cc", itertools.combinations(runs["c"], 2)),
                ("ci", itertools.product(runs["c"], runs["i"]))):
            for a, b in pairs:
                d, eq = _dist(torch, a, b, names)
                out[key].append({"rel_l2": d, "bitwise": eq})
        _emit({"tool": "capture_diag", "mode": "noise", "root": args.root,
               "case": name, "steps": steps, "runs": args.runs,
               "plain_bwd": args.plain_bwd,
               "deterministic": args.deterministic,
               "interpreted_vs_interpreted": out["ii"],
               "captured_vs_captured": out["cc"],
               "captured_vs_interpreted": out["ci"],
               "max": {k: max(p["rel_l2"] for p in v)
                       for k, v in out.items()},
               "min": {k: min(p["rel_l2"] for p in v)
                       for k, v in out.items()}})
        del runs
        torch.cuda.empty_cache()


def _trace_kernels(path, kind_of):
    """(kernels [(ts, dur, name, kind, correlation)], graph launches
    {correlation: ts}, host (first ts, last end)) of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, launches, host = [], {}, [None, None]
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = e.get("args", {}).get("correlation")
        if cat == "kernel":
            kernels.append((e["ts"], e["dur"], e["name"],
                            kind_of(e["name"].lower()), corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "GraphLaunch" in e["name"]:
                launches[corr] = e["ts"]
        if cat in ("cpu_op", "python_function", "user_annotation",
                   "cuda_runtime", "cuda_driver"):
            end = e["ts"] + e.get("dur", 0)
            host[0] = e["ts"] if host[0] is None else min(host[0], e["ts"])
            host[1] = end if host[1] is None else max(host[1], end)
    return sorted(kernels), launches, host


def window(args):
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _load(args.root)
    import paddle_tpu_torch as fluid

    cs.phase_build()
    fam = cs.build_lm_family(fluid, fluid.CUDAPlace(0))
    short = [r for i, r in enumerate(cs.decode_workload(
        np.random.RandomState(cs.SEED + 2), 10)) if i % 5 != 4]
    per = cs.PER_DISPATCH["layer_norm_fwd"]
    skip, size = 8, 40
    tmp = tempfile.mkdtemp(prefix="window_")
    for rep in range(args.repeats):
        gc.collect()
        bat = fluid.serving.DecodeBatcher(
            fam["step"], fam["step_spec"], ladder=(1, 2, 4, 8),
            ctx_ladder=(256,), start=False)
        bat.warmup()
        futs = [bat.submit(p, max_new_tokens=n) for p, n in short]
        bat.drive(max_steps=skip)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            n = bat.drive(max_steps=size)
            torch.cuda.synchronize()
        bat.drive()
        assert n == size and all(f.done() for f in futs)
        counted = sum(e.count for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")
                      and cs._decode_kind(e.key.lower()) == "layer_norm_fwd")
        path = os.path.join(tmp, "w%d.json" % rep)
        prof.export_chrome_trace(path)
        kernels, launches, host = _trace_kernels(path, cs._decode_kind)
        by_launch = collections.defaultdict(list)
        for k in kernels:
            by_launch[k[4]].append(k)
        order = sorted(launches, key=launches.get)
        ln = [sum(k[3] == "layer_norm_fwd" for k in by_launch.get(c, ()))
              for c in order]
        rec = {"tool": "capture_diag", "mode": "window", "repeat": rep,
               "profiler_count": counted, "want": size * per,
               "trace_ln_kernels": sum(k[3] == "layer_norm_fwd"
                                       for k in kernels),
               "graph_launches": len(order),
               "kernels_outside_graph_launches": sum(
                   k[4] not in launches for k in kernels),
               "first_kernel_after_host_start_us": (
                   kernels[0][0] - host[0]) if kernels else None,
               "host_end_after_last_kernel_end_us": (
                   host[1] - max(k[0] + k[1] for k in kernels))
               if kernels else None}
        short_ones = [i for i, c in enumerate(ln) if c != per]
        if short_ones:
            sizes = collections.Counter(len(by_launch.get(c, ()))
                                        for c in order)
            rec["short_launches"] = []
            for i in short_ones:
                c = order[i]
                mine = collections.Counter(k[2] for k in by_launch[c])
                # the same graph's other launches: the most kernels in common
                peers = [collections.Counter(k[2] for k in by_launch[o])
                         for o in order if o != c and by_launch.get(o)]
                peer = max(peers, key=lambda p: sum((p & mine).values()))
                rec["short_launches"].append({
                    "index": i, "ln": ln[i],
                    "kernels": len(by_launch[c]),
                    "missing": dict(peer - mine), "extra": dict(mine - peer),
                    "first_us": by_launch[c][0][0] - kernels[0][0],
                    "last_end_us": max(k[0] + k[1] for k in by_launch[c])
                    - kernels[0][0]})
            rec["launch_sizes"] = dict(sizes)
        _emit(rec)
        os.remove(path)
        del bat, prof


def decode_windows(args):
    import numpy as np
    import torch
    import torch.profiler as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _load(args.root)
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg[:400])
            _emit({"tool": "capture_diag", "mode": "decode-windows",
                   "check_failed": msg[:2000]})

    cs.check = check
    tmp = tempfile.mkdtemp(prefix="windows_")
    traces = []
    base = tp.profile

    class Traced(base):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            path = os.path.join(tmp, "t%d.json" % len(traces))
            self.export_chrome_trace(path)
            traces.append(path)
            return out

    smi = cs.phase_device(torch)
    cs.phase_build()
    fam = cs.phase_decode_check(torch, smi)
    import paddle_tpu_torch as fluid

    scope, progs = cs._decode_programs(fluid, cs.GPT2)
    cs._decode_capture_case(torch, fluid, scope, progs)
    del scope, progs
    tp.profile = Traced
    try:
        cs.phase_decode(torch, smi, fam)
    finally:
        tp.profile = base
    for i, path in enumerate(traces):
        kernels, launches, host = _trace_kernels(path, cs._decode_kind)
        names = collections.Counter(k[2] for k in kernels)
        kinds = collections.Counter(k[3] for k in kernels)
        rec = {"tool": "capture_diag", "mode": "decode-windows",
               "trace": i, "kernels": len(kernels),
               "graph_launches": len(launches),
               "port_kernels": {k: kinds[k] for k in cs.KERNELS
                                if kinds[k]},
               "first_kernel_after_host_start_us": (
                   kernels[0][0] - host[0]) if kernels else None,
               "host_end_after_last_kernel_end_us": (
                   host[1] - max(k[0] + k[1] for k in kernels))
               if kernels else None}
        if launches:
            by_launch = collections.defaultdict(list)
            for k in kernels:
                by_launch[k[4]].append(k)
            order = sorted(launches, key=launches.get)
            per = [collections.Counter(k[2] for k in by_launch.get(c, ()))
                   for c in order]
            sizes = collections.Counter(sum(p.values()) for p in per)
            mode = sizes.most_common(1)[0][0]
            rec["launch_sizes"] = {str(n): c for n, c in sizes.items()}
            full = next(p for p in per if sum(p.values()) == mode)
            rec["short_launches"] = [
                {"index": j, "of": len(order), "kernels": sum(p.values()),
                 "missing": dict(full - p),
                 "first_us": by_launch[order[j]][0][0] - kernels[0][0]
                 if by_launch.get(order[j]) else None}
                for j, p in enumerate(per) if sum(p.values()) < mode][:8]
            rec["outside_launches"] = dict(collections.Counter(
                k[2][:60] for k in kernels if k[4] not in launches))
        rec["counts_not_multiple_of_40"] = {
            n[:80]: c for n, c in names.items() if c % 40 and c > 30}
        _emit(rec)
        os.remove(path)
    _emit({"tool": "capture_diag", "mode": "decode-windows",
           "failed_checks": failed})
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("noise")
    a.add_argument("--root", default=DEFAULT_ROOT)
    a.add_argument("--runs", type=int, default=4)
    a.add_argument("--plain-bwd", action="store_true")
    a.add_argument("--deterministic", action="store_true")
    b = sub.add_parser("window")
    b.add_argument("--root", default=DEFAULT_ROOT)
    b.add_argument("--repeats", type=int, default=10)
    c = sub.add_parser("decode-windows")
    c.add_argument("--root", default=DEFAULT_ROOT)
    args = ap.parse_args()
    args.root = os.path.abspath(args.root)
    if args.cmd == "noise" and args.deterministic:
        # cuBLAS's own deterministic workspace, before any CUDA call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    {"noise": noise, "window": window,
     "decode-windows": decode_windows}[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
