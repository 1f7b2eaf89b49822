#!/usr/bin/env python3
"""Serving A/B of two checkouts of this repository on one CUDA card.

    python3 paddle_tpu_torch/tools/serve_ab.py --base DIR [--change DIR]
        [--bursts 30] [--out FILE]

Two worker processes, one per checkout, each import ``paddle_tpu_torch``
and ``chip_smoke.py`` from their checkout, build its kernels, save the
full-width BERT-base classifier of ``chip_smoke.py`` (random weights from
its seed) and load it into a ``ServingEngine`` (one replica, batches up to
8 rows) and a ``Predictor``. The driver then asks them for measurement
bursts in turn, base-change then change-base, so the host's drift over the
call falls on both sides alike; only the worker asked runs, the other
waits on its pipe. One burst measures, under ``inference_mode``:

* the host time of 200 calls of each kernel wrapper on the serving path
  (``flash_attention`` and ``fused_layer_norm`` at the 8-row dispatch's
  shapes); the card runs behind and is drained after the clock stops;
* the wall time of 10 sequential 8-row ``Predictor.run`` dispatches;
* 200 requests of 1-4 rows through the engine in a closed loop of 32
  outstanding: requests/s and the p99 of the client's latencies;
* the same loop with every op and every ``Executor.run`` timed: host
  microseconds per dispatch by op type, in all ops, and in the run.

Prints one JSON line per burst and a summary: per side the median over
bursts, the per-pair ratios change / base, and an exact two-sided sign
test over the pairs. ``--change`` defaults to the checkout holding this
script. Exits non-zero if a worker fails.
"""

import argparse
import collections
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CHANGE = os.path.dirname(os.path.dirname(HERE))


class _Worker:
    """The serving stack of one checkout, measured burst by burst."""

    def __init__(self, root):
        sys.path.insert(0, root)
        import numpy as np
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.core import executor
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import fused_layer_norm as fln

        self.torch, self.np, self.executor = torch, np, executor
        self.smi_line = cs.phase_device(torch)
        cs.phase_build()
        dev = torch.device("cuda", 0)
        gen = torch.Generator().manual_seed(cs.SEED)
        b, t = 8, cs.BERT["seq"]
        h, hd = cs.BERT["heads"], cs.BERT["d_model"]
        q, k, v, x = (torch.randn(b, t, hd, generator=gen).to(dev)
                      for _ in range(4))
        bias = cs._padding_bias(torch, gen, b, t, dev)[:, None, None, :]
        g, bb = (torch.randn(hd, generator=gen).to(dev) for _ in range(2))
        self.calls = {
            "flash_attention_us": lambda: fa.flash_attention(q, k, v, h,
                                                             bias),
            "fused_layer_norm_us": lambda: fln.fused_layer_norm(x, g, bb,
                                                                1e-5)}

        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            prob = cs.build_bert_classifier(fluid)
        startup.random_seed = cs.SEED
        exe = fluid.Executor()
        scope = fluid.Scope()
        self.model_dir = tempfile.mkdtemp(prefix="serve_ab_")
        with fluid.scope_guard(scope):
            exe.run(startup)
            fluid.io.save_inference_model(
                self.model_dir, ["input_ids", "segment_ids", "input_len"],
                [prob], exe, main_program=main)
        rng = np.random.RandomState(cs.SEED)
        self.feeds = []
        for _ in range(200):
            n = int(rng.randint(1, 5))
            self.feeds.append({
                "input_ids": rng.randint(0, cs.BERT["vocab"], (n, t)),
                "segment_ids": rng.randint(0, 2, (n, t)),
                "input_len": rng.randint(1, t + 1, (n,))})
        self.batch = {key: np.concatenate([f[key] for f in self.feeds])[:8]
                      for key in self.feeds[0]}
        self.pred = fluid.inference.Predictor(self.model_dir)
        self.engine = fluid.serving.ServingEngine(
            self.model_dir, num_replicas=1, max_batch_size=8)
        self.engine.warmup()
        self.burst()  # warm every path once

    def burst(self):
        torch = self.torch
        rec = {}
        with torch.inference_mode():
            for name, fn in self.calls.items():
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                rec[name] = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            self.pred.run(self.batch)  # fetches to numpy: synchronised
        rec["wall_ms_per_dispatch"] = (time.perf_counter() - t0) / 10 * 1e3
        rec["requests_per_s"], rec["p99_ms"] = self._closed_loop()
        rec.update(self._engine_breakdown())
        return rec

    def _closed_loop(self):
        lat, pending = [], collections.deque()
        t0 = time.perf_counter()
        for f in self.feeds:
            if len(pending) >= 32:
                start, fut = pending.popleft()
                fut.result(timeout=300)
                lat.append(time.perf_counter() - start)
            pending.append((time.perf_counter(), self.engine.submit(f)))
        while pending:
            start, fut = pending.popleft()
            fut.result(timeout=300)
            lat.append(time.perf_counter() - start)
        rate = len(self.feeds) / (time.perf_counter() - t0)
        lat.sort()
        return rate, lat[int(0.99 * (len(lat) - 1))] * 1e3

    def _engine_breakdown(self):
        """The closed loop again with every op and every ``Executor.run``
        timed on the host: microseconds per dispatch by op type, in all
        ops, and in the whole ``Executor.run`` (the timers' own cost is in
        every entry, alike on both sides)."""
        acc = collections.Counter()
        run_op, exe_run = self.executor.run_op, self.executor.Executor.run

        def timed_op(env, op):
            t0 = time.perf_counter()
            run_op(env, op)
            acc[op.type] += time.perf_counter() - t0

        def timed_run(exe, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return exe_run(exe, *args, **kwargs)
            finally:
                acc["executor_run"] += time.perf_counter() - t0
                acc["dispatches"] += 1

        self.executor.run_op = timed_op
        self.executor.Executor.run = timed_run
        try:
            rate, _ = self._closed_loop()
        finally:
            self.executor.run_op = run_op
            self.executor.Executor.run = exe_run
        n = acc.pop("dispatches")
        run_us = acc.pop("executor_run") / n * 1e6
        ops = {k: v / n * 1e6 for k, v in acc.items()}
        return {"engine_dispatches": n, "engine_run_us": run_us,
                "engine_ops_us": sum(ops.values()),
                "engine_requests_per_s_timed": rate,
                **{"op_us:" + k: v for k, v in ops.items()}}

    def close(self):
        self.engine.shutdown()
        shutil.rmtree(self.model_dir, ignore_errors=True)


def _serve(root):
    """Worker loop: one JSON line per command read from stdin."""
    w = _Worker(root)
    print(json.dumps({"ready": True, "device": w.smi_line}), flush=True)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd != "burst":
            break
        out = w.burst()
        print(json.dumps(out), flush=True)
    w.close()


def _sign_test(wins, n):
    """Exact two-sided binomial p-value of ``wins`` of ``n`` at 1/2."""
    k = min(wins, n - wins)
    tail = sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n
    return min(1.0, 2 * tail)


def _ask(proc, cmd):
    proc.stdin.write(cmd + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError("worker exited: rc %s" % proc.wait())
    return json.loads(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--base", help="checkout to compare against")
    ap.add_argument("--change", default=DEFAULT_CHANGE)
    ap.add_argument("--bursts", type=int, default=30,
                    help="bursts per side, in alternating pairs")
    ap.add_argument("--out", help="also append every JSON line here")
    args = ap.parse_args()
    if args.worker:
        _serve(os.path.abspath(args.worker))
        return 0
    if not args.base:
        ap.error("--base is required")
    roots = {"base": os.path.abspath(args.base),
             "change": os.path.abspath(args.change)}
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    procs = {side: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", root],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for side, root in roots.items()}
    try:
        for side, proc in procs.items():
            for line in proc.stdout:  # chip_smoke's phases print first
                ready = json.loads(line)
                if ready.get("ready"):
                    emit(dict(ready, side=side, root=roots[side]))
                    break
            else:
                raise RuntimeError("%s worker failed to start: rc %s"
                                   % (side, proc.wait()))
        runs = {"base": [], "change": []}
        for i in range(args.bursts):
            order = ("base", "change") if i % 2 == 0 else ("change", "base")
            for side in order:
                rec = _ask(procs[side], "burst")
                emit(dict(rec, pair=i, side=side))
                runs[side].append(rec)
    finally:
        for proc in procs.values():
            try:
                proc.stdin.write("quit\n")
                proc.stdin.close()
                proc.wait(timeout=120)
            except Exception:
                proc.kill()
                proc.wait()
    summary = {"bursts": args.bursts, "roots": roots}
    for m in runs["base"][0]:
        pairs = [(b[m], c[m]) for b, c in zip(runs["base"], runs["change"])
                 if m in c]
        higher = sum(c > b for b, c in pairs)
        base_med = statistics.median(b for b, _ in pairs)
        change_med = statistics.median(c for _, c in pairs)
        ratios = [c / b for b, c in pairs if b]
        summary[m] = {
            "base_median": base_med, "change_median": change_med,
            # a metric that reads 0 (no op runs outside a captured replay)
            # has no ratio
            "median_ratio": change_med / base_med if base_med else None,
            "pair_ratio_median": (statistics.median(ratios) if ratios
                                  else None),
            "change_higher": higher,
            "sign_test_p": _sign_test(higher, len(pairs))}
    emit({"summary": summary})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
