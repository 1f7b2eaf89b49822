#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (Hopper):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc/``, holds
each against its plain PyTorch version on the card, times it, and then
drives the port's serving path at the full width of BERT-base
(vocab 30522, seq 128, d_model 768, d_ff 3072, 12 heads, 12 layers; random
weights from seed 11): layers -> Program -> Executor (startup on the card)
-> io.save_inference_model -> ServingEngine -> Predictor -> op interpreter
-> kernels. Each phase prints one JSON line; any failure raises and exits
non-zero. The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Without CUDA, or outside the
repository, it exits non-zero and prints no result.
"""

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

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, and f32 FLOP/s on the
# CUDA cores — both kernels do their arithmetic in f32 without tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12

BERT = dict(vocab=30522, seq=128, d_model=768, d_ff=3072, heads=12,
            layers=12)
SEED = 11


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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


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


def _padding_bias(torch, gen, b, tk, dev):
    lengths = torch.randint(1, tk + 1, (b,), generator=gen)
    return torch.where(torch.arange(tk)[None] < lengths[:, None], 0.0,
                       -1e9).to(dev)


def phase_flash_check(torch, dev):
    """Kernel vs plain version at the served shape and the causal cases.
    bf16: the plain version runs in f32 on the same bf16 inputs."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED)
    b, t, h = 8, BERT["seq"], BERT["heads"]
    d = BERT["d_model"] // h
    cases = [
        ("bert_f32", b, t, t, h, d, False, True, torch.float32, 1e-4),
        ("bert_bf16", b, t, t, h, d, False, True, torch.bfloat16, 2e-2),
        ("causal_square", 2, 128, 128, 4, 64, True, False, torch.float32,
         1e-4),
        ("causal_tq_lt_tk", 2, 64, 128, 4, 64, True, False, torch.float32,
         1e-4),
        ("causal_tq_gt_tk", 2, 128, 64, 4, 64, True, False, torch.float32,
         1e-4),
    ]
    errs = {}
    for name, b_, tq, tk, h_, d_, causal, padded, dtype, tol in cases:
        q, k, v = (torch.randn(b_, n, h_ * d_, generator=gen).to(dev, dtype)
                   for n in (tq, tk, tk))
        bias = (_padding_bias(torch, gen, b_, tk, dev)[:, None, None, :]
                if padded else None)
        kb = fa.key_bias(bias, b_, tk) if bias is not None else None
        out, lse = fa.flash_attention_fwd(q, k, v, h_, kb, causal)
        want, want_lse = fa.attention_plain(q.float(), k.float(), v.float(),
                                            h_, bias, causal)
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        live = want_lse > -1e30  # rows that see at least one key
        lse_err = (lse - want_lse)[live].abs().max().item()
        check(torch.equal(lse <= -1e30, ~live), name + ": masked rows differ")
        emit({"phase": "flash_attention_fwd", "case": name,
              "shape": [b_, tq, tk, h_, d_], "causal": causal,
              "dtype": str(dtype), "max_abs_err": err, "lse_err": lse_err,
              "tol": tol})
        check(err <= tol and lse_err <= max(tol, 1e-4),
              "flash %s error %g (lse %g) > %g" % (name, err, lse_err, tol))
        errs[name] = err
    return errs


def phase_ln_check(torch, dev):
    """Kernel vs plain version (in f32 on the same inputs). f32: y within
    1e-5 absolute. bf16: y within one bf16 ulp (2^-8 relative to |y|, at
    least 2^-8 absolute), since the kernel rounds y once to bf16. Mean and
    var are f32 in both: 1e-4 absolute."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    d = BERT["d_model"]
    g = torch.randn(d, generator=gen).to(dev)
    bb = torch.randn(d, generator=gen).to(dev)
    errs = {}
    for rows in (1024, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(dev, dtype)
            y, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
            wy, wm, wv = fln.layer_norm_plain(x.float(), g, bb, 1e-5)
            torch.cuda.synchronize()
            dy = (y.float() - wy).abs()
            if dtype == torch.float32:
                y_ok = dy.max().item() <= 1e-5
            else:
                y_ok = bool((dy <= 2.0 ** -8 * wy.abs().clamp_min(1.0)).all())
            e = (dy.max().item(), (mean - wm).abs().max().item(),
                 (var - wv).abs().max().item())
            name = "%dx%d_%s" % (rows, d, str(dtype).split(".")[1])
            emit({"phase": "layer_norm_fwd", "case": name,
                  "max_abs_err_y": e[0], "max_abs_err_mean": e[1],
                  "max_abs_err_var": e[2], "y_within_tol": y_ok,
                  "tol_y": "1e-5 abs" if dtype == torch.float32
                  else "2^-8 rel", "tol_stats": 1e-4})
            check(y_ok and e[1] <= 1e-4 and e[2] <= 1e-4,
                  "layer_norm %s errors %s" % (name, e))
            errs[name] = max(e)
    return errs


def phase_timing(torch, dev):
    """Each kernel at the served shapes (the top batch rung, 8 x 128
    tokens, f32), beside its plain version, one PyTorch library call as a
    yardstick (timed here only; the port never calls it), and its bound."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    b, t, h = 8, BERT["seq"], BERT["heads"]
    hd = BERT["d_model"]
    d = hd // h
    q, k, v = (torch.randn(b, t, hd, generator=gen).to(dev) for _ in range(3))
    bias4 = _padding_bias(torch, gen, b, t, dev)[:, None, None, :]
    kb = fa.key_bias(bias4, b, t)

    def split(x):
        return x.view(b, t, h, d).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    rows = {}
    nbytes = 4 * (4 * b * t * hd + b * t + b * h * t)
    flops = 4 * b * h * t * t * d
    bnd, by = bound(nbytes, flops)
    rows["flash_attention_fwd"] = dict(
        ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, h, kb)),
        plain_ms=time_ms(lambda: fa.attention_plain(q, k, v, h, bias4)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias4)),
        bound_ms=bnd, bound_by=by, shape=[b, t, t, h, d], bytes=nbytes,
        flops=flops)

    n_rows = b * t
    x = torch.randn(n_rows, hd, generator=gen).to(dev)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    nbytes = 4 * (2 * n_rows * hd + 2 * hd + 2 * n_rows)
    flops = 8 * n_rows * hd
    bnd, by = bound(nbytes, flops)
    rows["layer_norm_fwd"] = dict(
        ms=time_ms(lambda: fln.layer_norm_fwd(x, g, bb, 1e-5)),
        plain_ms=time_ms(lambda: fln.layer_norm_plain(x, g, bb, 1e-5)),
        library_ms=time_ms(lambda: F.layer_norm(x, (hd,), g, bb, 1e-5)),
        bound_ms=bnd, bound_by=by, shape=[n_rows, hd], bytes=nbytes,
        flops=flops)
    for name, r in rows.items():
        emit(dict({"phase": "timing", "kernel": name}, **r))
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
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    rng = np.random.RandomState(SEED)
    s = BERT["seq"]
    feeds = []
    for _ in range(n_requests):
        n = int(rng.randint(1, 5))
        feeds.append({
            "input_ids": rng.randint(0, BERT["vocab"], (n, s)),
            "segment_ids": rng.randint(0, 2, (n, s)),
            "input_len": rng.randint(1, s + 1, (n,))})

    fa.flash_attention_fwd.launches = 0
    fln.layer_norm_fwd.launches = 0
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
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "layer_norm_fwd": fln.layer_norm_fwd.launches}
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
    check(fa.flash_attention_fwd.launches == launches["flash_attention_fwd"]
          and fln.layer_norm_fwd.launches == launches["layer_norm_fwd"],
          "the CPU check launched a kernel")
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
        kind = ("flash_attention_fwd" if "flash_fwd_kernel" in name
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
    flash_errs = phase_flash_check(torch, dev)
    ln_errs = phase_ln_check(torch, dev)
    times = phase_timing(torch, dev)
    launches = phase_serve(torch, smi_line)

    src = {"flash_attention_fwd": (
               "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
               "paddle_tpu/ops/flash_attention.py:1001",
               flash_errs["bert_f32"]),
           "layer_norm_fwd": (
               "paddle_tpu_torch/csrc/layer_norm_fwd.cu",
               "paddle_tpu/ops/fused_layer_norm.py:42",
               ln_errs["1024x768_float32"])}
    kernels = []
    for name, (source, replaces, err) in src.items():
        r = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
