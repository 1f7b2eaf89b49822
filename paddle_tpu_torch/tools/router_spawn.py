#!/usr/bin/env python3
"""Time a router's start over BERT-base workers on the card.

Saves the full-width BERT-base classifier of ``chip_smoke.py``'s ``serve``
phase (random weights from seed 11) and times ``Router(dir,
num_workers=N, worker_args=["--warmup", "--ladder", "1,2,4,8"]).start()``:
each worker imports the port, loads the model onto ``cuda:0``, builds the
kernels its warmup launches unless ``build/`` already holds them, and
runs and captures every rung before its READY line. Run it on a clean
checkout to see what a first start costs against the router's
``spawn_timeout_s``, then again to see a start that finds the kernels
built:

    python3 paddle_tpu_torch/tools/router_spawn.py [--workers 2] [--repeat 2]

Also prints what ``nvidia-smi --query-compute-apps`` lists while the
workers run (``chip_smoke.compute_apps``: pid and used MiB of each). One
JSON line per start.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def save_bert(fluid, chip_smoke):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        prob = chip_smoke.build_bert_classifier(fluid)
    startup.random_seed = chip_smoke.SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())  # no kernel built here
    exe.run(startup, scope=scope)
    model_dir = tempfile.mkdtemp(prefix="bert_base_router_")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            model_dir, ["input_ids", "segment_ids", "input_len"], [prob],
            exe, main_program=main)
    return model_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--spawn-timeout", type=float, default=120.0,
                    help="the router's spawn_timeout_s (its default: 120); "
                         "raise it to time a start that overruns it")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import Router, RouterClient

    model_dir = save_bert(fluid, chip_smoke)
    try:
        for i in range(args.repeat):
            built = sorted(f for f in os.listdir(_build.BUILD_DIR)
                           if f.endswith(".so")) \
                if os.path.isdir(_build.BUILD_DIR) else []
            router = Router(model_dir, num_workers=args.workers,
                            worker_args=["--warmup", "--ladder", "1,2,4,8"],
                            spawn_timeout_s=args.spawn_timeout)
            t0 = time.perf_counter()
            try:
                router.start()
                start_s = time.perf_counter() - t0
                apps = chip_smoke.compute_apps()
                client = RouterClient(router.address)
                feed = {"input_ids": [[1] * chip_smoke.BERT["seq"]],
                        "segment_ids": [[0] * chip_smoke.BERT["seq"]],
                        "input_len": [chip_smoke.BERT["seq"]]}
                client.predict(feed, timeout_s=120.0)
                client.close()
            finally:
                router.shutdown()
            print(json.dumps({
                "start": i, "workers": args.workers, "start_s": start_s,
                "spawn_timeout_s": router.spawn_timeout_s,
                "libraries_before": built,
                "ready": [w.ready for w in router._workers],
                "build_seconds": [w.exits[-1]["build_seconds"]
                                  if w.exits else None
                                  for w in router._workers],
                "worker_pids": [w.pid for w in router._workers],
                "compute_apps": apps}), flush=True)
    finally:
        shutil.rmtree(model_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
