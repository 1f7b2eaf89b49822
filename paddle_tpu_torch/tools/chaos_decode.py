#!/usr/bin/env python
"""Chaos drill for the port's continuous-batching decode door (the twin of
``tools/chaos_decode.py``).

Stands up a router + N decode workers (``builtin:lm_decode``, or
``--model`` a saved step directory holding ``decode_spec.json``) with the
prefix-KV cache ENABLED, drives shared-prefix decode requests until the
cache is hot, SIGKILLs a worker mid-decode, and audits three invariants:

  1. **Zero silent losses** — every accepted request resolves to tokens
     or a TYPED error (``WorkerFailed`` et al.) within its bound.
  2. **No corruption from a hot cache** — greedy decode is deterministic
     and every worker seeds identically, so every completed burst reply
     must be bitwise-identical to the cold-pass reply for its prompt.
  3. **No stale prefix after respawn** — after the fleet heals, the same
     prompts must reproduce the cold-pass outputs exactly.

    python paddle_tpu_torch/tools/chaos_decode.py --workers 2 \\
        --requests 16 --kill                      # workers on cuda:0
    python paddle_tpu_torch/tools/chaos_decode.py --smoke --device cpu
                                                  # 2 workers, 6 requests,
                                                  # WITH kill

Prints one JSON summary line (counters + verdict). The drill also scrapes
each worker's Prometheus exposition and requires ``prefix_hits > 0`` —
proof the drill exercised the cache rather than passing with it cold.
:func:`decode_drill` runs the same drill on a router the caller built
(``chip_smoke.py``'s ``router_decode`` phase).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _prompts(n_distinct):
    """Shared-prefix prompt family inside the builtin vocab (29)."""
    base = [5, 7, 11, 13, 2, 3, 17, 19]
    return [base + [21 + (i % 7), 1 + i % 28] for i in range(n_distinct)]


def scrape_prefix_hits(router):
    """Sum ``paddle_tpu_serving_prefix_hits`` across live workers via the
    worker 'stats' verb (the router only relays ping gauges)."""
    from paddle_tpu_torch.serving import rpc

    total = 0.0
    for w in list(router._workers):
        try:
            sock = rpc.connect(w.address, timeout=5.0)
            try:
                rpc.send_msg(sock, {"type": "stats"}, None)
                header, _ = rpc.recv_msg(sock)
            finally:
                sock.close()
        except Exception:
            continue  # a freshly killed worker is fine to skip
        for line in header.get("prometheus", "").splitlines():
            if line.startswith("paddle_tpu_serving_prefix_hits "):
                total += float(line.split()[-1])
    return total


def _ids(out):
    import numpy as np

    return tuple(int(t) for t in np.asarray(out[0]).ravel())


def decode_drill(router, client, prompts, requests, max_new, kill,
                 timeout_s, concurrent=False, before_kill=None):
    """The drill on a started decode ``router``: a cold pass over
    ``prompts`` (the ground truth), a hot pass (prefix clones; must not
    move), a burst of ``requests`` cycling the prompts with worker 0
    SIGKILLed mid-decode when ``kill``, as soon as it holds one of them
    in flight (``chaos_router.kill_in_flight``; ``before_kill()`` runs
    just before it), then, once the fleet has healed, a post-respawn
    pass.
    ``concurrent`` sends each pass as one burst instead of one prompt at
    a time. Returns the summary dict (without the verdict) and the
    seconds and tokens of each pass."""
    import numpy as np

    from paddle_tpu_torch.serving import (DeadlineExceededError,
                                          RouterShutdownError,
                                          ServerOverloadedError,
                                          WorkerFailedError)
    from paddle_tpu_torch.tools.chaos_router import (count_rerouted,
                                                     kill_in_flight)

    typed = (WorkerFailedError, ServerOverloadedError,
             DeadlineExceededError, RouterShutdownError)
    summary = {"workers": router.num_workers, "requests": requests,
               "kill": bool(kill), "accepted": 0, "completed": 0,
               "typed_errors": {}, "silent_losses": 0, "respawns": 0,
               "recovered": None, "prefix_hits": 0.0, "hot_match": None,
               "burst_mismatches": 0, "post_respawn_match": None,
               "killed_pid": None, "victim_in_flight": None,
               "rerouted": None}
    passes = {}

    def feed(p):
        return {"prompt_ids": np.asarray(p, "int64")}

    def run_pass(name):
        t0 = time.perf_counter()
        if concurrent:
            futs = [client.submit(feed(p), timeout_s=timeout_s,
                                  max_new_tokens=max_new) for p in prompts]
            got = [_ids(f.result(timeout_s + 30.0)) for f in futs]
        else:
            got = [_ids(client.predict(feed(p), timeout_s=timeout_s,
                                       max_new_tokens=max_new))
                   for p in prompts]
        passes[name] = {"seconds": time.perf_counter() - t0,
                        "tokens": sum(len(g) for g in got)}
        return got

    # cold pass: harvests every prompt's prefix into the cache and records
    # the ground-truth greedy output per prompt
    truth = dict(zip(map(tuple, prompts), run_pass("cold")))
    # hot pass: same prompts, now admitted via prefix clones
    summary["hot_match"] = run_pass("hot") == [truth[tuple(p)]
                                              for p in prompts]
    summary["prefix_hits"] = scrape_prefix_hits(router)
    t0 = time.perf_counter()
    burst = [prompts[i % len(prompts)] for i in range(requests)]
    futs = [(p, client.submit(feed(p), timeout_s=timeout_s,
                              max_new_tokens=max_new)) for p in burst]
    summary["accepted"] = len(futs)
    if kill:
        kill_in_flight(router, 0, summary, before_kill)
    tokens = 0
    for p, f in futs:
        try:
            got = _ids(f.result(timeout_s + 30.0))
            summary["completed"] += 1
            tokens += len(got)
            if got != truth[tuple(p)]:
                summary["burst_mismatches"] += 1
        except typed as e:
            kind = type(e).__name__
            summary["typed_errors"][kind] = \
                summary["typed_errors"].get(kind, 0) + 1
        except Exception:
            summary["silent_losses"] += 1
    passes["burst"] = {"seconds": time.perf_counter() - t0,
                       "tokens": tokens}
    if kill:
        count_rerouted(router, summary)
        t0 = time.time()
        while time.time() - t0 < 120.0:
            snap = router.metrics_.snapshot()
            if snap["respawns"] >= 1 and all(
                    w["healthy"] for w in router._worker_states()):
                break
            time.sleep(0.2)
        summary["recovered"] = True
    summary["respawns"] = router.metrics_.snapshot()["respawns"]
    # post-respawn pass: the healed fleet (one cold cache, one hot) must
    # still reproduce the cold-pass outputs exactly
    try:
        summary["post_respawn_match"] = run_pass("post_respawn") == [
            truth[tuple(p)] for p in prompts]
    except Exception:
        summary["post_respawn_match"] = False
        summary["recovered"] = False
    return summary, passes


def verdict(summary):
    from paddle_tpu_torch.tools.chaos_router import hit_in_flight

    return (summary["silent_losses"] == 0
            and summary["completed"] > 0
            and summary["hot_match"] is True
            and summary["burst_mismatches"] == 0
            and summary["post_respawn_match"] is True
            and summary["prefix_hits"] > 0
            and (not summary["kill"] or summary["respawns"] >= 1)
            and hit_in_flight(summary))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="chaos_decode", description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--model", default="builtin:lm_decode")
    ap.add_argument("--device", default="cuda",
                    help="every worker's --device (cuda = cuda:0, or cpu)")
    ap.add_argument("--kill", action="store_true",
                    help="SIGKILL one worker while the decode burst is "
                         "in flight, then require a respawn")
    ap.add_argument("--timeout-s", type=float, default=90.0)
    ap.add_argument("--smoke", action="store_true",
                    help="preset: 2 workers, 6 requests, WITH kill — the "
                         "drill's whole point is the mid-decode kill")
    args = ap.parse_args(argv)
    if args.smoke:
        args.workers, args.requests, args.kill = 2, 6, True
        args.max_new = min(args.max_new, 4)
    sys.path.insert(0, ROOT)

    from paddle_tpu_torch.serving import Router, RouterClient

    worker_env = {
        "PADDLE_TPU_PREFIX_CACHE_MB": "8",
        "PADDLE_TPU_DECODE_MAX_NEW": str(args.max_new),
    }
    router = Router(args.model, num_workers=args.workers,
                    heartbeat_interval_s=0.2, worker_env=worker_env,
                    worker_args=["--device", args.device])
    try:
        router.start()
        client = RouterClient(router.address, pool_size=8)
        summary, passes = decode_drill(router, client, _prompts(4),
                                       args.requests, args.max_new,
                                       args.kill, args.timeout_s)
        client.close()
    finally:
        router.shutdown()
    summary.update(model=args.model, device=args.device, passes=passes)
    ok = verdict(summary)
    summary["verdict"] = "ok" if ok else "FAIL"
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
