"""Serving worker process: one :class:`ServingEngine` behind a socket (the
port of ``paddle_tpu/serving/worker.py``).

Spawned and supervised by :mod:`paddle_tpu_torch.serving.router`; runnable
by hand for debugging::

    python -m paddle_tpu_torch.serving.worker --model path/to/saved_model \\
        --port 0 --replicas 1 [--device cpu]

``--device`` (default ``cuda``, i.e. ``cuda:0``) is where the engine
serves; without a CUDA device a worker not given ``--device cpu`` raises.
The worker binds an EPHEMERAL port (``--port 0``, the default) and
announces it on stdout as a single machine-readable line::

    PADDLE_TPU_WORKER_READY {"port": 41123, "pid": 7, "device": "cuda:0"}

which the router parses to learn the address. With ``--warmup`` every
rung has run before that line: on the card each rung's first dispatch is
interpreted (building the kernels it needs when ``build/`` lacks them)
and its second captured as a CUDA graph. Without it the first requests
at each rung pay for that, and may spend much of their deadline there.
Everything after the READY line is diagnostics; at shutdown the worker prints one more line,
``PADDLE_TPU_WORKER_EXIT {...}``, with what it served, its device, the
executor runs of its replicas (interpreted, captured, replayed) and the
port's kernel launch counters read in this process
(``ops.launch_counts``): how a caller that did not start the process sees
which kernels it ran.

Protocol (one ``rpc`` frame in, one out, persistent connections):

  * ``{"type": "ping"}`` -> ``{"type": "pong", "stats": {...}}`` — the
    health-check probe, answering with live engine gauges (queue depth,
    in-flight, deadline_refused) the router folds into routing.
  * ``{"type": "infer", "deadline_s": <remaining-or-null>, ...}`` plus
    the feed arrays -> ``{"type": "result", "n_out": N}`` plus fetch
    arrays ``o0..o{N-1}``, or a typed ``{"type": "error", "error":
    <kind>, "message": ...}``. A request whose propagated budget is
    already spent is REFUSED before it touches the engine
    (``error: "DeadlineRefused"``).
  * ``{"type": "stats"}`` -> the gauges, the engine's Prometheus
    exposition and ``kernels`` (the exit line's report, read now).
  * ``{"type": "shutdown"}`` -> acked, then the process drains and exits.
  * ``{"type": "reload", "dir": <ckpt dir>, "version": <n or null>}`` ->
    ``{"type": "reloaded", "version": N, "swap_count": K}``: the engine
    stages the version through ``checkpoint.load_staged`` (CRC-verified)
    and hot-swaps it between micro-batches.
  * the two-phase swap: ``prepare`` (``dir``, ``version``) ->
    ``{"type": "prepared", "version": N}`` stages without serving;
    ``commit`` (``version``) -> ``{"type": "committed", ...}`` flips to
    it (idempotent under retry); ``abort`` -> ``{"type": "aborted",
    "staged": bool}`` drops it. A failure is typed (``ReloadFailed``,
    ``PrepareFailed``, ``CommitFailed``) and never fatal: the worker
    keeps serving the old weights.

``--model`` takes a ``save_inference_model`` directory (one holding
``decode_spec.json`` serves decode) or a ``builtin:<name>`` spec
(``builtin:fc`` tiny classifier, ``builtin:mt_greedy`` the
machine-translation greedy While-loop decoder, ``builtin:lm_decode`` a
tiny KV-cache decode step with its chunk sibling) — the builtins exist so
tests and the chaos tools can prove the door is model-agnostic without
shipping model files around.
"""

import argparse
import json
import os
import signal
import socketserver
import sys
import threading

import numpy as np

from ..obs import flight, trace
from ..reliability import faults
from . import rpc
from .admission import DeadlineExceededError, ServerOverloadedError

__all__ = ["READY_PREFIX", "EXIT_PREFIX", "main", "build_model"]

READY_PREFIX = "PADDLE_TPU_WORKER_READY "
EXIT_PREFIX = "PADDLE_TPU_WORKER_EXIT "


def build_model(spec, device=None):
    """Resolve ``--model``: a saved-model directory passes through (the
    engine loads it); ``builtin:<name>`` builds a small in-process
    program + scope on ``device`` and returns a ``ProgramPredictor`` over
    it. ``builtin:lm_decode`` builds the KV-cache decode step program
    (plus its chunk sibling for chunked prefill) and tags the predictor
    with ``_decode_spec``/``_decode_prefill`` so ``main()`` can stand up a
    continuous-batching decode engine behind the same socket."""
    if not spec.startswith("builtin:"):
        return spec
    name = spec.split(":", 1)[1]
    import paddle_tpu_torch as fluid
    from ..core.executor import place_for
    from ..inference import ProgramPredictor

    place = place_for(device)
    main_prog, startup = fluid.Program(), fluid.Program()
    main_prog.random_seed = startup.random_seed = 11
    scope = fluid.Scope()
    decode_spec = lm_cfg = None
    with fluid.program_guard(main_prog, startup), fluid.scope_guard(scope):
        fluid.unique_name.switch()
        if name == "fc":
            x = fluid.layers.data("x", shape=[8])
            prob = fluid.layers.softmax(fluid.layers.fc(x, size=4))
            fetches, feeds = [prob], ["x"]
        elif name == "mt_greedy":
            from ..models import machine_translation as mt

            ids, scores = mt.seq2seq_attention_greedy_infer(
                src_vocab=32, trg_vocab=32, seq_len=6, emb_dim=8,
                hid_dim=8, max_out_len=4)
            fetches, feeds = [ids, scores], ["src_ids", "src_len"]
        elif name == "lm_decode":
            from ..models import transformer as tlm

            lm_cfg = tlm.lm_step_config(
                vocab=29, d_model=16, d_ff=32, n_head=2, n_layer=2,
                ctx_cap=32, pos_cap=64)
            fetches, decode_spec = tlm.transformer_lm_step(**lm_cfg)
            feeds = [decode_spec["token_feed"], decode_spec["pos_feed"]] \
                + [c["feed"] for c in decode_spec["cache_feeds"]]
        else:
            raise SystemExit("unknown builtin model %r (have: fc, "
                             "mt_greedy, lm_decode)" % name)
        exe = fluid.Executor(place)
        exe.run(startup)
    pred = ProgramPredictor(main_prog, feeds, fetches, scope=scope,
                            place=place)
    if decode_spec is not None:
        # chunk sibling: same ParamAttr names -> same scope entries, so
        # its startup is never run (the step startup initialized them)
        from ..models import transformer as tlm

        chunk_main, chunk_start = fluid.Program(), fluid.Program()
        chunk_main.random_seed = chunk_start.random_seed = 11
        with fluid.program_guard(chunk_main, chunk_start), \
                fluid.scope_guard(scope):
            fluid.unique_name.switch()
            cfetch, cspec = tlm.transformer_lm_chunk(**lm_cfg)
        cfeeds = [cspec["token_feed"], cspec["pos_feed"]] \
            + [c["feed"] for c in cspec["cache_feeds"]]
        cpred = ProgramPredictor(chunk_main, cfeeds, cfetch, scope=scope,
                                 place=place)
        pred._decode_spec = decode_spec
        pred._decode_prefill = {"predictor": cpred, "spec": cspec}
    return pred


class _WorkerState:
    """Counters + the engine (and its device), shared with every
    connection thread."""

    def __init__(self, engine, device=None):
        self.engine = engine
        self.device = device
        self.lock = threading.Lock()
        self.deadline_refused = 0
        self.served = 0
        self.stop = threading.Event()


def _stats(state):
    eng = state.engine
    with state.lock:
        refused, served = state.deadline_refused, state.served
    return {
        "pid": os.getpid(),
        "queue_depth": eng._batcher.depth() if eng._batcher else 0,
        "in_flight": eng._admission.in_flight,
        "deadline_refused": refused,
        "served": served,
        # fleet version-skew must be auditable from OUTSIDE: every
        # ping/stats answer names the model version this worker serves
        "serve_version": eng.serve_version,
        "swap_count": eng.swap_count,
    }


def _replica_predictors(engine):
    """Every predictor the engine dispatches through: each replica's, or
    in decode mode each batcher's step (and chunk) predictor."""
    if engine._decoders is not None:
        preds = []
        for d in engine._decoders:
            preds.append(d._predictor)
            if d._prefill is not None:
                preds.append(d._prefill["pred"])
        return preds
    return [w.predictor for w in engine._workers]


def _kernel_report(state):
    """What this worker served, where, its replicas' executor runs, the
    kernel launch counters and the seconds each kernel library took to
    build in this process (0.0: found built): the exit line's fields, and
    the ``stats`` verb's ``kernels``."""
    from .. import ops
    from ..ops import _build

    runs = dict.fromkeys(("interpreted", "captures", "replays"), 0)
    for pred in _replica_predictors(state.engine):
        exe = getattr(pred, "_exe", None)
        for entry in getattr(exe, "_cache", {}).values():
            for k in runs:
                runs[k] += entry.runs[k]
    snap = state.engine.metrics()
    with state.lock:
        served = state.served
    return {"pid": os.getpid(), "device": state.device, "served": served,
            "batches": snap["batches"],
            "decode_steps": snap["decode_steps"], "runs": runs,
            "launches": ops.launch_counts(),
            "build_seconds": dict(_build.build_seconds)}


def _handle_infer(state, header, arrays):
    """One request end-to-end; ALWAYS returns a response pair — an
    accepted frame never goes unanswered (zero-silent-loss starts here)."""
    remaining = header.get("deadline_s")
    if remaining is not None and remaining <= 0:
        # budget spent in transit or in the router queue is refused
        # BEFORE an engine slot is wasted
        with state.lock:
            state.deadline_refused += 1
        flight.record("deadline.refused", where="worker",
                      overdue_s=-remaining)
        return {"type": "error", "error": "DeadlineRefused",
                "message": "request budget expired %.3fs before it "
                           "reached the worker" % -remaining}, None
    # adopt the router-propagated context so the queue span (and the
    # engine.batch span parented through req.trace_ctx) stitch onto the
    # client's trace id
    tracer = trace.active()
    token = None
    if tracer is not None:
        ctx = trace.extract(header)
        if ctx is not None:
            token = tracer.activate(ctx)
    try:
        with trace.span("worker.queue") as sp:
            fut = state.engine.submit(
                dict(arrays), timeout_s=remaining,
                max_new_tokens=header.get("max_new_tokens"),
                eos_id=header.get("eos_id"))
            outs = fut.result(remaining + 30.0 if remaining is not None
                              else 300.0)
            if sp:
                sp.set(pid=os.getpid())
    except ServerOverloadedError as e:
        return {"type": "error", "error": "ServerOverloaded",
                "message": str(e)}, None
    except DeadlineExceededError as e:
        return {"type": "error", "error": "DeadlineExceeded",
                "message": str(e)}, None
    except Exception as e:
        return {"type": "error", "error": "WorkerFailed",
                "message": "%s: %s" % (type(e).__name__, e)}, None
    finally:
        if token is not None:
            tracer.deactivate(token)
    with state.lock:
        state.served += 1
    if not isinstance(outs, (list, tuple)):
        outs = [outs]  # decode futures resolve to ONE ids array
    out_arrays = {"o%d" % i: np.asarray(o) for i, o in enumerate(outs)}
    return {"type": "result", "n_out": len(outs)}, out_arrays


def _handle_reload(state, header):
    """Hot-swap the engine to a published checkpoint version. Failure is
    typed, never fatal: the worker keeps serving the old weights and the
    caller (publisher/router) decides on fallback."""
    ckpt_dir = header.get("dir")
    if not ckpt_dir:
        return {"type": "error", "error": "Rpc",
                "message": "reload needs a 'dir' field"}
    try:
        version = state.engine.reload(ckpt_dir,
                                      version=header.get("version"))
    except Exception as e:
        return {"type": "error", "error": "ReloadFailed",
                "message": "%s: %s" % (type(e).__name__, e)}
    return {"type": "reloaded", "version": version,
            "swap_count": state.engine.swap_count}


def _handle_prepare(state, header):
    """Phase 1 of the fleet's two-phase swap: CRC-stage, don't touch the
    served weights. A typed failure aborts the whole fleet's swap."""
    ckpt_dir = header.get("dir")
    if not ckpt_dir:
        return {"type": "error", "error": "Rpc",
                "message": "prepare needs a 'dir' field"}
    try:
        version = state.engine.prepare(ckpt_dir,
                                       version=header.get("version"))
    except Exception as e:
        return {"type": "error", "error": "PrepareFailed",
                "message": "%s: %s" % (type(e).__name__, e)}
    return {"type": "prepared", "version": version}


def _handle_commit(state, header):
    """Phase 2: flip to the staged version (idempotent under retry). A
    typed failure leaves this worker on the old weights; the fleet
    publisher quarantines the target and makes the skew loud."""
    try:
        version = state.engine.commit(version=header.get("version"))
    except Exception as e:
        return {"type": "error", "error": "CommitFailed",
                "message": "%s: %s" % (type(e).__name__, e)}
    return {"type": "committed", "version": version,
            "swap_count": state.engine.swap_count}


def _make_server(host, port, state):
    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            sock = self.request
            while not state.stop.is_set():
                try:
                    header, arrays = rpc.recv_msg(sock)
                except rpc.ConnectionClosed:
                    return
                except rpc.RpcError as e:
                    # torn/corrupt frame: answer typed if the pipe still
                    # works, then drop the connection (framing is lost)
                    try:
                        rpc.send_msg(sock, {"type": "error",
                                            "error": "Rpc",
                                            "message": str(e)})
                    except Exception:
                        pass
                    return
                kind = header.get("type")
                if kind == "ping":
                    resp, out = {"type": "pong",
                                 "stats": _stats(state)}, None
                elif kind == "infer":
                    resp, out = _handle_infer(state, header, arrays)
                elif kind == "stats":
                    # the scrape verb: gauges plus the engine's full
                    # Prometheus exposition, and the kernel report
                    resp, out = {
                        "type": "stats",
                        "stats": _stats(state),
                        "prometheus":
                            state.engine.metrics_.prometheus_text(),
                        "kernels": _kernel_report(state),
                    }, None
                elif kind == "reload":
                    resp, out = _handle_reload(state, header), None
                elif kind == "prepare":
                    resp, out = _handle_prepare(state, header), None
                elif kind == "commit":
                    resp, out = _handle_commit(state, header), None
                elif kind == "abort":
                    resp, out = {"type": "aborted",
                                 "staged": state.engine.abort_swap()}, None
                elif kind == "shutdown":
                    resp, out = {"type": "ok"}, None
                else:
                    resp, out = {"type": "error", "error": "Rpc",
                                 "message": "unknown message type %r"
                                            % kind}, None
                try:
                    rpc.send_msg(sock, resp, out)
                except rpc.RpcError:
                    return
                if kind == "shutdown":
                    state.stop.set()
                    threading.Thread(target=self.server.shutdown,
                                     daemon=True).start()
                    return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True
        # a burst of new connections (a client's pool, the router's
        # per-worker sockets) must not overflow socketserver's
        # backlog of 5: a dropped SYN is retried after 1 s
        request_queue_size = 128

    return Server((host, port), Handler)


def _decode_kwargs(model):
    """Decode mode: a ``builtin:lm_decode`` predictor carries its spec; a
    saved-model dir holding decode_spec.json serves decode. Knobs ride env
    vars so the router's ``worker_env`` reaches them:
    ``PADDLE_TPU_PREFIX_CACHE_MB`` (>0 turns on the shared prefix-KV
    cache), ``PADDLE_TPU_DECODE_MAX_NEW`` (default max_new_tokens per
    request)."""
    decode_kw = {}
    decode_spec = getattr(model, "_decode_spec", None)
    if decode_spec is not None:
        decode_kw["decode"] = decode_spec
        prefill = getattr(model, "_decode_prefill", None)
        if prefill is not None:
            decode_kw["decode_prefill"] = prefill
    elif isinstance(model, str) and os.path.exists(
            os.path.join(model, "decode_spec.json")):
        decode_kw["decode"] = True
    if decode_kw:
        try:
            mb = float(os.environ.get("PADDLE_TPU_PREFIX_CACHE_MB",
                                      "0") or 0)
        except ValueError:
            mb = 0.0
        if mb > 0:
            decode_kw["prefix_cache"] = {
                "max_bytes": int(mb * (1 << 20))}
        try:
            decode_kw["default_max_new_tokens"] = int(os.environ.get(
                "PADDLE_TPU_DECODE_MAX_NEW", "16"))
        except ValueError:
            decode_kw["default_max_new_tokens"] = 16
    return decode_kw


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.worker",
        description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    help="saved-model dir or builtin:<fc|mt_greedy|"
                         "lm_decode>")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 (default) binds an ephemeral port, announced "
                         "on stdout")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--ladder", default="1,2,4,8",
                    help="comma batch rungs for the engine bucket ladder")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue-depth", type=int, default=256)
    ap.add_argument("--placement", default="single",
                    choices=["single", "per_device"])
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the engine serves: cuda (default, "
                         "cuda:0), cuda:N or cpu")
    ap.add_argument("--warmup", action="store_true",
                    help="run every bucket rung (and capture its step on "
                         "the card) before READY")
    args = ap.parse_args(argv)

    faults.maybe_install_from_env()
    trace.maybe_start_from_env()
    flight.install()
    from ..core.executor import resolve_device
    from .engine import ServingEngine

    device = str(resolve_device(args.device))
    ladder = tuple(int(x) for x in args.ladder.split(",") if x.strip())
    model = build_model(args.model, device)
    engine = ServingEngine(model,
                           num_replicas=args.replicas, ladder=ladder,
                           max_wait_ms=args.max_wait_ms,
                           max_queue_depth=args.max_queue_depth,
                           placement=args.placement, mp=args.mp,
                           device=device if isinstance(model, str)
                           else None,
                           **_decode_kwargs(model))
    if args.warmup:
        try:
            engine.warmup()
        except Exception as e:  # warmup is an optimization, not a gate
            print("worker: warmup failed: %r" % e, file=sys.stderr)

    state = _WorkerState(engine, device)
    server = _make_server(args.host, args.port, state)
    port = server.server_address[1]

    def _on_term(signum, frame):
        state.stop.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
    except ValueError:
        pass  # not the main thread (in-process test harness)

    print(READY_PREFIX + json.dumps(
        {"port": port, "pid": os.getpid(), "model": args.model,
         "device": device}), flush=True)
    try:
        server.serve_forever(poll_interval=0.1)
    finally:
        server.server_close()
        engine.shutdown(drain=True, timeout_s=5.0)
        print(EXIT_PREFIX + json.dumps(_kernel_report(state)), flush=True)
        # SIGTERM from the router lands here via _on_term -> shutdown,
        # so a reaped worker still flushes its trace shard and flight ring
        trace.flush()
        flight.maybe_dump(reason="worker-shutdown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
