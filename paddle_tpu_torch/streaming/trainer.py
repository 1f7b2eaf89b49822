"""Long-running DeepFM trainer over a live record stream (the port of
``paddle_tpu/streaming/trainer.py``).

Reference: the pslib/Downpour trainer loop — ``async_executor.cc`` workers
consume click logs forever while the table server ships fresh parameters
to serving. Here the trainer consumes a :class:`~.stream.RecordStream`,
tracks an accuracy proxy on held-out rows, and periodically *publishes*:
a CRC-verified versioned checkpoint (``checkpoint.save_checkpoint``)
whose write runs on a background thread — the device->host snapshot is
synchronous (a captured step writes the next state into the same
tensors) but the training loop never blocks on the disk write, and the
atomic ``latest`` marker lands last so the swap plane can only ever
observe complete versions. The trainer runs on ``place`` (default
``CUDAPlace(0)``; without a GPU that raises: pass ``CPUPlace()``).

Fault site ``checkpoint.publish`` trips once per publish attempt:
``error`` models a failed publish (counted, training continues — a
long-running trainer must not die to one), ``corrupt`` damages the
landed version so the swap plane's fallback-to-previous-intact path can
be drilled end to end. Fault site ``cursor.write`` trips once per
cursor capture inside a publish: ``error`` fails the WHOLE publish (a
version without its cursor would silently replay from zero on resume),
``corrupt`` drops the file offsets — the resulting full replay must
show up *counted* in ``replayed_rows``, never silently.

Restart story (the multi-host control plane): every publish
carries the stream's ingest cursor inside the checkpoint manifest
(atomic — manifest present means cursor present), and a per-step
``progress.json`` ledger records how far past the last publish the
trainer had read. ``resume()`` restores weights + step + cursor from
the newest intact version and computes ``replayed_rows`` = ledger rows
minus cursor rows: at-least-once ingest with bounded, counted replay.
SIGTERM flips a preemption flag; the loop finishes its micro-batch,
flushes a final checkpoint+cursor under a ``Deadline`` grace budget,
releases its partition leases, and exits clean — so a restart resumes
instead of replaying from zero. ``dp > 1`` (a data-parallel step over
several cards) waits for ROADMAP A7.
"""

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np

from .. import checkpoint
from ..core.executor import Executor, Scope, scope_guard, to_numpy
from ..core.framework import Program, program_guard
from ..core import unique_name
from ..data.data_feed import DataFeedDesc
from ..obs import flight
from ..reliability import faults
from ..reliability.policy import Deadline
from .stream import RecordStream, StreamIngester, write_records

__all__ = ["StreamingTrainer", "feed_desc", "synthesize_stream_files"]

_PROGRESS = "progress.json"

TRAINER_READY_PREFIX = "PADDLE_TPU_TRAINER_READY "


def feed_desc(num_fields=4, dense_dim=4, batch_size=16):
    """The DeepFM stream schema: one record = concatenated dense slots."""
    return DataFeedDesc([("feat_ids", (num_fields,), "int64"),
                         ("dense_value", (dense_dim,), "float32"),
                         ("label", (1,), "int64")], batch_size=batch_size)


def synthesize_stream_files(data_dir, num_fields=4, sparse_feature_dim=64,
                            dense_dim=4, n_files=1, rows_per_file=256,
                            start_index=0, seed=0, chunk_rows=64):
    """Write learnable synthetic CTR rows as recordio files (pure-Python
    writer — no native toolchain needed). The labeling rule is a fixed
    function of ``seed``, so successive calls with increasing
    ``start_index`` extend the SAME distribution — the producer side of a
    tail-follow drill. Returns the file paths written."""
    desc = feed_desc(num_fields, dense_dim, batch_size=1)
    rule = np.random.RandomState(seed)
    w_id = rule.normal(0.0, 1.0, sparse_feature_dim)
    w_dense = rule.normal(0.0, 1.0, dense_dim)
    thresh = 0.5 * float(w_dense.sum())  # E[logit] -> ~balanced labels
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for fi in range(start_index, start_index + n_files):
        path = os.path.join(data_dir, "part-%05d.recordio" % fi)
        rng = np.random.RandomState(seed * 7919 + 1000 + fi)
        recs = []
        for _ in range(rows_per_file):
            ids = rng.randint(0, sparse_feature_dim, num_fields)
            dense = rng.uniform(0.0, 1.0, dense_dim).astype("f4")
            logit = float(w_id[ids].sum()) + float(dense @ w_dense)
            recs.append(desc.serialize({
                "feat_ids": ids, "dense_value": dense,
                "label": [int(logit > thresh)]}))
            if len(recs) >= chunk_rows:
                write_records(path, recs)
                recs = []
        if recs:
            write_records(path, recs)
        paths.append(path)
    return paths


class StreamingTrainer:
    """DeepFM trainer consuming a record stream, publishing versioned
    checkpoints every ``publish_every_steps`` without blocking the loop.

    ``ckpt_dir`` receives ``checkpoint_<n>`` versions (retention-GC'd to
    ``max_versions``, pinned versions excepted) and ``serve/`` — an
    inference-model export written once at startup that a ServingEngine
    loads; subsequent publishes only ship parameter deltas via the
    checkpoint versions the swap plane stages.

    The first ``holdout_batches`` full batches off the stream are HELD
    OUT (never trained on) and scored at every publish —
    ``last_eval_loss`` is the accuracy proxy the soak test watches
    improve across hot swaps."""

    def __init__(self, ckpt_dir, num_fields=4, sparse_feature_dim=64,
                 embedding_size=8, dense_dim=4, hidden_sizes=(32,),
                 batch_size=16, learning_rate=0.05, publish_every_steps=50,
                 max_versions=4, holdout_batches=2, seed=7, place=None,
                 dp=None):
        if dp and int(dp) > 1:
            raise NotImplementedError(
                "StreamingTrainer(dp=%d): the data-parallel step over "
                "several cards is not ported yet (ROADMAP A7)" % int(dp))
        from ..models.deepfm import deepfm
        from .. import optimizer

        self.ckpt_dir = ckpt_dir
        self.serve_dir = os.path.join(ckpt_dir, "serve")
        self.publish_every_steps = int(publish_every_steps)
        self.max_versions = max_versions
        self.holdout_batches = int(holdout_batches)
        self.data_feed = feed_desc(num_fields, dense_dim, batch_size)
        self.holdout = []
        self.step = 0
        self.publishes = 0
        self.publish_failures = 0
        self.last_train_loss = None
        self.last_eval_loss = None
        self._writer = None
        self._stream = None
        self.coordinator = None
        self.resumed_version = None
        self.replayed_rows = 0
        self.preempted = threading.Event()
        from .stream import REGISTRY
        REGISTRY.gauge(
            "paddle_tpu_stream_replayed_rows",
            "rows re-read past the resumed cursor (at-least-once replay)",
            fn=lambda: self.replayed_rows)

        self.main, self.startup = Program(), Program()
        self.main.random_seed = self.startup.random_seed = int(seed)
        self.scope = Scope()
        with program_guard(self.main, self.startup), \
                scope_guard(self.scope):
            unique_name.switch()
            spec = deepfm(sparse_feature_dim=sparse_feature_dim,
                          num_fields=num_fields,
                          embedding_size=embedding_size,
                          dense_dim=dense_dim, hidden_sizes=hidden_sizes)
            self.loss = spec.loss
            self.prob = spec.fetches["prob"]
            optimizer.Adam(learning_rate=learning_rate).minimize(self.loss)
            self.exe = Executor(place)
            self.exe.run(self.startup)
            # forward-only clone for held-out scoring: pruning to the loss
            # drops the backward + Adam ops, so scoring never trains
            eval_prog = self.main.clone(for_test=True)
            eval_loss = eval_prog.global_block().var(self.loss.name)
            self.eval_prog = eval_prog.prune([eval_loss])
            self.eval_loss = self.eval_prog.global_block().var(
                self.loss.name)
            self.train_prog = self.main
            self.dp = 0
        self._export_serve_dir()

    def _export_serve_dir(self):
        from .. import io

        with scope_guard(self.scope):
            io.save_inference_model(
                self.serve_dir, ["feat_ids", "dense_value"], [self.prob],
                self.exe, main_program=self.main)

    # -- accuracy proxy ------------------------------------------------------
    def eval_holdout(self):
        """Mean loss over the held-out batches (lower = better)."""
        if not self.holdout:
            return None
        losses = []
        for feed in self.holdout:
            v, = self.exe.run(self.eval_prog, feed=feed,
                              fetch_list=[self.eval_loss], scope=self.scope,
                              return_numpy=False)
            losses.append(float(to_numpy(v)))
        return float(np.mean(losses))

    # -- durable cursor / progress ledger ------------------------------------
    def _capture_cursor(self):
        """The stream's resume point, destined for the version manifest.
        Fault site ``cursor.write``: ``error`` raises (failing the whole
        publish — a cursor-less version would replay from zero silently),
        ``corrupt`` drops the offsets, modeling a torn cursor that forces
        a full — but *counted* — replay."""
        if self._stream is None:
            return None
        mode = faults.trip("cursor.write")
        cur = self._stream.cursor()
        if mode == "corrupt":
            cur = {"rows": 0, "files": {}}
        return cur

    def _write_progress(self):
        """Per-step ledger of how far the ingest has read — the delta
        between this and the last published cursor is exactly the replay
        a restart pays, so resume() can COUNT it."""
        if self._stream is None:
            return
        tmp = os.path.join(self.ckpt_dir, _PROGRESS + ".tmp")
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({"rows": self._stream.rows_total,
                                    "step": self.step}))
            os.replace(tmp, os.path.join(self.ckpt_dir, _PROGRESS))
        except OSError:
            pass  # a torn ledger only costs replay accounting, not data

    def _read_progress(self):
        try:
            with open(os.path.join(self.ckpt_dir, _PROGRESS)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- resume --------------------------------------------------------------
    def resume(self, stream=None):
        """Warm-start from the newest intact published version: weights,
        step counter, and (when ``stream`` is given) the ingest cursor —
        weights and cursor always come from the SAME version, so the
        model never skips rows it was not trained on. Replay is counted:
        ``replayed_rows`` = the dead incarnation's progress ledger minus
        the resumed cursor (bounded by the publish cadence). Returns the
        version resumed from, or None (cold start)."""
        try:
            v, updates, extra = checkpoint.load_staged(
                self.ckpt_dir, self.main)
        except checkpoint.NoCheckpointError:
            return None
        checkpoint.apply_updates(self.scope, updates, self.exe.device,
                                 self.main)
        self.step = int(extra.get("step", 0))
        self.resumed_version = v
        cur = extra.get("cursor")
        if stream is not None and cur is not None:
            stream.seek(cur)
            self._stream = stream
            ledger = self._read_progress()
            if ledger is not None:
                self.replayed_rows = max(
                    0, int(ledger.get("rows", 0)) - int(cur.get("rows", 0)))
        flight.record("trainer.resume", version=v, step=self.step,
                      replayed_rows=self.replayed_rows)
        return v

    # -- publish -------------------------------------------------------------
    def publish(self):
        """Snapshot + async-write one checkpoint version, the stream's
        ingest cursor riding in the manifest (atomic: a kill mid-publish
        leaves a manifest-less torn dir, so the older version's cursor
        stays the resume point). Never raises: a failed publish is
        counted (``publish_failures``), recorded to the flight ring, and
        training continues."""
        # surface a PREVIOUS publish's write failure now (non-blocking:
        # only a finished writer is examined)
        if self._writer is not None and self._writer.done() \
                and self._writer.error is not None:
            self.publish_failures += 1
            flight.record("publish.fail", step=self.step,
                          error=type(self._writer.error).__name__)
            self._writer = None
        self.last_eval_loss = self.eval_holdout()
        try:
            # fault site: 'error' = the publish path dying mid-flight,
            # 'corrupt' = a bad version landing (swap-plane fallback drill)
            mode = faults.trip("checkpoint.publish")
            extra = {"step": self.step, "eval_loss": self.last_eval_loss}
            cur = self._capture_cursor()
            if cur is not None:
                extra["cursor"] = cur
            writer = checkpoint.save_checkpoint(
                self.exe, self.ckpt_dir, main_program=self.main,
                scope=self.scope, async_write=True,
                max_versions=self.max_versions,
                extra_meta=extra)
        except Exception as e:  # noqa: BLE001 — a trainer outlives publishes
            self.publish_failures += 1
            flight.record("publish.fail", step=self.step,
                          error=type(e).__name__)
            return None
        version = int(os.path.basename(writer.path).split("_")[1])
        if mode == "corrupt":
            writer.wait()  # only the injected-corruption path blocks
            checkpoint._flip_byte(
                os.path.join(writer.path, "replicated.npz"))
        self._writer = writer
        self.publishes += 1
        flight.record("publish.version", version=version, step=self.step,
                      eval_loss=self.last_eval_loss)
        return writer

    # -- the loop ------------------------------------------------------------
    def run(self, stream, max_steps=None, max_bad_records=0,
            on_publish=None, on_step=None):
        """Consume ``stream`` until it closes (or ``max_steps`` training
        steps ran, or :attr:`preempted` is set — the SIGTERM grace path
        finishes the current micro-batch and returns). Publishes every
        ``publish_every_steps``; each step lands in the progress ledger.
        Returns the number of training steps executed."""
        self._stream = stream
        ing = StreamIngester(stream, self.data_feed,
                             max_bad_records=max_bad_records)
        for feed in ing.batches():
            if self.preempted.is_set():
                break
            if len(self.holdout) < self.holdout_batches:
                self.holdout.append(feed)
                continue
            v, = self.exe.run(self.train_prog, feed=feed,
                              fetch_list=[self.loss],
                              scope=self.scope, return_numpy=False)
            self.last_train_loss = float(to_numpy(v))
            self.step += 1
            self._write_progress()
            if on_step is not None:
                on_step(self)
            if self.publish_every_steps \
                    and self.step % self.publish_every_steps == 0:
                self.publish()
                if on_publish is not None:
                    on_publish(self)
            if max_steps is not None and self.step >= max_steps:
                break
        return self.step

    # -- preemption-aware shutdown -------------------------------------------
    def flush(self, grace_s=10.0, clock=None):
        """The SIGTERM grace path: one final synchronous publish (cursor
        included) bounded by a :class:`Deadline`, then lease release —
        so the whole-group restart resumes from HERE, not from the last
        periodic publish. Returns True when the flush landed whole."""
        deadline = Deadline(grace_s, clock=clock)
        ok = False
        writer = self.publish()
        if writer is not None:
            ok = writer.wait_until(deadline) and writer.error is None
        flight.record("preempt.flush", step=self.step, ok=ok,
                      remaining_s=round(deadline.remaining(), 3))
        if self.coordinator is not None:
            self.coordinator.release_all()
        return ok

    def close(self):
        """Join the in-flight checkpoint write (surfacing its error)."""
        if self._writer is not None:
            self._writer.wait()
            self._writer = None


def main(argv=None):
    """CLI for drills: tail-follow ``--data-dir`` and train, publishing
    into ``--ckpt-dir``. Prints a READY line (with the serve dir) once
    the model is built and exported, so a parent process can time its
    kill signals against the publish cadence.

    Multi-host mode (``--partitions N``): the host only tails stream
    files in partitions it holds a lease on (``streaming/coordinator``),
    heartbeating every step (and between empty tail polls, so an idle
    host keeps coordinating) and taking over expired/torn leases — a
    takeover adopts the dead host's published cursor from its
    ``--peer-dirs`` so reassigned partitions resume mid-file instead of
    from byte 0. Host identity comes from ``--host-id`` or
    ``PADDLE_TRAINER_ID``, and on a restart the
    trainer resumes from its newest intact version's cursor (replay
    counted in ``replayed_rows``). SIGTERM = preemption notice: finish
    the micro-batch, flush checkpoint+cursor within ``--grace-s``,
    release leases, exit 0. ``--device`` (default ``cuda``, i.e.
    ``cuda:0``) is where it trains; the model widths default to the
    reference CLI's tiny DeepFM."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--publish-every", type=int, default=25)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-versions", type=int, default=4)
    p.add_argument("--sparse-dim", type=int, default=64)
    p.add_argument("--poll-interval", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--partitions", type=int, default=0,
                   help="stream partitions (0 = tail the whole dir)")
    p.add_argument("--host-id", default=None,
                   help="lease owner id (default: PADDLE_TRAINER_ID/pid)")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="healthy-fleet share divisor (default: "
                        "PADDLE_TRAINERS or 1)")
    p.add_argument("--lease-ttl", type=float, default=2.0)
    p.add_argument("--grace-s", type=float, default=10.0,
                   help="SIGTERM flush budget (Deadline)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel degree (> 1 waits for ROADMAP A7)")
    p.add_argument("--device", default="cuda",
                   help="where the trainer runs (cuda = cuda:0, or cpu)")
    p.add_argument("--num-fields", type=int, default=4)
    p.add_argument("--embedding-size", type=int, default=8)
    p.add_argument("--dense-dim", type=int, default=4)
    p.add_argument("--hidden", default="32",
                   help="comma-separated MLP widths")
    p.add_argument("--holdout-batches", type=int, default=2)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--peer-dirs", default="",
                   help="comma-separated peer ckpt dirs (cursor handover "
                        "source on partition takeover)")
    args = p.parse_args(argv)

    faults.maybe_install_from_env()
    flight.install()
    from ..core.executor import place_for

    trainer = StreamingTrainer(
        args.ckpt_dir, batch_size=args.batch_size,
        publish_every_steps=args.publish_every,
        max_versions=args.max_versions,
        sparse_feature_dim=args.sparse_dim, seed=args.seed, dp=args.dp,
        num_fields=args.num_fields, embedding_size=args.embedding_size,
        dense_dim=args.dense_dim,
        hidden_sizes=tuple(int(h) for h in args.hidden.split(",") if h),
        holdout_batches=args.holdout_batches,
        place=place_for(args.device))
    host = args.host_id or os.environ.get("PADDLE_TRAINER_ID") \
        or str(os.getpid())
    num_hosts = args.num_hosts or int(os.environ.get("PADDLE_TRAINERS", 1))
    peer_dirs = [d for d in args.peer_dirs.split(",") if d]

    coord = None
    # Coordination must not starve with the batch loop: a host whose own
    # partitions run dry stops stepping, and a per-step beat alone would
    # then never renew its leases or reclaim a dead peer's. The stream's
    # idle sleep (between empty tail polls) drives the same beat, so an
    # idle survivor still takes over expired partitions.
    idle_hooks = {}

    def _idle_sleep(seconds):
        fn = idle_hooks.get("beat")
        if fn is not None:
            fn()
        time.sleep(seconds)

    if args.partitions > 0:
        from .coordinator import PartitionCoordinator

        share = -(-args.partitions // max(1, num_hosts))  # ceil
        coord = PartitionCoordinator(
            args.data_dir, host, args.partitions, ttl_s=args.lease_ttl,
            target_share=share)
        trainer.coordinator = coord
        coord.poll()
        stream = RecordStream(coord.source(),
                              poll_interval_s=args.poll_interval,
                              sleep=_idle_sleep)
    else:
        stream = RecordStream(args.data_dir,
                              poll_interval_s=args.poll_interval)

    def _on_sigterm(*_a):
        trainer.preempted.set()
        stream.interrupt()  # unblock an idle tail-follow immediately

    signal.signal(signal.SIGTERM, _on_sigterm)

    if not args.no_resume:
        try:
            trainer.resume(stream)
        except Exception as e:  # noqa: BLE001 — cold start beats dying
            flight.record("trainer.resume_failed", error=type(e).__name__)

    handover_done = set()

    def beat(tr):
        """Per-step coordination: renew leases, take over what expired,
        and adopt the dead owner's published cursor for gained ground."""
        gained = coord.poll()
        if not gained:
            return
        frag = coord.partition_cursor(
            peer_dirs + [args.ckpt_dir], gained)
        if frag["files"]:
            stream.seek(frag, merge=True)
        for d in peer_dirs:
            if d in handover_done:
                continue
            _v, extra = checkpoint.load_extra(d)
            cur = (extra or {}).get("cursor") or {}
            try:
                with open(os.path.join(d, _PROGRESS)) as f:
                    ledger = json.load(f)
            except (OSError, ValueError):
                continue
            if any(coord.partition_of(n) in gained
                   for n in cur.get("files", {})):
                # the dead host had read past its published cursor; the
                # takeover re-reads those rows — count them as replay
                tr.replayed_rows += max(
                    0, int(ledger.get("rows", 0))
                    - int(cur.get("rows", 0)))
                handover_done.add(d)

    if coord is not None:
        last_beat = [0.0]
        beat_every = max(0.05, args.lease_ttl / 4.0)

        def _idle_beat():
            now = time.monotonic()
            if now - last_beat[0] >= beat_every:
                last_beat[0] = now
                beat(trainer)

        idle_hooks["beat"] = _idle_beat

    print(TRAINER_READY_PREFIX + json.dumps(
        {"pid": os.getpid(), "serve_dir": trainer.serve_dir,
         "host": host, "resumed_version": trainer.resumed_version,
         "replayed_rows": trainer.replayed_rows}), flush=True)
    t0 = time.monotonic()
    steps = trainer.run(stream, max_steps=args.steps,
                        on_step=beat if coord is not None else None)
    owned_at_exit = sorted(coord.owned) if coord else None
    if trainer.preempted.is_set():
        trainer.flush(grace_s=args.grace_s)
    elif coord is not None:
        coord.release_all()
    trainer.close()
    flight.maybe_dump(reason="trainer-exit")
    print(json.dumps({
        "steps": steps, "publishes": trainer.publishes,
        "publish_failures": trainer.publish_failures,
        "eval_loss": trainer.last_eval_loss,
        "rows_per_sec": stream.rows_per_sec(),
        "rows_total": stream.rows_total,
        "host": host, "preempted": trainer.preempted.is_set(),
        "resumed_version": trainer.resumed_version,
        "replayed_rows": trainer.replayed_rows,
        "partitions_owned": owned_at_exit,
        "reassigned": coord.reassigned if coord else 0,
        "elapsed_s": round(time.monotonic() - t0, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
