"""Partition coordinator: TTL-leased ownership of stream partitions.
(The port's copy of ``paddle_tpu/streaming/coordinator.py``.)

Reference: pslib/Downpour splits the click-log firehose across trainer
hosts by file, with the fleet controller reassigning a dead worker's
shard; ``checkpoint_notify`` is the cross-host coordination primitive
(SURVEY §C). Here the shared medium IS the stream directory: every
recordio file hashes to one of ``num_partitions`` partitions, and a
host may only tail files in partitions it holds a live *lease* on.

Leases are JSON files under ``<data_dir>/.leases/partition-<k>.lease``
with a wall-clock expiry. The protocol is deliberately boring:

* **acquire** — atomic tmp+``os.replace`` of a claim carrying a bumped
  ``epoch``, then read-back verify (last writer wins; the loser sees a
  foreign owner and walks away). No fcntl, works on any shared filesystem.
* **renew** (fault site ``lease.renew``) — heartbeat rewrite pushing
  ``expires`` forward. A renewal first re-reads the lease: if the disk
  copy is not ours-at-our-epoch, we LOST the lease (expired + reclaimed
  while we stalled) and must stop reading that partition — ownership is
  dropped loudly (``lease.lost`` flight event), never assumed.
* **expiry / torn leases** — a lease past ``expires``, or one that does
  not parse (a torn write from a dying host), is *reclaimed, not
  trusted*: any survivor may claim it with ``epoch + 1``. Reclaiming a
  foreign lease is counted (``reassigned``) and flight-recorded
  (``lease.reassign``) — host loss must be reconstructible from the dump.

``target_share`` bounds greed during normal operation (N healthy hosts
split the partitions evenly) but never blocks takeover: expired and torn
leases are claimed past the share, because a dead host's partitions have
no one else to go to.

The wall clock (``time.time``) is the coordination clock — leases cross
process boundaries, so a monotonic per-process clock cannot order them.
Tests inject a shared fake ``clock`` into every coordinator instead.
"""

import fnmatch
import json
import os
import time
import zlib

from ..obs import flight
from ..reliability import faults
from .stream import REGISTRY

__all__ = ["PartitionCoordinator", "partition_of"]


def partition_of(name, num_partitions):
    """Stable file->partition hash (basename only, so every host agrees
    regardless of mount point)."""
    base = os.path.basename(name)
    return zlib.crc32(base.encode("utf-8")) % int(num_partitions)


class PartitionCoordinator:
    """Lease-based ownership of stream-directory partitions for ONE host.

    Drive it with ``poll()`` (renew owned leases, then claim whatever is
    claimable) on the trainer's cadence; ``source()`` returns the file
    lister a :class:`~.stream.RecordStream` consumes, filtered live to
    the partitions currently owned — losing a lease stops the tail mid-
    stream, gaining one starts it."""

    def __init__(self, data_dir, host, num_partitions, ttl_s=5.0,
                 target_share=None, clock=None, registry=None,
                 lease_dir=None):
        self.data_dir = data_dir
        self.host = str(host)
        self.num_partitions = int(num_partitions)
        self.ttl_s = float(ttl_s)
        self.target_share = target_share
        self._clock = clock or time.time
        self.lease_dir = lease_dir or os.path.join(data_dir, ".leases")
        self.owned = set()
        self.epochs = {}          # partition -> epoch we hold it at
        self.reassigned = 0       # foreign expired/torn leases taken over
        self.lost = 0             # leases we held that got reclaimed
        self.renew_failures = 0
        reg = registry if registry is not None else REGISTRY
        self.registry = reg
        reg.gauge("paddle_tpu_stream_partitions_owned",
                  "stream partitions this host holds a live lease on",
                  fn=lambda: len(self.owned))

    # -- lease file plumbing -------------------------------------------------
    def _lease_path(self, k):
        return os.path.join(self.lease_dir, "partition-%d.lease" % k)

    def _read_lease(self, k):
        """(lease_dict_or_None, exists). A lease that exists but does not
        parse is TORN — reported as ``(None, True)`` and treated as
        reclaimable, never trusted."""
        try:
            with open(self._lease_path(k)) as f:
                raw = f.read()
        except OSError:
            return None, False
        try:
            lease = json.loads(raw)
            if not isinstance(lease, dict) or "owner" not in lease:
                return None, True
            return lease, True
        except ValueError:
            return None, True

    def _write_lease(self, k, epoch, torn=False):
        os.makedirs(self.lease_dir, exist_ok=True)
        now = self._clock()
        body = json.dumps({"partition": k, "owner": self.host,
                           "epoch": int(epoch), "renewed": now,
                           "expires": now + self.ttl_s})
        if torn:  # injected: model a host dying mid-rename
            body = body[:max(1, len(body) // 2)]
        tmp = self._lease_path(k) + (".claim-%s" % self.host)
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, self._lease_path(k))

    def _is_ours(self, k):
        lease, _ = self._read_lease(k)
        return (lease is not None and lease.get("owner") == self.host
                and lease.get("epoch") == self.epochs.get(k))

    # -- protocol ------------------------------------------------------------
    def acquire(self, k):
        """Claim partition ``k`` if its lease is absent, torn, expired, or
        a previous incarnation of *this* host's. Returns True on win."""
        if k in self.owned:
            return True
        lease, exists = self._read_lease(k)
        now = self._clock()
        if lease is not None and lease.get("owner") != self.host \
                and float(lease.get("expires", 0)) > now:
            return False  # live foreign lease: respect it
        foreign = (exists and (lease is None  # torn = foreign wreckage
                               or lease.get("owner") != self.host))
        epoch = (int(lease.get("epoch", 0)) + 1) if lease else 1
        self._write_lease(k, epoch)
        # read-back verify: last writer wins, the loser walks away
        cur, _ = self._read_lease(k)
        if not (cur is not None and cur.get("owner") == self.host
                and cur.get("epoch") == epoch):
            return False
        self.owned.add(k)
        self.epochs[k] = epoch
        if foreign:
            self.reassigned += 1
            age = (now - float(lease.get("expires", now))) if lease else None
            flight.record("lease.reassign", partition=k, host=self.host,
                          epoch=epoch, expired_for_s=age,
                          torn=lease is None)
        else:
            flight.record("lease.acquire", partition=k, host=self.host,
                          epoch=epoch)
        return True

    def renew(self):
        """Heartbeat every owned lease. Fault site ``lease.renew`` trips
        once per lease renewal: ``error`` = a missed heartbeat (the lease
        ages toward expiry — the takeover drill), ``corrupt`` = a torn
        renewal write (survivors must reclaim, not trust it)."""
        for k in sorted(self.owned):
            try:
                mode = faults.trip("lease.renew")
            except faults.InjectedFault:
                self.renew_failures += 1
                continue  # missed heartbeat; expiry clock keeps running
            if not self._is_ours(k):
                # expired + reclaimed while we stalled: ownership is gone,
                # stop reading the partition NOW (split-brain guard)
                self.owned.discard(k)
                self.epochs.pop(k, None)
                self.lost += 1
                flight.record("lease.lost", partition=k, host=self.host)
                continue
            self._write_lease(k, self.epochs[k], torn=(mode == "corrupt"))

    def poll(self):
        """One coordination beat: renew what we hold, claim what is
        claimable (bounded by ``target_share`` for healthy leases, never
        for expired/torn takeovers). Returns newly gained partitions."""
        self.renew()
        gained = set()
        for k in range(self.num_partitions):
            if k in self.owned:
                continue
            lease, exists = self._read_lease(k)
            now = self._clock()
            live_foreign = (lease is not None
                            and lease.get("owner") != self.host
                            and float(lease.get("expires", 0)) > now)
            if live_foreign:
                continue
            takeover = exists and (lease is None
                                   or lease.get("owner") != self.host)
            if (not takeover and self.target_share is not None
                    and len(self.owned) >= int(self.target_share)):
                continue  # healthy fleet: leave unclaimed ground to peers
            if self.acquire(k):
                gained.add(k)
        return gained

    def release(self, k):
        """Hand a partition back (preemption-aware shutdown): the lease
        file is removed so a peer claims it without waiting out the TTL."""
        if k not in self.owned:
            return
        if self._is_ours(k):
            try:
                os.unlink(self._lease_path(k))
            except OSError:
                pass
        self.owned.discard(k)
        self.epochs.pop(k, None)
        flight.record("lease.release", partition=k, host=self.host)

    def release_all(self):
        for k in sorted(self.owned):
            self.release(k)

    # -- stream integration --------------------------------------------------
    def partition_of(self, name):
        return partition_of(name, self.num_partitions)

    def source(self, pattern="*.recordio"):
        """A live file lister for :class:`~.stream.RecordStream`: only
        files in currently-owned partitions. Re-evaluated every poll, so
        lease gain/loss changes what the stream tails mid-run."""
        def _list():
            try:
                names = os.listdir(self.data_dir)
            except OSError:
                return []
            return [os.path.join(self.data_dir, n) for n in names
                    if fnmatch.fnmatch(n, pattern)
                    and self.partition_of(n) in self.owned]
        return _list

    def partition_cursor(self, ckpt_dirs, partitions):
        """Cross-host cursor handover: scan each publish dir's newest
        intact version for cursor entries whose file belongs to
        ``partitions``, keeping the furthest offset per file. Returns a
        cursor fragment for ``RecordStream.seek(..., merge=True)`` plus
        the max ``rows`` count seen (the dead host's accounted progress,
        for replay bookkeeping)."""
        from .. import checkpoint

        want = set(partitions)
        files, rows = {}, 0
        for d in ckpt_dirs:
            _v, extra = checkpoint.load_extra(d)
            cur = (extra or {}).get("cursor")
            if not cur:
                continue
            for name, ent in cur.get("files", {}).items():
                if self.partition_of(name) not in want:
                    continue
                best = files.get(name)
                if best is None or int(ent.get("offset", 0)) \
                        > int(best.get("offset", 0)):
                    files[name] = dict(ent)
            rows = max(rows, int(cur.get("rows", 0)))
        return {"files": files, "rows": rows}
