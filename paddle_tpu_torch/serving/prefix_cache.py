"""Prefix-KV cache for the continuous-batching decode tier (the port's copy
of ``paddle_tpu/serving/prefix_cache.py``).

Millions of requests share system prompts and few-shot prefixes, yet a
prefix-blind scheduler re-prefills every prompt from token zero. This
module keeps a **hash-trie over token-id prefixes** mapping to the KV
rows the slot table already computed for them: admission walks the trie
for the longest cached prefix and CLONES those rows into the new slot's
cache (one device-side copy) instead of re-ingesting the prefix token
by token — TTFT for a request with a P-token cached prefix drops by P
step dispatches.

Design points, in the order they matter for correctness:

  * **Clone, never alias.** A hit copies the stored rows into the slot's
    own cache rows; live slots never reference entry storage after
    admission, so LRU eviction can NEVER corrupt an in-flight request
    (``tests/test_torch_decode_serving.py`` pins this with an
    evict-under-the-slot test).
  * **Ref-counting against admissions.** ``lookup`` pins the entry
    (``refs += 1``) and the batcher releases it after the rows are
    cloned at admission; a pinned entry is skipped by eviction, so the
    bytes accounting can never free storage a pending admission is
    about to read.
  * **LRU over bytes AND entries.** ``max_bytes`` bounds device/host
    memory, ``max_entries`` bounds trie size; either limit evicts the
    least-recently-used unpinned entry (evictions are observable:
    ``ServingMetrics.prefix_evictions``).
  * **Match is capped at len(prompt)-1.** The step program needs to FEED
    the last prompt token to produce first-generation logits, so a full
    prompt match still leaves one token to ingest — the scheduler, not
    this module, enforces sampling correctness, but ``lookup(limit=...)``
    is how it asks.

The trie stores per-entry ``rows``: a dict of cache-feed name ->
``[prefix_len, *tail]`` tensor, a clone the batcher made on the device its
slot table lives on (any object with ``nbytes`` and row slicing serves);
an entry's ``nbytes`` is its tensors' own."""

import threading
from collections import OrderedDict

__all__ = ["PrefixCache", "PrefixEntry", "PrefixMatch"]


class PrefixEntry:
    """One cached prefix: the token key, the per-feed KV rows, and the
    ref-count admissions hold while cloning."""

    __slots__ = ("key", "rows", "nbytes", "refs")

    def __init__(self, key, rows):
        self.key = key
        self.rows = rows
        self.nbytes = int(sum(getattr(a, "nbytes", 0)
                              for a in rows.values()))
        self.refs = 0

    def __len__(self):
        return len(self.key)

    def __repr__(self):
        return ("PrefixEntry(%d toks, %d B, refs=%d)"
                % (len(self.key), self.nbytes, self.refs))


class PrefixMatch:
    """One lookup hit: the pinned donor ``entry`` plus how many of its
    LEADING rows (``length``) match the queried prompt. The donor may be
    deeper than the match — causal attention makes an entry's first m
    rows exactly the KV state of its first m tokens, so any entry below
    the deepest matched trie node can donate its leading rows. Release
    the entry (``PrefixCache.release``) after cloning ``rows[:length]``."""

    __slots__ = ("entry", "length")

    def __init__(self, entry, length):
        self.entry = entry
        self.length = int(length)

    def __repr__(self):
        return "PrefixMatch(%d of %d toks)" % (self.length,
                                               len(self.entry.key))


class _Node:
    __slots__ = ("children", "entry")

    def __init__(self):
        self.children = {}
        self.entry = None


class PrefixCache:
    """Hash-trie prefix -> KV-rows cache with pinned-aware LRU eviction.

    Thread-safe: ``submit`` (caller threads) looks prefixes up while the
    scheduler loop thread harvests and clones, so every public method
    serializes on an internal lock. Entries are immutable after insert —
    the lock guards the trie/LRU bookkeeping, never row data. A single
    instance can safely back several batchers (the engine shares one per
    fleet)."""

    def __init__(self, max_bytes=64 << 20, max_entries=512, metrics=None):
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self.metrics = metrics
        self._root = _Node()
        self._lru = OrderedDict()   # key tuple -> PrefixEntry
        self._lock = threading.RLock()
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self):
        with self._lock:
            return len(self._lru)

    def __contains__(self, tokens):
        with self._lock:
            return tuple(int(t) for t in tokens) in self._lru

    # -- read path ----------------------------------------------------------
    def lookup(self, tokens, limit=None):
        """Longest cached prefix of ``tokens`` (at most ``limit`` tokens
        long). Returns a :class:`PrefixMatch` whose entry is PINNED
        (caller MUST :meth:`release` after cloning) or ``None``. The
        donor entry may be DEEPER than the match: the walk descends the
        trie as far as ``tokens`` agree, then any entry in the subtree
        below the deepest matched node donates its first ``depth`` rows
        (valid because causal attention makes an entry's leading rows
        depend only on its leading tokens). Bumps LRU recency of the
        donor and the hit/miss counters."""
        limit = len(tokens) if limit is None else min(int(limit),
                                                      len(tokens))
        with self._lock:
            node = self._root
            depth = 0
            for i in range(limit):
                nxt = node.children.get(int(tokens[i]))
                if nxt is None:
                    break
                node = nxt
                depth = i + 1
            donor = self._find_entry(node) if depth else None
            if donor is None:
                self.misses += 1
                return None
            donor.refs += 1
            self._lru.move_to_end(donor.key)
            self.hits += 1
            if self.metrics is not None:
                self.metrics.observe_prefix_hit(depth)
            return PrefixMatch(donor, depth)

    @staticmethod
    def _find_entry(node):
        """Any entry at or below ``node`` (eviction prunes entry-less
        branches bottom-up, so every surviving node leads to one)."""
        while node.entry is None:
            if not node.children:
                return None  # pruning invariant broken — treat as miss
            node = next(iter(node.children.values()))
        return node.entry

    def release(self, entry):
        """Drop an admission's pin (rows are cloned; entry is evictable
        again)."""
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    # -- write path ---------------------------------------------------------
    def insert(self, tokens, rows):
        """Cache ``rows`` (feed name -> [len(tokens), *tail]) under the
        token prefix. No-op if the exact prefix is already cached (first
        writer wins — re-harvesting identical rows buys nothing).
        Evicts LRU unpinned entries until both budgets hold; an entry
        larger than ``max_bytes`` on its own is refused. Returns the
        entry or ``None``."""
        key = tuple(int(t) for t in tokens)
        entry = PrefixEntry(key, dict(rows))
        if not key or entry.nbytes > self.max_bytes:
            return None
        with self._lock:
            if key in self._lru:
                return None
            self.nbytes += entry.nbytes
            node = self._root
            for t in key:
                node = node.children.setdefault(t, _Node())
            node.entry = entry
            self._lru[key] = entry
            self._evict_to_budget()
        return entry

    def _evict_to_budget(self):
        while (self.nbytes > self.max_bytes
               or len(self._lru) > self.max_entries):
            victim = None
            for key, entry in self._lru.items():  # LRU order, oldest first
                if entry.refs == 0:
                    victim = key
                    break
            if victim is None:
                return  # everything left is pinned by a pending admission
            self._evict(victim)

    def _evict(self, key):
        entry = self._lru.pop(key)
        self.nbytes -= entry.nbytes
        self.evictions += 1
        # unlink from the trie, pruning now-empty nodes bottom-up
        path = [self._root]
        for t in key:
            path.append(path[-1].children[t])
        path[-1].entry = None
        for i in range(len(key), 0, -1):
            node = path[i]
            if node.entry is None and not node.children:
                del path[i - 1].children[key[i - 1]]
            else:
                break
        if self.metrics is not None:
            self.metrics.observe_prefix_eviction()
        return entry

    # -- introspection ------------------------------------------------------
    def stats(self):
        with self._lock:
            return {"entries": len(self._lru), "bytes": self.nbytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
