"""Exact-match result cache for the serving hot path (the port's copy of
``knn_tpu/serve/cache.py``).

Real multi-user traffic is skewed: the same query rows arrive again and
again (hot entities, retried requests, dashboard refreshes). Retrieval is
deterministic, so an answer computed once is correct for every identical
query until the index changes — and the serving stack already stamps
every response with exactly the two tags that define "the index changed":
``index_version`` (hot reload / compaction swap) and ``mutation_seq``
(the delta tier's sequence point). An LRU keyed on

    (index_version, mutation_seq, nprobe, k, metric, canonical row hash)

is therefore **correct by construction** between version/sequence points:
a key can only hit while both tags match, a swap clears the cache
outright (``MicroBatcher.swap_model``), and any acknowledged mutation
moves ``mutation_seq`` so every stale key silently becomes unreachable
and ages out of the LRU. ``nprobe`` rides the key so an approximate
(ivf-rung) answer is only replayed at the probe-policy operating point
that produced it — a cache hit is bit-identical to what a fresh dispatch
at the same tags would return (pinned by tests/test_bucketing.py).

What is cached is the RETRIEVAL ``(dists [q,k], indices [q,k])`` plus the
answering rung, not the per-kind payload: predict and kneighbors share
one retrieval (predict = kneighbors + a host vote), so one entry serves
both kinds. Capacity is measured in cached query ROWS
(``--result-cache-rows``; an entry of q rows charges q), because memory
scales with rows x k, not entries.

When NOT to enable it (docs/SERVING.md): high-entropy query streams
(embeddings of novel inputs, raw sensor rows) never repeat a row, so
every lookup is a paid miss — the hash of the feature bytes — with zero
hits. The flag defaults to 0, which constructs nothing.

Thread model: lookups and inserts run on the single batcher worker;
``clear`` (hot reload) and ``stats`` (healthz/debug scrapes) may run on
other threads — all state sits under one lock, and the hot-path cost is
one hash + one OrderedDict move per request.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from knn_tpu_torch import obs


def query_digest(features) -> bytes:
    """Canonical digest of a query block: the batcher admits features as
    C-contiguous float32 (``MicroBatcher.submit``), so the raw bytes ARE
    the canonical form — equal arrays always collide, bit-different
    floats (including -0.0 vs 0.0 and distinct NaN payloads) never do,
    which is exactly the "identical query" contract exact-match needs."""
    h = hashlib.blake2b(digest_size=16)
    h.update(features.tobytes())
    return h.digest()


class ResultCache:
    """Bounded LRU of retrieval answers, capacity in query rows."""

    def __init__(self, max_rows: int):
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.max_rows = int(max_rows)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._rows = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- the hot path (batcher worker) ------------------------------------

    def key(self, version, seq, nprobe, features) -> tuple:
        return (version, seq, nprobe, features.shape,
                query_digest(features))

    def get(self, key: tuple) -> "Optional[Tuple]":
        """``(dists, idx, rung)`` on a hit (arrays are the cached copies —
        callers slice/read, never mutate), None on a miss. Counts both."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if ent is not None:
            obs.counter_add(
                "knn_cache_hits_total",
                help="serving requests answered from the exact-match "
                     "result cache (no device dispatch)",
            )
            return ent
        obs.counter_add(
            "knn_cache_misses_total",
            help="result-cache lookups that fell through to a dispatch",
        )
        return None

    def put(self, key: tuple, dists, idx, rung: str) -> None:
        """Insert one answered request's retrieval slice. Oversized
        entries (rows > max_rows) are not cached at all — they would
        evict the whole cache to store one request."""
        rows = int(dists.shape[0])
        if rows > self.max_rows:
            return
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._rows -= old[0].shape[0]
            self._entries[key] = (dists, idx, rung)
            self._rows += rows
            while self._rows > self.max_rows and self._entries:
                _, (d, _i, _r) = self._entries.popitem(last=False)
                self._rows -= d.shape[0]
                evicted += 1
            self.evictions += evicted
        if evicted:
            obs.counter_add(
                "knn_cache_evictions_total", evicted,
                help="result-cache entries evicted by the row-capacity LRU",
            )

    # -- lifecycle / reporting --------------------------------------------

    def clear(self) -> int:
        """Drop everything — the swap/rebase invalidation path (a new
        index version makes every cached answer unreachable anyway; the
        clear returns the memory instead of waiting for LRU aging).
        Returns how many entries were dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._rows = 0
        return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "rows": self._rows,
                "max_rows": self.max_rows,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
