"""The mutable engine: write-ahead log + live state + instruments (the port
of ``knn_tpu/mutable/engine.py``).

One :class:`MutableEngine` owns everything a mutable-serving process
mutates: the delta arrays, the tombstone sets, the write-ahead epoch log
(``serve/artifact.py`` persistence primitives), and the stable-id
machinery compaction rebases through. Threading contract:

- **mutations are applied ONLY by the batcher worker thread**
  (``MicroBatcher.submit_mutation`` enqueues; the worker drains the
  mutation queue between read dispatches — mutations serialize against
  dispatches for free, and readers never block on a write because read
  ADMISSION never touches the engine);
- **readers** take :meth:`snapshot` — an immutable
  :class:`~knn_tpu_torch.mutable.state.MutableView` of shared append-frozen
  arrays — once per dispatch, under the batcher's own snapshot lock;
- **compaction** (its own thread, ``mutable/compact.py``) calls
  :meth:`seal` to freeze a fold point (rotating the WAL to a fresh epoch,
  so mid-compaction writes land in the new epoch without loss) and
  :meth:`rebase` inside the batcher's model-swap critical section, so a
  dispatch can never pair the new base with the old delta.

Durability: every mutation is appended + flushed to the epoch log BEFORE
it is applied or acknowledged; boot replays every record newer than the
base generation's ``folded_seq`` (a torn final line is the one in-flight
never-acked append and is dropped, with a warning, and the log repaired).

The epoch records are the JAX package's bytes for the same mutations
(``serve/artifact.py``): the floats of a row are written through Python
``float`` as there, so a WAL written by either package replays in the
other.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Optional

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.mutable.state import (
    MutableView,
    MutationConflict,
    ReplicationGap,
    WALDivergence,
    check_stable_ascending,
    stable_to_position,
    validate_insert,
)
from knn_tpu_torch.resilience.errors import DataError, OverloadError
from knn_tpu_torch.serve import artifact

#: Freshness histogram buckets (ms): write-ack to visible-in-snapshots.
FRESHNESS_BUCKETS_MS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                        5000)

#: Initial delta allocation; grows by amortized doubling up to the cap.
_INITIAL_SLOTS = 64

#: Content digests kept per applied WAL record for the replication
#: overlap check (the fleet's, ROADMAP A12): enough to cover any realistic
#: shipping window; older seqs fall back to skip-without-check (they are
#: either folded into a generation or far behind every live cursor).
_DIGEST_KEEP = 8192


def wal_record_digest(rec: dict) -> str:
    """Canonical content digest of one WAL record — what the WAL fan-out
    protocol uses to prove that two logs agree about a sequence number
    (``POST /admin/wal-append`` overlap checks). Excludes any ``digest``
    field so a record round-trips."""
    body = {k: v for k, v in rec.items() if k != "digest"}
    payload = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def truncate_wal(root, cap_seq: int) -> int:
    """Drop every epoch-log record with ``seq > cap_seq`` (atomic rewrite
    per file, empty epochs removed) and return how many records were
    dropped. The rejoin primitive: a rebooted ex-primary's WAL tail past
    the promoted follower's takeover point is UNACKNOWLEDGED by
    construction (a write is only acked once a follower holds it), and
    under the new primary those seqs name different mutations — replaying
    the stale tail before following would be silent divergence."""
    dropped = 0
    for _n, path in artifact.list_epochs(root):
        records, _torn = artifact.read_epoch_records(path,
                                                     tolerate_torn=True)
        keep = [r for r in records if int(r.get("seq", 0)) <= cap_seq]
        if len(keep) == len(records):
            continue
        dropped += len(records) - len(keep)
        if keep:
            artifact.repair_epoch(path, keep)
        else:
            path.unlink()
    return dropped


#: ``device_tail="auto"`` activates the delta buffer on the model's device
#: (``mutable/device_tail.py``) once this many delta slots are in use —
#: below it the host merge's numpy scan beats a device round trip (JAX's
#: threshold, kept). "on" activates at the first insert, "off" never
#: constructs it. KNN_TPU_DEVICE_TAIL overrides "auto".
DEVICE_TAIL_MIN_ROWS = 256


class _Freshness:
    """Streaming write-to-visible stats + a bounded ring for quantiles
    (the /healthz ``mutable.freshness`` block; the exact distribution
    lives in the ``knn_mutable_freshness_ms`` histogram)."""

    __slots__ = ("count", "sum_ms", "max_ms", "_ring", "_pos")

    def __init__(self, ring: int = 512):
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0
        self._ring = np.zeros(ring, np.float64)
        self._pos = 0

    def note(self, ms: float) -> None:
        self.count += 1
        self.sum_ms += ms
        self.max_ms = max(self.max_ms, ms)
        self._ring[self._pos % self._ring.shape[0]] = ms
        self._pos += 1

    def export(self) -> dict:
        filled = min(self._pos, self._ring.shape[0])
        doc = {
            "count": self.count,
            "mean_ms": (round(self.sum_ms / self.count, 3)
                        if self.count else None),
            "max_ms": round(self.max_ms, 3) if self.count else None,
            "p99_ms": None,
        }
        if filled:
            doc["p99_ms"] = round(
                float(np.percentile(self._ring[:filled], 99)), 3)
        return doc


class MutableEngine:
    """See the module docstring. ``root`` is the artifact directory the
    server booted from (epoch logs and compacted generations live inside
    it); ``model`` is the ALREADY-LOADED base model for the current
    generation (``artifact.resolve_mutable_base`` names the directory).
    Construction replays any existing epoch records newer than the base's
    fold point, then opens a fresh epoch for this process's writes."""

    def __init__(self, model, root, *, delta_cap: int = 4096,
                 current: Optional[dict] = None, base_dir=None,
                 version: Optional[str] = None,
                 device_tail: str = "auto"):
        if delta_cap < 1:
            raise ValueError(f"delta_cap must be >= 1, got {delta_cap}")
        if device_tail == "auto":
            import os

            env = os.environ.get("KNN_TPU_DEVICE_TAIL", "auto")
            device_tail = env if env in ("on", "off") else "auto"
        if device_tail not in ("auto", "on", "off"):
            raise ValueError(
                f"device_tail must be 'auto', 'on', or 'off', got "
                f"{device_tail!r}")
        from pathlib import Path

        self.root = Path(root)
        self.delta_cap = int(delta_cap)
        self._model = model
        self._version = version
        self._k = model.k
        self._metric = model.metric
        train = model.train_
        self._base_n = train.num_instances
        self._d = train.num_features
        self._lock = threading.RLock()
        self._fresh = _Freshness()
        self._last_compaction: Optional[dict] = None
        self._on_pressure = None  # Compactor.kick, wired after build
        # seq -> content digest for the replication overlap check
        # (wal_record_digest); bounded, pruned oldest-first.
        self._digests: "dict[int, str]" = {}

        base = Path(base_dir) if base_dir is not None else self.root
        block, stable = artifact.read_mutable_block(base)
        if stable is not None:
            if stable.shape[0] != self._base_n:
                raise DataError(
                    f"{base}: mutable_stable_ids spans {stable.shape[0]} "
                    f"rows but the base has {self._base_n}"
                )
            self._base_stable = check_stable_ascending(stable, str(base))
        else:
            self._base_stable = np.arange(self._base_n, dtype=np.int64)
        folded = 0
        self._generation = 0
        if current is not None:
            self._generation = int(current.get("generation", 0))
            folded = int(current.get("folded_seq", 0))
        if block is not None:
            folded = max(folded, int(block.get("folded_seq", 0)))
        self._folded_seq = folded
        self._seq = folded
        self._next_stable = int(self._base_stable[-1]) + 1 if self._base_n \
            else 0
        if block is not None:
            self._next_stable = max(self._next_stable,
                                    int(block.get("next_stable", 0)))
        if current is not None:
            self._next_stable = max(self._next_stable,
                                    int(current.get("next_stable", 0)))

        # Live delta state (slots below _count are append-frozen).
        cap = min(_INITIAL_SLOTS, self.delta_cap)
        self._features = np.zeros((cap, self._d), np.float32)
        self._values = np.zeros(cap, np.float32)
        self._stable = np.zeros(cap, np.int64)
        self._count = 0
        self._tomb_stable: frozenset = frozenset()
        self._tomb_pos: frozenset = frozenset()
        self._tomb_base = np.empty(0, np.int64)
        self._tomb_delta = np.empty(0, np.int64)
        # Device-resident delta tail (mutable/device_tail.py): built
        # LAZILY at the activation threshold so a mutable-on boot with
        # no (or few) mutations constructs zero device machinery and the
        # empty-view byte-identity pin holds trivially.
        self._device_tail_mode = device_tail
        self._dtail = None
        self._tail_device = getattr(model, "device", "cuda")

        self._replay()
        self._sync_device_tail()
        epochs = artifact.list_epochs(self.root)
        self._epoch = (epochs[-1][0] + 1) if epochs else 1
        self._log = artifact.EpochLog(
            artifact.epoch_path(self.root, self._epoch))
        self._closed = False

    # -- boot replay -------------------------------------------------------

    def _replay(self) -> None:
        epochs = artifact.list_epochs(self.root)
        last = epochs[-1][0] if epochs else None
        for n, path in epochs:
            records, torn = artifact.read_epoch_records(
                path, tolerate_torn=(n == last))
            for rec in records:
                seq = int(rec["seq"])
                if seq <= self._folded_seq:
                    continue
                if seq <= self._seq:
                    raise DataError(
                        f"{path}: epoch log is not seq-monotonic "
                        f"({seq} after {self._seq}); the write-ahead log "
                        f"is corrupt"
                    )
                if seq != self._seq + 1:
                    # A HOLE in the acknowledged history: every record was
                    # acked durable in seq order, so a missing seq means
                    # lost writes — replaying past it would silently serve
                    # a history that never happened (the primary-failover
                    # catch-up path depends on this being typed, never a
                    # skip).
                    raise DataError(
                        f"{path}: epoch stream has a seq gap (expected "
                        f"{self._seq + 1}, found {seq}); the write-ahead "
                        f"log lost acknowledged records"
                    )
                self._replay_one(rec, path)
            if torn:
                print(f"warning: {path}: dropped a torn final record "
                      f"(crash mid-append; that mutation was never "
                      f"acknowledged)", flush=True)
                # Repair NOW: once this boot opens a fresh epoch, this
                # file is no longer last and loses its torn-tolerance —
                # an unrepaired fragment would make the next boot refuse
                # an artifact this boot accepted.
                artifact.repair_epoch(path, records)

    def _replay_one(self, rec: dict, path) -> None:
        op = rec.get("op")
        try:
            if op == "insert":
                rows = np.asarray(rec["rows"], np.float32)
                values = np.asarray(rec["values"], np.float32)
                if rows.ndim != 2 or rows.shape[1] != self._d:
                    raise ValueError(f"bad row shape {rows.shape}")
                # Replay NEVER enforces the cap: every record was
                # acknowledged durable — a smaller --delta-cap on reboot
                # must not lose writes (compaction will fold them).
                self._append_rows(rows, values, int(rec["sid0"]),
                                  enforce_cap=False)
            elif op == "delete":
                sids = [int(s) for s in rec["sids"]]
                self._tombstone_stables(sids, where=str(path))
            else:
                raise ValueError(f"unknown op {op!r}")
        except (KeyError, ValueError, TypeError) as e:
            raise DataError(
                f"{path}: unreplayable epoch record (seq "
                f"{rec.get('seq')}): {e}") from e
        self._seq = int(rec["seq"])
        self._note_digest(self._seq, rec)
        self._next_stable = max(self._next_stable,
                                int(self._stable[:self._count].max(
                                    initial=-1)) + 1)

    def _note_digest(self, seq: int, rec: dict) -> None:
        """Record ``seq``'s content digest for the replication overlap
        check (caller holds the lock or is __init__); bounded by
        ``_DIGEST_KEEP`` — seqs that age out fall back to
        skip-without-check on overlap."""
        self._digests[seq] = wal_record_digest(rec)
        while len(self._digests) > _DIGEST_KEEP:
            # Seqs insert strictly ascending, so dict order IS seq
            # order: the first key is the oldest (O(1), not a key scan).
            self._digests.pop(next(iter(self._digests)))

    # -- shared state primitives (caller holds self._lock or is __init__) --

    def _grow_to(self, want: int) -> None:
        cap = self._features.shape[0]
        if want <= cap:
            return
        new_cap = cap
        while new_cap < want:
            new_cap *= 2
        new_cap = min(new_cap, max(self.delta_cap, want))
        # Amortized doubling with fresh allocations: snapshots holding the
        # OLD arrays keep reading their frozen prefix untouched.
        for name in ("_features", "_values", "_stable"):
            old = getattr(self, name)
            shape = (new_cap,) + old.shape[1:]
            fresh = np.zeros(shape, old.dtype)
            fresh[:self._count] = old[:self._count]
            setattr(self, name, fresh)

    def _append_rows(self, rows: np.ndarray, values: np.ndarray,
                     sid0: int, enforce_cap: bool = True) -> "list[int]":
        m = rows.shape[0]
        if enforce_cap and self._count + m > self.delta_cap:
            raise OverloadError(
                f"delta tier full ({self._count}/{self.delta_cap} slots); "
                f"compaction is behind — retry after backoff or trigger "
                f"/admin/compact"
            )
        self._grow_to(self._count + m)
        s = self._count
        self._features[s:s + m] = rows
        self._values[s:s + m] = values
        self._stable[s:s + m] = np.arange(sid0, sid0 + m, dtype=np.int64)
        self._count = s + m
        self._sync_device_tail(appended=(s, self._count))
        return list(range(self._base_n + s, self._base_n + s + m))

    def _sync_device_tail(self, appended=None) -> None:
        """Keep the device-resident delta buffer in lockstep with the
        host arrays (caller holds the lock). Lazy activation at the mode
        threshold; after that, each append writes a new buffer and a host
        growth (capacity change) triggers a full rebuild inside
        :meth:`DeviceDeltaTail.append`."""
        mode = self._device_tail_mode
        if mode == "off":
            return
        if self._dtail is None:
            want = 1 if mode == "on" else DEVICE_TAIL_MIN_ROWS
            if self._count < want:
                return
            from knn_tpu_torch.mutable.device_tail import DeviceDeltaTail

            self._dtail = DeviceDeltaTail(self._tail_device)
            self._dtail.rebuild(self._features, self._count,
                                self._tomb_delta, self._base_n)
            return
        if appended is not None:
            self._dtail.append(self._features, appended[0], appended[1],
                               self._base_n)
        else:
            self._dtail.rebuild(self._features, self._count,
                                self._tomb_delta, self._base_n)

    def _rebuild_tomb_arrays(self) -> None:
        base, delta = [], []
        for p in self._tomb_pos:
            (base if p < self._base_n else delta).append(p)
        self._tomb_base = np.array(sorted(base), np.int64)
        self._tomb_delta = np.array(
            sorted(p - self._base_n for p in delta), np.int64)

    def _position_of_stable(self, sid: int) -> Optional[int]:
        pos = stable_to_position(self._base_stable, sid)
        if pos is not None:
            return pos
        live = self._stable[:self._count]
        hits = np.nonzero(live == sid)[0]
        if hits.size:
            return self._base_n + int(hits[0])
        return None

    def _validate_tombstones(self, sids: "list[int]",
                             where: str) -> "list[int]":
        """THE one copy of the delete-safety rules (duplicate/unknown/
        already-dead rows, the k-floor) — run by ``apply_delete`` BEFORE
        the WAL append and re-run by :meth:`_tombstone_stables` at apply
        and replay. Two drifting copies would be a WAL hazard: a rule
        relaxed at admission but not at apply acks a record that the
        post-append apply (or a boot replay) then refuses. Returns the
        positional ids."""
        positions = []
        fresh = set()
        for sid in sids:
            if sid in self._tomb_stable or sid in fresh:
                raise MutationConflict(
                    f"{where}: row (stable id {sid}) is already deleted")
            pos = self._position_of_stable(sid)
            if pos is None:
                raise MutationConflict(
                    f"{where}: no such row (stable id {sid})")
            positions.append(pos)
            fresh.add(sid)
        live_total = (self._base_n - int(self._tomb_base.shape[0])
                      + self._count - int(self._tomb_delta.shape[0]))
        if live_total - len(sids) < self._k:
            raise MutationConflict(
                f"{where}: deleting {len(sids)} row(s) would leave "
                f"{live_total - len(sids)} live rows, below k="
                f"{self._k} — the index must always answer full top-k"
            )
        return positions

    def _tombstone_stables(self, sids: "list[int]", where: str) -> "list[int]":
        positions = self._validate_tombstones(sids, where)
        self._tomb_stable = self._tomb_stable | set(sids)
        self._tomb_pos = self._tomb_pos | set(positions)
        self._rebuild_tomb_arrays()
        if self._dtail is not None:
            # Deletes are rare next to reads: a new full [cap] mask keeps
            # the device tail's tombstones exact.
            self._dtail.set_dead(self._tomb_delta)
        return positions

    # -- mutation application (batcher worker thread) ----------------------

    def apply_insert(self, rows, values, submitted_ns: int) -> dict:
        """Validate → WAL append (flushed) → apply → ack. Raises
        ``ValueError`` (400) for malformed payloads, ``OverloadError``
        (429) when the delta tier is full."""
        rows, values = validate_insert(self._model, rows, values)
        with self._lock:
            if self._closed:
                raise OverloadError("mutable engine is shut down")
            if self._count + rows.shape[0] > self.delta_cap:
                self._note_mutation("insert", "rejected")
                raise OverloadError(
                    f"delta tier full ({self._count}/{self.delta_cap} "
                    f"slots); compaction is behind — retry after backoff "
                    f"or trigger /admin/compact"
                )
            seq = self._seq + 1
            sid0 = self._next_stable
            rec = {
                "seq": seq, "op": "insert", "sid0": sid0,
                "rows": [[float(v) for v in r] for r in rows],
                "values": [float(v) for v in values],
            }
            self._log.append(rec)
            ids = self._append_rows(rows, values, sid0)
            self._seq = seq
            self._note_digest(seq, rec)
            self._next_stable = sid0 + rows.shape[0]
            epoch = self._epoch
            # The version is stamped HERE, under the lock the rebase
            # holds: the ack's positional ids and its version tag must
            # name the same generation, or a client could pair old-space
            # ids with the new tag and satisfy a delete precondition
            # against the wrong rows.
            version = self._version
            pressure = self.pressure()
        self._note_visible(submitted_ns)
        self._note_mutation("insert", "ok", rows.shape[0])
        self._maybe_kick(pressure)
        return {"op": "insert", "ids": ids, "rows": rows.shape[0],
                "seq": seq, "epoch": epoch, "index_version": version}

    def apply_delete(self, ids, submitted_ns: int,
                     expect_version: Optional[str] = None) -> dict:
        """Delete by positional id (the ids kneighbors responses carry,
        in the CURRENT generation's space). Unknown/already-deleted rows,
        k-floor violations, and a failed ``expect_version`` precondition
        raise :class:`MutationConflict` (409). The precondition is checked
        HERE, under the same lock :meth:`rebase` holds — checking it any
        earlier (e.g. at HTTP admission) races a compaction swap and a
        positional id from the old generation would silently name a
        different row in the new one."""
        try:
            ids = [int(i) for i in np.asarray(ids).ravel()]
        except (TypeError, ValueError) as e:
            raise ValueError(f"delete ids must be integers: {e}") from e
        if not ids:
            raise ValueError("empty delete (0 ids)")
        with self._lock:
            if self._closed:
                raise OverloadError("mutable engine is shut down")
            if (expect_version is not None
                    and expect_version != self._version):
                self._note_mutation("delete", "rejected")
                raise MutationConflict(
                    f"index_version precondition failed: request names "
                    f"{expect_version!r} but {self._version!r} is serving "
                    f"(a compaction re-assigned row ids; re-read before "
                    f"deleting)"
                )
            try:
                # Positional -> stable translation (a concern only this
                # entry point has; replay logs stable ids directly)...
                sids = []
                seen = set()
                for p in ids:
                    if p in seen:
                        raise MutationConflict(
                            f"duplicate id {p} in one delete request")
                    seen.add(p)
                    if p < 0 or p >= self._base_n + self._count:
                        raise MutationConflict(
                            f"no such row: id {p} (addressable: 0.."
                            f"{self._base_n + self._count - 1})")
                    sids.append(int(self._base_stable[p])
                                if p < self._base_n
                                else int(self._stable[p - self._base_n]))
                # ...then the shared safety rules BEFORE anything is
                # durable: a refused delete must leave the write-ahead
                # log untouched, or replay would re-apply a mutation
                # that was never acknowledged.
                self._validate_tombstones(sids, where="delete")
            except MutationConflict:
                self._note_mutation("delete", "rejected")
                raise
            seq = self._seq + 1
            rec = {"seq": seq, "op": "delete", "sids": sids}
            self._log.append(rec)
            self._tombstone_stables(sids, where="delete")
            self._seq = seq
            self._note_digest(seq, rec)
            epoch = self._epoch
            version = self._version  # same-lock pairing as apply_insert
            pressure = self.pressure()
        self._note_visible(submitted_ns)
        self._note_mutation("delete", "ok", len(ids))
        self._maybe_kick(pressure)
        return {"op": "delete", "deleted": len(ids), "seq": seq,
                "epoch": epoch, "index_version": version}

    # -- replication (the fleet's, ROADMAP A12; no route calls these yet) --

    def apply_replicated(self, rec: dict) -> dict:
        """Apply ONE primary-shipped WAL record through the exact same
        validation path local mutations take — a divergent record (wrong
        width, unknown label, impossible delete) is a typed refusal, never
        silent corruption.

        Contract (what primary-failover catch-up depends on):

        - ``seq == applied + 1`` → validate, append to THIS replica's own
          WAL (flushed — a promoted follower must be able to re-ship and
          to survive its own reboot), apply, return ``applied: True``;
        - ``seq <= applied`` → **idempotent no-op** (the primary re-ships
          from a conservative cursor after a resync) — but only after the
          content digest matches the record already applied at that seq;
          a mismatch raises :class:`WALDivergence` (the two logs disagree
          about history — re-seed, don't retry);
        - ``seq > applied + 1`` → :class:`ReplicationGap` carrying
          ``applied_seq`` so the shipper resets its cursor (never a
          silent skip).
        """
        try:
            seq = int(rec["seq"])
            op = rec["op"]
        except (KeyError, TypeError, ValueError) as e:
            raise DataError(f"unreplayable WAL record: {e}") from e
        with self._lock:
            if self._closed:
                raise OverloadError("mutable engine is shut down")
            if seq <= self._seq:
                known = self._digests.get(seq)
                shipped = wal_record_digest(rec)
                if known is not None and known != shipped:
                    raise WALDivergence(
                        f"seq {seq} is already applied with digest "
                        f"{known} but the primary shipped {shipped} — "
                        f"this replica's log has diverged from the "
                        f"primary's; re-seed it from a fresh copy"
                    )
                return {"applied": False, "seq": self._seq}
            if seq != self._seq + 1:
                raise ReplicationGap(
                    f"record seq {seq} skips past the next expected "
                    f"{self._seq + 1}; re-ship from {self._seq}",
                    applied_seq=self._seq,
                )
            if op == "insert":
                # The full local-insert validation (width, finiteness,
                # label range) — the "divergent record is a typed
                # refusal" half of the fan-out contract.
                rows, values = validate_insert(
                    self._model, rec["rows"], rec.get("values"))
                sid0 = int(rec["sid0"])
                clean = {"seq": seq, "op": "insert", "sid0": sid0,
                         "rows": [[float(v) for v in r] for r in rows],
                         "values": [float(v) for v in values]}
                self._log.append(clean)
                self._append_rows(rows, values, sid0, enforce_cap=False)
                self._next_stable = max(self._next_stable,
                                        sid0 + rows.shape[0])
            elif op == "delete":
                sids = [int(s) for s in rec["sids"]]
                clean = {"seq": seq, "op": "delete", "sids": sids}
                # Validate BEFORE the WAL append (the apply_delete
                # discipline: a refused record must leave this replica's
                # log untouched).
                self._validate_tombstones(sids, where="wal-append")
                self._log.append(clean)
                self._tombstone_stables(sids, where="wal-append")
            else:
                raise DataError(f"unknown op {op!r} in replicated record "
                                f"seq {seq}")
            self._seq = seq
            self._note_digest(seq, clean)
            pressure = self.pressure()
        self._note_mutation(op, "replicated",
                            len(clean.get("rows", clean.get("sids", [0]))))
        self._maybe_kick(pressure)
        return {"applied": True, "seq": seq}

    def records_since(self, after_seq: int,
                      limit: int = 512) -> "tuple[list[dict], int]":
        """WAL records with ``seq > after_seq`` (ascending, at most
        ``limit``), each stamped with its content ``digest`` — the
        shipping source for the primary's fan-out and for rejoin
        catch-up. Reads the epoch files directly (the appender flushes
        whole lines, and a torn tail is by definition un-acked — skipped
        this round, shipped the next). A cursor behind the fold point is
        still servable while a retention hold (mutable/compact.py) kept
        the folded epochs on disk: the stream is verified gapless from
        ``after_seq + 1`` before shipping, and the typed
        :class:`DataError` re-seed refusal fires only when records are
        actually missing — compacted into a base generation and their
        epochs pruned, so that follower must re-seed from a copy of the
        artifact directory (the snapshot bootstrap path,
        ROADMAP A12). A file vanishing MID-scan (the compactor's
        epoch pruning is not coordinated with this lock-free read) is a
        transient race, re-scanned — and surfaced as a plain ``OSError``
        (retry later, NOT the terminal re-seed state) if it somehow
        persists."""
        for _attempt in range(3):
            with self._lock:
                folded = self._folded_seq
                own_seq = self._seq
            out: "list[dict]" = []
            try:
                epochs = artifact.list_epochs(self.root)
                last = epochs[-1][0] if epochs else None
                for n, path in epochs:
                    if len(out) >= limit:
                        break
                    records, _torn = artifact.read_epoch_records(
                        path, tolerate_torn=(n == last))
                    for rec in records:
                        if (int(rec["seq"]) > after_seq
                                and len(out) < limit):
                            out.append({**rec,
                                        "digest": wal_record_digest(rec)})
            except DataError as e:
                if isinstance(e.__cause__, FileNotFoundError):
                    continue  # pruned mid-scan; re-list and re-read
                raise
            out.sort(key=lambda r: int(r["seq"]))
            if after_seq < folded:
                expect = after_seq
                for rec in out:
                    if int(rec["seq"]) != expect + 1:
                        break
                    expect += 1
                else:
                    if out:  # gapless from the cursor: retention held
                        return out, own_seq
                raise DataError(
                    f"cursor seq {after_seq} predates the fold point "
                    f"{folded}: those records are compacted into a base "
                    f"generation and their epochs pruned — re-seed the "
                    f"follower from a copy of the artifact directory"
                )
            return out, own_seq
        raise OSError(
            "epoch files kept vanishing mid-scan (compaction churn); "
            "transient — retry the shipment"
        )

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> MutableView:
        with self._lock:
            return MutableView(
                features=self._features, values=self._values,
                stable=self._stable, count=self._count,
                tomb_pos=self._tomb_pos, tomb_base=self._tomb_base,
                tomb_delta_slots=self._tomb_delta, seq=self._seq,
                base_n=self._base_n, generation=self._generation,
                device=(self._dtail.view() if self._dtail is not None
                        else None),
            )

    @property
    def seq(self) -> int:
        """The last applied mutation sequence number (the replication
        cursor's anchor; /healthz ``fleet.applied_seq``)."""
        with self._lock:
            return self._seq

    @property
    def folded_seq(self) -> int:
        """The fold point: records at or below it live only in compacted
        base generations (their epochs are pruned) — the lowest seq a
        WAL shipper's cursor can meaningfully start from."""
        with self._lock:
            return self._folded_seq

    def pressure(self) -> int:
        """Mutations awaiting compaction: delta slots in use plus live
        tombstones — what ``--compact-threshold`` gates on."""
        with self._lock:
            return self._count + len(self._tomb_stable)

    def delta_full(self) -> bool:
        """Advisory (lock-free) admission pre-check: True when the delta
        tier has no free slot. The authoritative check is the locked one
        in :meth:`apply_insert` — this only spares a doomed insert the
        queue round-trip."""
        return self._count >= self.delta_cap

    # -- compaction interface (mutable/compact.py) -------------------------

    def seal(self) -> dict:
        """Freeze a fold point and rotate the WAL: returns the fold input
        (frozen array refs + tombstones + ``seq``), after which new
        mutations land in a FRESH epoch file and delta slots >= the frozen
        ``count`` — nothing the fold reads can move underneath it."""
        with self._lock:
            fold = {
                "features": self._features, "values": self._values,
                "stable": self._stable, "count": self._count,
                "tomb_stable": self._tomb_stable, "seq": self._seq,
                "generation": self._generation,
                "sealed_epoch": self._epoch,
            }
            self._log.close()
            self._epoch += 1
            self._log = artifact.EpochLog(
                artifact.epoch_path(self.root, self._epoch))
            return fold

    def rebase(self, fold: dict, new_model, new_base_stable: np.ndarray,
               generation: int, version: Optional[str] = None) -> None:
        """Re-anchor the live state on a freshly-compacted base. MUST run
        inside the batcher's model-swap critical section (the hook of
        ``MicroBatcher.swap_model``): the model swap and this rebase are
        one atomic step to every dispatch snapshot. All validation and
        array building happen BEFORE the first assignment, so a raise
        leaves the engine exactly as it was (``swap_model`` restores the
        old model on a hook failure — together that is a true rollback)."""
        with self._lock:
            new_base_stable = check_stable_ascending(
                np.asarray(new_base_stable, np.int64), "rebase")
            new_base_n = int(new_base_stable.shape[0])
            post = list(range(fold["count"], self._count))
            keep_tombs = self._tomb_stable - fold["tomb_stable"]
            cap = min(max(_INITIAL_SLOTS, len(post)), self.delta_cap)
            features = np.zeros((cap, self._d), np.float32)
            values = np.zeros(cap, np.float32)
            stable = np.zeros(cap, np.int64)
            for j, slot in enumerate(post):
                features[j] = self._features[slot]
                values[j] = self._values[slot]
                stable[j] = self._stable[slot]
            positions = set()
            for sid in keep_tombs:
                pos = stable_to_position(new_base_stable, sid)
                if pos is None:
                    hits = np.nonzero(stable[:len(post)] == sid)[0]
                    if not hits.size:
                        raise DataError(
                            f"rebase: post-seal tombstone (stable id "
                            f"{sid}) maps to no row in the new generation "
                            f"— the fold is inconsistent"
                        )
                    pos = new_base_n + int(hits[0])
                positions.add(pos)
            self._model = new_model
            self._version = version
            self._base_stable = new_base_stable
            self._base_n = new_base_n
            self._generation = generation
            self._folded_seq = fold["seq"]
            self._features, self._values, self._stable = (features, values,
                                                          stable)
            self._count = len(post)
            self._tomb_stable = frozenset(keep_tombs)
            self._tomb_pos = frozenset(positions)
            self._rebuild_tomb_arrays()
            # Fresh generation, fresh tail: drop the old device buffer
            # (snapshots holding its view keep reading it — nothing writes
            # into a tail's tensors) and lazily re-activate at the
            # threshold.
            self._dtail = None
            self._sync_device_tail()

    def reseed(self, new_model, new_base_stable, current: dict,
               version: Optional[str] = None, commit=None) -> None:
        """Abandon this engine's entire lineage in favor of a freshly
        installed snapshot generation (the fleet's bootstrap, ROADMAP A12).
        MUST run
        inside the batcher's model-swap critical section, exactly like
        :meth:`rebase`. Unlike a rebase nothing survives: delta slots,
        tombstones, the digest window, and the WAL cursor all reset to
        the snapshot's fold point — records past it arrive back through
        the normal replication path (the primary holds them).

        ``commit`` — an optional callable run under the engine lock
        AFTER validation but BEFORE any state mutates: the bootstrap
        installer's durable commit (clear old-lineage epochs, atomic
        CURRENT.json replace). Running it here means no mutation can
        append to an epoch file that is about to be abandoned, and a
        raise from it leaves the engine untouched (``swap_model``
        restores the old model — together a true rollback)."""
        with self._lock:
            if new_base_stable is not None:
                stable = check_stable_ascending(
                    np.asarray(new_base_stable, np.int64), "reseed")
            else:
                stable = np.arange(new_model.train_.num_instances,
                                   dtype=np.int64)
            if new_model.train_.num_features != self._d:
                raise DataError(
                    f"reseed: snapshot generation has "
                    f"{new_model.train_.num_features} features but this "
                    f"replica serves {self._d} — wrong fleet"
                )
            folded = int(current.get("folded_seq", 0))
            if commit is not None:
                commit()
            self._model = new_model
            self._version = version
            self._base_stable = stable
            self._base_n = int(stable.shape[0])
            self._generation = int(current.get("generation", 0))
            self._folded_seq = folded
            self._seq = folded
            self._next_stable = max(
                int(stable[-1]) + 1 if self._base_n else 0,
                int(current.get("next_stable", 0)))
            cap = min(_INITIAL_SLOTS, self.delta_cap)
            self._features = np.zeros((cap, self._d), np.float32)
            self._values = np.zeros(cap, np.float32)
            self._stable = np.zeros(cap, np.int64)
            self._count = 0
            self._tomb_stable = frozenset()
            self._tomb_pos = frozenset()
            self._rebuild_tomb_arrays()
            self._digests = {}
            self._dtail = None
            self._sync_device_tail()
            # The old lineage's epoch files are gone (commit cleared
            # them); rotate to a fresh log so new records land in an
            # epoch that postdates the installed fold point.
            self._log.close()
            epochs = artifact.list_epochs(self.root)
            self._epoch = (epochs[-1][0] + 1) if epochs else 1
            self._log = artifact.EpochLog(
                artifact.epoch_path(self.root, self._epoch))

    def note_compaction(self, outcome: str, wall_ms: float,
                        detail: Optional[dict] = None) -> None:
        with self._lock:
            self._last_compaction = {
                "outcome": outcome, "wall_ms": round(wall_ms, 3),
                **(detail or {}),
            }
        obs.counter_add(
            "knn_mutable_compactions_total",
            help="background compactions by outcome (rolled_back = the "
                 "old generation kept serving)",
            outcome=outcome,
        )
        obs.gauge_set(
            "knn_mutable_compaction_wall_ms", round(wall_ms, 3),
            help="wall time of the most recent compaction attempt",
        )

    def base_manifest_block(self, fold: dict,
                            new_base_stable: np.ndarray) -> dict:
        """The ``mutable_block`` the compactor hands ``save_index`` for a
        new generation."""
        return {
            "stable_ids": np.asarray(new_base_stable, np.int64),
            "folded_seq": int(fold["seq"]),
            "next_stable": int(self._next_stable),
            "generation": int(fold["generation"]) + 1,
        }

    # -- instruments / export ----------------------------------------------

    def on_pressure(self, cb) -> None:
        self._on_pressure = cb

    def _maybe_kick(self, pressure: int) -> None:
        cb = self._on_pressure
        if cb is not None:
            try:
                cb(pressure)
            except Exception:  # noqa: BLE001 — compaction nudge only
                pass

    def _note_mutation(self, op: str, outcome: str, rows: int = 1) -> None:
        obs.counter_add(
            "knn_mutable_mutations_total", rows,
            help="acknowledged/rejected mutations by op (rows for "
                 "inserts, ids for deletes)",
            op=op, outcome=outcome,
        )

    def _note_visible(self, submitted_ns: int) -> None:
        ms = (time.monotonic_ns() - submitted_ns) / 1e6
        with self._lock:
            self._fresh.note(ms)
        obs.histogram_observe(
            "knn_mutable_freshness_ms", ms,
            buckets=FRESHNESS_BUCKETS_MS,
            help="write-to-visible latency: mutation submit to applied-"
                 "in-every-subsequent-dispatch-snapshot",
        )

    def export(self) -> dict:
        """Refresh the ``knn_mutable_*`` gauges (scrape-time, the
        ``knn_slo_*`` rule) and return the /healthz ``mutable`` block."""
        with self._lock:
            live_delta = self._count - int(self._tomb_delta.shape[0])
            doc = {
                "delta_rows": live_delta,
                "delta_slots": self._count,
                "delta_cap": self.delta_cap,
                "delta_ratio": (round(live_delta / self._base_n, 6)
                                if self._base_n else None),
                "tombstones": len(self._tomb_stable),
                "seq": self._seq,
                "folded_seq": self._folded_seq,
                "epoch": self._epoch,
                "generation": self._generation,
                "base_rows": self._base_n,
                "freshness": self._fresh.export(),
                "last_compaction": self._last_compaction,
                "device_tail": {
                    "mode": self._device_tail_mode,
                    "active": self._dtail is not None,
                },
            }
        obs.gauge_set(
            "knn_mutable_delta_rows", doc["delta_rows"],
            help="live (non-tombstoned) rows in the delta tier",
        )
        obs.gauge_set(
            "knn_mutable_delta_ratio", doc["delta_ratio"] or 0.0,
            help="live delta rows over base rows (compaction debt)",
        )
        obs.gauge_set(
            "knn_mutable_tombstones", doc["tombstones"],
            help="live tombstones masked out of candidate sets",
        )
        obs.gauge_set(
            "knn_mutable_epoch", doc["epoch"],
            help="active write-ahead epoch number",
        )
        obs.gauge_set(
            "knn_mutable_generation", doc["generation"],
            help="compacted base generation the process serves",
        )
        return doc

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._log.close()
