"""The replica-side fleet role: WAL fan-out, follower apply, promotion
(the port of ``knn_tpu/fleet/replica.py``).

One :class:`FleetReplica` rides a mutable ``ServeApp``:

- **primary** (``serve --replicate-to URL,...``): after every locally
  acknowledged mutation, one :class:`WALShipper` per follower pushes the
  ordered record stream over ``POST /admin/wal-append`` (cursor per
  follower, gap resync via the follower's reported ``applied_seq``,
  divergence is terminal). With ``ack_mode="any"`` (the default) a
  mutation's HTTP 200 waits until at least one follower holds its seq —
  that is the invariant that makes "promote the most-caught-up follower"
  lose zero acknowledged writes.
- **follower** (``serve --follower-of URL``): read-only for clients;
  applies shipped records through
  :meth:`~knn_tpu_torch.mutable.engine.MutableEngine.apply_replicated` (the
  exact local-mutation validation path — a divergent record is a typed
  refusal, not silent corruption). ``POST /admin/promote`` flips the
  role in place and starts shipping to the surviving peers.

The port's one departure: an apply reaches the delta tail on the card, so
a serving follower hands each shipped batch to its batcher's worker thread
(``apply=``, the serve layer's ``submit_mutation("replicate", ...)``) and
the HTTP handler waits on it. JAX applies on the handler thread, which its
immutable arrays allow. The semi-synchronous wait stays on the primary's
handler thread, never on its worker: one slow follower must not stall the
primary's reads.

Rejoin (docs/SERVING.md §Running a replica set): a rebooted ex-primary
boots ``--follower-of NEW_PRIMARY``; :func:`reconcile_wal_with_primary`
truncates its WAL past the new primary's takeover point — that tail is
unacknowledged by construction (see above), and under the new lineage
those seqs name different mutations.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Optional

from knn_tpu_torch import obs
from knn_tpu_torch.fleet.wire import request_json
from knn_tpu_torch.mutable.state import (
    MutationConflict,
    ReplicationGap,
    WALDivergence,
)
from knn_tpu_torch.resilience.errors import DataError
from knn_tpu_torch.resilience.retry import guarded_call

#: Shipper states an operator reads in /healthz ``fleet.followers``.
SHIP_OK = "ok"
SHIP_UNREACHABLE = "unreachable"
SHIP_DIVERGED = "diverged"        # parked: re-seed the follower
SHIP_BEHIND_FOLD = "behind_fold"  # parked: re-seed the follower
SHIP_REJECTED = "rejected"

#: ``knn_fleet_shipper_state`` gauge encoding — the numeric mirror of
#: the states above so a dashboard can alert on "any follower parked"
#: without string labels: 0 shipping/idle, 1 unreachable, 2 rejected,
#: 3 parked awaiting re-seed (behind the fold), 4 parked diverged.
SHIP_STATE_CODE = {
    SHIP_OK: 0,
    SHIP_UNREACHABLE: 1,
    SHIP_REJECTED: 2,
    SHIP_BEHIND_FOLD: 3,
    SHIP_DIVERGED: 4,
}

#: Replication-lag clock bound: stamped apply instants kept while no
#: follower has confirmed them (writes-in-flight, not history).
_MAX_SEQ_STAMPS = 4096

#: How long a parked (diverged/behind-fold) shipper waits before
#: re-probing its follower. Parking — not dying — is what makes the
#: documented recovery work WITHOUT a primary restart: once the operator
#: re-seeds and reboots the follower, the next probe resyncs (gap-409 →
#: cursor reset, digest overlap clean) and shipping resumes; until then
#: each probe is one cheap refused batch per interval. The env override
#: exists for the drill harnesses (chip_smoke.py's fleet phase) which run
#: whole park→re-seed→resume cycles in seconds, not for production.
TERMINAL_RETRY_S = float(os.environ.get("KNN_TPU_SHIP_RETRY_S") or 30.0)


class WALShipper(threading.Thread):
    """One ordered push cursor: this primary -> one follower."""

    def __init__(self, fleet: "FleetReplica", url: str, *,
                 interval_s: float = 0.05, batch: int = 512,
                 timeout_s: float = 10.0):
        super().__init__(daemon=True,
                         name=f"knn-fleet-ship-{url.split('//')[-1]}")
        self.fleet = fleet
        self.url = url.rstrip("/")
        self.interval_s = interval_s
        self.batch = batch
        self.timeout_s = timeout_s
        # Start the cursor AT the fold point: records at or below it
        # live only in compacted generations (records_since would refuse
        # cursor 0 on any ever-compacted artifact). A follower that is
        # genuinely behind the fold answers the first shipment with a
        # gap-409 naming its real seq; the resync then lands below the
        # fold and records_since's typed refusal marks it re-seed —
        # exactly the one case that SHOULD be terminal.
        self.acked_seq = fleet.engine.folded_seq
        self.state = SHIP_OK
        self.last_error: Optional[str] = None
        self.shipped = 0
        self._halt = threading.Event()
        self._kick = threading.Event()

    def kick(self) -> None:
        self._kick.set()

    def stop(self) -> None:
        self._halt.set()
        self._kick.set()

    def lag(self) -> int:
        return max(0, self.fleet.engine.seq - self.acked_seq)

    def run(self) -> None:
        while not self._halt.is_set():
            self._kick.wait(self.interval_s)
            self._kick.clear()
            if self._halt.is_set():
                break
            try:
                self._ship_pending()
            except (WALDivergence, DataError) as e:
                # PARK this follower (its log diverged, or it is behind
                # the fold point): shipping more records could only
                # corrupt it further. The state is surfaced in /healthz
                # for the operator to re-seed + reboot the follower —
                # after which the slow re-probe below resyncs and
                # resumes, with no primary restart needed.
                if isinstance(e, WALDivergence):
                    self.state = SHIP_DIVERGED
                else:
                    self.state = SHIP_BEHIND_FOLD
                    # Re-anchor at the fold so the re-probe SHIPS
                    # instead of re-raising: a re-seeded follower
                    # (seq >= fold) then resyncs cleanly; one still
                    # genuinely behind answers gap-409 below the fold
                    # and parks here again.
                    self.acked_seq = self.fleet.engine.folded_seq
                self.last_error = str(e)
                self._note("parked")
                self._export_state()
                self._halt.wait(TERMINAL_RETRY_S)
                self._kick.clear()
            except Exception as e:  # noqa: BLE001 — a shipper must
                # never die on a transport blip; next interval retries.
                self.state = SHIP_UNREACHABLE
                self.last_error = f"{type(e).__name__}: {e}"
                self._note("error")
                self._export_state()

    def _ship_pending(self) -> None:
        while not self._halt.is_set():
            if self.fleet.engine.seq <= self.acked_seq:
                # Caught up: don't touch the epoch files at all — an
                # idle shipper would otherwise re-read and re-parse the
                # whole WAL every poll tick.
                if self.state is SHIP_UNREACHABLE:
                    self.state = SHIP_OK
                self._export_lag()
                return
            records, own_seq = self.fleet.engine.records_since(
                self.acked_seq, limit=self.batch)
            if not records:
                if self.state is SHIP_UNREACHABLE:
                    self.state = SHIP_OK
                self._export_lag()
                return
            status, doc = guarded_call(
                "fleet.wal_ship",
                lambda: request_json(
                    "POST", self.url + "/admin/wal-append",
                    {"records": records, "primary_seq": own_seq},
                    timeout=self.timeout_s,
                ),
            )
            if status == 200:
                self.acked_seq = int(doc.get("applied_seq", self.acked_seq))
                self.shipped += int(doc.get("applied", 0))
                self.state = SHIP_OK
                self.last_error = None
                self._note("ok")
                self.fleet.note_follower_ack(self.url, self.acked_seq)
            elif status == 409 and doc.get("diverged"):
                raise WALDivergence(
                    f"{self.url}: {doc.get('error', 'diverged')}")
            elif status == 409 and "applied_seq" in doc:
                # Seq gap from the follower's perspective (it rebooted,
                # or a prior batch was lost): resync the cursor to what
                # it reports and re-ship from there — never skip.
                self.acked_seq = int(doc["applied_seq"])
                self._note("resync")
                self.fleet.note_follower_ack(self.url, self.acked_seq)
            else:
                self.state = SHIP_REJECTED
                self.last_error = (f"HTTP {status}: "
                                   f"{doc.get('error', doc)}")
                self._note("rejected")
                return
            self._export_lag()

    def _note(self, outcome: str) -> None:
        obs.counter_add(
            "knn_fleet_wal_ship_total",
            help="WAL shipment batches by follower and outcome",
            follower=self.url, outcome=outcome,
        )

    def _export_lag(self) -> None:
        obs.gauge_set(
            "knn_fleet_replication_lag_seq", self.lag(),
            help="primary applied_seq minus this follower's acked seq",
            follower=self.url,
        )
        self._export_state()

    def _export_state(self) -> None:
        obs.gauge_set(
            "knn_fleet_shipper_state", SHIP_STATE_CODE.get(self.state, 1),
            help="per-follower shipper state: 0 shipping/idle, "
                 "1 unreachable, 2 rejected, 3 parked-reseed (behind "
                 "the fold), 4 parked-diverged",
            follower=self.url,
        )

    def export(self) -> dict:
        self._export_state()
        lag_ms = self.fleet.follower_lag_ms(self.url)
        return {
            "acked_seq": self.acked_seq,
            "lag": self.lag(),
            "lag_ms": lag_ms,
            "state": self.state,
            "last_error": self.last_error,
            "shipped": self.shipped,
        }


class FleetReplica:
    """This process's role in a replica set (``/healthz`` ``fleet``
    block). Built ONLY when ``--follower-of`` or ``--replicate-to`` was
    given — a plain serve constructs nothing from this package.

    ``apply`` applies one shipped batch (records in seq order) and returns
    ``{"applied", "skipped"}``; the default applies on the calling thread
    (``engine.apply_replicated_records``), a serving follower passes its
    batcher's worker."""

    def __init__(self, engine, *, role: str,
                 primary_url: Optional[str] = None,
                 replicate_to=(), ack_mode: str = "any",
                 ack_timeout_s: float = 5.0,
                 ship_interval_s: float = 0.05, apply=None):
        if role not in ("primary", "follower"):
            raise ValueError(f"fleet role must be primary or follower, "
                             f"got {role!r}")
        if ack_mode not in ("any", "none"):
            raise ValueError(f"ack_mode must be 'any' or 'none', got "
                             f"{ack_mode!r}")
        self.engine = engine
        self._apply = apply or engine.apply_replicated_records
        self.role = role
        self.primary_url = primary_url
        self.ack_mode = ack_mode
        self.ack_timeout_s = float(ack_timeout_s)
        self.ship_interval_s = float(ship_interval_s)
        self.promoted_at_seq: Optional[int] = None
        self.promotions = 0
        #: Highest ``primary_seq`` a shipped batch has carried (follower
        #: side): how far ahead the primary reported being when it last
        #: shipped here — the read-staleness reference the serve layer
        #: annotates lagging answers with.
        self.primary_seq_seen = 0
        self._lock = threading.Lock()
        self._ack_cond = threading.Condition(self._lock)
        self._shippers: "dict[str, WALShipper]" = {}
        self._closed = False
        # The replication-lag clock (primary side): stamp each applied
        # seq's wall instant; a follower's ack of seq s then measures
        # apply->confirmed-replicated in milliseconds. Bounded: seqs at
        # or below every follower's ack are dropped on each ack.
        self._seq_stamps: "collections.OrderedDict[int, float]" = \
            collections.OrderedDict()
        self._lag_ms: "dict[str, float]" = {}
        engine.on_applied(self._on_applied)
        if role == "primary":
            for url in replicate_to:
                self._start_shipper(url)

    # -- primary side ------------------------------------------------------

    def _start_shipper(self, url: str) -> None:
        url = url.rstrip("/")
        existing = self._shippers.get(url)
        if existing is not None:
            if existing.is_alive():
                return
            existing.stop()  # a dead thread is replaced, never kept
        shipper = WALShipper(self, url, interval_s=self.ship_interval_s)
        self._shippers[url] = shipper
        shipper.start()

    def _on_applied(self) -> None:
        if self.role == "primary":
            with self._ack_cond:
                self._seq_stamps[self.engine.seq] = time.monotonic()
                while len(self._seq_stamps) > _MAX_SEQ_STAMPS:
                    self._seq_stamps.popitem(last=False)
        for s in list(self._shippers.values()):
            s.kick()

    def note_follower_ack(self, url: str, seq: int) -> None:
        now = time.monotonic()
        with self._ack_cond:
            # The newest stamped seq this ack covers gives the lag clock:
            # apply-instant -> replicated-confirmed for that write. Acks
            # usually confirm the latest seq, so the reversed scan is
            # O(1) in the common case.
            stamp = None
            for s in reversed(self._seq_stamps):
                if s <= seq:
                    stamp = self._seq_stamps[s]
                    break
            if stamp is not None:
                lag_ms = round((now - stamp) * 1e3, 3)
                self._lag_ms[url.rstrip("/")] = lag_ms
                obs.gauge_set(
                    "knn_fleet_replication_lag_ms", lag_ms,
                    help="ms from a write's primary apply to this "
                         "follower's ack of it (the replication-delay "
                         "SLI; seq-lag 0 with a stale clock means idle, "
                         "not behind)",
                    follower=url.rstrip("/"),
                )
            # Stamps every follower has confirmed can never clock a
            # future ack; drop them so the dict stays ack-bounded.
            floor = min((sh.acked_seq
                         for sh in self._shippers.values()), default=seq)
            while self._seq_stamps:
                first = next(iter(self._seq_stamps))
                if first > floor:
                    break
                del self._seq_stamps[first]
            self._ack_cond.notify_all()

    def follower_lag_ms(self, url: str) -> Optional[float]:
        """Last measured replication delay for one follower (ms), or
        None before the first confirmed ack."""
        with self._ack_cond:
            return self._lag_ms.get(url.rstrip("/"))

    def max_follower_seq(self) -> int:
        shippers = list(self._shippers.values())
        return max((s.acked_seq for s in shippers), default=0)

    def retention_floor(self) -> Optional[int]:
        """The lowest WAL cursor a LIVE follower still needs — the
        compactor's epoch-pruning floor (``Compactor(retention_floor=
        ...)``), closing the hazard where a fold silently strands a
        merely-lagging follower behind the fold point. Parked shippers
        (diverged / behind the fold) are excluded on purpose: they
        recover through the snapshot bootstrap path, not the WAL, and
        holding epochs for them would pin the log forever. None when
        there is nothing to hold for (follower role, or no shippers)."""
        if self.role != "primary":
            return None
        live = [s.acked_seq for s in self._shippers.values()
                if s.state not in (SHIP_DIVERGED, SHIP_BEHIND_FOLD)]
        if not live:
            return None
        return min(live)

    def wait_replicated(self, seq: int,
                        timeout_s: Optional[float] = None) -> bool:
        """Block until at least one follower has acknowledged ``seq``
        (the semi-synchronous half of the durability story). True
        immediately for ``ack_mode="none"`` or a primary with no
        followers configured (single-replica durability is then the
        local WAL, exactly as before this layer existed)."""
        if self.role != "primary" or self.ack_mode == "none":
            return True
        if not self._shippers:
            return True
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.ack_timeout_s)
        with self._ack_cond:
            while self.max_follower_seq() < seq:
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    return False
                self._ack_cond.wait(min(left, 0.1))
        return True

    # -- follower side -----------------------------------------------------

    def apply_wal_records(self, records, primary_seq=None) -> dict:
        """Apply one shipped batch in seq order (the ``/admin/wal-append``
        body). Raises the engine's typed taxonomy unchanged —
        :class:`ReplicationGap` carries the seq to resync from,
        :class:`WALDivergence`/validation errors mean the batch (and this
        replica) must not be trusted."""
        with self._lock:
            if self.role != "follower":
                raise MutationConflict(
                    "this replica is the primary; it ships WAL records, "
                    "it does not accept them (a second primary would be "
                    "a split brain)"
                )
        if not isinstance(records, list) or not records:
            raise ValueError('wal-append body needs a non-empty '
                             '"records" list')
        if primary_seq is not None:
            # The primary's own seq when it shipped this batch: the
            # freshest "how far behind am I" reference a follower has,
            # annotated onto lagging reads (staleness_seq).
            self.primary_seq_seen = max(self.primary_seq_seen,
                                        int(primary_seq))
        counts = self._apply(
            sorted(records, key=lambda r: int(r.get("seq", 0))))
        return {"applied_seq": self.engine.seq, **counts}

    def promote(self, replicate_to=()) -> dict:
        """Follower -> primary, in place: record the takeover seq (the
        truncation point a rebooted ex-primary reconciles against),
        start shipping to the surviving peers, accept writes from the
        next request on."""
        with self._lock:
            if self.role == "primary":
                raise MutationConflict(
                    "already the primary; promote a FOLLOWER")
            self.role = "primary"
            self.primary_url = None
            self.promoted_at_seq = self.engine.seq
            self.promotions += 1
            for url in replicate_to or ():
                self._start_shipper(url)
        obs.counter_add(
            "knn_fleet_promotions_total",
            help="follower->primary promotions this process served",
        )
        return {"role": self.role, "seq": self.engine.seq,
                "promoted_at_seq": self.promoted_at_seq,
                "followers": sorted(self._shippers)}

    def staleness_seq(self) -> int:
        """How many acknowledged primary writes this follower has not yet
        applied, judged by the freshest shipped ``primary_seq`` (0 when
        caught up, when never shipped to, or on the primary itself)."""
        if self.role != "follower":
            return 0
        return max(0, self.primary_seq_seen - self.engine.seq)

    # -- shared ------------------------------------------------------------

    def export(self) -> dict:
        doc = {
            "role": self.role,
            "applied_seq": self.engine.seq,
            "ack_mode": self.ack_mode,
            "promoted_at_seq": self.promoted_at_seq,
        }
        if self.role == "follower":
            doc["primary_url"] = self.primary_url
            doc["primary_seq_seen"] = self.primary_seq_seen
            doc["staleness_seq"] = self.staleness_seq()
        else:
            doc["followers"] = {url: s.export()
                                for url, s in self._shippers.items()}
        return doc

    def close(self) -> None:
        with self._ack_cond:
            self._closed = True
            self._ack_cond.notify_all()
        for s in self._shippers.values():
            s.stop()
        for s in self._shippers.values():
            s.join(timeout=5)


def reconcile_wal_with_primary(root, primary_url: str, *,
                               timeout_s: float = 2.0,
                               attempts: int = 5) -> Optional[dict]:
    """The rejoin step, run BEFORE the engine boots and replays: ask the
    new primary for its takeover point and truncate this artifact's WAL
    past it (see :func:`knn_tpu_torch.mutable.engine.truncate_wal` for why that
    tail is safe — and necessary — to drop). Best-effort: an unreachable
    primary returns None and boot proceeds on the local log alone (the
    wal-append digest overlap check still catches divergence later,
    typed)."""
    from knn_tpu_torch.mutable.engine import truncate_wal

    last_err: Optional[str] = None
    for attempt in range(attempts):
        try:
            status, doc = request_json(
                "GET", primary_url.rstrip("/") + "/healthz",
                timeout=timeout_s)
        except OSError as e:
            last_err = f"{type(e).__name__}: {e}"
            time.sleep(min(0.2 * (attempt + 1), 1.0))
            continue
        fleet = doc.get("fleet") if isinstance(doc, dict) else None
        if not isinstance(fleet, dict):
            return {"reconciled": False,
                    "reason": f"primary /healthz ({status}) carries no "
                              f"fleet block"}
        cap = fleet.get("promoted_at_seq")
        if cap is None:
            # Never-promoted primary: the shared lineage IS its whole
            # log; nothing local can be divergent.
            return {"reconciled": True, "dropped": 0, "cap": None}
        dropped = truncate_wal(root, int(cap))
        return {"reconciled": True, "dropped": dropped, "cap": int(cap)}
    return {"reconciled": False,
            "reason": f"primary unreachable ({last_err})"}
