"""Durable metrics history: an append-only on-disk segment ring (the
port's copy of ``knn_tpu/obs/history.py``).

Every serve process with ``--history-dir`` set appends a periodic
snapshot of its metrics registry to ``seg-<n>.jsonl`` segments. The
encoding is delta-based so a quiet process costs bytes proportional to
what actually changed:

* each segment opens with a **header** line pinning the format version
  and a schema hash — a reader from an incompatible build refuses with a
  typed ``DataError`` instead of silently misdecoding;
* the first snapshot in a segment is a **base** record carrying absolute
  values (and histogram bucket *bounds*), so every segment decodes
  independently of its predecessors — retention can drop whole segments
  without orphaning state;
* subsequent snapshots are **delta** records: counter increments,
  changed gauges, and raw non-cumulative histogram bucket-count deltas.
  Histograms are reconstructed through ``Histogram.merge_counts`` — the
  same primitive the multihost aggregator uses — never by pre-summing
  into lossy percentiles.

The segment files are byte-equal to the JAX package's for the same
samples and clock (the same JSON layout, key order, rounding, label sort
and delta encoding), so either package reads the other's directory.

Crash-safety mirrors the mutable index's WAL tail contract
(``mutable/engine.py``): a torn final line of the *last* segment is the
expected signature of a crash mid-append and is tolerated and repaired
in place (atomic tmp+rename); a torn or corrupt line anywhere else is
real damage and raises ``DataError``.

The recorder also keeps a bounded in-memory ring of absolute samples —
that ring backs the live ``GET /debug/history`` endpoint and feeds the
alert engine's evaluation cadence (obs/alerts.py) through ``on_sample``.
With ``history_dir=None`` the recorder runs memory-only: alert rules
without durable history construct no files at all.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from knn_tpu_torch import obs
from knn_tpu_torch.obs.metrics import Histogram
from knn_tpu_torch.resilience.errors import DataError

#: Bump on any incompatible change to the segment encoding.
HISTORY_FORMAT = 1

#: Structural schema the hash pins: the set of record/entry fields a
#: reader must understand. Computed over a canonical JSON form so the
#: hash changes exactly when the wire format does.
_SCHEMA = {
    "history": HISTORY_FORMAT,
    "record": ["t", "d", "m"],
    "entry": ["n", "k", "l", "v", "b", "c", "s", "ct"],
    "kinds": ["c", "g", "h"],
}

SCHEMA_HASH = hashlib.sha256(
    json.dumps(_SCHEMA, sort_keys=True).encode("utf-8")
).hexdigest()[:32]

_SEGMENT_RE = re.compile(r"^seg-(\d+)\.jsonl$")

#: Live-ring hard cap — retention/interval bounds it in practice; this
#: protects against pathological flag combos (1h retention @ 1ms).
_RING_MAX = 8192

_KIND_CODE = {"counter": "c", "gauge": "g", "histogram": "h"}


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def parse_window(raw) -> float:
    """``"300"``/``"300s"``/``"5m"``/``"1h"`` -> seconds (float > 0)."""
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        secs = float(raw)
    else:
        text = str(raw).strip().lower()
        mult = 1.0
        if text.endswith("h"):
            mult, text = 3600.0, text[:-1]
        elif text.endswith("m"):
            mult, text = 60.0, text[:-1]
        elif text.endswith("s"):
            text = text[:-1]
        try:
            secs = float(text) * mult
        except ValueError:
            raise ValueError(f"bad window {raw!r}: want e.g. 300, 300s, 5m, 1h")
    if not secs > 0:
        raise ValueError(f"bad window {raw!r}: must be > 0 seconds")
    return secs


# ---------------------------------------------------------------------------
# Sample state: the decoded, absolute view of one snapshot instant.
# key -> ("c"|"g", name, labels, value)
#      | ("h", name, labels, bounds, counts, sum, count)


def _state_from_snapshot(records: List[dict]) -> Dict[tuple, tuple]:
    """Absolute state from an ``aggregate.snapshot_registry()`` listing."""
    state: Dict[tuple, tuple] = {}
    for rec in records:
        kind = _KIND_CODE.get(rec.get("kind"))
        if kind is None:
            continue
        labels = dict(rec.get("labels") or {})
        key = (rec["name"], _label_key(labels))
        if kind == "h":
            state[key] = ("h", rec["name"], labels,
                          tuple(float(b) for b in rec["buckets"]),
                          [int(c) for c in rec["counts"]],
                          float(rec["sum"]), int(rec["count"]))
        else:
            state[key] = (kind, rec["name"], labels, float(rec["value"]))
    return state


def _value_of(entry: tuple) -> float:
    """Scalar view of a state entry: counter/gauge value; histogram COUNT
    (alert rules on histograms alert on observation count)."""
    return float(entry[6] if entry[0] == "h" else entry[3])


class HistoryRecorder:
    """Periodic snapshot writer + live ring. All disk I/O happens on the
    sampling thread (or the caller of ``sample_once`` in tests)."""

    def __init__(self, history_dir: Optional[str], *,
                 interval_s: float = 5.0,
                 retention_s: float = 3600.0,
                 source: str = "serve",
                 sample_fn: Callable[[], List[dict]],
                 on_sample: Optional[Callable[[float, "HistoryRecorder"], None]] = None,
                 clock: Callable[[], float] = time.time,
                 autostart: bool = True):
        if not interval_s > 0:
            raise ValueError("history interval must be > 0 seconds")
        if retention_s < interval_s:
            raise ValueError("history retention must be >= the interval")
        self.history_dir = history_dir
        self.interval_s = float(interval_s)
        self.retention_s = float(retention_s)
        self.source = source
        self.sample_fn = sample_fn
        self.on_sample = on_sample
        self.clock = clock
        # Segments rotate on age so retention (which drops whole segments)
        # has sane granularity: ~8 live segments, never shorter than one
        # interval.
        self.rotate_s = max(self.interval_s, self.retention_s / 8.0)

        self._lock = threading.Lock()
        ring_len = min(_RING_MAX, max(8, int(retention_s / interval_s) + 4))
        self._ring: deque = deque(maxlen=ring_len)
        self._file = None
        self._segment = 0
        self._segment_t0: Optional[float] = None
        self._segments_last_ts: Dict[int, float] = {}
        self._prev: Dict[tuple, tuple] = {}
        self._snapshots = 0
        self._pruned = 0

        if history_dir is not None:
            os.makedirs(history_dir, exist_ok=True)
            self._segment = self._boot_scan(history_dir)

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            name = "knn-history" if history_dir is not None else "knn-alerts"
            self._thread = threading.Thread(
                target=self._loop, name=name, daemon=True)
            self._thread.start()

    # -- boot ----------------------------------------------------------------

    def _boot_scan(self, history_dir: str) -> int:
        """Repair a torn tail left by a crashed predecessor and pick the
        next segment number. Pre-existing segments stay on disk (subject
        to retention); this process always opens a fresh segment so its
        header reflects *this* boot's source/interval."""
        numbers = _list_segments(history_dir)
        if not numbers:
            return 0
        last = numbers[-1]
        path = _segment_path(history_dir, last)
        lines, torn = _read_segment_lines(path, tolerate_torn=True)
        if torn:
            _repair_segment(path, lines)
        # Seed retention bookkeeping so old segments prune promptly.
        for n in numbers:
            try:
                recs = _decode_segment(_segment_path(history_dir, n),
                                       tolerate_torn=(n == last))
                if recs:
                    self._segments_last_ts[n] = recs[-1][0]
            except DataError:
                # A damaged *older* segment must not brick the writer —
                # the post-mortem reader is where strictness matters.
                continue
        return last

    # -- sampling ------------------------------------------------------------

    def _loop(self) -> None:
        # A fixed cadence (JAX waits a whole interval after each sample, so
        # its samples drift by the snapshot's own time). A stall of the
        # thread (the interpreter lock under load) that lets ticks pass
        # skips them: samples never come closer than one interval, and the
        # stall shows as one wide gap.
        due = time.monotonic()
        while True:
            due += self.interval_s
            now = time.monotonic()
            if now > due:
                due += math.ceil((now - due) / self.interval_s) \
                    * self.interval_s
            if self._stop.wait(due - now):
                return
            try:
                self.sample_once()
            except Exception:
                obs.counter_add("knn_history_errors_total",
                                help="History snapshots that raised.")

    def sample_once(self) -> float:
        """Take one snapshot now. Returns the sample timestamp."""
        ts = float(self.clock())
        state = _state_from_snapshot(self.sample_fn())
        with self._lock:
            self._ring.append((ts, state))
            if self.history_dir is not None:
                self._write_sample(ts, state)
            self._snapshots += 1
        obs.counter_add("knn_history_snapshots_total",
                        help="Metrics-history snapshots taken.")
        if self.on_sample is not None:
            try:
                self.on_sample(ts, self)
            except Exception:
                obs.counter_add("knn_history_errors_total",
                                help="History snapshots that raised.")
        return ts

    def _write_sample(self, ts: float, state: Dict[tuple, tuple]) -> None:
        rotate = (self._file is None
                  or (self._segment_t0 is not None
                      and ts - self._segment_t0 >= self.rotate_s))
        if rotate:
            self._open_segment(ts)
            record = _encode_base(ts, state)
        else:
            record = _encode_delta(ts, state, self._prev)
        self._prev = state
        self._segments_last_ts[self._segment] = ts
        if record is not None:
            try:
                self._file.write(
                    json.dumps(record, separators=(",", ":")) + "\n")
                self._file.flush()
            except (OSError, ValueError):
                pass  # a full disk must never take down serving
        self._prune(ts)

    def _open_segment(self, ts: float) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        self._segment += 1
        self._segment_t0 = ts
        path = _segment_path(self.history_dir, self._segment)
        self._file = open(path, "a", buffering=1, encoding="utf-8")
        header = {"history": HISTORY_FORMAT, "segment": self._segment,
                  "schema_hash": SCHEMA_HASH, "source": self.source,
                  "interval_s": self.interval_s, "created_unix": round(ts, 3)}
        self._file.write(json.dumps(header, separators=(",", ":")) + "\n")
        self._file.flush()
        obs.gauge_set("knn_history_segment", self._segment,
                      help="Current history segment number.")

    def _prune(self, now: float) -> None:
        cutoff = now - self.retention_s
        for n in sorted(self._segments_last_ts):
            if n == self._segment:
                continue
            if self._segments_last_ts[n] < cutoff:
                try:
                    os.unlink(_segment_path(self.history_dir, n))
                except OSError:
                    pass
                del self._segments_last_ts[n]
                self._pruned += 1
                obs.counter_add("knn_history_pruned_total",
                                help="History segments dropped by retention.")

    # -- live queries (the /debug/history + alert-engine view) ---------------

    def samples(self) -> List[Tuple[float, Dict[tuple, tuple]]]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> Optional[Tuple[float, Dict[tuple, tuple]]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def query(self, *, metric=None, labels=None, window_s=None) -> dict:
        return query_samples(self.samples(), metric=metric, labels=labels,
                             window_s=window_s)

    def status(self) -> dict:
        with self._lock:
            return {
                "dir": self.history_dir,
                "interval_s": self.interval_s,
                "retention_s": self.retention_s,
                "segment": self._segment,
                "snapshots": self._snapshots,
                "pruned_segments": self._pruned,
                "ring_points": len(self._ring),
            }

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # One final snapshot so the on-disk record extends to shutdown.
        try:
            self.sample_once()
        except Exception:
            pass
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# ---------------------------------------------------------------------------
# Encoding


def _encode_base(ts: float, state: Dict[tuple, tuple]) -> dict:
    entries = []
    for key in sorted(state):
        e = state[key]
        if e[0] == "h":
            entries.append({"n": e[1], "k": "h", "l": e[2],
                            "b": list(e[3]), "c": list(e[4]),
                            "s": e[5], "ct": e[6]})
        else:
            entries.append({"n": e[1], "k": e[0], "l": e[2], "v": e[3]})
    return {"t": round(ts, 3), "d": 0, "m": entries}


def _encode_delta(ts: float, state: Dict[tuple, tuple],
                  prev: Dict[tuple, tuple]) -> Optional[dict]:
    entries = []
    for key in sorted(state):
        e = state[key]
        p = prev.get(key)
        if e[0] == "h":
            if p is None or p[0] != "h" or p[3] != e[3]:
                # New histogram (or rebuilt with different bounds):
                # absolute entry, bounds included.
                entries.append({"n": e[1], "k": "h", "l": e[2],
                                "b": list(e[3]), "c": list(e[4]),
                                "s": e[5], "ct": e[6]})
                continue
            dc = [a - b for a, b in zip(e[4], p[4])]
            dcount = e[6] - p[6]
            if dcount or any(dc):
                entries.append({"n": e[1], "k": "h", "l": e[2], "c": dc,
                                "s": round(e[5] - p[5], 9), "ct": dcount})
        elif e[0] == "c":
            base = p[3] if p is not None and p[0] == "c" else 0.0
            dv = e[3] - base
            if dv:
                entries.append({"n": e[1], "k": "c", "l": e[2], "v": dv})
        else:  # gauge: absolute, only when changed
            if p is None or p[0] != "g" or p[3] != e[3]:
                entries.append({"n": e[1], "k": "g", "l": e[2], "v": e[3]})
    if not entries:
        return {"t": round(ts, 3), "d": 1, "m": []}
    return {"t": round(ts, 3), "d": 1, "m": entries}


# ---------------------------------------------------------------------------
# Reading (post-mortem + CLI)


def _segment_path(history_dir: str, n: int) -> str:
    return os.path.join(history_dir, f"seg-{n}.jsonl")


def _list_segments(history_dir: str) -> List[int]:
    out = []
    try:
        names = os.listdir(history_dir)
    except OSError:
        return out
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _read_segment_lines(path: str, tolerate_torn: bool
                        ) -> Tuple[List[dict], bool]:
    """Parse a segment's JSON lines. A bad FINAL line is the crash
    signature and returns ``(good_lines, True)`` when tolerated; a bad
    line anywhere else — or an intolerable final line — is ``DataError``."""
    with open(path, "r", encoding="utf-8") as f:
        raw = f.read().split("\n")
    if raw and raw[-1] == "":
        raw.pop()
    out: List[dict] = []
    for i, line in enumerate(raw):
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("not an object")
        except ValueError:
            if tolerate_torn and i == len(raw) - 1:
                return out, True
            raise DataError(
                f"{path}:{i + 1}: corrupt history record "
                "(only a torn final line of the last segment is repairable)")
        out.append(rec)
    return out, False


def _repair_segment(path: str, lines: List[dict]) -> None:
    """Atomically rewrite a segment minus its torn tail (WAL idiom:
    write tmp, fsync, rename over)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for rec in lines:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _decode_segment(path: str, tolerate_torn: bool
                    ) -> List[Tuple[float, Dict[tuple, tuple]]]:
    lines, _torn = _read_segment_lines(path, tolerate_torn)
    if not lines:
        return []
    header = lines[0]
    if header.get("history") != HISTORY_FORMAT:
        raise DataError(
            f"{path}: unsupported history format {header.get('history')!r} "
            f"(this build reads format {HISTORY_FORMAT})")
    if header.get("schema_hash") != SCHEMA_HASH:
        raise DataError(
            f"{path}: schema hash {header.get('schema_hash')!r} != "
            f"{SCHEMA_HASH} — segment written by an incompatible build")
    samples: List[Tuple[float, Dict[tuple, tuple]]] = []
    # Reconstruction registry: one Histogram per key, folded through
    # merge_counts exactly like the multihost aggregator.
    hists: Dict[tuple, Histogram] = {}
    state: Dict[tuple, tuple] = {}
    for i, rec in enumerate(lines[1:], start=2):
        try:
            ts = float(rec["t"])
            delta = int(rec.get("d", 0))
            entries = rec["m"]
        except (KeyError, TypeError, ValueError):
            raise DataError(f"{path}:{i}: malformed history record")
        if delta == 0:
            state, hists = {}, {}
        for ent in entries:
            try:
                _apply_entry(ent, delta, state, hists)
            except (KeyError, TypeError, ValueError, IndexError) as exc:
                raise DataError(f"{path}:{i}: bad history entry: {exc}")
        samples.append((ts, _freeze_state(state, hists)))
    return samples


def _apply_entry(ent: dict, delta: int, state: Dict[tuple, tuple],
                 hists: Dict[tuple, Histogram]) -> None:
    kind = ent["k"]
    labels = dict(ent.get("l") or {})
    key = (ent["n"], _label_key(labels))
    if kind == "h":
        if "b" in ent or key not in hists:
            bounds = ent["b"]
            h = Histogram(ent["n"], _label_key(labels), buckets=bounds)
            h.merge_counts(ent["c"], float(ent["s"]), int(ent["ct"]))
            hists[key] = h
            state[key] = ("h", ent["n"], labels)
        else:
            hists[key].merge_counts(ent["c"], float(ent["s"]), int(ent["ct"]))
    elif kind == "c":
        base = 0.0
        if delta and key in state and state[key][0] == "c":
            base = state[key][3]
        state[key] = ("c", ent["n"], labels, base + float(ent["v"]))
    elif kind == "g":
        state[key] = ("g", ent["n"], labels, float(ent["v"]))
    else:
        raise ValueError(f"unknown instrument kind {kind!r}")


def _freeze_state(state: Dict[tuple, tuple],
                  hists: Dict[tuple, Histogram]) -> Dict[tuple, tuple]:
    out: Dict[tuple, tuple] = {}
    for key, e in state.items():
        if e[0] == "h":
            h = hists[key]
            out[key] = ("h", e[1], e[2], h.buckets, h.bucket_counts(),
                        h.sum, h.count)
        else:
            out[key] = e
    return out


class History:
    """Decoded on-disk history: ordered absolute samples across segments."""

    def __init__(self, history_dir: str,
                 samples: List[Tuple[float, Dict[tuple, tuple]]],
                 segments: List[int], repaired: bool):
        self.history_dir = history_dir
        self.samples = samples
        self.segments = segments
        self.repaired = repaired

    def query(self, *, metric=None, labels=None, window_s=None) -> dict:
        return query_samples(self.samples, metric=metric, labels=labels,
                             window_s=window_s)


def load_history(history_dir: str, *, repair: bool = True) -> History:
    """Read every segment under ``history_dir``. The final segment's torn
    tail is tolerated (and repaired in place when ``repair`` and the
    directory is writable); damage anywhere else raises ``DataError``."""
    if not os.path.isdir(history_dir):
        raise DataError(f"{history_dir}: not a history directory")
    numbers = _list_segments(history_dir)
    if not numbers:
        raise DataError(f"{history_dir}: no history segments (seg-*.jsonl)")
    repaired = False
    samples: List[Tuple[float, Dict[tuple, tuple]]] = []
    for n in numbers:
        path = _segment_path(history_dir, n)
        is_last = n == numbers[-1]
        if is_last and repair:
            lines, torn = _read_segment_lines(path, tolerate_torn=True)
            if torn:
                try:
                    _repair_segment(path, lines)
                    repaired = True
                except OSError:
                    pass  # read-only dir: still tolerated, just not repaired
        samples.extend(_decode_segment(path, tolerate_torn=is_last))
    samples.sort(key=lambda s: s[0])
    return History(history_dir, samples, numbers, repaired)


# ---------------------------------------------------------------------------
# Queries (shared by the live ring, the CLI, and the report generator)


def query_samples(samples, *, metric=None, labels=None, window_s=None,
                  t_from=None, t_to=None) -> dict:
    """Series view over absolute samples. ``labels`` is a subset match;
    ``window_s`` is trailing from the newest sample (ignored when an
    explicit ``t_from``/``t_to`` range is given)."""
    if samples:
        hi = t_to if t_to is not None else samples[-1][0]
        if t_from is not None:
            lo = t_from
        elif window_s is not None:
            lo = hi - float(window_s)
        else:
            lo = samples[0][0]
    else:
        lo = hi = 0.0
    want = dict(labels or {})
    series: Dict[tuple, dict] = {}
    for ts, state in samples:
        if ts < lo or ts > hi:
            continue
        for key, e in state.items():
            if metric is not None and e[1] != metric:
                continue
            if want and any(e[2].get(k) != v for k, v in want.items()):
                continue
            s = series.get(key)
            if s is None:
                s = series[key] = {"name": e[1],
                                   "kind": {"c": "counter", "g": "gauge",
                                            "h": "histogram"}[e[0]],
                                   "labels": e[2], "points": []}
            if e[0] == "h":
                s["points"].append([round(ts, 3), e[6], round(e[5], 6)])
                s["buckets"] = list(e[3])
                s["counts"] = list(e[4])
            else:
                s["points"].append([round(ts, 3), e[3]])
    out = [series[k] for k in sorted(series)]
    return {"metric": metric, "labels": want,
            "window": {"from": round(lo, 3), "to": round(hi, 3)},
            "series": out}
