"""One-command incident reports: ``python -m knn_tpu_torch report --history
DIR`` (the port's copy of ``knn_tpu/obs/report.py``; its JSON document
equals the JAX package's on the same directory).

Stitches everything a post-mortem needs out of artifacts that already
exist on disk — no live process required:

* the durable metrics history (obs/history.py segments),
* alert fire/resolve pairs and action outcomes (``alerts.jsonl``),
* flight-recorder slowest-K dumps frozen at fire time (``forensics/``),
* alert-armed device profiles (``profiles/``),
* workload-capture manifests (``--captures DIR``, the serve process's
  ``--capture-dir``) — alert-armed captures carry ``reason=alert:<name>``,
* access-log error lines (``--access-log FILE``),

into a single JSON document plus a markdown rendering with ONE merged
timeline. Generation is deterministic: every timestamp comes from the
artifacts, never from the wall clock, so the same inputs always produce
byte-identical output (testable, diffable, attachable to a ticket).
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

from knn_tpu_torch.obs import history as history_mod
from knn_tpu_torch.resilience.errors import DataError

#: Error access-log lines kept on the timeline (the log itself is the
#: full record; the report is a summary).
_MAX_ERROR_LINES = 100


def _read_jsonl_tolerant(path: str) -> List[dict]:
    """Audit-log reader with the WAL-tail rule: a torn FINAL line is a
    crash signature and is dropped; garbage anywhere else is damage."""
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
            if i == len(raw) - 1:
                break
            raise DataError(f"{path}:{i + 1}: corrupt record")
        out.append(rec)
    return out


def _scan_captures(captures_dir: str) -> List[dict]:
    out = []
    try:
        names = sorted(os.listdir(captures_dir))
    except OSError:
        return out
    for name in names:
        manifest = os.path.join(captures_dir, name, "manifest.json")
        if not (name.startswith("workload-") and os.path.isfile(manifest)):
            continue
        try:
            with open(manifest, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        out.append({"path": os.path.join(captures_dir, name),
                    "reason": doc.get("reason"),
                    "t0_unix": doc.get("t0_unix"),
                    "records": doc.get("records"),
                    "stop_reason": doc.get("stop_reason")})
    return out


def _scan_dumps(dirpath: str, pattern: str) -> List[dict]:
    """Forensics/profile artifacts named ``<kind>-<alert>-<ms>.json``."""
    out = []
    rx = re.compile(pattern)
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return out
    for name in names:
        m = rx.match(name)
        if m:
            out.append({"path": os.path.join(dirpath, name),
                        "alert": m.group(1),
                        "ts": int(m.group(2)) / 1000.0})
    return out


def build_report(history_dir: str, *,
                 window: Optional[float] = None,
                 access_log: Optional[str] = None,
                 captures: Optional[str] = None) -> dict:
    """Assemble the incident-report document. ``window`` (seconds) trails
    back from the newest timestamp found in ANY artifact, so a report
    over a crashed process's directory covers right up to the crash."""
    hist = history_mod.load_history(history_dir)
    alerts_path = os.path.join(history_dir, "alerts.jsonl")
    alert_entries = (_read_jsonl_tolerant(alerts_path)
                     if os.path.isfile(alerts_path) else [])
    capture_entries = _scan_captures(captures) if captures else []
    forensics = _scan_dumps(os.path.join(history_dir, "forensics"),
                            r"^slowest-(.+)-(\d+)\.json$")
    profiles = _scan_dumps(os.path.join(history_dir, "profiles"),
                           r"^profile-(.+)-(\d+)\.json$")

    all_ts = [s[0] for s in hist.samples]
    all_ts += [e["ts"] for e in alert_entries if isinstance(e.get("ts"), (int, float))]
    all_ts += [c["t0_unix"] for c in capture_entries
               if isinstance(c.get("t0_unix"), (int, float))]
    if not all_ts:
        raise DataError(f"{history_dir}: nothing to report on")
    t_hi = max(all_ts)
    t_lo = t_hi - window if window is not None else min(all_ts)

    def in_window(ts) -> bool:
        return isinstance(ts, (int, float)) and t_lo <= ts <= t_hi

    timeline: List[dict] = []
    fires = resolves = 0
    for e in alert_entries:
        if not in_window(e.get("ts")):
            continue
        event = e.get("event")
        if event == "fire":
            fires += 1
            summary = (f"alert {e.get('alert')} FIRED "
                       f"(severity={e.get('severity')}, value={e.get('value')})")
        elif event == "resolve":
            resolves += 1
            summary = f"alert {e.get('alert')} resolved (value={e.get('value')})"
        elif event == "action":
            summary = (f"action {e.get('action')} on {e.get('alert')} "
                       f"({e.get('on')}): {e.get('outcome')}")
        else:
            summary = f"alert {e.get('alert')}: {event}"
        timeline.append({"ts": round(float(e["ts"]), 3), "kind": f"alert-{event}",
                         "summary": summary, **{k: v for k, v in e.items()
                                                if k not in ("ts", "event")}})
    for c in capture_entries:
        if not in_window(c.get("t0_unix")):
            continue
        timeline.append({
            "ts": round(float(c["t0_unix"]), 3), "kind": "capture",
            "summary": (f"workload capture ({c.get('reason')}): "
                        f"{c.get('records')} records, "
                        f"stop={c.get('stop_reason')}"),
            "reason": c.get("reason"), "path": c["path"]})
    for f in forensics:
        if in_window(f["ts"]):
            timeline.append({"ts": round(f["ts"], 3), "kind": "forensics",
                             "summary": f"slowest-K frozen for {f['alert']}",
                             "path": f["path"]})
    for p in profiles:
        if in_window(p["ts"]):
            timeline.append({"ts": round(p["ts"], 3), "kind": "profile",
                             "summary": f"device profile for {p['alert']}",
                             "path": p["path"]})

    access = None
    if access_log and os.path.isfile(access_log):
        lines = _read_jsonl_tolerant(access_log)
        total = errors = 0
        err_lines = []
        for rec in lines:
            if not in_window(rec.get("ts")):
                continue
            total += 1
            status = rec.get("status")
            if isinstance(status, int) and status >= 400:
                errors += 1
                if len(err_lines) < _MAX_ERROR_LINES:
                    err_lines.append(rec)
        for rec in err_lines:
            timeline.append({
                "ts": round(float(rec["ts"]), 3), "kind": "request-error",
                "summary": (f"{rec.get('kind')} {rec.get('status')} "
                            f"{rec.get('outcome')} "
                            f"({rec.get('ms')} ms, rung={rec.get('rung')}, "
                            f"id={rec.get('request_id')})"),
                "request_id": rec.get("request_id")})
        access = {"path": access_log, "requests": total, "errors": errors,
                  "error_lines_on_timeline": len(err_lines)}

    timeline.sort(key=lambda e: (e["ts"], e["kind"], e["summary"]))

    metrics = _summarize_metrics(hist.samples, t_lo, t_hi)
    return {
        "report": 1,
        "history_dir": history_dir,
        "window": {"from": round(t_lo, 3), "to": round(t_hi, 3),
                   "seconds": round(t_hi - t_lo, 3)},
        "history": {"segments": len(hist.segments),
                    "samples": len(hist.samples),
                    "repaired_torn_tail": hist.repaired},
        "alerts": {"fires": fires, "resolves": resolves,
                   "entries": len(alert_entries)},
        "captures": capture_entries,
        "access_log": access,
        "timeline": timeline,
        "metrics": metrics,
    }


def _summarize_metrics(samples, t_lo, t_hi) -> List[dict]:
    """Per-series digest over the window: counters report their delta,
    gauges min/last/max, histograms observation-count delta + mean."""
    first: dict = {}
    last: dict = {}
    lo: dict = {}
    hi: dict = {}
    for ts, state in samples:
        if ts < t_lo or ts > t_hi:
            continue
        for key, e in state.items():
            v = history_mod._value_of(e)
            if key not in first:
                first[key] = (e, v)
                lo[key] = hi[key] = v
            lo[key] = min(lo[key], v)
            hi[key] = max(hi[key], v)
            last[key] = (e, v)
    out = []
    for key in sorted(first):
        e0, v0 = first[key]
        e1, v1 = last[key]
        row = {"name": e1[1], "kind": {"c": "counter", "g": "gauge",
                                       "h": "histogram"}[e1[0]],
               "labels": e1[2]}
        if e1[0] == "c":
            row["delta"] = round(v1 - v0, 6)
            row["last"] = round(v1, 6)
        elif e1[0] == "g":
            row.update(min=round(lo[key], 6), max=round(hi[key], 6),
                       last=round(v1, 6))
        else:
            row["count_delta"] = int(v1 - v0)
            dsum = e1[5] - e0[5]
            row["sum_delta"] = round(dsum, 6)
            if v1 > v0:
                row["mean"] = round(dsum / (v1 - v0), 6)
        out.append(row)
    return out


def render_markdown(doc: dict) -> str:
    w = doc["window"]
    lines = [
        "# Incident report",
        "",
        f"History: `{doc['history_dir']}` — {doc['history']['segments']} "
        f"segment(s), {doc['history']['samples']} snapshot(s)"
        + (" (torn tail repaired)" if doc["history"]["repaired_torn_tail"]
           else ""),
        f"Window: {w['from']} .. {w['to']} ({w['seconds']}s)",
        f"Alerts: {doc['alerts']['fires']} fire(s), "
        f"{doc['alerts']['resolves']} resolve(s)",
    ]
    if doc.get("access_log"):
        a = doc["access_log"]
        lines.append(f"Requests: {a['requests']} in window, "
                     f"{a['errors']} error(s)")
    lines += ["", "## Timeline", ""]
    if doc["timeline"]:
        lines += ["| t | kind | event |", "|---|---|---|"]
        for e in doc["timeline"]:
            summary = e["summary"].replace("|", "\\|")
            lines.append(f"| {e['ts']} | {e['kind']} | {summary} |")
    else:
        lines.append("(no events in window)")
    if doc["captures"]:
        lines += ["", "## Workload captures", ""]
        for c in doc["captures"]:
            lines.append(f"- `{c['path']}` — reason={c['reason']}, "
                         f"records={c['records']}, stop={c['stop_reason']}")
    lines += ["", "## Metrics", ""]
    rows = doc["metrics"]
    if rows:
        lines += ["| metric | labels | summary |", "|---|---|---|"]
        for r in rows:
            labels = ",".join(f"{k}={v}" for k, v in sorted(r["labels"].items()))
            if r["kind"] == "counter":
                s = f"+{r['delta']} (last {r['last']})"
            elif r["kind"] == "gauge":
                s = f"min {r['min']} / max {r['max']} / last {r['last']}"
            else:
                s = f"count +{r['count_delta']}"
                if "mean" in r:
                    s += f", mean {r['mean']}"
            lines.append(f"| {r['name']} | {labels} | {s} |")
    else:
        lines.append("(no metrics in window)")
    lines.append("")
    return "\n".join(lines)
