"""Deterministic workload replay: re-drive a captured trace, verify it
(the port of ``knn_tpu/obs/replay.py``).

The capture half (:mod:`knn_tpu_torch.obs.workload`) records what
happened; this module makes it happen AGAIN — open-loop, with the original
inter-arrival timing (or scaled by ``--speed``) — against either an
in-process :class:`~knn_tpu_torch.serve.batcher.MicroBatcher` on the card
or a live server over HTTP, and checks the answers:

- **reads** fire at their recorded arrival offsets without waiting for
  earlier completions (open-loop: a slow target builds queue, exactly as
  the original traffic would have), each resolved on a waiter pool that
  records its wall and answer digest;
- **mutations** replay in ``mutation_seq`` order as sequence points:
  every outstanding read drains first, then the mutation is applied and
  acknowledged — in process through the batcher's
  ``submit_mutation`` (its mutable engine; ``replay --mutable on``),
  against a live server through ``/insert`` and ``/delete``. A failed one
  is recorded in the verdict, never silently dropped;
- **verification**: wherever a replayed answer's
  ``(index_version, mutation_seq)`` matches the recorded one (``tag``),
  or for every answered pair (``always``), the answer digests must match
  BIT-IDENTICALLY (:func:`~knn_tpu_torch.obs.workload.answer_digest`,
  transport-independent, so a JSON body verifies against an in-process
  capture). Tag mismatches are counted ``skipped``, never divergences.

The verdict dict (``replay --verdict-out``) carries measured p50/p99/QPS
next to the CAPTURED run's numbers and the verification counts, in the
JAX package's layout.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from knn_tpu_torch.obs.workload import Workload, answer_digest

VERIFY_MODES = ("tag", "always", "off")

#: Seconds a replayed read or mutation may take before it is recorded as a
#: failure.
TIMEOUT_S = 120.0


class _Results:
    """Thread-safe collection of per-event replay outcomes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reads: list = []       # (event, result dict)
        self.mutations: list = []   # (event, result dict)

    def add_read(self, ev, res) -> None:
        with self._lock:
            self.reads.append((ev, res))

    def add_mutation(self, ev, res) -> None:
        with self._lock:
            self.mutations.append((ev, res))


def _resolve_inproc(ev, handle, t0, results: _Results,
                    timeout_s: float) -> None:
    try:
        value = handle.result(timeout=timeout_s)
    except Exception as e:  # noqa: BLE001 — a typed failure is an outcome
        results.add_read(ev, {
            "outcome": "error", "error": f"{type(e).__name__}: {e}",
            "ms": (time.monotonic() - t0) * 1e3,
        })
        return
    meta = handle.meta or {}
    results.add_read(ev, {
        "outcome": "ok",
        "ms": (time.monotonic() - t0) * 1e3,
        "rung": meta.get("rung"),
        "index_version": meta.get("index_version"),
        "mutation_seq": meta.get("mutation_seq"),
        "digest": answer_digest(ev["kind"], value),
    })


def _http_json(base_url: str, path: str, payload: dict,
               headers: Optional[dict] = None, timeout_s: float = 60.0):
    req = urllib.request.Request(
        base_url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode())
        except ValueError:
            body = {}
        return e.code, body


def _http_read(ev, rows, base_url, results: _Results,
               timeout_s: float) -> None:
    payload = {"instances": rows.tolist()}
    if ev.get("deadline_ms") is not None:
        payload["deadline_ms"] = ev["deadline_ms"]
    if ev.get("class") is not None:
        payload["class"] = ev["class"]
    t0 = time.monotonic()
    try:
        status, body = _http_json(base_url, "/" + ev["kind"], payload,
                                  timeout_s=timeout_s)
    except Exception as e:  # noqa: BLE001 — connection-level failure
        results.add_read(ev, {
            "outcome": "error", "error": f"{type(e).__name__}: {e}",
            "ms": (time.monotonic() - t0) * 1e3,
        })
        return
    ms = (time.monotonic() - t0) * 1e3
    if status != 200:
        results.add_read(ev, {
            "outcome": "error", "ms": ms, "status": status,
            "error": str(body.get("error", ""))[:200],
        })
        return
    if ev["kind"] == "predict":
        value = np.asarray(body["predictions"], dtype=np.float64)
    else:
        value = (np.asarray(body["distances"], dtype=np.float64),
                 np.asarray(body["indices"], dtype=np.float64))
    results.add_read(ev, {
        "outcome": "ok", "ms": ms,
        "index_version": body.get("index_version"),
        "mutation_seq": body.get("mutation_seq"),
        "digest": answer_digest(ev["kind"], value),
    })


def _fire_mutation(ev, workload: Workload, batcher, base_url,
                   results: _Results, timeout_s: float) -> None:
    """Apply one mutation and WAIT for its ack (the sequence-point
    barrier — see the module docstring); a failure is recorded, never
    raised."""
    try:
        if ev["op"] == "insert":
            rows, values = workload.rows_for(ev), ev.get("values")
            payload = {"rows": rows, "values": values}
            body = {"rows": rows.tolist(), "labels": values}
        else:
            payload = body = {"ids": ev.get("ids", [])}
        if batcher is not None:
            out = batcher.submit_mutation(ev["op"], payload).result(
                timeout=timeout_s)
        else:
            st, out = _http_json(base_url, f"/{ev['op']}", body,
                                 timeout_s=timeout_s)
            if st != 200:
                raise RuntimeError(
                    f"/{ev['op']} {st}: {out.get('error', '')}")
        results.add_mutation(ev, {
            "outcome": "ok",
            "seq": out.get("seq") if isinstance(out, dict) else None,
        })
    except Exception as e:  # noqa: BLE001 — recorded per mutation
        results.add_mutation(ev, {
            "outcome": "error",
            "error": f"{type(e).__name__}: {e}",
        })


def replay_workload(workload: Workload, *, batcher=None,
                    base_url: Optional[str] = None, speed: float = 1.0,
                    verify: str = "tag",
                    replay_mutations: bool = True) -> dict:
    """Re-drive ``workload`` and return the verdict dict.

    Exactly one of ``batcher`` (in-process) / ``base_url`` (live server)
    must be given. ``speed`` scales the arrival clock (2.0 = twice as
    fast; 0 = no pacing, fire as fast as the replay loop runs).
    ``verify``: ``tag`` (default) checks digests only at matching
    ``(index_version, mutation_seq)``; ``always`` checks every ok/ok
    pair (for replays against a rebuilt-but-identical index whose
    version TAG necessarily moved); ``off`` skips verification.

    The waiter/HTTP pool has one thread per read, capped at 128, so
    open-loop pacing and latency stay faithful up to 128 concurrently
    outstanding requests (past that, HTTP reads fire late and in-process
    walls absorb the waiters' pickup delay). Each read or mutation waits
    at most ``TIMEOUT_S``.
    """
    if (batcher is None) == (base_url is None):
        raise ValueError("exactly one of batcher / base_url is required")
    if verify not in VERIFY_MODES:
        raise ValueError(f"verify must be one of {VERIFY_MODES}, got "
                         f"{verify!r}")
    if speed < 0:
        raise ValueError(f"speed must be >= 0, got {speed}")
    from concurrent.futures import ThreadPoolExecutor

    results = _Results()
    events = workload.events
    mutations = workload.mutation_events
    pool_size = min(128, max(16, len(workload.read_events)))
    timeout_s = TIMEOUT_S
    skipped_mutations = 0 if (replay_mutations or not mutations) \
        else len(mutations)
    late_fires = 0
    t_start = time.monotonic()
    with ThreadPoolExecutor(max_workers=pool_size,
                            thread_name_prefix="knn-replay") as pool:
        outstanding: list = []
        for ev in events:
            if speed > 0:
                target = t_start + (ev["t_ms"] / 1e3) / speed
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                elif -delay > 0.05:
                    late_fires += 1
            if "op" in ev:
                if replay_mutations:
                    # A sequence-point barrier is two-sided: drain every
                    # outstanding read FIRST (a mutation applies between
                    # dispatches and would otherwise jump reads still
                    # queued, serving them at a later mutation_seq than
                    # the capture recorded — the flake this closes), then
                    # apply and wait for the ack.
                    for f in outstanding:
                        f.result()
                    outstanding.clear()
                    _fire_mutation(ev, workload, batcher, base_url,
                                   results, timeout_s)
                continue
            rows = workload.rows_for(ev)
            if batcher is not None:
                t0 = time.monotonic()
                try:
                    handle = batcher.submit(
                        rows, ev["kind"],
                        deadline_ms=ev.get("deadline_ms"),
                        request_class=ev.get("class"),
                    )
                except Exception as e:  # noqa: BLE001 — typed admission
                    results.add_read(ev, {
                        "outcome": "error",
                        "error": f"{type(e).__name__}: {e}", "ms": 0.0,
                    })
                    continue
                outstanding.append(pool.submit(
                    _resolve_inproc, ev, handle, t0, results, timeout_s))
            else:
                outstanding.append(pool.submit(
                    _http_read, ev, rows, base_url, results, timeout_s))
    wall_s = max(time.monotonic() - t_start, 1e-9)

    # -- verdict -------------------------------------------------------------
    ok_ms = sorted(r["ms"] for _e, r in results.reads
                   if r["outcome"] == "ok")
    errors = [(e, r) for e, r in results.reads if r["outcome"] != "ok"]
    verified = divergent = skipped_tag = unverifiable = 0
    divergence_samples = []
    for ev, res in results.reads:
        if verify == "off":
            break
        if (ev.get("outcome") != "ok" or ev.get("digest") is None
                or res["outcome"] != "ok"):
            unverifiable += 1
            continue
        if verify == "tag" and (
                ev.get("index_version") != res.get("index_version")
                or ev.get("mutation_seq") != res.get("mutation_seq")):
            skipped_tag += 1
            continue
        if res["digest"] == ev["digest"]:
            verified += 1
        else:
            divergent += 1
            if len(divergence_samples) < 8:
                divergence_samples.append({
                    "id": ev.get("id"),
                    "request_id": ev.get("request_id"),
                    "kind": ev["kind"],
                    "t_ms": ev["t_ms"],
                    "captured_digest": ev["digest"],
                    "replayed_digest": res["digest"],
                    "index_version": res.get("index_version"),
                    "mutation_seq": res.get("mutation_seq"),
                })
    mut_ok = sum(1 for _e, r in results.mutations
                 if r["outcome"] == "ok")
    mut_seq_aligned = sum(
        1 for e, r in results.mutations
        if r["outcome"] == "ok" and r.get("seq") == e.get("seq")
    )
    measured = {
        "requests": len(results.reads),
        "ok": len(ok_ms),
        "errors": len(errors),
        "wall_s": round(wall_s, 3),
        "qps": round(len(results.reads) / wall_s, 2),
        "late_fires": late_fires,
    }
    if ok_ms:
        arr = np.asarray(ok_ms)
        measured["p50_ms"] = round(float(np.percentile(arr, 50)), 3)
        measured["p99_ms"] = round(float(np.percentile(arr, 99)), 3)
        measured["mean_ms"] = round(float(arr.mean()), 3)
    else:
        measured["p50_ms"] = measured["p99_ms"] = measured["mean_ms"] = None
    return {
        "workload": {
            "path": str(workload.path),
            "requests": workload.manifest["requests"],
            "mutations": workload.manifest["mutations"],
            "duration_ms": workload.manifest.get("duration_ms"),
            "policy": workload.manifest.get("policy"),
            "index_version": workload.manifest.get("index_version"),
            "mutation_stream_complete": workload.manifest.get(
                "mutation_stream_complete", True),
        },
        "target": "in-process" if batcher is not None else base_url,
        "speed": speed,
        "measured": measured,
        "captured": workload.captured_latency_summary(),
        "verify": {
            "mode": verify,
            "verified": verified,
            "divergences": divergent,
            "skipped_tag_mismatch": skipped_tag,
            "unverifiable": unverifiable,
            "divergence_samples": divergence_samples,
        },
        "mutations": {
            "fired": len(results.mutations),
            "ok": mut_ok,
            "seq_aligned": mut_seq_aligned,
            "skipped": skipped_mutations,
            "error_samples": [
                r.get("error") for _e, r in results.mutations
                if r["outcome"] != "ok"
            ][:4],
        },
        "error_samples": [
            {"id": e.get("id"), "error": r.get("error"),
             "status": r.get("status")} for e, r in errors
        ][:8],
    }
