"""What-if batching simulation: cost a candidate policy in milliseconds
(the port's copy of ``knn_tpu/obs/whatif.py``; numpy only, its results
bit-equal to JAX's on the same arrivals).

Changing ``max_batch`` / ``max_wait_ms`` / the compiled shape buckets on a
live replica means a reboot-warm-measure cycle per candidate. This module
replaces that loop with a **discrete-event simulator** of the batcher's
admission/coalesce policy (``serve/batcher.py::_collect``'s exact rules)
driven by a CAPTURED arrival process (:mod:`knn_tpu_torch.obs.workload`) and
costed by the capacity model's fitted affine dispatch cost
``w(r) = a + b·r`` (:mod:`knn_tpu_torch.obs.capacity`) — so a whole
policy frontier (predicted p50/p99/occupancy/waste per candidate) comes
back in milliseconds without booting a server.

What is modeled — exactly the single-worker batcher:

- one worker; FIFO queue; while the worker is busy, arrivals queue;
- a batch closes at the earlier of ``max_wait_ms`` from the OLDEST queued
  arrival or queued rows reaching ``max_batch`` (and never before the
  worker is free — an expired window dispatches immediately at pickup);
- whole requests only, greedily packed up to ``max_batch`` rows; a
  single request larger than ``max_batch`` dispatches alone, chunked
  (paying the intercept ``a`` once per chunk, the same rule the capacity
  fit excludes chunked dispatches for);
- a dispatch of ``rows`` costs ``a + b·padded(rows)`` ms, where
  ``padded`` quantizes to the policy's shape buckets (pad to the next
  bucket; the ladder is an argument, never process-wide state) or is
  ``rows`` itself for the bucket-less live policy, matching how the fit
  was measured.

What is NOT modeled: HTTP handler overhead, GC/scheduler jitter,
deadline expiries, the degradation ladder, and mutations — which is why
the autotuner (:mod:`knn_tpu_torch.control.autotune`) applies a candidate
only after a replay on the live batcher proves it.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np


def padded_rows(rows: int, buckets: Optional[Sequence[int]],
                max_batch: int) -> int:
    """The compiled-shape rows a dispatch of ``rows`` pays under a shape
    bucket policy: the smallest bucket >= rows (``max_batch`` tops the
    ladder implicitly); bucket-less policies pay the actual rows."""
    if not buckets:
        return rows
    for b in buckets:
        if rows <= b:
            return int(b)
    return max(rows, int(max_batch))


def simulate(arrivals: Sequence, *, max_batch: int, max_wait_ms: float,
             a_ms: float, b_ms_per_row: float,
             buckets: Optional[Sequence[int]] = None) -> dict:
    """Run the arrival process through one candidate policy.

    ``arrivals`` — ``[(t_ms, rows)]``, sorted by time (a
    :meth:`~knn_tpu_torch.obs.workload.Workload.arrivals` list).
    Returns the predicted serving summary: per-request latency
    percentiles, dispatch count, occupancy, padded-row waste, duty cycle.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if max_wait_ms < 0:
        raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
    if a_ms < 0 or b_ms_per_row < 0:
        raise ValueError(
            f"dispatch cost must be non-negative, got a={a_ms}, "
            f"b={b_ms_per_row}")
    if buckets is not None:
        buckets = sorted({int(b) for b in buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints: {buckets}")
    arrivals = sorted((float(t), int(r)) for t, r in arrivals)
    n = len(arrivals)
    if n == 0:
        return {"requests": 0, "dispatches": 0, "p50_ms": None,
                "p99_ms": None, "mean_ms": None, "occupancy_mean": 0.0,
                "padded_row_waste_ratio": 0.0, "duty_cycle": 0.0,
                "predicted_qps": 0.0}
    i = 0
    pending: deque = deque()
    t_free = arrivals[0][0]
    lat: list = []
    busy = 0.0
    total_rows = total_padded = dispatches = 0
    occ_sum = 0.0
    while i < n or pending:
        if not pending:
            pending.append(arrivals[i])
            i += 1
        t0 = pending[0][0]
        start = max(t_free, t0)  # the worker picks the batch up here
        while i < n and arrivals[i][0] <= start:
            pending.append(arrivals[i])
            i += 1
        queued = sum(r for _, r in pending)
        deadline = t0 + max_wait_ms
        close = start
        if queued < max_batch and start < deadline:
            # Coalescing window: wait for more work until the deadline,
            # closing early the instant queued rows reach max_batch.
            close = deadline
            while i < n and arrivals[i][0] <= deadline:
                pending.append(arrivals[i])
                queued += arrivals[i][1]
                i += 1
                if queued >= max_batch:
                    close = max(start, arrivals[i - 1][0])
                    break
        batch, rows_b = [], 0
        while pending:
            t_a, r = pending[0]
            if batch and rows_b + r > max_batch:
                break
            batch.append((t_a, r))
            rows_b += r
            pending.popleft()
        pad = padded_rows(rows_b, buckets, max_batch)
        if rows_b > max_batch:
            # Oversized single request: chunked dispatch pays the
            # intercept per chunk (the capacity fit's exclusion rule).
            chunks = -(-rows_b // max_batch)
            wall = chunks * a_ms + b_ms_per_row * pad
        else:
            wall = a_ms + b_ms_per_row * pad
        finish = close + wall
        for t_a, _r in batch:
            lat.append(finish - t_a)
        busy += wall
        total_rows += rows_b
        total_padded += pad
        # Occupancy mirrors the live tracker (obs/capacity.py) FOR
        # BUCKET POLICIES: rows over the compiled shape the dispatch
        # padded to — the definition the whatif-vs-live parity test
        # holds the two to. Bucket-less candidates keep the
        # rows/max_batch meaning (the sim does not know the engine's
        # legacy pad quantum, so their occupancy is NOT comparable to a
        # live quantum-padded serve's — compare bucketed to bucketed).
        if buckets:
            occ_sum += min(1.0, rows_b / max(1, pad if pad >= rows_b
                                             else max_batch))
        else:
            occ_sum += min(1.0, rows_b / max_batch)
        dispatches += 1
        t_free = finish
    span_ms = max(t_free - arrivals[0][0], 1e-9)
    arr = np.asarray(sorted(lat))
    return {
        "requests": n,
        "dispatches": dispatches,
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "mean_ms": round(float(arr.mean()), 3),
        "occupancy_mean": round(occ_sum / dispatches, 4),
        "padded_row_waste_ratio": round(
            (total_padded - total_rows) / total_padded
            if total_padded else 0.0, 4),
        "duty_cycle": round(min(1.0, busy / span_ms), 4),
        "predicted_qps": round(n / (span_ms / 1e3), 2),
    }


def frontier(arrivals: Sequence, policies: Sequence[dict], *, a_ms: float,
             b_ms_per_row: float) -> "list[dict]":
    """Simulate every candidate policy over one arrival process.

    ``policies`` — dicts with ``max_batch``, ``max_wait_ms``, optional
    ``buckets``. Returns one row per candidate: the policy + its
    predicted summary — the occupancy/waste/p50/p99 frontier an operator
    (or the autotuner) reads to pick a setting without booting a server
    per candidate.
    """
    out = []
    for p in policies:
        sim = simulate(
            arrivals, max_batch=p["max_batch"],
            max_wait_ms=p["max_wait_ms"], a_ms=a_ms,
            b_ms_per_row=b_ms_per_row, buckets=p.get("buckets"),
        )
        out.append({"policy": {k: p.get(k) for k in
                               ("max_batch", "max_wait_ms", "buckets")},
                    **sim})
    return out


def default_policy_candidates(max_batch: int, max_wait_ms: float,
                              buckets: Optional[Sequence[int]] = None
                              ) -> "list[dict]":
    """The autotuner's candidate grid around the LIVE policy: the current
    ``max_wait_ms`` plus halvings/doublings of it (and 0 — pure
    anti-coalescing — when the current wait is small), same ``max_batch``
    and bucket ladder throughout. Only the coalescing window varies:
    ``max_batch``/``buckets`` change compiled shapes, which the
    replay-verification contract treats as an operator decision, not a
    cadence re-tune (:mod:`knn_tpu_torch.control.autotune`)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if max_wait_ms < 0:
        raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
    waits = {round(float(max_wait_ms), 4)}
    base = max(float(max_wait_ms), 0.25)
    for factor in (0.25, 0.5, 2.0, 4.0):
        waits.add(round(base * factor, 4))
    if base <= 1.0:
        waits.add(0.0)
    return [{"max_batch": int(max_batch), "max_wait_ms": w,
             "buckets": list(buckets) if buckets else None}
            for w in sorted(waits)]
