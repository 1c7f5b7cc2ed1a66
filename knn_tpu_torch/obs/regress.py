"""Noise-aware perf-regression comparison: best-of-mins with MAD tolerance
(the port's copy of ``knn_tpu/obs/regress.py``; no framework in it).

The decision rule a benchmark gate applies to two records of per-trial
measurements:

- Each gated metric is a list of per-trial measurements
  (``obs/bench_timing.py`` records trial lists).
- The central comparison is **best-of-mins**: the minimum trial is the
  least-noise estimate of the true cost on a contended box (stalls only
  ever ADD time), so ``fresh_best`` vs ``baseline_best``.
- The tolerance is **noise-aware**: ``max(rel_tol · baseline_best,
  mad_k · MAD(baseline_trials), abs_floor_ms)``. The MAD (median absolute
  deviation) of the baseline's own trials measures how noisy this metric
  is ON THIS BOX — a metric whose baseline spread is wide gets a wide
  gate, a tight one gets a tight gate, and the absolute floor keeps
  microsecond-scale metrics from failing on scheduler jitter.
- A metric regresses when the fresh best exceeds (lower-is-better) or
  undercuts (higher-is-better) the baseline best by more than the
  tolerance. Improvements never fail the gate; they are reported so a
  suspicious 10x "win" is visible too.

The verdict JSON (``compare_records``) is the machine-readable artifact;
``pass`` is the single gate bit. Its verdicts equal the JAX package's on
the same records.
"""

from __future__ import annotations

from typing import Dict, List

#: Default gate knobs: 5% relative, 5 baseline-MADs, 0.5 ms floor. mad_k=5
#: is deliberately loose — this gate exists to catch real regressions
#: (tens of percent), not to flag every breeze on a shared CI box.
DEFAULT_REL_TOL = 0.05
DEFAULT_MAD_K = 5.0
DEFAULT_ABS_FLOOR = 0.5


def median(xs: List[float]) -> float:
    srt = sorted(xs)
    m = len(srt)
    return srt[m // 2] if m % 2 else (srt[m // 2 - 1] + srt[m // 2]) / 2


def mad(xs: List[float]) -> float:
    """Median absolute deviation — the robust spread estimate (a single
    stalled trial cannot inflate it the way it inflates a stddev)."""
    if len(xs) < 2:
        return 0.0
    med = median(xs)
    return median([abs(x - med) for x in xs])


def compare_metric(
    name: str,
    baseline_trials: List[float],
    fresh_trials: List[float],
    direction: str = "lower",
    rel_tol: float = DEFAULT_REL_TOL,
    mad_k: float = DEFAULT_MAD_K,
    abs_floor: float = DEFAULT_ABS_FLOOR,
    unit: str = "ms",
) -> dict:
    """One metric's verdict dict. ``direction`` is "lower" (latencies) or
    "higher" (throughputs); best-of is min/max respectively, and the
    regression test points the matching way."""
    if direction not in ("lower", "higher"):
        raise ValueError(f"direction must be 'lower' or 'higher', got "
                         f"{direction!r}")
    if not baseline_trials or not fresh_trials:
        return {
            "metric": name, "regressed": True, "unit": unit,
            "reason": "missing trials "
                      f"(baseline={len(baseline_trials or [])}, "
                      f"fresh={len(fresh_trials or [])})",
        }
    best = min if direction == "lower" else max
    base_best = float(best(baseline_trials))
    fresh_best = float(best(fresh_trials))
    base_mad = mad([float(x) for x in baseline_trials])
    tol = max(rel_tol * abs(base_best), mad_k * base_mad, abs_floor)
    delta = (fresh_best - base_best if direction == "lower"
             else base_best - fresh_best)
    return {
        "metric": name,
        "direction": direction,
        "unit": unit,
        "baseline_best": round(base_best, 4),
        "fresh_best": round(fresh_best, 4),
        "baseline_mad": round(base_mad, 4),
        "tolerance": round(tol, 4),
        "delta": round(delta, 4),  # positive = worse, by `direction`
        "regressed": delta > tol,
        "improved": delta < -tol,
    }


def compare_records(
    baseline: dict,
    fresh: dict,
    rel_tol: float = DEFAULT_REL_TOL,
    mad_k: float = DEFAULT_MAD_K,
    abs_floor: float = DEFAULT_ABS_FLOOR,
) -> dict:
    """Compare two gate records' ``metrics`` maps (``{name: {"trials":
    [...], "direction": ..., "unit": ...}}`` — the shape
    a gate record carries). A metric present in the baseline
    but missing from the fresh record is a failure (a silently dropped
    measurement must not read as a pass); metrics only the fresh record
    has are reported as ``new`` and do not gate."""
    checks = []
    base_metrics: Dict[str, dict] = baseline.get("metrics", {})
    fresh_metrics: Dict[str, dict] = fresh.get("metrics", {})
    for name in sorted(base_metrics):
        b = base_metrics[name]
        f = fresh_metrics.get(name)
        if f is None:
            checks.append({
                "metric": name, "regressed": True,
                "reason": "metric missing from the fresh record",
            })
            continue
        checks.append(compare_metric(
            name, b.get("trials", []), f.get("trials", []),
            direction=b.get("direction", "lower"),
            rel_tol=rel_tol, mad_k=mad_k, abs_floor=abs_floor,
            unit=b.get("unit", "ms"),
        ))
    new = sorted(set(fresh_metrics) - set(base_metrics))
    verdict = {
        "pass": not any(c["regressed"] for c in checks),
        "checks": checks,
        "new_metrics": new,
        "params": {"rel_tol": rel_tol, "mad_k": mad_k,
                   "abs_floor": abs_floor},
    }
    return verdict


def summarize(verdict: dict) -> str:
    """One human line per check (the gate's console output)."""
    lines = []
    for c in verdict["checks"]:
        if "reason" in c:
            lines.append(f"FAIL {c['metric']}: {c['reason']}")
            continue
        state = ("REGRESSED" if c["regressed"]
                 else "improved" if c.get("improved") else "ok")
        lines.append(
            f"{state:>9} {c['metric']}: fresh {c['fresh_best']}"
            f"{c['unit']} vs baseline {c['baseline_best']}{c['unit']} "
            f"(tol {c['tolerance']}{c['unit']}, "
            f"mad {c['baseline_mad']}{c['unit']})"
        )
    return "\n".join(lines)
