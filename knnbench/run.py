"""One run of one cell: set-up, the measured window, the check, one line.

``python3 -m knnbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Set-up makes the inputs from the seed (``gen.py``), fits the program and
warms the cell's one shape with one call. The window then calls the
program back to back from one caller for ``--seconds``, each call on the
next query set of the pool, and keeps every answer. After the window the
program's state is freed and a sample of the answers, drawn from the seed,
is held against the plain reference (``reference.py``). The last line of
standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error and the last key of that
object. The metrics are read by ``metrics/<name>.py``: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics from a
``torch.profiler`` trace of the window with ``--trace 1``. The program
builds its CUDA sources into ``build/knn_tpu_torch/`` of the checkout in
the first run there; the harness keeps no cache of its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback

import numpy as np

from knnbench import bounds, gen, manifest, reference, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "knn_tpu")


def forbidden_modules(names) -> "list[str]":
    """The names among ``names`` whose top-level name, the part before the
    first dot, is one of :data:`FORBIDDEN`, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""

    window_s: float  # host clock, first call sent to last answer back
    queries: int  # answered in the window
    calls: int
    setup_s: float
    bound_s: float  # the least time of one call (bounds.py)
    trace: "trace.Summary | None"


def program(cell: manifest.Cell, inputs: dict, device: str):
    """The system under test: ``knn_tpu_torch``'s ``KNNClassifier`` on the
    cell's entry, in the mix's ``precision`` where it names one. Returns
    ``(call, close)``; ``call(dataset)`` gives the entry's answers on the
    host."""
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import KNNClassifier

    train = Dataset(inputs["train_x"], inputs["train_y"])
    options = ({"precision": cell.traffic["precision"]}
               if "precision" in cell.traffic else {})
    model = KNNClassifier(cell.traffic["k"], backend="cuda", device=device,
                          **options).fit(train)
    call = getattr(model, cell.traffic["entry"])

    def close():
        train.device_cache.clear()

    return call, close


def query_sets(pool: np.ndarray, traffic: dict) -> list:
    """One host ``Dataset`` per call-sized block of the pool, made in
    set-up as a caller would hold its queries."""
    from knn_tpu_torch.data.dataset import Dataset

    q = traffic["queries_per_call"]
    zeros = np.zeros(q, np.int32)
    return [Dataset(pool[s:s + q], zeros) for s in range(0, pool.shape[0], q)]


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def check(cell: manifest.Cell, inputs: dict, answered: list, seed: int,
          device: str) -> dict:
    """The numbers compared, each ``{"value", "limit"}``. ``answered``
    holds ``(call, answer)`` for each call of the window, ``answer`` None
    for a call that failed.

    ``kneighbors``: ``bad_ids`` counts the queries with an index out of
    range or repeated; ``rank_gap`` is the widest gap by which the true
    distance of the j-th neighbor returned lies above the reference's j-th,
    and ``dist_err`` the widest gap between a distance returned and the
    true distance of its index, each as a share of the query's k-th
    reference distance. ``predict``: ``wrong_label_share``, the share of
    the labels compared that differ from the reference's vote."""
    traffic, limits = cell.traffic, cell.limits
    q, k = traffic["queries_per_call"], traffic["k"]
    good = [(c, a) for c, a in answered if a is not None]
    sample = gen.check_sample(seed, q * len(good), traffic["check_queries"])
    picked = [(good[j][0], good[j][1], r) for j, r in zip(sample // q, sample % q)]
    queries = np.array([inputs["pool"][gen.call_rows(traffic, c)][r]
                        for c, _, r in picked], np.float32).reshape(
                            len(picked), cell.config["dim"])
    ref_d, ref_i = reference.neighbors(inputs["train_x"], queries, k, device)
    checks = {"unanswered": q * (len(answered) - len(good))}
    if traffic["entry"] == "kneighbors":
        got_d = np.array([a[0][r] for _, a, r in picked],
                         np.float64).reshape(ref_d.shape)
        got_i = np.array([a[1][r] for _, a, r in picked],
                         np.int64).reshape(ref_i.shape)
        valid = (got_i >= 0) & (got_i < cell.config["train_rows"])
        ordered = np.sort(got_i, axis=1)
        repeated = (ordered[:, 1:] == ordered[:, :-1]).any(axis=1)
        checks["bad_ids"] = int((~valid.all(axis=1) | repeated).sum())
        true_d = reference.distances(inputs["train_x"], queries,
                                     np.where(valid, got_i, 0), device)
        scale = np.maximum(ref_d[:, -1:], np.finfo(np.float64).tiny)
        gap = np.where(valid, (true_d - ref_d) / scale, 0.0)
        err = np.where(valid, np.abs(got_d - true_d) / scale, 0.0)
        checks["rank_gap"] = _finite(gap.max(initial=0.0))
        checks["dist_err"] = _finite(err.max(initial=0.0))
    else:
        got = np.array([a[r] for _, a, r in picked], np.int64)
        want = reference.vote(inputs["train_y"][ref_i].astype(np.int64),
                              cell.config["classes"])
        checks["wrong_label_share"] = (float((got != want).mean())
                                       if len(got) else 0.0)
    out = {name: {"value": v, "limit": limits[name]}
           for name, v in checks.items()}
    out["compared"] = {"value": len(picked),
                       "limit": min(traffic["check_queries"], q * len(good))}
    return out


def _finite(x) -> float:
    """``x``, or the largest float64 where it is not finite, so that the
    result stays plain JSON and the number still fails its limit."""
    x = float(x)
    return x if np.isfinite(x) else float(np.finfo(np.float64).max)


def passed(checks: dict) -> bool:
    """Every number at or under its limit; ``compared`` at its limit."""
    return all(c["value"] == c["limit"] if name == "compared"
               else c["value"] <= c["limit"] for name, c in checks.items())


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: "float | None" = None,
             make_system=program, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result object. ``t0`` is the
    process's start on the ``time.perf_counter`` clock."""
    import torch
    from torch.profiler import record_function

    t0 = time.perf_counter() if t0 is None else t0
    cfg, traffic = cell.config, cell.traffic
    cuda = device.startswith("cuda")
    t_start = time.perf_counter()
    inputs = gen.make_inputs(cfg, traffic, seed, device)
    t_inputs = time.perf_counter()
    call, close = make_system(cell, inputs, device)
    sets = query_sets(inputs["pool"], traffic)
    q = traffic["queries_per_call"]
    t_fit = time.perf_counter()
    call(sets[0])  # builds what the program builds, warms the one shape
    _sync(device)
    # Set-up's objects leave the collector's generations, so a collection
    # in the window walks only what the window made.
    gc.collect()
    gc.freeze()
    answered, failures = [], 0
    setup_s = time.perf_counter() - t0
    print(f"setup: {t_start - t0:.3f} s to the harness, inputs "
          f"{t_inputs - t_start:.3f} s, fit {t_fit - t_inputs:.3f} s, "
          f"first call {t0 + setup_s - t_fit:.3f} s", file=log)
    with trace.profiled(traced, cuda) as events:
        with record_function(trace.WINDOW):
            start = time.perf_counter()
            i = 1
            while time.perf_counter() - start < seconds:
                try:
                    with record_function(trace.CALL):
                        out = call(sets[i % len(sets)])
                except Exception:  # noqa: BLE001 — counted as failed
                    if failures == 0:
                        traceback.print_exc(file=log)
                    failures += 1
                    out = None
                answered.append((i, out))
                i += 1
            end = time.perf_counter()
        _sync(device)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = trace.summarize(events) if traced else None
    del events

    close()
    del call, close
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check(cell, inputs, answered, seed, device)
    ok = sum(a is not None for _, a in answered)
    reading = Reading(
        window_s=end - start, queries=q * ok, calls=ok, setup_s=setup_s,
        bound_s=bounds.retrieval_bound_s(q, cfg["train_rows"], cfg["dim"],
                                         traffic["k"])[0],
        trace=summary)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = m.read(reading)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": passed(checks), "attempted": q * len(answered),
              "failed": q * (len(answered) - ok), "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def process_start(fallback: float) -> float:
    """When this process started, on the ``time.perf_counter`` clock: from
    ``/proc/self/stat`` (10 ms steps), else ``fallback``."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf(
            "SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return fallback
    return min(fallback, time.perf_counter() - age)


def main(argv=None, t0: "float | None" = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(prog="knnbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    t_args = time.perf_counter()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"knnbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import knn_tpu_torch

    where = os.path.realpath(os.path.dirname(knn_tpu_torch.__file__))
    if not where.startswith(str(manifest.ROOT) + os.sep):
        print(f"knnbench: knn_tpu_torch is imported from {where}, outside "
              f"this checkout ({manifest.ROOT})", file=sys.stderr)
        return 2
    t_port = time.perf_counter()
    start = process_start(t0)
    print(f"start: interpreter {t0 - start:.3f} s, imports (torch among "
          f"them) and arguments {t_args - t0:.3f} s, the card and "
          f"knn_tpu_torch {t_port - t_args:.3f} s", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t0=start)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"knnbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
