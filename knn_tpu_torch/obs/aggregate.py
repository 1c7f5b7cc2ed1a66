"""Multi-process fleet aggregation: merge per-process metric registries on
rank 0, with ``{proc=…}`` labels and straggler gauges (the port of
``knn_tpu/obs/aggregate.py``).

Every process of a launcher run (``parallel/multihost.py``) keeps its own
:class:`~knn_tpu_torch.obs.metrics.MetricsRegistry`; this module brings
them together:

- :func:`snapshot_registry` — one process's registry as a plain
  JSON-able list (raw bucket counts for histograms, so merging is exact);
- :func:`merge_snapshots`   — rank 0 folds the per-process snapshots into
  one registry, every instrument gaining a ``proc`` label (counters stay
  per-process: summing them is the scrape consumer's choice);
- :func:`straggler_gauges`  — derived fleet gauges over each process's
  ``knn_shard_dispatch_ms`` sample (``obs/instrument.py::
  record_shard_dispatch``): ``knn_shard_dispatch_ms_max`` /
  ``knn_shard_dispatch_ms_min`` / ``knn_shard_dispatch_skew`` per path;
- :func:`local_straggler_gauges` — the same family from one sharded
  serve dispatch's per-shard walls (``shard/dispatch.py``);
- :func:`aggregate_multihost` — the transport: the snapshots cross
  processes through ``torch.distributed.all_gather_object`` on the
  launcher's process group (gloo or NCCL, whichever the launcher chose).
  Rank 0 returns the merged registry + straggler dict; other ranks
  return ``(None, {})``. Without a process group: merges its own
  snapshot as proc 0, so the output shape is launcher-independent.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from knn_tpu_torch import obs
from knn_tpu_torch.obs.metrics import Histogram, MetricsRegistry

#: The sharded strategies whose dispatch walls feed the straggler gauges.
STRATEGY_PATHS = ("query-sharded", "train-sharded", "ring")


def snapshot_registry(registry: Optional[MetricsRegistry] = None) -> List[dict]:
    """One registry as a JSON-able list of instrument records. Histograms
    carry RAW (non-cumulative) bucket counts so a merge can reconstruct
    them exactly; the exposition-side cumulative form is derivable, the
    reverse only up to the shared bucket ladder."""
    reg = registry if registry is not None else obs.registry()
    out = []
    for inst in reg.instruments():
        rec = {
            "name": inst.name,
            "kind": inst.kind,
            "labels": dict(inst.labels),
            "help": inst.help,
        }
        if isinstance(inst, Histogram):
            rec.update(
                buckets=list(inst.buckets),
                counts=inst.bucket_counts(),
                sum=inst.sum,
                count=inst.count,
            )
        else:
            rec["value"] = inst.value
        out.append(rec)
    return out


def merge_snapshots(
    snapshots: Dict,
    registry: Optional[MetricsRegistry] = None,
    label: Optional[str] = "proc",
) -> MetricsRegistry:
    """Fold per-source snapshots into one registry, adding
    ``<label>=<source key>`` to every label set. Values stay per-source
    (a counter from proc 1 never adds into proc 0's) — fleet-level sums
    are a query over the merged registry, not a lossy pre-aggregation.

    ``label`` names the attribution key: ``"proc"`` for multihost
    processes (the original use), ``"replica"`` for the fleet router's
    federated ``/metrics`` scrape (snapshot keys are replica base URLs).
    ``label=None`` folds records with their labels unchanged — how the
    router overlays its OWN registry into the same merged document."""
    reg = registry if registry is not None else MetricsRegistry()
    for proc in sorted(snapshots):
        for rec in snapshots[proc]:
            labels = dict(rec["labels"])
            if label is not None:
                labels[label] = str(proc)
            help_ = rec.get("help", "")
            if rec["kind"] == "counter":
                reg.counter(rec["name"], help=help_, **labels).add(
                    rec["value"]
                )
            elif rec["kind"] == "gauge":
                reg.gauge(rec["name"], help=help_, **labels).set(
                    rec["value"]
                )
            elif rec["kind"] == "histogram":
                h = reg.histogram(
                    rec["name"], buckets=rec["buckets"], help=help_, **labels
                )
                h.merge_counts(rec["counts"], rec["sum"], rec["count"])
            else:
                raise ValueError(
                    f"snapshot record {rec['name']!r} has unknown kind "
                    f"{rec['kind']!r}"
                )
    return reg


def straggler_gauges(
    snapshots: Dict[int, List[dict]],
    registry: MetricsRegistry,
) -> Dict[str, dict]:
    """Derive the fleet straggler gauges from each process's
    ``knn_shard_dispatch_ms`` sample: per strategy path, set
    ``knn_shard_dispatch_ms_max`` / ``_min`` and
    ``knn_shard_dispatch_skew`` (= max/min) on ``registry`` and return
    ``{path: {"max_ms", "min_ms", "skew", "max_proc", "procs"}}``.
    Paths no process dispatched are absent from the result."""
    per_path: Dict[str, Dict[int, float]] = {}
    for proc, snap in snapshots.items():
        for rec in snap:
            if rec["name"] != "knn_shard_dispatch_ms":
                continue
            path = rec["labels"].get("path", "?")
            per_path.setdefault(path, {})[proc] = float(rec["value"])
    out: Dict[str, dict] = {}
    for path, by_proc in sorted(per_path.items()):
        vals = list(by_proc.values())
        mx, mn = max(vals), min(vals)
        # A 0 ms min (the gauge rounds to 3 decimals, so a sub-µs wall
        # stores 0.0) must not read as INFINITE skew — inf also breaks
        # strict-JSON consumers of the --metrics-out artifact. Clamp the
        # denominator to the rounding floor: the ratio then means "at
        # least this skewed", stays finite, and a fleet of all-zero walls
        # is exactly balanced.
        skew = 1.0 if mx == 0 else mx / max(mn, 0.001)
        max_proc = max(by_proc, key=by_proc.get)
        registry.gauge(
            "knn_shard_dispatch_ms_max",
            help="slowest process's sharded dispatch->fetch wall ms",
            path=path,
        ).set(mx)
        registry.gauge(
            "knn_shard_dispatch_ms_min",
            help="fastest process's sharded dispatch->fetch wall ms",
            path=path,
        ).set(mn)
        registry.gauge(
            "knn_shard_dispatch_skew",
            help="straggler ratio: max/min sharded dispatch wall across "
                 "processes (1.0 = balanced; min clamped to the 0.001 ms "
                 "rounding floor so the gauge stays finite)",
            path=path,
        ).set(round(skew, 4))
        out[path] = {
            "max_ms": mx,
            "min_ms": mn,
            "skew": skew,
            "max_proc": max_proc,
            "procs": len(by_proc),
        }
    return out


def local_straggler_gauges(path: str,
                           walls_ms: Dict[int, float]) -> Optional[dict]:
    """The IN-PROCESS twin of :func:`straggler_gauges`: derive the same
    ``knn_shard_dispatch_ms_max/min`` + ``knn_shard_dispatch_skew``
    family from one sharded serve dispatch's per-shard walls
    (``{shard: wall_ms}``) and set them on the default registry. One
    metric family for both topologies: the shards are logical (one
    process, ``serve --shards``) or whole processes (the launcher).
    Returns ``{"max_ms", "min_ms", "skew", "max_shard", "shards"}`` or
    None when obs is off / no walls."""
    if not walls_ms or not obs.enabled():
        return None
    vals = list(walls_ms.values())
    mx, mn = max(vals), min(vals)
    # Same finite-skew clamp as the fleet derivation above.
    skew = 1.0 if mx == 0 else mx / max(mn, 0.001)
    obs.gauge_set(
        "knn_shard_dispatch_ms_max",
        round(mx, 3),
        help="slowest process's sharded dispatch->fetch wall ms",
        path=path,
    )
    obs.gauge_set(
        "knn_shard_dispatch_ms_min",
        round(mn, 3),
        help="fastest process's sharded dispatch->fetch wall ms",
        path=path,
    )
    obs.gauge_set(
        "knn_shard_dispatch_skew",
        round(skew, 4),
        help="straggler ratio: max/min sharded dispatch wall across "
             "processes (1.0 = balanced; min clamped to the 0.001 ms "
             "rounding floor so the gauge stays finite)",
        path=path,
    )
    return {
        "max_ms": round(mx, 3),
        "min_ms": round(mn, 3),
        "skew": round(skew, 4),
        "max_shard": max(walls_ms, key=walls_ms.get),
        "shards": len(walls_ms),
    }


def aggregate_multihost(
    registry: Optional[MetricsRegistry] = None,
) -> Tuple[Optional[MetricsRegistry], Dict[str, dict]]:
    """Gather every process's registry snapshot and merge on rank 0.

    Returns ``(merged_registry, stragglers)`` on rank 0 and ``(None, {})``
    elsewhere. Without an initialized process group (or with one process):
    merges the local snapshot as proc 0. The gather is symmetric — every
    rank must call it — and only rank 0 pays the merge."""
    import torch.distributed as dist

    local = snapshot_registry(registry)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        snaps = {0: local}
        merged = merge_snapshots(snaps)
        return merged, straggler_gauges(snaps, merged)
    gathered: List = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, json.dumps(local, separators=(",", ":")))
    if dist.get_rank() != 0:
        return None, {}
    snaps = {p: json.loads(doc) for p, doc in enumerate(gathered)}
    merged = merge_snapshots(snaps)
    return merged, straggler_gauges(snaps, merged)
