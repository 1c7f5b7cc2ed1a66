"""``BENCHMARK.json`` and the files it names.

A cell of ``workloads`` names a configuration and a traffic mix. The
configuration's file is the ``file`` of its ``configs`` entry; the mix is
``traffic/<traffic>.json``; a metric of either list is read by
``metrics/<name>.py``. So a later cell, mix, configuration or metric is new
files and new entries, and no file here changes.

A configuration or a mix may hold only the keys that the harness reads,
with values it implements (:data:`CONFIG_KEYS`, :data:`TRAFFIC_KEYS`): a
file that asks for something else is refused, never run as something else.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Each key a configuration may hold, with the values the harness
# implements (None: any value of the key's kind).
CONFIG_KEYS = {
    "name": None, "source": None, "assumed": None, "reduced": None,
    "guarantee": None,
    "train_rows": None, "test_rows": None, "dim": None, "classes": None,
    "value_min": None, "value_max": None, "value_scale": None,
    "metric": ("euclidean",), "dtype": ("float32",),
    "limits": None,
}
CONFIG_REQUIRED = ("name", "train_rows", "dim", "classes", "value_min",
                   "value_max", "value_scale", "metric", "dtype", "limits")
# ``precision``: the program's distance form, which only its ``predict``
# takes; ``limits`` (optional) replace the configuration's for the mix.
TRAFFIC_KEYS = {
    "entry": ("kneighbors", "predict"), "k": None, "queries_per_call": None,
    "pool_queries": None, "check_queries": None,
    "precision": ("exact", "fast", "bf16"), "limits": None,
}
TRAFFIC_REQUIRED = ("entry", "k", "queries_per_call", "pool_queries",
                    "check_queries")
# The numbers each entry's check compares (``run.check``).
CHECKS = {"kneighbors": ("unanswered", "bad_ids", "rank_gap", "dist_err"),
          "predict": ("unanswered", "wrong_label_share")}


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: object  # ``read(reading) -> float | None`` of metrics/<name>.py


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: "tuple[Metric, ...]"
    per_layer: "tuple[Metric, ...]"

    @property
    def limits(self) -> dict:
        """The limit of each number the check compares: the mix's where it
        gives them, else the configuration's."""
        return self.traffic.get("limits", self.config["limits"])


def _reader(bench_dir: Path, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"knnbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _validate(kind: str, name: str, data: dict, keys: dict,
              required: tuple) -> None:
    """Raise ``ValueError`` on a key the harness does not read, a value it
    does not implement, or a required key left out."""
    for key, value in data.items():
        if key not in keys:
            raise ValueError(f"{kind} {name!r}: the harness reads no key "
                             f"{key!r} (it reads {sorted(keys)})")
        if keys[key] is not None and value not in keys[key]:
            raise ValueError(f"{kind} {name!r}: {key} = {value!r} is not "
                             f"implemented (only {list(keys[key])})")
    missing = [key for key in required if key not in data]
    if missing:
        raise ValueError(f"{kind} {name!r} lacks {missing}")


def load(root: Path = ROOT) -> dict:
    """The manifest at ``root``; raises on a missing or malformed one."""
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        manifest = json.load(f)
    for key in ("command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"):
        if key not in manifest:
            raise ValueError(f"BENCHMARK.json lacks {key!r}")
    return manifest


def cell(name: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, its mix and the readers of
    the metrics it reports."""
    manifest = load(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(root / configs[w["config"]]["file"], encoding="utf-8") as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json",
              encoding="utf-8") as f:
        traffic = json.load(f)
    _validate("configuration", w["config"], config, CONFIG_KEYS,
              CONFIG_REQUIRED)
    _validate("traffic mix", w["traffic"], traffic, TRAFFIC_KEYS,
              TRAFFIC_REQUIRED)
    if "precision" in traffic and traffic["entry"] != "predict":
        raise ValueError(f"traffic mix {w['traffic']!r}: only predict takes "
                         "a precision; kneighbors is always exact")

    def metrics(key):
        return tuple(Metric(m["name"], m["unit"], _reader(bench_dir, m["name"]))
                     for m in manifest[key] if _applies(m, name))

    out = Cell(name, int(w["chips"]), config, traffic,
               metrics("end_to_end"), metrics("per_layer"))
    missing = set(CHECKS[traffic["entry"]]) - set(out.limits)
    if missing:
        raise ValueError(f"cell {name!r} has no limit for {sorted(missing)}")
    return out
