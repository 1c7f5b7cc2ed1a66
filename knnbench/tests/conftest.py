"""Fixtures of the benchmark's tests: a temporary copy of the benchmark
whose configurations and mixes are cut to a size the CPU runs in a second."""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path

import pytest

from knnbench import manifest

# The CPU cut: every configuration's train keeps at most this many
# features (sift 3,000 rows of 128, fashion-mnist 900 of 784), and no fewer
# rows than MIN_ROWS, so a configuration of any size runs here unedited.
TINY_FEATURES = 384_000
MIN_ROWS = 900


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n", encoding="utf-8")


def copy_bench(root: Path) -> Path:
    """``BENCHMARK.json`` and ``knnbench/`` copied under ``root``."""
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, root / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def cut_to_cpu_size(root: Path) -> Path:
    """Every configuration that ``root``'s ``BENCHMARK.json`` names cut to
    the rows of one rule on its width, and every mix to a few small calls.
    Cutting twice changes nothing."""
    for entry in manifest.load(root)["configs"]:
        path = root / entry["file"]
        cfg = json.loads(path.read_text())
        cfg["train_rows"] = min(cfg["train_rows"], max(
            MIN_ROWS, math.ceil(TINY_FEATURES / cfg["dim"])))
        write_json(path, cfg)
    for path in (root / "knnbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["queries_per_call"] = min(mix["queries_per_call"], 32)
        mix["pool_queries"] = 96
        mix["check_queries"] = 64
        write_json(path, mix)
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark at CPU size: the same cells and metrics, the
    configurations' rows and the mixes' queries cut down."""
    return cut_to_cpu_size(copy_bench(tmp_path))


@pytest.fixture
def tiny_cell(tiny_root):
    def get(name: str) -> manifest.Cell:
        return manifest.cell(name, root=tiny_root,
                             bench_dir=tiny_root / "knnbench")
    return get
