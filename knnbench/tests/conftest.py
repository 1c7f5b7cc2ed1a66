"""Fixtures of the benchmark's tests: a temporary copy of the benchmark
whose configurations and mixes are cut to a size the CPU runs in a second."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from knnbench import manifest

TINY_ROWS = {"sift-128-euclidean": 3000, "fashion-mnist-784-euclidean": 900}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n", encoding="utf-8")


def copy_bench(root: Path) -> Path:
    """``BENCHMARK.json`` and ``knnbench/`` copied under ``root``."""
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, root / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark at CPU size: the same cells and metrics, the
    configurations' rows and the mixes' queries cut down."""
    root = copy_bench(tmp_path)
    for name, rows in TINY_ROWS.items():
        path = root / "knnbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["train_rows"] = rows
        write_json(path, cfg)
    for path in (root / "knnbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["queries_per_call"] = min(mix["queries_per_call"], 32)
        mix["pool_queries"] = 96
        mix["check_queries"] = 64
        write_json(path, mix)
    return root


@pytest.fixture
def tiny_cell(tiny_root):
    def get(name: str) -> manifest.Cell:
        return manifest.cell(name, root=tiny_root,
                             bench_dir=tiny_root / "knnbench")
    return get
