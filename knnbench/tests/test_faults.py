"""A run on the CPU with the timed path broken underneath: the check has to
come out false for each fault a cell can have, and true without one."""

from __future__ import annotations

import json

import numpy as np
import pytest

from knn_tpu_torch.models.knn import KNNClassifier
from knnbench import manifest, run
from knnbench.tests.conftest import cut_to_cpu_size, write_json

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def alter_one_answer(out, _last):
    """One answer in eight altered where it is produced."""
    if isinstance(out, tuple):
        d, i = (a.copy() for a in out)
        i[::8, 0] = (i[::8, 0] + 1) % 7
        return d, i
    out = out.copy()
    out[::8] = (out[::8] + 1) % 10
    return out


def drop_half(out, _last):
    """Half of the call's queries left out, their slots filled from the
    other half."""
    def half(a):
        a = a.copy()
        h = a.shape[0] // 2
        a[h:2 * h] = a[:h]
        return a
    return tuple(half(a) for a in out) if isinstance(out, tuple) else half(out)


def stale(out, last):
    """The call before's answers returned again."""
    return last[0] if last else out


def fail(out, last):
    """Every call after the warm-up raises."""
    if last:
        raise RuntimeError("injected")
    return out


@pytest.fixture
def break_program(monkeypatch):
    def install(fault):
        for entry in ("kneighbors", "predict"):
            real = getattr(KNNClassifier, entry)
            last = []

            def broken(self, test, real=real, last=last):
                out = fault(real(self, test), last)
                last[:] = [out]
                return out
            monkeypatch.setattr(KNNClassifier, entry, broken)
    return install


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(tiny_cell, name):
    result = run.run_cell(tiny_cell(name), 2**31 + 3, 0.3, False, device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert all(c["value"] <= c["limit"] or n == "compared"
               for n, c in result["checks"].items())


@pytest.mark.parametrize("fault", [alter_one_answer, drop_half, stale, fail])
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_fails_the_check(tiny_cell, break_program, name, fault):
    break_program(fault)
    result = run.run_cell(tiny_cell(name), 2**31 + 3, 0.3, False,
                          device="cpu")
    assert result["correct"] is False
    if fault is fail:
        assert result["failed"] == result["attempted"] > 0
        assert result["checks"]["unanswered"]["value"] > 0
    assert np.isfinite(result["metrics"]["setup_s"]["value"])


def add_bigann(root):
    """BIGANN-100M's shape, 100,000,000 x 128, and a cell on it: one new
    file and two new entries."""
    bench_dir = root / "knnbench"
    cfg = json.loads((bench_dir / "configs" / "sift-128-euclidean.json")
                     .read_text())
    cfg.update(name="bigann-100m", train_rows=100_000_000,
               source="big-ann-benchmarks bigann-100M")
    write_json(bench_dir / "configs" / "bigann-100m.json", cfg)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bigann-100m", "source": "a test",
                             "file": "knnbench/configs/bigann-100m.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "bigann100m.k10.batch10k",
                               "config": "bigann-100m",
                               "traffic": "kneighbors-k10-batch10k",
                               "chips": 1, "why": "a test"})
    write_json(root / "BENCHMARK.json", bench)


@pytest.mark.parametrize("fault", [None, alter_one_answer])
def test_a_configuration_of_any_size_runs_as_new_files(
        tiny_root, tiny_cell, break_program, fault):
    """A 100M-row configuration added to the CPU copy as new files and
    entries is cut by the fixture's one rule and checked like the others,
    and no file that was there changes."""
    before = {p: p.read_bytes() for p in (tiny_root / "knnbench").rglob("*")
              if p.is_file()}
    old = manifest.load(tiny_root)
    add_bigann(tiny_root)
    cut_to_cpu_size(tiny_root)
    for path, data in before.items():
        assert path.read_bytes() == data, path
    new = manifest.load(tiny_root)
    for key, value in old.items():
        kept = new[key][:len(value)] if isinstance(value, list) else new[key]
        assert kept == value
    cell = tiny_cell("bigann100m.k10.batch10k")
    assert (cell.config["train_rows"], cell.config["dim"]) == (3000, 128)
    if fault:
        break_program(fault)
    result = run.run_cell(cell, 2**31 + 3, 0.3, False, device="cpu")
    assert result["correct"] is (fault is None)
    assert result["checks"]["compared"]["value"] == 64
