"""The manifest, the files it names, and what a later change may add."""

from __future__ import annotations

import json
import re

import pytest

from knnbench import manifest, run
from knnbench.tests.conftest import copy_bench, write_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files_by_name():
    bench = manifest.load()
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["entry"] in ("kneighbors", "predict")
        assert cell.chips == 1
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert all(callable(m.read) for m in cell.end_to_end + cell.per_layer)


def test_manifest_keeps_its_format():
    bench = manifest.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["knnbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("knnbench/")
        assert c["reduced"] == json.loads(
            (manifest.ROOT / c["file"]).read_text())["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_a_new_cell_mix_config_and_metric_are_new_files_only(tmp_path):
    """A throwaway configuration, mix, metric and cell, added to a copy as
    new files and new entries, run without an edit to any file there."""
    root = copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in (root / "knnbench").rglob("*")
              if p.is_file()}
    bench_dir = root / "knnbench"
    cfg = json.loads((bench_dir / "configs" / "sift-128-euclidean.json")
                     .read_text())
    cfg.update(name="tiny-16", train_rows=500, dim=16)
    write_json(bench_dir / "configs" / "tiny-16.json", cfg)
    write_json(bench_dir / "traffic" / "kneighbors-k3-call8.json",
               {"entry": "kneighbors", "k": 3, "queries_per_call": 8,
                "pool_queries": 32, "check_queries": 16})
    (bench_dir / "metrics" / "calls_in_window.py").write_text(
        "def read(r):\n    return r.calls\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-16", "source": "a test",
                             "file": "knnbench/configs/tiny-16.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.k3.call8", "config": "tiny-16",
                               "traffic": "kneighbors-k3-call8", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "calls_in_window", "unit": "count",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.k3.call8"]})
    write_json(root / "BENCHMARK.json", bench)

    for path, data in before.items():
        assert path.read_bytes() == data
    cell = manifest.cell("tiny.k3.call8", root=root, bench_dir=bench_dir)
    assert cell.config["dim"] == 16 and cell.traffic["k"] == 3
    result = run.run_cell(cell, 5, 0.2, False, device="cpu")
    assert result["correct"]
    assert set(result["metrics"]) == {"qps", "setup_s", "calls_in_window"}
    assert result["metrics"]["calls_in_window"]["value"] >= 1
    old = manifest.cell("sift128.k10.batch10k", root=root,
                        bench_dir=bench_dir)
    assert "calls_in_window" not in {m.name for m in old.end_to_end}


def test_an_unknown_cell_or_reader_is_refused(tmp_path):
    with pytest.raises(KeyError):
        manifest.cell("no.such.cell")
    root = copy_bench(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "unread", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "qps"})
    write_json(root / "BENCHMARK.json", bench)
    with pytest.raises(FileNotFoundError):
        manifest.cell("sift128.k10.batch10k", root=root,
                      bench_dir=root / "knnbench")


def _with_mix(tmp_path, mix: dict, config_edit=None):
    """A copy whose sift k = 10 cell runs ``mix``, and whose sift
    configuration has ``config_edit`` applied."""
    root = copy_bench(tmp_path)
    write_json(root / "knnbench" / "traffic" / "kneighbors-k10-batch10k.json",
               mix)
    if config_edit:
        path = root / "knnbench" / "configs" / "sift-128-euclidean.json"
        cfg = json.loads(path.read_text())
        cfg.update(config_edit)
        write_json(path, cfg)
    return manifest.cell("sift128.k10.batch10k", root=root,
                         bench_dir=root / "knnbench")


MIX = {"entry": "kneighbors", "k": 10, "queries_per_call": 16,
       "pool_queries": 64, "check_queries": 32}


@pytest.mark.parametrize("mix, config_edit, words", [
    ({**MIX, "callers": 16}, None, "reads no key 'callers'"),
    ({**MIX, "loop": "open"}, None, "reads no key 'loop'"),
    ({**MIX, "entry": "radius_neighbors"}, None, "not implemented"),
    ({**MIX, "precision": "bf16"}, None, "only predict takes a precision"),
    ({**MIX, "precision": "int8"}, None, "not implemented"),
    (MIX, {"metric": "angular"}, "not implemented"),
    (MIX, {"dtype": "float16"}, "not implemented"),
    (MIX, {"integer_values": True}, "reads no key 'integer_values'"),
    ({**MIX, "limits": {"unanswered": 0}}, None, "has no limit"),
    ({k: v for k, v in MIX.items() if k != "k"}, None, "lacks ['k']"),
])
def test_what_the_harness_does_not_implement_is_refused(
        tmp_path, mix, config_edit, words):
    with pytest.raises(ValueError, match=re.escape(words)):
        _with_mix(tmp_path, mix, config_edit)


def test_a_mix_passes_its_precision_and_limits_to_the_program(
        tmp_path, monkeypatch):
    """A precision cell is new files only: the mix's ``precision`` reaches
    ``KNNClassifier`` and its ``limits`` replace the configuration's."""
    from knn_tpu_torch.models.knn import KNNClassifier

    seen = []
    real = KNNClassifier.__init__

    def spy(self, k, **kw):
        seen.append(kw)
        real(self, k, **kw)
    monkeypatch.setattr(KNNClassifier, "__init__", spy)
    root = copy_bench(tmp_path)
    bench_dir = root / "knnbench"
    path = bench_dir / "configs" / "fashion-mnist-784-euclidean.json"
    cfg = json.loads(path.read_text())
    cfg["train_rows"] = 600
    write_json(path, cfg)
    write_json(bench_dir / "traffic" / "predict-k10-bf16-call16.json",
               {"entry": "predict", "k": 10, "queries_per_call": 16,
                "pool_queries": 64, "check_queries": 32, "precision": "bf16",
                "limits": {"unanswered": 0, "wrong_label_share": 0.5}})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fmnist784.k10.bf16", "config":
                               "fashion-mnist-784-euclidean", "traffic":
                               "predict-k10-bf16-call16", "chips": 1,
                               "why": "a test"})
    write_json(root / "BENCHMARK.json", bench)
    cell = manifest.cell("fmnist784.k10.bf16", root=root, bench_dir=bench_dir)
    assert cell.limits["wrong_label_share"] == 0.5
    result = run.run_cell(cell, 2**31 + 9, 0.2, False, device="cpu")
    assert seen and all(kw.get("precision") == "bf16" for kw in seen)
    assert result["checks"]["wrong_label_share"]["limit"] == 0.5


@pytest.mark.parametrize("name, rows", [("sift128.k10.batch10k", 3000),
                                        ("fmnist784.k10.batch10k", 900),
                                        ("sift128.k100.batch10k", 3000)])
def test_the_cpu_cut_keeps_each_cells_rows(tiny_cell, name, rows):
    """The one rule of ``cut_to_cpu_size`` gives the rows the CPU tests
    have always run."""
    assert tiny_cell(name).config["train_rows"] == rows
