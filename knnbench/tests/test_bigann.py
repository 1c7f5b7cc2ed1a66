"""The bigann-100M configuration, its mix and its cell, and the two readers
of the train's residency: loaded through the manifest, cut to the CPU's
size by the fixture's one rule, and checked like the other cells."""

from __future__ import annotations

import pytest

import numpy as np
import torch

from knn_tpu_torch.ops import cuda_knn
from knnbench import manifest, run
from knnbench.tests.test_faults import (  # noqa: F401 (a fixture)
    alter_one_answer,
    break_program,
    drop_half,
    fail,
    stale,
)

CELL = "bigann100m.k10.batch10k"
READERS = ("train_card_copies", "train_upload_link_pct")


def test_the_cell_loads_at_its_published_size():
    cell = manifest.cell(CELL)
    assert cell.chips == 1
    assert (cell.config["name"], cell.config["train_rows"],
            cell.config["dim"]) == ("bigann-100m-128-euclidean", 100_000_000,
                                    128)
    assert cell.config["reduced"] == []
    sift = manifest.cell("sift128.k10.batch10k")
    assert cell.limits == sift.limits
    assert cell.config["guarantee"] == sift.config["guarantee"]
    assert {k: v for k, v in cell.traffic.items() if k != "check_queries"} \
        == {k: v for k, v in sift.traffic.items() if k != "check_queries"}
    assert cell.traffic["check_queries"] == 2048
    assert {m.name for m in cell.end_to_end} == {"qps", "setup_s"}
    assert {m.name for m in cell.per_layer} == set(READERS)
    for name in READERS:
        assert name not in {m.name for m in sift.per_layer}


def test_the_cpu_cut_keeps_3000_rows(tiny_cell):
    cell = tiny_cell(CELL)
    assert (cell.config["train_rows"], cell.config["dim"]) == (3000, 128)


def test_the_sound_program_passes_the_check(tiny_cell):
    result = run.run_cell(tiny_cell(CELL), 2**31 + 5, 0.3, True,
                          device="cpu")
    assert result["correct"] and result["failed"] == 0
    # On the CPU the "card" is the host: one operand, padded to 3,072 rows,
    # and no link, so no share of it.
    copies = result["metrics"]["train_card_copies"]
    assert copies == {"value": 3072 / 3000, "unit": "x"}
    assert "train_upload_link_pct" not in result["metrics"]


@pytest.mark.parametrize("fault", [alter_one_answer, drop_half, stale, fail])
def test_each_fault_fails_the_check(tiny_cell, break_program, fault):
    break_program(fault)
    result = run.run_cell(tiny_cell(CELL), 2**31 + 5, 0.3, False,
                          device="cpu")
    assert result["correct"] is False


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_a_record(monkeypatch, name):
    cell = manifest.cell(CELL)
    read = next(m.read for m in cell.per_layer if m.name == name)
    monkeypatch.setattr(cuda_knn, "train_residency", lambda: None)
    assert read(None) is None
    monkeypatch.delattr(cuda_knn, "train_residency")  # a port without it
    assert read(None) is None


@pytest.mark.parametrize("name,want", [("train_card_copies", 1.0),
                                       ("train_upload_link_pct", 50.0)])
def test_the_readers_read_a_made_up_record(monkeypatch, name, want):
    cell = manifest.cell(CELL)
    read = next(m.read for m in cell.per_layer if m.name == name)
    record = {"rows": 100_000_000, "dim": 128, "host_bytes": 51_200_000_000,
              "card_bytes": 51_200_000_000, "blocks": 191, "upload_s": 4.0,
              "stage_s": 2.0, "copy_s": 1.6, "transpose_s": 0.1}
    monkeypatch.setattr(cuda_knn, "train_residency", lambda: dict(record))
    assert read(None) == pytest.approx(want, rel=1e-12)
    record["copy_s"] = None  # a CPU device: nothing crossed a link
    if name == "train_upload_link_pct":
        assert read(None) is None


def test_card_copies_reads_a_row_major_copy_beside_the_operand():
    """The layout before the operand was the one copy (a row-major train in
    the device cache beside it) reads 2.00."""
    read = next(m.read for m in manifest.cell(CELL).per_layer
                if m.name == "train_card_copies")
    x = np.ones((1024, 128), np.float32)
    cache = {}
    cuda_knn.cached_train(x, torch.device("cpu"), cache)
    cuda_knn.route_train(x, torch.device("cpu"), cache, "exact",
                         torch.float32)
    assert read(None) == 2.0
