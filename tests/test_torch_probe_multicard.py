"""The cross-card probe (``knn_tpu_torch/probes/multicard.py``) on the CPU
at a cut size: two logical shards of the host and two gloo ranks, every
engine held equal to the single-device answer and every launcher line to
the single-process CLI's (the probe raises otherwise), one JSON line."""

import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")

from knn_tpu_torch.probes import multicard  # noqa: E402


def test_probe_runs_on_logical_shards_of_the_host():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert multicard.main(["--device", "cpu", "--rows", "600",
                               "--queries", "30", "--shards", "2",
                               "--reps", "1"]) == 0
    doc = json.loads(out.getvalue().splitlines()[-1])
    assert doc["cards"] == 2
    assert set(doc["engines"]) == {"query_sharded_x2", "train_sharded_x2",
                                   "ring_x2"}
    assert {v["dist_backend"] for v in doc["launch"].values()} == {"gloo"}
    assert doc["engines"]["train_sharded_x2"]["bytes"] == 30 * 10 * 2 * 12


def test_probe_refuses_fewer_than_two_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multicard.main([]) == 1
    assert "two or more CUDA cards" in capsys.readouterr().err
