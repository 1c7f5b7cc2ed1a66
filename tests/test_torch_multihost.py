"""The multi-process path on the port (``knn_tpu_torch/parallel/
multihost.py`` through ``python -m knn_tpu_torch.parallel.launch``), the
twin of ``tests/test_multihost.py``: two real processes on the CPU joined
by a ``gloo`` process group (the launcher's choice without a card),
against the single-process JAX answer computed in this test process.

Every subprocess has its own timeout, and the launcher its own
``--timeout``, so a hung group fails the test instead of the suite.
Tolerances: predictions exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.data.arff import load_arff  # noqa: E402
from knn_tpu.parallel.query_sharded import predict_query_sharded  # noqa: E402
from knn_tpu_torch.parallel.launch import free_port  # noqa: E402
from tests import fixtures  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def small():
    d = fixtures.datasets_dir()
    tr, te = d / "small-train.arff", d / "small-test.arff"
    train, test = load_arff(str(tr)), load_arff(str(te))
    want = predict_query_sharded(train.features, train.labels,
                                 test.features, 5, train.num_classes)
    return str(tr), str(te), want


def _launch(args, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.parallel.launch",
         "--device", "cpu", "--timeout", str(timeout - 20), *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))


@pytest.mark.parametrize("strategy,extra", [
    ("query-sharded", []),
    ("query-sharded", ["--engine", "xla"]),
    ("train-sharded", []),
])
def test_two_process_launch_matches_jax(tmp_path, small, strategy, extra):
    tr, te, want = small
    dump = tmp_path / "preds.npy"
    proc = _launch(["-np", "2", "--devices-per-proc", "2", tr, te, "5",
                    "--strategy", strategy, *extra, "--json",
                    "--dump-predictions", str(dump)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "process group backend gloo" in proc.stderr
    lines = proc.stdout.splitlines()
    assert "Accuracy was" in lines[0]
    rec = json.loads(lines[1])
    assert rec["dist_backend"] == "gloo" and rec["world_size"] == 2
    assert rec["strategy"] == strategy
    np.testing.assert_array_equal(np.load(dump), want)


def test_train_sharded_stripe_engine_is_a_usage_error():
    proc = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.parallel.multihost",
         "train.arff", "test.arff", "5",
         "--strategy", "train-sharded", "--engine", "stripe"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 2, proc.stderr[-500:]
    assert "xla engine only" in proc.stderr


def test_lost_coordinator_degrades_to_solo_counted(tmp_path, small):
    # A rendezvous that never forms is a WorkerLostError: each process
    # moves, counted and logged, to one process on its own device (the
    # host here, as asked), never to another backend.
    tr, te, want = small
    dump = tmp_path / "preds.npy"
    metrics = tmp_path / "m.json"
    proc = _launch(["-np", "2", tr, te, "5", "--dump-predictions",
                    str(dump), "--metrics-out", str(metrics)],
                   env={"KNN_TPU_FAULTS": "multihost.init=always",
                        "KNN_TPU_RETRY_BASE_MS": "0"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "degrading to single-process" in proc.stderr
    np.testing.assert_array_equal(np.load(dump), want)
    doc = json.loads(metrics.read_text())
    assert doc["processes"] == 1
    lost = doc["metrics"]["knn_worker_lost_total"]
    assert lost[0]["labels"] == {"reason": "injected", "proc": "0"}
    moves = doc["metrics"]["knn_fallback_total"]
    assert moves[0]["labels"]["to"] == "solo"


def test_cli_mpi_persona_under_torchrun_variables(tmp_path, small):
    # torchrun's variables (MASTER_ADDR, RANK, WORLD_SIZE) make the CLI
    # join the group before it classifies: --persona mpi then spans both
    # processes, and every rank prints the same line and predictions.
    tr, te, want = small
    port = free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "knn_tpu_torch", tr, te, "5",
             "--persona", "mpi", "--device", "cpu", "--dump-predictions",
             str(tmp_path / f"p{rank}.npy")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "Accuracy was" in out
    for rank in (0, 1):
        np.testing.assert_array_equal(np.load(tmp_path / f"p{rank}.npy"),
                                      want)
