"""One short run of each cell on the card, through the command of
``BENCHMARK.json``. Skips where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from knnbench import manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_a_short_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "knnbench", "--workload", name, "--seed",
         str(2**31 + 77), "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
