"""One short run of each cell on the card, through the command of
``BENCHMARK.json``. Skips where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from knnbench import gen, manifest, reference


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 100])
def test_train_blocks_give_the_one_block_answer_at_sift_size(
        card, monkeypatch, k):
    """sift's 1,000,000 x 128 train and 4,096 queries: eight train blocks
    rank as the whole train does, bit for bit."""
    cfg = manifest.cell("sift128.k10.batch10k").config
    inputs = gen.make_inputs(cfg, {"queries_per_call": 4096,
                                   "pool_queries": 4096}, 2**31 + 91, "cuda")
    whole = reference.neighbors(inputs["train_x"], inputs["pool"], k, "cuda")
    monkeypatch.setattr(reference, "TRAIN_BLOCK_ELEMENTS", 1 << 24)
    assert -(-cfg["train_rows"] // reference.train_block_rows(
        cfg["train_rows"], cfg["dim"])) >= 8
    streamed = reference.neighbors(inputs["train_x"], inputs["pool"], k,
                                   "cuda")
    for a, b in zip(whole, streamed):
        np.testing.assert_array_equal(a, b)
