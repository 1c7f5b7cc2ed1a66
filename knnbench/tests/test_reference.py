"""The plain reference against brute force, ties included, and the control."""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from knnbench import control, manifest, reference, run


def brute(train, queries, k):
    """Every distance in exact integer arithmetic, then sorted by
    (distance, index)."""
    t, q = train.astype(np.int64), queries.astype(np.int64)
    out = []
    for row in q:
        d = ((t - row) ** 2).sum(axis=1)
        out.append(sorted(range(len(t)), key=lambda j: (d[j], j))[:k])
    return np.array(out)


@pytest.mark.parametrize("n, d, k, seed", list(itertools.product(
    [1, 7, 40], [1, 3, 16], [1, 5], [0, 1])))
def test_neighbors_equal_brute_force_on_grids(n, d, k, seed):
    rng = np.random.default_rng(seed)
    train = rng.integers(0, 4, (n, d)).astype(np.float32)  # many ties
    train[n // 2:] = train[:n - n // 2]  # duplicate rows: distance ties
    queries = rng.integers(0, 4, (9, d)).astype(np.float32)
    k = min(k, n)
    dist, idx = reference.neighbors(train, queries, k)
    np.testing.assert_array_equal(idx, brute(train, queries, k))
    want = ((train[idx].astype(np.float64) - queries[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(dist, want)


def test_blocks_give_the_same_answer(monkeypatch):
    rng = np.random.default_rng(3)
    train = rng.integers(0, 256, (500, 8)).astype(np.float32)
    queries = rng.integers(0, 256, (37, 8)).astype(np.float32)
    whole = reference.neighbors(train, queries, 4)
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 500 * 3)
    blocked = reference.neighbors(train, queries, 4)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n, d, k, block, tile, seed", [
    (40, 3, 5, 7, 10**6, 0),  # duplicate rows, many ties, 6 blocks
    (40, 3, 5, 7, 20, 1),  # with query tiles of 2 queries
    (41, 16, 5, 8, 10**6, 0),  # rows not a multiple of the block
    (30, 3, 12, 5, 10**6, 1),  # k larger than a block's rows
    (1000, 8, 100, 96, 10**6, 2),  # k = 100 over 11 blocks
    (1000, 8, 100, 300, 900, 3),  # k = 100, query tiles of 3 queries
])
def test_train_blocks_give_the_one_block_answer(monkeypatch, n, d, k, block,
                                                tile, seed):
    rng = np.random.default_rng(seed)
    levels = 4 if k < 100 else 256
    train = rng.integers(0, levels, (n, d)).astype(np.float32)
    train[n // 2:] = train[:n - n // 2]  # duplicate rows: distance ties
    queries = rng.integers(0, levels, (13, d)).astype(np.float32)
    whole = reference.neighbors(train, queries, k)
    monkeypatch.setattr(reference, "TRAIN_BLOCK_ELEMENTS", block * d)
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", tile)
    assert reference.train_block_rows(n, d) == block
    streamed = reference.neighbors(train, queries, k)
    for a, b in zip(whole, streamed):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(streamed[1], brute(train, queries, k))


def test_no_tile_or_train_block_exceeds_the_budget(monkeypatch):
    """Every train block and query tile sent to the device and every
    distance tile stays under the budget's element counts, whatever the
    train's rows."""
    rng = np.random.default_rng(6)
    train = rng.integers(0, 16, (997, 16)).astype(np.float32)
    queries = rng.integers(0, 16, (29, 16)).astype(np.float32)
    whole = reference.neighbors(train, queries, 10)
    monkeypatch.setattr(reference, "TRAIN_BLOCK_ELEMENTS", 100 * 16)
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 512)
    uploads, tiles = [], []
    on_device, smallest = reference._on_device, reference._smallest

    def count_upload(rows, device, operands):
        uploads.append(rows.size)
        return on_device(rows, device, operands)

    def count_tile(d, k):
        tiles.append(d.numel())
        return smallest(d, k)
    monkeypatch.setattr(reference, "_on_device", count_upload)
    monkeypatch.setattr(reference, "_smallest", count_tile)
    streamed = reference.neighbors(train, queries, 10)
    for a, b in zip(whole, streamed):
        np.testing.assert_array_equal(a, b)
    assert max(uploads) <= 100 * 16 and max(tiles) <= 512
    assert len(tiles) == 10 * 6  # 10 train blocks, 6 tiles of 5 queries


def test_vote_ties_go_to_the_lowest_class():
    labels = np.array([[2, 1, 1, 2], [3, 3, 0, 0], [4, 4, 4, 1], [5, 6, 7, 8]])
    np.testing.assert_array_equal(reference.vote(labels, 9), [1, 0, 4, 5])


@pytest.mark.parametrize("operands, x, want", [
    ("tf32", 1 + 2.0**-11, 1 + 2.0**-10),  # a tie rounds away from zero
    ("tf32", 1 + 2.0**-12, 1.0),
    ("tf32", -(1 + 3 * 2.0**-12), -(1 + 2.0**-10)),
    ("bf16", 1 + 2.0**-8, 1.0),  # a tie rounds to even
    ("bf16", 1 + 3 * 2.0**-8, 1 + 2.0**-6),
    (None, 1 + 2.0**-20, 1 + 2.0**-20),
])
def test_operands_keep_their_significand(operands, x, want):
    got = reference.round_operands(torch.tensor([x], dtype=torch.float32),
                                   operands)
    assert got.dtype == torch.float32 and got.item() == want


def test_distances_of_named_rows():
    rng = np.random.default_rng(5)
    train = rng.random((50, 6), dtype=np.float32)
    queries = rng.random((4, 6), dtype=np.float32)
    idx = rng.integers(0, 50, (4, 3))
    want = ((train[idx].astype(np.float64) - queries[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(reference.distances(train, queries, idx), want)
    dist, near = reference.neighbors(train, queries, 3)
    np.testing.assert_array_equal(reference.distances(train, queries, near), dist)


@pytest.mark.parametrize("tile", [None, 4 * 2 * 6 * 3])
def test_distances_equal_the_gather_on_the_device(monkeypatch, tile):
    """The rows gathered on the host give what gathering from the whole
    train on the device gave, bit for bit, in one block or in many."""
    rng = np.random.default_rng(7)
    train = rng.random((300, 6), dtype=np.float32)
    queries = rng.random((11, 6), dtype=np.float32)
    idx = rng.integers(0, 300, (11, 2))
    t = torch.as_tensor(train)
    near = t[torch.as_tensor(idx)].to(torch.float64)
    x = torch.as_tensor(queries).to(torch.float64)
    want = ((near - x[:, None]) ** 2).sum(-1).numpy()
    if tile:
        monkeypatch.setattr(reference, "BLOCK_ELEMENTS", tile)  # 3 queries
    np.testing.assert_array_equal(reference.distances(train, queries, idx),
                                  want)


@pytest.mark.parametrize("operands", ["tf32", "bf16"])
def test_lower_operands_depart_on_the_cells_data(operands):
    rng = np.random.default_rng(4)
    train = (rng.integers(0, 256, (2000, 128)) / 255).astype(np.float32)
    queries = (rng.integers(0, 256, (16, 128)) / 255).astype(np.float32)
    exact_d, exact = reference.neighbors(train, queries, 10)
    low_d, low = reference.neighbors(train, queries, 10, operands=operands)
    assert np.abs(low_d - exact_d).max() > 1e-5 * exact_d.max()
    # Integers are exact in both: the precision shows only on scaled values.
    ints = np.round(train * 255)
    np.testing.assert_array_equal(
        reference.neighbors(ints, np.round(queries * 255), 10)[0],
        reference.neighbors(ints, np.round(queries * 255), 10,
                            operands=operands)[0])


@pytest.mark.parametrize("name, system, rows, compared, failed", [
    ("sift128.k10.batch10k", "reference-tf32", 3000, 64, "rank_gap"),
    ("sift128.k100.batch10k", "reference-tf32", 3000, 64, "rank_gap"),
    ("fmnist784.k10.batch10k", "program-bf16", 60000, 512,
     "wrong_label_share"),
])
def test_the_control_fails_the_check(tiny_root, name, system, rows, compared,
                                     failed):
    """The control in the program's place is not correct: the reference
    with TF32 operands for ``kneighbors``, the program's own bfloat16 form
    for ``predict``. The sift cells at few rows; fashion-mnist at its
    published rows, where near neighbors lie close enough for the vote to
    turn."""
    cell = manifest.cell(name, root=tiny_root, bench_dir=tiny_root / "knnbench")
    cell = dataclasses.replace(
        cell, config={**cell.config, "train_rows": rows},
        traffic={**cell.traffic, "queries_per_call": compared,
                 "pool_queries": compared, "check_queries": compared})
    result = run.run_cell(cell, 2**31 + 21, 0.01, False, device="cpu",
                          make_system=control.SYSTEMS[system])
    assert result["correct"] is False
    check = result["checks"][failed]
    assert check["value"] > check["limit"]
