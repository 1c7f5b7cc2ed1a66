"""Tests of the port that need a CUDA card; they skip without one.

The machine with the card has no ``jax``, and ``tests/conftest.py`` imports
it, so this file imports nothing of ``jax`` or ``knn_tpu`` and is run there
without the conftest:

    python -m pytest --noconftest tests/test_torch_card.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu_torch.backends import cuda as cuda_backend  # noqa: E402
from knn_tpu_torch.backends import get_backend  # noqa: E402
from knn_tpu_torch.backends.oracle import knn_oracle  # noqa: E402
from knn_tpu_torch.convert import dataset_from_arrays  # noqa: E402
from knn_tpu_torch.ops import cuda_knn, tile_knn  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _grid(rng, n, q, d):
    train = rng.integers(0, 4, (n, d)).astype(np.float32)
    train[n // 2 : n // 2 + 100] = train[:100]  # dist == 0 ties
    train[5, 0] = np.nan
    test = rng.integers(0, 4, (q, d)).astype(np.float32)
    return train, test


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(1, 1), (11, 10), (128, 16)])
def test_kernel_equals_plain_version(card, d, k):
    rng = np.random.default_rng(d + k)
    train, test = _grid(rng, 2000, 300, d)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    before = (cuda_knn.knn_stripe_scan.launches,
              cuda_knn.knn_stripe_merge.launches)
    kd, ki = cuda_knn.knn_stripe_candidates(t, q, 1990, k)
    rd, ri = cuda_knn.knn_stripe_candidates_reference(t, q, 1990, k)
    torch.cuda.synchronize()
    assert (cuda_knn.knn_stripe_scan.launches,
            cuda_knn.knn_stripe_merge.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(ki, ri) and torch.equal(kd, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits,rows", [(1, 2000), (7, 320), (32, 64)])
def test_scan_and_merge_equal_their_plain_versions(card, n_splits, rows):
    rng = np.random.default_rng(n_splits)
    train, test = _grid(rng, 2000, 300, 11)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    n_valid = min(1990, n_splits * rows)
    partial = cuda_knn.knn_stripe_scan(t, q, n_valid, 5, n_splits, rows)
    want = cuda_knn.knn_stripe_scan_reference(t, q, n_valid, 5, n_splits, rows)
    assert torch.equal(partial, want)
    for got, ref in zip(cuda_knn.knn_stripe_merge(partial),
                        cuda_knn.knn_stripe_merge_reference(partial)):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_backend_predicts_like_the_oracle(card):
    rng = np.random.default_rng(1)
    train, test = _grid(rng, 3000, 200, 7)
    labels = rng.integers(0, 5, 3000).astype(np.int32)
    got = cuda_backend.predict_arrays(train, labels, test, 5, 5)
    np.testing.assert_array_equal(got, knn_oracle(train, labels, test, 5, 5))
    np.testing.assert_array_equal(
        got, cuda_backend.predict_arrays(train, labels, test, 5, 5, device="cpu"))


@pytest.mark.cuda
def test_wrapper_rejects_host_and_card_mix(card):
    with pytest.raises(ValueError):
        cuda_knn.knn_stripe_candidates(
            torch.zeros(10, 3, device=card), torch.zeros(2, 3), 10, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["exact", "fast", "bf16"])
@pytest.mark.parametrize("d,k", [(1, 1), (129, 5), (784, 16)])
def test_tile_kernel_equals_plain_version(card, form, d, k):
    # Integer grids: every form's products and sums are exact, so the keys
    # are bit-equal whatever order the plain version's matmul sums in.
    rng = np.random.default_rng(d + k)
    train, test = _grid(rng, 2000, 300, d)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    if form == "bf16":
        t = t.to(torch.bfloat16)
    before = (tile_knn.knn_tile_scan.launches[form],
              cuda_knn.knn_stripe_merge.launches)
    kd, ki = tile_knn.knn_tile_candidates(t, q, 1990, k, form)
    rd, ri = tile_knn.knn_tile_candidates_reference(t, q, 1990, k, form)
    torch.cuda.synchronize()
    assert (tile_knn.knn_tile_scan.launches[form],
            cuda_knn.knn_stripe_merge.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(ki, ri) and torch.equal(kd, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits,rows", [(1, 2048), (5, 384), (16, 128)])
def test_tile_scan_equals_its_plain_version_on_floats_exact_form(
        card, n_splits, rows):
    # The exact form rounds twice in both: bit-equal on float data too.
    rng = np.random.default_rng(n_splits)
    train = rng.standard_normal((2000, 300)).astype(np.float32)
    test = rng.standard_normal((200, 300)).astype(np.float32)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    n_valid = min(1990, n_splits * rows)
    got = tile_knn.knn_tile_scan(t, q, n_valid, 5, "exact", n_splits, rows)
    want = tile_knn.knn_tile_scan_reference(t, q, n_valid, 5, "exact",
                                            n_splits, rows)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast", "bf16", "auto"])
@pytest.mark.parametrize("engine", ["auto", "merge"])
def test_cuda_tile_backend_predicts_like_the_oracle(card, precision, engine):
    rng = np.random.default_rng(2)
    train, test = _grid(rng, 3000, 200, 200)
    labels = rng.integers(0, 5, 3000).astype(np.int32)
    tr = dataset_from_arrays(train, labels)
    te = dataset_from_arrays(test, np.zeros(200, np.int32))
    got = get_backend("cuda-tile")(tr, te, 5, precision=precision,
                                   engine=engine)
    np.testing.assert_array_equal(got, knn_oracle(train, labels, test, 5, 5))
    np.testing.assert_array_equal(
        got, get_backend("cuda-tile")(tr, te, 5, precision=precision,
                                      engine=engine, device="cpu"))


@pytest.mark.cuda
def test_tile_wrapper_rejects_host_and_card_mix(card):
    with pytest.raises(ValueError):
        tile_knn.knn_tile_candidates(
            torch.zeros(10, 300, device=card), torch.zeros(2, 300), 10, 1, "fast")
