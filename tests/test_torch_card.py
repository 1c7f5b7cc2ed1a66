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
from knn_tpu_torch.ops import cuda_knn, probe_matmul, tile_knn  # noqa: E402


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


def _plan(rows):
    """split_plan's layout (one 64-row tile per split at this size), or
    splits of ``rows`` rows, which span several tiles."""
    return (cuda_knn.split_plan(1990, 300, 132) if rows is None
            else (-(-1990 // rows), rows))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 256])
@pytest.mark.parametrize("k", [17, 32, 100, 256, 257, 1000, 1990])
def test_big_k_stripe_kernels_equal_their_plain_versions(card, k, rows):
    # The stripe route at k > 16: the tile kernel's exact form over the
    # stripe scan's split layouts, then the merge; and the whole route.
    rng = np.random.default_rng(k)
    train, test = _grid(rng, 2000, 300, 11)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    plan = _plan(rows)
    partial = tile_knn.knn_tile_scan(t, q, 1990, k, "exact", *plan)
    assert torch.equal(partial, tile_knn.knn_tile_scan_reference(
        t, q, 1990, k, "exact", *plan))
    for got, ref in zip(cuda_knn.knn_stripe_merge(partial),
                        cuda_knn.knn_stripe_merge_reference(partial)):
        assert torch.equal(got, ref)
    kd, ki = cuda_knn.knn_stripe_candidates(t, q, 1990, k)
    rd, ri = cuda_knn.knn_stripe_candidates_reference(t, q, 1990, k)
    assert torch.equal(ki, ri) and torch.equal(kd, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (16, 128), (3, 700)])
@pytest.mark.parametrize("form", ["exact", "fast", "bf16"])
@pytest.mark.parametrize("k", [17, 256, 257, 1000, 1990, 2000])
def test_big_k_tile_kernel_equals_plain_version(card, form, k, plan):
    # Splits shorter than k (16 of 128 rows), longer, and the wrapper's own
    # plan; k past the valid rows leaves sentinels.
    rng = np.random.default_rng(k)
    train, test = _grid(rng, 2000, 300, 129)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    if plan is None:
        kd, ki = tile_knn.knn_tile_candidates(t, q, 1990, k, form)
    else:
        partial = tile_knn.knn_tile_scan(t, q, 1990, k, form, *plan)
        assert torch.equal(partial, tile_knn.knn_tile_scan_reference(
            t, q, 1990, k, form, *plan))
        kd, ki = cuda_knn.knn_stripe_merge(partial)
    rd, ri = tile_knn.knn_tile_candidates_reference(t, q, 1990, k, form)
    assert torch.equal(ki, ri) and torch.equal(kd, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("metric,precision,k", [
    ("euclidean", "exact", 40), ("euclidean", "fast", 5),
    ("manhattan", "exact", 5), ("chebyshev", "exact", 5),
    ("cosine", "exact", 300)])
def test_xla_route_on_the_card_predicts_like_the_host(card, metric, precision,
                                                      k, engine):
    rng = np.random.default_rng(k)
    train, test = _grid(rng, 3000, 200, 7)
    train[5, 0] = 0.0
    labels = rng.integers(0, 5, 3000).astype(np.int32)
    kw = dict(metric=metric, precision=precision, engine=engine)
    for extra in ({}, {"force_tiled": True, "train_tile": 512},
                  {"query_batch": 64}):
        got = cuda_backend.predict_arrays(train, labels, test, k, 5, **kw,
                                          **extra)
        want = cuda_backend.predict_arrays(train, labels, test, k, 5, **kw,
                                           **extra, device="cpu")
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 256, 200])
@pytest.mark.parametrize("mode", ["rounds", "lite", "nosel"])
@pytest.mark.parametrize("d,k", [(1, 1), (11, 5), (64, 16)])
def test_selection_variants_equal_their_plain_versions(card, mode, d, k, rows):
    rng = np.random.default_rng(d + k)
    train, test = _grid(rng, 2000, 300, d)
    if mode == "lite":  # lite's gate: no NaN
        train[5, 0] = 0.0
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    plan = _plan(rows)
    before = cuda_knn.knn_stripe_scan_variant.launches[mode]
    got = cuda_knn.knn_stripe_scan_variant(t, q, 1990, k, mode, *plan)
    want = cuda_knn.knn_stripe_scan_variant_reference(t, q, 1990, k, mode,
                                                      *plan)
    torch.cuda.synchronize()
    assert cuda_knn.knn_stripe_scan_variant.launches[mode] == before + 1
    assert torch.equal(got, want)
    if mode != "nosel":
        md, mi = cuda_knn.knn_stripe_merge(got)
        rd, ri = cuda_knn.knn_stripe_candidates(t, q, 1990, k)
        assert torch.equal(mi, ri) and torch.equal(md, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,block_n", [(700, 100, 128), (4096, 784, 1024),
                                         (1000, 37, 8), (5000, 784, 1024),
                                         (4099, 64, 256), (130, 1, 8),
                                         (3001, 1000, 8)])
def test_probe_matmul_equals_plain_version_on_integer_grids(card, n, d, block_n):
    rng = np.random.default_rng(n)
    r, f = np.arange(n)[:, None], np.arange(d)[None, :]
    train = ((r * 7 + f * 3 + rng.integers(0, 3, (n, d))) % 5).astype(np.float32)
    test = rng.integers(0, 4, (200, d)).astype(np.float32)
    t = torch.from_numpy(train).to(card, torch.bfloat16)
    q = torch.from_numpy(test).to(card, torch.bfloat16)
    before = probe_matmul.pure_matmul.launches
    got = probe_matmul.pure_matmul(t, q, block_n)
    want = probe_matmul.pure_matmul_reference(t, q, block_n)
    torch.cuda.synchronize()
    assert probe_matmul.pure_matmul.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (3, 700)])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k", [(1, 1), (15, 16), (64, 17), (129, 5),
                                 (784, 256), (1000, 16)])
def test_bf16_wgmma_kernel_equals_plain_version(card, d, k, store, plan):
    # The tensor-core bf16 kernel on integer grids (every product and
    # partial sum exact): keys bit-equal at its own plan and at splits that
    # end inside a 128-row tile, N and Q off the tile sizes.
    rng = np.random.default_rng(d + k)
    train, test = _grid(rng, 2000, 300, d)
    t = torch.from_numpy(train).to(card, store)
    q = torch.from_numpy(test).to(card)
    if plan is None:
        sm = torch.cuda.get_device_properties(card).multi_processor_count
        plan = tile_knn.tile_split_plan(1990, 300, sm, k, "bf16")
    before = tile_knn.knn_tile_scan.launches["bf16"]
    got = tile_knn.knn_tile_scan(t, q, 1990, k, "bf16", *plan)
    want = tile_knn.knn_tile_scan_reference(t, q, 1990, k, "bf16", *plan)
    torch.cuda.synchronize()
    assert tile_knn.knn_tile_scan.launches["bf16"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 64, 129, 784])
def test_bf16_operand_on_the_card_equals_the_hosts(card, d):
    x = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (300, d)).astype(np.float32))
    got = tile_knn.bf16_operand(x.to(card), cache=True)
    assert got.device.type == "cuda" and got.data_ptr() % 16 == 0
    assert torch.equal(got.cpu(), tile_knn.bf16_operand(x))
