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


# The feature-major staging's edges: feature counts around the tile kernel's
# 16-feature chunk and the stripe scan's float4 groups (and its wider tile
# past 64 features), N and n_valid off the 128-row tiles, Q off the
# 128-query blocks and Q = 1, NaN rows, k on both selection paths.
STAGING_D = (1, 11, 15, 16, 17, 33, 65, 130, 784, 1000)
STAGING_K = (1, 10, 16, 17, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 130])
@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("k", STAGING_K)
@pytest.mark.parametrize("d", STAGING_D)
def test_feature_major_staging_edges(card, d, k, kind, q):
    # Bit-equal keys against the plain versions: every form on integer
    # grids, the exact forms on float rows; at each kernel's own plan and at
    # splits of 332 rows (ending inside a tile, starting on 16-byte rows).
    rng = np.random.default_rng(d * 100 + k)
    n, n_valid = 1001, 990
    if kind == "grid":
        train, test = _grid(rng, n, q, d)
    else:
        train = rng.standard_normal((n, d)).astype(np.float32)
        test = rng.standard_normal((q, d)).astype(np.float32)
        train[7, d // 2] = np.nan
    test[0, 0] = np.nan if q > 1 else test[0, 0]
    t, qt = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    forms = ("exact", "fast") if kind == "grid" else ("exact",)
    for form in forms:
        for plan in (tile_knn.tile_split_plan(n_valid, q, sm, k, form),
                     (3, 332)):
            got = tile_knn.knn_tile_scan(t, qt, n_valid, k, form, *plan)
            want = tile_knn.knn_tile_scan_reference(t, qt, n_valid, k, form,
                                                    *plan)
            assert torch.equal(got, want), (form, plan)
    if d <= cuda_knn.STRIPE_MAX_D and k <= cuda_knn.STRIPE_MAX_K:
        for plan in (cuda_knn.split_plan(n_valid, q, sm), (3, 332)):
            got = cuda_knn.knn_stripe_scan(t, qt, n_valid, k, *plan)
            want = cuda_knn.knn_stripe_scan_reference(t, qt, n_valid, k, *plan)
            assert torch.equal(got, want), plan
        kd, ki = cuda_knn.knn_stripe_candidates(t, qt, n_valid, k)
        rd, ri = cuda_knn.knn_stripe_candidates_reference(t, qt, n_valid, k)
        assert torch.equal(ki, ri) and torch.equal(kd, rd)


@pytest.mark.cuda
def test_feature_major_train_is_kept_and_misaligned_splits_raise(card):
    rng = np.random.default_rng(0)
    train, test = _grid(rng, 700, 50, 11)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    cuda_knn.knn_stripe_scan(t, q, 700, 5, 3, 256)
    kept = cuda_knn.feature_major(t, cache=True)
    tile_knn.knn_tile_scan(t, q, 700, 5, "fast", 3, 256)
    assert cuda_knn.feature_major(t, cache=True) is kept
    # Bit for bit (the grid has a NaN, which torch.equal never matches).
    assert torch.equal(kept.cpu().view(torch.int32),
                       cuda_knn.feature_major(t.cpu()).view(torch.int32))
    for call in (lambda: cuda_knn.knn_stripe_scan(t, q, 700, 5, 3, 250),
                 lambda: cuda_knn.knn_stripe_scan_variant(t, q, 700, 5,
                                                          "lite", 3, 250),
                 lambda: tile_knn.knn_tile_scan(t, q, 700, 5, "exact", 3,
                                                250)):
        with pytest.raises(ValueError, match="multiple of 4 rows"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("d", [1, 11, 64, 65, 128])
def test_stripe_split_plan_is_one_wave(card, d, k):
    # The plan sizes one wave at the blocks per SM that the kernel's
    # registers and shared memory allow.
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    blocks = cuda_knn.stripe_blocks_per_sm(card, d, k)
    assert 1 <= blocks <= 16
    for n_valid, q in ((1_016_499, 1718), (30_803, 1718), (990, 1)):
        n_splits, rows = cuda_knn.stripe_split_plan(n_valid, q, card, d, k)
        assert n_splits * -(-q // 128) <= sm * blocks
        assert rows % cuda_knn._TILE_ROWS == 0 and n_splits * rows >= n_valid


def _model_problem(seed, n=3000, q=300, d=7, classes=5):
    rng = np.random.default_rng(seed)
    train, test = _grid(rng, n, q, d)
    labels = rng.integers(0, classes, n).astype(np.int32)
    targets = rng.normal(size=n).astype(np.float32)
    return (dataset_from_arrays(train, labels, raw_targets=targets),
            dataset_from_arrays(test, np.zeros(q, np.int32)))


def _stripe_launches():
    return (cuda_knn.knn_stripe_scan.launches,
            cuda_knn.knn_stripe_merge.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "stripe", "xla"])
def test_async_on_the_card_equals_sync_and_host(card, engine):
    from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor

    train, test = _model_problem(11)
    model = KNNClassifier(k=5, engine=engine).fit(train)
    host = KNNClassifier(k=5, engine=engine, device="cpu").fit(train)
    before = _stripe_launches()
    handles = [model.kneighbors_async(test) for _ in range(4)]
    want_d, want_i = model.kneighbors(test)
    moved = _stripe_launches() != before
    assert moved == (engine != "xla")
    for h in handles:
        d, i = h.result()
        assert np.array_equal(d, want_d) and np.array_equal(i, want_i)
    host_d, host_i = host.kneighbors(test)
    assert np.array_equal(want_i, host_i) and np.array_equal(want_d, host_d)
    assert np.array_equal(model.predict_async(test).result(),
                          host.predict(test))
    reg = KNNRegressor(k=5, weights="distance", engine=engine).fit(train)
    assert np.array_equal(reg.predict_async(test).result(),
                          KNNRegressor(k=5, weights="distance", engine=engine,
                                       device="cpu").fit(train).predict(test))


@pytest.mark.cuda
@pytest.mark.parametrize("k,chunk_rows", [(5, 64), (5, 301), (20, 100)])
def test_chunked_deferred_retrieval_on_the_card(card, k, chunk_rows):
    train, test = _model_problem(12, q=1000)
    resolve = cuda_knn.stripe_candidates_arrays(
        train.features, test.features, k, chunk_rows=chunk_rows,
        deferred=True)
    d, i = resolve()
    want_d, want_i = cuda_knn.stripe_candidates_arrays(
        train.features, test.features, k, device="cpu")
    assert np.array_equal(d, want_d) and np.array_equal(i, want_i)
    assert resolve()[1] is i
    empty = cuda_knn.stripe_candidates_arrays(
        train.features, test.features[:0], k, deferred=True)()
    assert empty[0].shape == empty[1].shape == (0, k)


@pytest.mark.cuda
def test_chunk_cap_bounds_the_partial_keys(card):
    for n, q, d, k, form in ((30_803, 659_712, 11, 5, "exact"),
                             (30_803, 200_000, 11, 128, "exact"),
                             (65_536, 100_000, 784, 1000, "fast")):
        rows = cuda_knn.candidate_chunk_rows(n, q, card, d, k, form)
        splits = cuda_knn.route_split_plan(n, rows, card, d, k, form)[0]
        assert 1 <= rows <= q
        assert rows == q or rows * splits * k * 8 <= cuda_knn.PARTIAL_BYTES_CAP


@pytest.mark.cuda
def test_radius_on_the_card_launches_the_large_k_tile_scan(card):
    from knn_tpu_torch.models.knn import radius_neighbors_arrays

    rng = np.random.default_rng(13)
    train = rng.uniform(0, 10, (2000, 4)).astype(np.float32)
    test = rng.uniform(0, 10, (200, 4)).astype(np.float32)
    before = (tile_knn.knn_tile_scan.launches["exact"],
              cuda_knn.knn_stripe_merge.launches)
    d, i, mask = radius_neighbors_arrays(train, test, 2.0)
    assert (tile_knn.knn_tile_scan.launches["exact"] > before[0]
            and cuda_knn.knn_stripe_merge.launches > before[1])
    hd, hi, hmask = radius_neighbors_arrays(train, test, 2.0, device="cpu")
    assert d.shape == (200, 128)
    assert np.array_equal(i, hi) and np.array_equal(d, hd)
    assert np.array_equal(mask, hmask)
    bf = ((test[:, None, :] - train[None, :, :]) ** 2).sum(-1)
    for row in range(0, 200, 17):
        assert set(i[row][mask[row]].tolist()) == set(
            np.nonzero(bf[row] <= 2.0)[0].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_sweep_on_the_card_is_one_retrieval(card, engine):
    from knn_tpu_torch.models.knn import KNNClassifier, sweep_k

    train, test = _model_problem(14)
    sweep_k(train, test, [1, 5, 10], engine=engine)  # build, upload
    before = _stripe_launches()
    got = sweep_k(train, test, [1, 5, 10], engine=engine)
    after = _stripe_launches()
    want = (1, 1) if engine == "auto" else (0, 0)
    assert (after[0] - before[0], after[1] - before[1]) == want
    host = sweep_k(train, test, [1, 5, 10], engine=engine, device="cpu")
    for k in (1, 5, 10):
        assert np.array_equal(got[k], host[k])
        assert np.array_equal(got[k], KNNClassifier(k=k, engine=engine).fit(
            train).predict(test))
