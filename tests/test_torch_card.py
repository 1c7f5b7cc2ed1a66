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


def _bigk_case(case, d):
    """``(train, test, n_valid)`` for the k > 16 selection: 3,001 integer
    rows (n_valid 2,924), 300 queries (the last query block holds 44).
    ``grid``: small integers, duplicated rows, NaN rows; ``descending``:
    every query's distance falls with the row index, so every row passes
    its threshold and the buffers overflow; ``equal``: one distance for
    every row of a query, so the lowest indices win; ``nan``: half the rows
    NaN."""
    n, q = 3001, 300
    rng = np.random.default_rng(d * 7 + len(case))
    if case == "grid":
        train, test = _grid(rng, n, q, d)
        train[rng.choice(n, 200, replace=False), rng.integers(0, d, 200)] = np.nan
    elif case == "descending":
        train = np.zeros((n, d), np.float32)
        train[:, 0] = np.arange(n, 0, -1)
        test = rng.integers(0, 2, (q, d)).astype(np.float32)
    elif case == "equal":
        train = np.ones((n, d), np.float32)
        test = rng.integers(0, 3, (q, d)).astype(np.float32)
    else:
        train, test = _grid(rng, n, q, d)
        train[rng.choice(n, n // 2, replace=False), 0] = np.nan
    return train, test, n - 77


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid", "descending", "equal", "nan"])
@pytest.mark.parametrize("d", [11, 128, 784])
@pytest.mark.parametrize("k", [17, 100, 128, 256, 1000])
@pytest.mark.parametrize("form", ["exact", "fast"])
def test_k_over_16_selection_keys_equal_plain_version(card, form, k, d, case):
    # The CUDA-core forms' k > 16 selection (candidates filtered in the
    # epilogue, buffered and folded in batches, overflow rounds) at the
    # wrapper's plan and at splits of 128 rows (fewer valid rows than k
    # from k = 128 on) and 700 rows; integer data, so the fast form's keys
    # are exact too. Keys bit-equal per (query, split).
    train, test, n_valid = _bigk_case(case, d)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    plans = [tile_knn.tile_split_plan(n_valid, 300, sm, k, form),
             (-(-n_valid // 128), 128), (-(-n_valid // 700), 700)]
    for plan in plans:
        got = tile_knn.knn_tile_scan(t, q, n_valid, k, form, *plan)
        want = tile_knn.knn_tile_scan_reference(t, q, n_valid, k, form, *plan)
        assert torch.equal(got, want), (plan, int((got != want).sum()))


@pytest.mark.cuda
def test_k_over_16_selection_counters_count_on_the_card(card):
    # With obs on the kernel adds its totals on the card; every row passes
    # on descending rows, so the first tile's 128 keys a query overflow the
    # 64-key buffers.
    from knn_tpu_torch import obs

    train, test, n_valid = _bigk_case("descending", 11)
    t, q = torch.from_numpy(train).to(card), torch.from_numpy(test).to(card)
    before = tile_knn.selection_counters()
    tile_knn.knn_tile_scan(t, q, n_valid, 100, "exact", 1, 3072)
    assert tile_knn.selection_counters() == before  # obs off: no totals
    was = obs.enabled()
    obs.enable()
    try:
        tile_knn.knn_tile_scan(t, q, n_valid, 100, "exact", 1, 3072)
    finally:
        if not was:
            obs.disable()
    got = tile_knn.selection_counters()
    delta = {name: got[name] - before[name] for name in got}
    assert delta["candidates"] == 300 * n_valid  # every row passes
    assert delta["folds"] >= 300 * n_valid // 64
    assert delta["overflow_rounds"] >= 1
    assert tile_knn.knn_tile_scan.candidates == got["candidates"]


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


@pytest.mark.cuda
def test_real_out_of_memory_is_classified_oom(card):
    from knn_tpu_torch.resilience.errors import DeviceError, classify_exception

    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(1 << 48, dtype=torch.uint8, device=card)
    err = classify_exception(ei.value, "device.put")
    assert isinstance(err, DeviceError) and err.oom and not err.transient
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_card_rung_fault_raises_and_no_host_rung_answers(card):
    from knn_tpu_torch.resilience import degrade, faults
    from knn_tpu_torch.resilience.errors import DeviceError

    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (500, 9)).astype(np.float32)
    y = rng.integers(0, 5, 500).astype(np.int32)
    train = dataset_from_arrays(x, y)
    test = dataset_from_arrays(x[:300], y[:300])
    want = knn_oracle(x, y, x[:300], 5, 5)
    for backend in ("cuda", "cuda-tile"):
        before = cuda_knn.knn_stripe_scan.launches
        with faults.inject("device.put=always"):
            with pytest.raises(DeviceError):
                degrade.predict_with_ladder(backend, train, test, 5)
        assert cuda_knn.knn_stripe_scan.launches == before
        with faults.inject("backend.compile=once") as plan:
            res = degrade.predict_with_ladder(backend, train, test, 5)
        assert plan.stats()["backend.compile"]["fired"] == 1
        assert res.backend == backend and not res.degraded
        np.testing.assert_array_equal(res.predictions, want)
    with faults.inject("device.put=once:oom"):
        res = degrade.predict_with_ladder("cuda", train, test, 5)
    assert res.backend == "cuda" and res.opts["query_batch"] == 150
    np.testing.assert_array_equal(res.predictions, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,form", [(9, 32, "exact"), (200, 5, "exact")])
def test_oom_halving_reruns_the_tile_kernel(card, monkeypatch, d, k, form):
    # Outside stripe_route_ok the halved rerun runs the same tile kernel,
    # query_batch rows a launch, and never the XLA route's ops.
    from knn_tpu_torch.resilience import degrade, faults

    for name in ("knn_forward", "forward_tiled_core",
                 "_predict_query_batched"):
        monkeypatch.setattr(cuda_backend, name, lambda *a, _n=name, **kw:
                            pytest.fail(f"the XLA route ran ({_n})"))
    rng = np.random.default_rng(d + k)
    x = rng.integers(0, 4, (3000, d)).astype(np.float32)
    y = rng.integers(0, 5, 3000).astype(np.int32)
    train = dataset_from_arrays(x, y)
    test = dataset_from_arrays(x[:300], y[:300])
    before = tile_knn.knn_tile_scan.launches[form]
    with faults.inject("device.put=once:oom"):
        res = degrade.predict_with_ladder("cuda", train, test, k)
    assert res.backend == "cuda" and res.opts["query_batch"] == 150
    assert tile_knn.knn_tile_scan.launches[form] == before + 2
    np.testing.assert_array_equal(res.predictions,
                                  knn_oracle(x, y, x[:300], k, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["stripe", "xla"])
def test_staged_block_on_the_card_is_bit_identical(card, engine):
    # The batcher's staged upload read in place of the retrieval's own,
    # rows past Q garbage on purpose, on both routes.
    from knn_tpu_torch.models.knn import _kneighbors_arrays

    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (2000, 11)).astype(np.float32)
    q = rng.integers(0, 4, (37, 11)).astype(np.float32)
    block = torch.full((64, 11), 7e7, device=card)
    block[:37] = torch.from_numpy(q).to(card)
    want = _kneighbors_arrays(x, q, 10, engine=engine)
    got = _kneighbors_arrays(x, q, 10, engine=engine,
                             prefetched_queries=block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_batcher_stages_on_a_side_stream_bit_identically(card, monkeypatch):
    # Requests queued ahead of the worker: each next batch is staged in
    # pinned memory and copied on the side stream while the current batch
    # runs; the answers equal the synchronous retrieval's, bit for bit.
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.serve import batcher as batcher_mod

    hits = []
    take = batcher_mod._UploadStager.take
    monkeypatch.setattr(batcher_mod._UploadStager, "take",
                        lambda self, live: hits.append(1) or take(self, live))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(30000, 11)).astype(np.float32)
    y = rng.integers(0, 10, 30000).astype(np.int32)
    model = KNNClassifier(k=5).fit(dataset_from_arrays(x, y))
    q = rng.normal(size=(400, 11)).astype(np.float32)
    want_d, want_i = model.kneighbors(dataset_from_arrays(q, y[:400]))
    scans = cuda_knn.knn_stripe_scan.launches
    with batcher_mod.MicroBatcher(model, max_batch=32, max_wait_ms=200.0,
                                  buckets=(16, 32)) as b:
        handles = [b.submit(q[i:i + 4], "kneighbors")
                   for i in range(0, 400, 4)]
        got = [h.result(timeout=60) for h in handles]
        staged = [blk for blk in b._stager._buffers.values()]
    assert hits and cuda_knn.knn_stripe_scan.launches > scans
    assert all(buf.is_pinned() for buf in staged)
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]),
                                  want_d)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                  want_i)


@pytest.mark.cuda
def test_devprof_reads_the_card_and_captures_the_kernels(card):
    from knn_tpu_torch import obs
    from knn_tpu_torch.obs import devprof

    x = torch.randn(20000, 11, device=card)
    mem = devprof.device_memory_stats()
    assert mem[0]["source"] == "memory_stats"
    assert mem[0]["in_use"] >= x.numel() * 4 and mem[0]["total"] > 0
    q = torch.randn(100, 11, device=card)
    cuda_knn.knn_stripe_candidates(x, q, 20000, 5)
    torch.cuda.synchronize()
    was = obs.enabled()
    obs.enable()
    try:
        with devprof.capture() as cap:
            with obs.span("serve.dispatch"):
                cuda_knn.knn_stripe_candidates(x, q, 20000, 5)
                torch.cuda.synchronize()
    finally:
        if not was:
            obs.disable()
    names = [e.get("name", "") for e in cap.trace["traceEvents"]]
    assert any("stripe_scan" in n for n in names)
    assert any("stripe_merge" in n for n in names)
    assert "serve.dispatch" in names


def _ivf_problem(rng, n=6000, q=64, d=11):
    x = rng.integers(0, 6, (n, d)).astype(np.float32)
    x[n // 2 : n // 2 + 200] = x[:200]  # dist == 0 ties across cells
    qx = rng.integers(0, 6, (q, d)).astype(np.float32)
    qx[3, 2] = np.nan
    return x, qx


@pytest.mark.cuda
@pytest.mark.parametrize("nprobe", [1, 7, 32])
def test_ivf_device_scorer_on_the_card_equals_the_host_scorer(card, nprobe):
    from knn_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(nprobe)
    x, qx = _ivf_problem(rng)
    ivf = IVFIndex.build(x, 32, seed=0, device="cpu")
    host = ivf.search(x, qx, 10, nprobe, scorer="host")
    dev = ivf.search(x, qx, 10, nprobe, scorer="device", device=card)
    np.testing.assert_array_equal(dev[1], host[1])
    np.testing.assert_array_equal(dev[0].view(np.uint32),
                                  host[0].view(np.uint32))
    assert dev[2].scorer == "device" and dev[2]._replace(
        scorer="host", padded_candidate_rows=0) == host[2]
    assert ivf._cache["device"][2].device.type == "cuda"


@pytest.mark.cuda
def test_ivf_full_probe_on_the_card_equals_the_stripe_kernel(card):
    from knn_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(3)
    x, qx = _ivf_problem(rng)
    qx = np.nan_to_num(qx)
    ivf = IVFIndex.build(x, 16, seed=0, device=card)
    _, di, _ = ivf.search(x, qx, 10, 16, scorer="device", device=card)
    t = torch.from_numpy(x).to(card)
    _, ki = cuda_knn.knn_stripe_candidates(t, torch.from_numpy(qx).to(card),
                                           x.shape[0], 10)
    np.testing.assert_array_equal(di, ki.cpu().numpy())


@pytest.mark.cuda
def test_kmeans_assignment_on_the_card_equals_the_cpu_and_ignores_tf32(card):
    """The assignment step on the card against the same torch function on
    the CPU: equal cells except rows whose two nearest centroids lie within
    2^-20 of |x|^2 + |c|^2 (the matmul sums in another order), with TF32
    allowed or not."""
    import importlib

    # The module: knn_tpu_torch.index re-exports the kmeans function.
    kmeans = importlib.import_module("knn_tpu_torch.index.kmeans")

    rng = np.random.default_rng(0)
    x = rng.random((65536, 11)).astype(np.float32)
    cents = rng.random((1024, 11)).astype(np.float32)
    ca, cd = kmeans._assign_batched(x, cents, 65536, torch.device("cpu"))
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        ga, gd = kmeans._assign_batched(x, cents, 65536, card)
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    diff = np.nonzero(ga != ca)[0]
    x64, c64 = x.astype(np.float64), cents.astype(np.float64)
    for r in diff:
        dg = ((x64[r] - c64[ga[r]]) ** 2).sum()
        dc = ((x64[r] - c64[ca[r]]) ** 2).sum()
        scale = (x64[r] ** 2).sum() + (c64[ga[r]] ** 2).sum() + (
            c64[ca[r]] ** 2).sum()
        assert abs(dg - dc) <= 2.0 ** -20 * scale, r
    assert diff.size <= 64
    np.testing.assert_allclose(gd, cd, rtol=0, atol=2.0 ** -20 * 23)


@pytest.mark.cuda
def test_ivf_rung_serves_on_the_card_and_degrades_to_the_kernels(card):
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.index.ivf import IVFIndex, IVFServing
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.resilience import faults
    from knn_tpu_torch.serve.batcher import MicroBatcher

    rng = np.random.default_rng(5)
    x, qx = _ivf_problem(rng)
    qx = np.nan_to_num(qx)
    model = KNNClassifier(k=5).fit(Dataset(x, np.zeros(len(x), np.int32)))
    model.ivf_ = IVFIndex.build(x, 16, seed=0, device=card)
    want = model.ivf_.search(x, qx[:8], 5, 4, scorer="host")
    with MicroBatcher(model, max_batch=16, max_wait_ms=0.0,
                      ivf=IVFServing(4, 16, scorer="device")) as b:
        h = b.submit(qx[:8], "kneighbors")
        d, i = h.result(timeout=60)
        assert h.meta["rung"] == "ivf"
        np.testing.assert_array_equal(i, want[1])
        scans = cuda_knn.knn_stripe_scan.launches
        with faults.inject("serve.dispatch=once"):
            h = b.submit(qx[:8], "kneighbors")
            _, i = h.result(timeout=60)
        assert h.meta["rung"] == "fast"
        assert cuda_knn.knn_stripe_scan.launches == scans + 1


def _mutable_pair_on(card, model, tmp_path):
    """Two engines over byte-identical artifacts on the card: the delta
    tail forced on vs off."""
    import shutil

    from knn_tpu_torch.mutable.engine import MutableEngine
    from knn_tpu_torch.serve.artifact import save_index

    save_index(model, tmp_path / "on", ivf=getattr(model, "ivf_", None))
    shutil.copytree(tmp_path / "on", tmp_path / "off")
    return (MutableEngine(model, tmp_path / "on", device_tail="on"),
            MutableEngine(model, tmp_path / "off", device_tail="off"))


@pytest.mark.cuda
def test_device_tail_merges_on_the_card_like_the_host(card, tmp_path):
    """The torch-scan route with a delta tail on the card: the merge rides
    the scan's dispatch (no hand kernel launched) and answers bit-equal to
    the host merge of the same view; a base tombstone takes the host
    merge."""
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.mutable import device_tail
    from knn_tpu_torch.serve.batcher import MicroBatcher

    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (3000, 6)).astype(np.float32)
    qx = rng.integers(0, 4, (40, 6)).astype(np.float32)
    qx[3, 1] = np.nan
    model = KNNClassifier(k=5, engine="xla").fit(
        Dataset(x, rng.integers(0, 3, 3000).astype(np.int32)))
    on, off = _mutable_pair_on(card, model, tmp_path)
    rows = rng.integers(0, 4, (300, 6)).astype(np.float32)
    vals = rng.integers(0, 3, 300).astype(np.float32)
    for e in (on, off):
        e.apply_insert(rows, vals, 0)
        e.apply_delete([3001], 0)
    assert on.snapshot().device.features.device.type == "cuda"
    with MicroBatcher(model, max_batch=64, max_wait_ms=0.0,
                      mutable=on) as b_on, \
            MicroBatcher(model, max_batch=64, max_wait_ms=0.0,
                         mutable=off) as b_off:
        merges = device_tail._delta_merge_core.launches
        scans = cuda_knn.knn_stripe_scan.launches
        got = b_on.kneighbors(qx, timeout=60)
        assert device_tail._delta_merge_core.launches == merges + 1
        assert cuda_knn.knn_stripe_scan.launches == scans
        want = b_off.kneighbors(qx, timeout=60)
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[0].view(np.uint32) == want[0].view(np.uint32)).all()
        for b in (b_on, b_off):
            b.submit_mutation("delete", {"ids": [int(want[1][0, 0])]}
                              ).result(timeout=60)
        got = b_on.kneighbors(qx, timeout=60)
        want = b_off.kneighbors(qx, timeout=60)
        np.testing.assert_array_equal(got[1], want[1])
    on.close()
    off.close()


@pytest.mark.cuda
def test_kernel_route_widens_through_the_tile_scan(card, tmp_path):
    """The kernels' route with tombstones: the host merge widens through
    the same rung's retrieval on the card (past k = 16: the tile scan's
    large-k form), the answer equal to the merged host oracle."""
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.mutable.engine import MutableEngine
    from knn_tpu_torch.mutable.state import merged_oracle_kneighbors
    from knn_tpu_torch.serve.artifact import save_index
    from knn_tpu_torch.serve.batcher import MicroBatcher

    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (5000, 11)).astype(np.float32)
    qx = rng.normal(0, 2, (16, 11)).astype(np.float32)
    model = KNNClassifier(k=10).fit(Dataset(x, np.zeros(5000, np.int32)))
    save_index(model, tmp_path / "idx")
    eng = MutableEngine(model, tmp_path / "idx")
    with MicroBatcher(model, max_batch=64, max_wait_ms=0.0,
                      mutable=eng) as b:
        _, base_i = b.kneighbors(qx, timeout=60)
        dead = sorted({int(v) for v in base_i[:3].ravel()})
        b.submit_mutation("delete", {"ids": dead}).result(timeout=60)
        b.submit_mutation("insert", {"rows": qx[:4] + 0.01,
                                     "values": [0, 0, 0, 0]}
                          ).result(timeout=60)
        tiles = dict(tile_knn.knn_tile_scan.launches)
        d, i = b.kneighbors(qx, timeout=60)
        assert len(dead) + 10 > 16
        assert sum(tile_knn.knn_tile_scan.launches.values()) > sum(
            tiles.values())
    want = merged_oracle_kneighbors(model, eng.snapshot(), qx)
    eng.close()
    np.testing.assert_array_equal(i, want[1])
    np.testing.assert_allclose(d, want[0], rtol=11 * 2.0 ** -24, atol=0)
    assert not np.isin(i, dead).any()


@pytest.mark.cuda
def test_ivf_fused_delta_scorer_on_the_card(card, tmp_path):
    """The ivf rung with a delta tail on the card: the fused delta segment
    scorer answers like the host merge of the same view."""
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.index.ivf import IVFIndex, IVFServing
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.ops import segment_score

    rng = np.random.default_rng(5)
    x, qx = _ivf_problem(rng)
    qx = np.nan_to_num(qx)
    model = KNNClassifier(k=5).fit(Dataset(x, np.zeros(len(x), np.int32)))
    model.ivf_ = IVFIndex.build(x, 16, seed=0, device=card)
    on, off = _mutable_pair_on(card, model, tmp_path)
    rows = (x[:50] + 0.01).astype(np.float32)
    for e in (on, off):
        e.apply_insert(rows, np.zeros(50, np.float32), 0)
    serving = IVFServing(4, 16)
    launches = segment_score.segment_topk_delta_core.launches
    got = serving.kneighbors(model, qx, view=on.snapshot())
    assert segment_score.segment_topk_delta_core.launches == launches + 1
    want = serving.kneighbors(model, qx, view=off.snapshot())
    on.close()
    off.close()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 32])
def test_sharded_engines_on_one_card_repeated_4_times(card, k):
    """Four logical shards of cuda:0: each engine's predictions equal the
    single-card ``cuda`` backend's, its per-shard kernels launched (the
    stripe scan at k <= 16, the tile kernel's exact form at k = 32), and
    its collectives equal the byte model."""
    from knn_tpu_torch.parallel import comm_audit
    from knn_tpu_torch.parallel.query_sharded import predict_query_sharded
    from knn_tpu_torch.parallel.ring import predict_ring
    from knn_tpu_torch.parallel.train_sharded import predict_train_sharded

    rng = np.random.default_rng(k)
    train, test = _grid(rng, 5000, 301, 11)
    labels = rng.integers(0, 4, 5000).astype(np.int32)
    want = cuda_backend.predict_arrays(train, labels, test, k, 4)
    mesh = (torch.device("cuda", 0),) * 4
    for fn, kw in ((predict_query_sharded, {}),
                   (predict_train_sharded, {"mesh_shape": (1, 4)}),
                   (predict_ring, {})):
        before = (cuda_knn.knn_stripe_scan.launches,
                  tile_knn.knn_tile_scan.launches["exact"])
        log = []
        got = fn(train, labels, test, k, 4, devices=mesh, log=log, **kw)
        np.testing.assert_array_equal(got, want)
        after = (cuda_knn.knn_stripe_scan.launches,
                 tile_knn.knn_tile_scan.launches["exact"])
        moved = after[0] - before[0] if k <= 16 else after[1] - before[1]
        assert moved >= 4, (fn.__name__, before, after)
        if fn is predict_train_sharded:
            comm_audit.audit_train_sharded(log, 301, k, 4)
        if fn is predict_ring:
            rows = -(-5000 // 4)
            comm_audit.audit_ring(log, rows * 11 * 4, rows * 4, 4)


@pytest.mark.cuda
def test_sharded_model_on_one_card_repeated_4_times(card):
    """A model sharded four ways on the card answers bit-identically to the
    unsharded model, through the stripe kernels."""
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.shard.model import make_sharded

    rng = np.random.default_rng(3)
    train, test = _grid(rng, 4000, 257, 11)
    model = KNNClassifier(k=10).fit(
        Dataset(train, rng.integers(0, 3, 4000).astype(np.int32)))
    q = Dataset(test, np.zeros(len(test), np.int32))
    want = model.kneighbors(q)
    before = cuda_knn.knn_stripe_merge.launches
    got = make_sharded(model, 4).kneighbors(q)
    assert cuda_knn.knn_stripe_merge.launches == before + 4
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0].view(np.uint32) == want[0].view(np.uint32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda-sharded", "cuda-train-sharded",
                                     "cuda-ring"])
def test_sharded_ladder_ends_typed_on_cuda(card, backend):
    """An injected ``collective.step`` fault on a sharded rung moves the
    ladder to ``cuda`` (the same kernels on one card), counted; never to
    the host."""
    from knn_tpu_torch.resilience import degrade, faults

    rng = np.random.default_rng(1)
    train, test = _grid(rng, 3000, 100, 7)
    tr = dataset_from_arrays(train, rng.integers(0, 3, 3000).astype(np.int32))
    te = dataset_from_arrays(test, np.zeros(100, np.int32))
    warned = []
    with faults.inject("collective.step=always"):
        res = degrade.predict_with_ladder(backend, tr, te, 5,
                                          {"num_devices": 1},
                                          warn=warned.append)
    assert res.backend == "cuda" and res.degraded
    assert "falling back to 'cuda'" in warned[0]
    np.testing.assert_array_equal(
        res.predictions, get_backend("cuda")(tr, te, 5))


def _sift_shaped(seed, n=1_000_000, q=1024, d=128):
    """sift-128's shape with the benchmark's values: integers / 255."""
    rng = np.random.default_rng(seed)
    train = (rng.integers(0, 256, (n, d), dtype=np.int32) / 255).astype(
        np.float32)
    test = (rng.integers(0, 256, (q, d), dtype=np.int32) / 255).astype(
        np.float32)
    return train, test


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["stripe", "exact", "fast"])
def test_blocked_train_gives_the_one_block_keys_at_sift_size(card,
                                                             monkeypatch,
                                                             route):
    """A 1,000,000 x 128 train uploaded in eight blocks gives the stripe
    scan's, and the tile scan's exact and fast forms', keys bit-equal to
    the train uploaded in one block, whose operand and norms equal the
    row-major tensor's."""
    train, test = _sift_shaped(5)
    q = torch.from_numpy(test).to(card)
    n, k = train.shape[0], 10 if route == "stripe" else 100

    def keys(tx):
        if route == "stripe":
            plan = cuda_knn.stripe_split_plan(n, q.shape[0], card, 128, k)
            return cuda_knn.knn_stripe_scan(tx, q, n, k, *plan)
        sm = torch.cuda.get_device_properties(card).multi_processor_count
        plan = tile_knn.tile_split_plan(n, q.shape[0], sm, k, route)
        return tile_knn.knn_tile_scan(tx, q, n, k, route, *plan)

    def built():
        return cuda_knn.route_train(train, card, None,
                                    "exact" if route == "stripe" else route,
                                    torch.float32)

    monkeypatch.setattr(cuda_knn, "UPLOAD_BLOCK_BYTES", train.nbytes)
    whole = built()
    assert cuda_knn.train_residency()["blocks"] == 1
    want = keys(whole)
    row_major = torch.from_numpy(train).to(card)
    assert torch.equal(cuda_knn.feature_major(whole, cache=True),
                       cuda_knn.feature_major(row_major))
    if route == "fast":
        from knn_tpu_torch.ops.distance import sq_norms

        assert torch.equal(cuda_knn._kept_with(whole, "sq_norms", None),
                           sq_norms(row_major))
    assert torch.equal(keys(row_major), want)
    del whole, row_major
    monkeypatch.setattr(cuda_knn, "UPLOAD_BLOCK_BYTES", train.nbytes // 8)
    blocked = built()
    assert cuda_knn.train_residency()["blocks"] >= 8
    assert torch.equal(keys(blocked), want)


@pytest.mark.cuda
@pytest.mark.parametrize("norms", [False, True])
def test_fit_device_peak_is_the_operand_plus_two_blocks(card, norms):
    """The fit's peak of allocated device memory: the operand and at most
    two blocks beyond it (with the fast form's norms, summed after, held
    too)."""
    train, _ = _sift_shaped(6, q=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    tx = cuda_knn.route_train(train, card, None, "fast" if norms else "exact",
                              torch.float32)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    block = cuda_knn.upload_block_rows(128) * 128 * 4
    rec = cuda_knn.train_residency()
    held = rec["card_bytes"]
    # Nothing else is left allocated (the allocator rounds each block up).
    assert 0 <= torch.cuda.memory_allocated(card) - base - held < 1 << 20
    assert 0 < rec["copy_s"] < rec["upload_s"]
    assert 0 < rec["transpose_s"] < rec["upload_s"]
    operand = cuda_knn.feature_major(tx, cache=True)
    assert held == operand.numel() * 4 + (train.shape[0] * 4 if norms
                                          else 0)
    assert peak <= held + 2 * block, (peak, held, block)


@pytest.mark.cuda
def test_fit_host_growth_is_the_staging_buffers(card):
    """The host's peak resident set (``VmHWM``, or ``ru_maxrss`` where
    ``/proc/self/status`` has no such line) grows over the fit of a 512 MB
    train by at most the two staging buffers and 256 MiB: no whole host
    copy. Run in a fresh process, whose peak the fit can move."""
    import subprocess
    import sys

    script = """
import resource
import numpy as np, torch
from knn_tpu_torch.ops import cuda_knn

def hwm():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM"):
                return int(line.split()[1]) * 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

x = np.ones((1_000_000, 128), np.float32)
torch.zeros(1, device="cuda")
before = hwm()
cuda_knn.upload_feature_major(x, torch.device("cuda"))
print(hwm() - before, 2 * cuda_knn.UPLOAD_BLOCK_BYTES)
"""
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    grew, staging = map(int, out.stdout.split())
    assert grew <= staging + (256 << 20), (grew, staging)
