"""The stripe kernel's plain version against the JAX package.

``knn_stripe_candidates`` on CPU tensors runs ``knn_stripe_candidates_
reference``; it is held against ``knn_tpu``'s Pallas stripe kernel in
interpret mode (the small blocks of tests/test_pallas.py: block_q 8,
block_n 128) and against the numpy oracle.

Tolerance. On integer-grid inputs every distance is exact in float32, so
distances must be bit-equal and indices equal. On normal float inputs the
port rounds after the multiply and after the add (as main.cpp:17-19 does),
while XLA:CPU contracts ``d + diff*diff`` into a fused multiply-add, so the
two differ by at most the product roundings: ``rtol = d * 2**-24`` for a
d-term sum of non-negative terms. Indices are equal, except that two
candidates whose exact distances lie within that tolerance may swap.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from knn_tpu.backends.oracle import oracle_kneighbors  # noqa: E402
from knn_tpu.models import ordering as jordering  # noqa: E402
from knn_tpu.ops import pallas_knn  # noqa: E402
from knn_tpu.ops.vote import vote as jvote  # noqa: E402
from knn_tpu_torch.models import ordering  # noqa: E402
from knn_tpu_torch.ops import cuda_knn, tile_knn  # noqa: E402
from knn_tpu_torch.ops.distance import pairwise_sq_dists  # noqa: E402
from knn_tpu_torch.ops.vote import vote  # noqa: E402

INT_MAX = np.iinfo(np.int32).max
N, Q = 300, 13  # N is not a multiple of 128


def jax_stripe(train_x, test_x, n_valid, k):
    """``knn_tpu``'s stripe kernel, interpreted, unpadded [Q, k] outputs."""
    d = train_x.shape[1]
    txT, d_pad = pallas_knn.stripe_prepare_train(train_x, 128)
    qx = pallas_knn.stripe_prepare_queries(test_x, 8, d_pad)
    dist, idx = pallas_knn.knn_pallas_stripe_candidates(
        jnp.asarray(txT), jnp.asarray(qx), jnp.int32(n_valid), k,
        block_q=8, block_n=128, interpret=True, d_true=d,
    )
    q = test_x.shape[0]
    return np.asarray(dist)[:q], np.asarray(idx)[:q]


def port_stripe(train_x, test_x, n_valid, k):
    dist, idx = cuda_knn.knn_stripe_candidates(
        torch.from_numpy(train_x), torch.from_numpy(test_x), n_valid, k)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    return dist.numpy(), idx.numpy()


def int_grid(rng, d, n=N, q=Q):
    """Small integer values: exact float32 distances, dense tie plateaus,
    duplicated rows straddling 128-row tiles."""
    train = rng.integers(0, 3, (n, d)).astype(np.float32)
    train[150:200] = train[:50]
    test = np.concatenate([train[rng.choice(n, q // 2, replace=False)],
                           rng.integers(0, 3, (q - q // 2, d)).astype(np.float32)])
    return train, test


def assert_near_tie_swaps_only(train, test, d_got, i_got, d_want, i_want):
    """Distances within rtol = d * 2**-24; a differing index only where
    the two candidates' exact (float64) distances are that close."""
    d = train.shape[1]
    tol = d * 2.0**-24
    np.testing.assert_allclose(d_got, d_want, rtol=tol, atol=0)
    for r, c in zip(*np.nonzero(i_got != i_want)):
        a, b = i_got[r, c], i_want[r, c]
        da = np.sum((test[r].astype(np.float64) - train[a]) ** 2)
        db = np.sum((test[r].astype(np.float64) - train[b]) ** 2)
        assert abs(da - db) <= 2 * tol * max(da, db), (r, c, a, b, da, db)


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("d", [1, 7, 11, 64, 128])
class TestAgainstJaxStripe:
    def test_integer_grid_bit_equal(self, d, k):
        rng = np.random.default_rng(d * 100 + k)
        train, test = int_grid(rng, d)
        d_got, i_got = port_stripe(train, test, N, k)
        d_want, i_want = jax_stripe(train, test, N, k)
        np.testing.assert_array_equal(i_got, i_want)
        assert d_got.tobytes() == d_want.tobytes()
        od, oi = oracle_kneighbors(train, test, k)
        np.testing.assert_array_equal(i_got, oi)
        np.testing.assert_array_equal(d_got, od)

    def test_float_within_double_rounding_tolerance(self, d, k):
        rng = np.random.default_rng(d * 100 + k + 1)
        train = rng.standard_normal((N, d)).astype(np.float32)
        test = rng.standard_normal((Q, d)).astype(np.float32)
        d_got, i_got = port_stripe(train, test, N, k)
        d_want, i_want = jax_stripe(train, test, N, k)
        assert_near_tie_swaps_only(train, test, d_got, i_got, d_want, i_want)
        od, oi = oracle_kneighbors(train, test, k)
        assert_near_tie_swaps_only(train, test, d_got, i_got, od, oi)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_nan_rows_keep_their_index(k):
    # NaN rows are (+inf, their index); only rows past n_valid are
    # (+inf, INT_MAX). With fewer finite rows than k the answer holds the
    # lowest-indexed NaN rows before any sentinel.
    rng = np.random.default_rng(7)
    train = rng.integers(0, 3, (N, 7)).astype(np.float32)
    train[rng.choice(N, 40, replace=False), 3] = np.nan
    test = rng.integers(0, 3, (Q, 7)).astype(np.float32)
    test[0, 0] = np.nan  # every distance of query 0 is NaN
    few = train[:20].copy()
    few[3:, 1] = np.nan  # 3 finite rows
    for tr in (train, few):
        d_got, i_got = port_stripe(tr, test, tr.shape[0], k)
        d_want, i_want = jax_stripe(tr, test, tr.shape[0], k)
        np.testing.assert_array_equal(i_got, i_want)
        np.testing.assert_array_equal(d_got, d_want)
    np.testing.assert_array_equal(i_got[0], np.arange(k))
    assert np.isinf(d_got[0]).all()


@pytest.mark.parametrize("k", [1, 5, 16])
def test_n_valid_below_n(k):
    rng = np.random.default_rng(11)
    train, test = int_grid(rng, 11)
    for n_valid in (N - 45, 10, 0):
        d_got, i_got = port_stripe(train, test, n_valid, k)
        d_want, i_want = jax_stripe(train, test, n_valid, k)
        np.testing.assert_array_equal(i_got, i_want)
        np.testing.assert_array_equal(d_got, d_want)
        assert (i_got[:, min(k, n_valid):] == INT_MAX).all()
        assert (i_got[:, : min(k, n_valid)] < n_valid).all()


def test_distance_is_the_sequential_loop():
    # acc = acc + diff*diff, one feature at a time, rounded twice: bit-equal
    # to a numpy loop (numpy, like eager PyTorch, fuses nothing).
    rng = np.random.default_rng(3)
    q = rng.standard_normal((9, 23)).astype(np.float32)
    t = rng.standard_normal((31, 23)).astype(np.float32)
    t[4, 5] = np.nan
    acc = np.zeros((9, 31), np.float32)
    for f in range(23):
        diff = q[:, f : f + 1] - t[None, :, f]
        acc = acc + diff * diff
    acc[np.isnan(acc)] = np.inf
    got = pairwise_sq_dists(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    assert got.tobytes() == acc.tobytes()


def test_vote_matches_jax():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 4, (200, 6)).astype(np.int32)  # many vote ties
    got = vote(torch.from_numpy(labels), 4).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jvote(jnp.asarray(labels), 4)))


def test_lexicographic_topk_matches_jax_on_tie_plateaus():
    rng = np.random.default_rng(9)
    dists = rng.integers(0, 3, (20, 50)).astype(np.float32)
    dists[:, 7] = np.inf
    for k in (1, 4, 50):
        for idx in (np.arange(50), rng.permutation(50)):
            got = ordering.lexicographic_topk(dists, idx, k)
            want = jordering.lexicographic_topk(dists, idx, k)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    # the lexsort realization (float64 scores) orders the same way
    got = ordering.lexicographic_topk(dists.astype(np.float64), np.arange(50), 5)
    want = ordering.lexicographic_topk(dists, np.arange(50), 5)
    np.testing.assert_array_equal(got[1], want[1])


def test_stripe_inputs_finite_matches_jax():
    ok = np.ones((4, 3), np.float32)
    bad = ok.copy()
    bad[1, 1] = np.nan
    huge = np.full((2, 3), 1e19, np.float32)
    for arrays in ((ok, ok), (ok, bad), (huge, ok), (np.empty((0, 3), np.float32),)):
        assert cuda_knn.stripe_inputs_finite(*arrays) == \
            pallas_knn.stripe_inputs_finite(*arrays)


def test_stripe_route_ok_matches_jax_on_the_exact_form():
    # Every form now: exact narrow, bf16 at any width, fast wide.
    for form in ("exact", "fast", "bf16"):
        for d in (1, 11, 128, 129, 784):
            for k in (1, 16, 17):
                assert cuda_knn.stripe_route_ok(form, d, k) == \
                    pallas_knn.stripe_route_ok(form, d, k), (form, d, k)
    assert cuda_knn.stripe_route_ok("bf16", 11, 5)


@pytest.mark.parametrize("n_valid", [0, 1, 63, 64, 65, 30_803, 1_016_499])
@pytest.mark.parametrize("q", [1, 128, 1718, 70_000])
def test_split_plan_covers_every_row(n_valid, q):
    n_splits, rows = cuda_knn.split_plan(n_valid, q, sm_count=132)
    assert 1 <= n_splits <= 65535 and rows % cuda_knn._TILE_ROWS == 0
    assert n_splits * rows >= n_valid > (n_splits - 1) * rows or n_valid == 0


def test_stripe_kernel_constants_match_the_source():
    # The split granule, the query block and the feature-major operand's
    # granules are the kernel's own (csrc/stripe_knn.cuh).
    import re

    head = (cuda_knn._build.CSRC / "stripe_knn.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", head).group(1))

    assert const("kTileRows") == cuda_knn._TILE_ROWS == 128
    assert const("kQueriesPerBlock") == cuda_knn._QUERIES_PER_BLOCK == 128
    assert const("kRowGranule") == cuda_knn.ROW_GRANULE == 128
    assert const("kSplitAlign") == cuda_knn.SPLIT_ALIGN == 4
    assert const("kMaxD") == cuda_knn.STRIPE_MAX_D
    assert const("kMaxRegisterK") == cuda_knn.STRIPE_MAX_K
    assert const("kTileRowsWide") == 32 and const("kWideD") == 64


@pytest.mark.parametrize("blocks_per_sm", [4, 9, 16])
@pytest.mark.parametrize("n_valid,q", [(30_803, 1718), (1_016_499, 1718),
                                       (3001, 300), (1990, 1)])
def test_split_plan_is_one_wave_of_the_blocks_an_sm_holds(n_valid, q,
                                                          blocks_per_sm):
    # stripe_split_plan passes the kernel's occupancy as blocks_per_sm: the
    # grid then fits the card at once, in whole 128-row tiles, every row
    # covered; fewer blocks per SM give longer splits.
    n_splits, rows = cuda_knn.split_plan(n_valid, q, 132,
                                         blocks_per_sm=blocks_per_sm)
    q_blocks = -(-q // cuda_knn._QUERIES_PER_BLOCK)
    assert n_splits * q_blocks <= 132 * blocks_per_sm or rows == 128 * -(
        -n_valid // 128)
    assert rows % cuda_knn._TILE_ROWS == 0
    assert n_splits * rows >= n_valid > (n_splits - 1) * rows
    if blocks_per_sm > 4:
        assert rows <= cuda_knn.split_plan(n_valid, q, 132, blocks_per_sm=4)[1]


@pytest.mark.parametrize("rows,ok", [(256, True), (200, True), (250, False),
                                     (6, False)])
def test_feature_major_kernels_take_splits_on_16_byte_rows(rows, ok):
    # check_splits with the kernels' alignment: each split starts on a
    # multiple of SPLIT_ALIGN rows, or the wrapper raises before a launch.
    n_valid = 1000
    args = (n_valid, -(-n_valid // rows), rows, cuda_knn.SPLIT_ALIGN)
    if ok:
        cuda_knn.check_splits(*args)
    else:
        with pytest.raises(ValueError, match="multiple of 4 rows"):
            cuda_knn.check_splits(*args)
    cuda_knn.check_splits(*args[:3])  # no alignment asked: any rows



@pytest.mark.parametrize("k", [1, 5, 16, 17, 32, 100, 256, 257, 1000, N])
@pytest.mark.parametrize("n_valid,n_splits,rows", [
    (N, 1, N), (N, 5, 64), (N - 45, 4, 64), (10, 1, 64), (0, 1, 64)])
def test_scan_then_merge_equals_the_whole_scan(k, n_valid, n_splits, rows):
    # The kernels' two steps, as their wrappers run them on CPU tensors:
    # per-split lists hold only their own rows, and merging them gives
    # what one scan over all rows gives, NaN rows and ties included. Past
    # k = 16 the stripe route scans with the tile kernel's exact form.
    rng = np.random.default_rng(k * 10 + n_splits)
    train, test = int_grid(rng, 7)
    train[rng.choice(N, 30, replace=False), 2] = np.nan
    t, q = torch.from_numpy(train), torch.from_numpy(test)
    if k <= cuda_knn.STRIPE_MAX_K:
        partial = cuda_knn.knn_stripe_scan(t, q, n_valid, k, n_splits, rows)
    else:
        with pytest.raises(ValueError, match="1..16"):
            cuda_knn.knn_stripe_scan(t, q, n_valid, k, n_splits, rows)
        partial = tile_knn.knn_tile_scan(t, q, n_valid, k, "exact", n_splits,
                                         rows)
    assert partial.shape == (Q, n_splits, k) and partial.dtype == torch.int64
    assert (partial[..., 1:] > partial[..., :-1]).logical_or(
        partial[..., 1:] == cuda_knn._SENTINEL_KEY).all()
    idx = (partial & 0xFFFFFFFF).numpy()
    for s in range(n_splits):
        lo, hi = s * rows, min((s + 1) * rows, n_valid)
        own = idx[:, s]
        assert ((own == INT_MAX) | ((own >= lo) & (own < hi))).all()
    d_got, i_got = cuda_knn.knn_stripe_merge(partial)
    d_want, i_want = cuda_knn.knn_stripe_candidates_reference(t, q, n_valid, k)
    assert torch.equal(i_got, i_want)
    assert d_got.numpy().tobytes() == d_want.numpy().tobytes()


@pytest.mark.parametrize("k", [17, 32, 100, 256])
def test_big_k_integer_grid_matches_jax_stripe_and_oracle(k):
    # The JAX stripe kernel takes any k when forced; the port's plain
    # version, the counterpart of the bucketed kernel lists, agrees.
    rng = np.random.default_rng(k)
    train, test = int_grid(rng, 7)
    d_got, i_got = port_stripe(train, test, N - 20, k)
    od, oi = oracle_kneighbors(train[: N - 20], test, k)
    np.testing.assert_array_equal(i_got, oi)
    np.testing.assert_array_equal(d_got, od)
    if k == 17:
        d_want, i_want = jax_stripe(train, test, N - 20, k)
        np.testing.assert_array_equal(i_got, i_want)
        assert d_got.tobytes() == d_want.tobytes()
