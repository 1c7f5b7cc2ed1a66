"""The XLA route of the ``cuda`` backend against the JAX package.

``ops/topk.py``, the three metrics of ``ops/distance.py``, and
``backends/cuda.py``'s ``knn_forward``, ``forward_tiled_core``,
``forward_candidates_core`` and ``predict_arrays`` run on CPU tensors and
are held against their ``knn_tpu`` namesakes on inputs made with numpy.

Tolerances. On integer grids every partial sum of every form and metric is
exact in float32, so distances are bit-equal and indices equal; this covers
tie plateaus (duplicated rows, equal distances), NaN rows, rows past
``n_valid``, padded tiles and cosine's slightly negative distances (a row
against itself: ``sqrt(n)*sqrt(n)`` may round below ``n``). On float rows
XLA:CPU sums the feature axis in its own order and contracts into FMAs, so
each side of a d-term sum of non-negative terms is off the exact value by
at most ``d * 2**-24`` of it: manhattan and the exact form agree within
``rtol = 2 * d * 2**-24``; chebyshev (a max of identically rounded gaps) is
bit-equal; cosine (a dot product in either order) within ``atol = 4 * (d +
2) * 2**-24``. Indices may then differ only where the two rows' float64
distances lie within twice that.
"""

import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from knn_tpu import cli as jcli  # noqa: E402
from knn_tpu.backends import get_backend as jget_backend  # noqa: E402
from knn_tpu.backends import tpu as jtpu  # noqa: E402
from knn_tpu.backends.oracle import knn_oracle  # noqa: E402
from knn_tpu.data.arff import load_arff as jload_arff  # noqa: E402
from knn_tpu.ops import distance as jdistance  # noqa: E402
from knn_tpu.ops import topk as jtopk  # noqa: E402
from knn_tpu_torch import cli  # noqa: E402
from knn_tpu_torch.backends import cuda  # noqa: E402
from knn_tpu_torch.backends import get_backend  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from knn_tpu_torch.models.ordering import lexicographic_topk  # noqa: E402
from knn_tpu_torch.ops import cuda_knn, distance, tile_knn, topk  # noqa: E402
from knn_tpu_torch.utils.windowed import windowed_dispatch  # noqa: E402
from tests import fixtures  # noqa: E402

INT_MAX = np.iinfo(np.int32).max
FORMS = ("exact", "fast", "bf16", "manhattan", "chebyshev", "cosine")
METRICS = ("manhattan", "chebyshev", "cosine")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def grid(seed, n=300, q=40, d=7, classes=6):
    """An integer grid with tie plateaus: duplicated train rows, queries
    that repeat train rows, a few NaN rows, and labels of several classes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (n, d)).astype(np.float32)
    x[n // 2 : n // 2 + n // 6] = x[: n // 6]
    qx = np.concatenate([x[rng.choice(n, q // 2, replace=False)],
                         rng.integers(0, 3, (q - q // 2, d)).astype(np.float32)])
    if d:
        x[rng.choice(n, 5, replace=False), rng.integers(0, d, 5)] = np.nan
        qx[0, 0] = np.nan
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y, qx


def floats(seed, n=300, q=40, d=7, classes=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32),
            rng.standard_normal((q, d)).astype(np.float32))


def dist64(form, qx, x):
    """float64 distances of ``form`` (the bf16 cross term ignored: it is
    only used on integer grids, where it is exact)."""
    q, r = qx.astype(np.float64)[:, None, :], x.astype(np.float64)[None]
    if form in ("exact", "fast", "bf16"):
        return ((q - r) ** 2).sum(-1)
    if form == "manhattan":
        return np.abs(q - r).sum(-1)
    if form == "chebyshev":
        return np.abs(q - r).max(-1)
    cross = (q * r).sum(-1)
    den = np.sqrt((q * q).sum(-1)) * np.sqrt((r * r).sum(-1))
    return 1 - np.where(den > 0, cross / np.where(den > 0, den, 1), 0)


def float_tol(form, qx, x):
    d = x.shape[1]
    if form == "chebyshev":
        return 0.0, 0.0
    if form == "cosine":
        return 0.0, 4 * (d + 2) * 2.0**-24
    if form in ("fast", "bf16"):
        scale = (qx**2).sum(1).max() + (x**2).sum(1).max()
        return 0.0, 4 * (d + 2) * 2.0**-24 * scale
    return 2 * d * 2.0**-24, 0.0


def assert_candidates_agree(form, qx, x, d_got, i_got, d_want, i_want, exact):
    """Bit-equal on integer grids; otherwise the float tolerance, and an
    index may differ only at a near tie."""
    if exact:
        np.testing.assert_array_equal(i_got, i_want)
        np.testing.assert_array_equal(d_got, d_want)
        return
    rtol, atol = float_tol(form, qx, x)
    np.testing.assert_allclose(d_got, d_want, rtol=rtol, atol=atol)
    full = dist64(form, qx, x)
    for r, c in zip(*np.nonzero(i_got != i_want)):
        a, b = full[r, i_got[r, c]], full[r, i_want[r, c]]
        assert abs(a - b) <= 2 * (rtol * max(abs(a), abs(b)) + atol), (r, c)


# ---- ops/topk.py ------------------------------------------------------------


def plateaus(seed, rows=20, cols=60):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 4, (rows, cols)).astype(np.float32)
    d[:, 7] = np.inf
    d[:, 11] = -0.5
    d[3] = np.inf
    return d


@pytest.mark.parametrize("index_base", [0, 1000])
@pytest.mark.parametrize("k", [1, 5, 60])
def test_topk_smallest_matches_jax(k, index_base):
    d = plateaus(k)
    got = topk.topk_smallest(t(d), k, index_base)
    want = jtopk.topk_smallest(jnp.asarray(d), k, index_base)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("k", [1, 8, 30, 40])
def test_merge_topk_matches_jax_in_any_arrival_order(k):
    # Indices arrive out of order, distances tie, the carry's (+inf,
    # INT32_MAX) start and negative distances (cosine) take part; -0.0 and
    # +0.0 tie as in lax.sort, the index deciding.
    rng = np.random.default_rng(k)
    da = rng.integers(-1, 3, (12, 20)).astype(np.float32)
    db = rng.integers(-1, 3, (12, 20)).astype(np.float32)
    da[:, 0], db[:, 0] = -0.0, 0.0
    da[:, 1] = -2.38e-7
    db[5:] = np.inf
    ia = rng.permutation(40)[:20].astype(np.int32) + np.zeros((12, 1), np.int32)
    ib = np.setdiff1d(np.arange(40), ia[0]).astype(np.int32)[::-1].copy()
    ib = ib + np.zeros((12, 1), np.int32)
    ib[7:, 10:] = INT_MAX
    got = topk.merge_topk(t(da), t(ia), t(db), t(ib), k)
    want = jtopk.merge_topk(*(jnp.asarray(a) for a in (da, ia, db, ib)), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    la = rng.integers(0, 5, ia.shape).astype(np.int32)
    lb = rng.integers(0, 5, ib.shape).astype(np.int32)
    got = topk.merge_topk_labeled(t(da), t(ia), t(la), t(db), t(ib), t(lb), k)
    want = jtopk.merge_topk_labeled(
        *(jnp.asarray(a) for a in (da, ia, la, db, ib, lb)), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sort_candidates_labeled_matches_jax():
    rng = np.random.default_rng(3)
    d = rng.integers(0, 3, (9, 33)).astype(np.float32)
    d[:, 4] = -1e-7
    i = np.stack([rng.permutation(33) for _ in range(9)]).astype(np.int32)
    lab = rng.integers(0, 4, (9, 33)).astype(np.int32)
    got = topk.sort_candidates_labeled(t(d), t(i), t(lab))
    want = jtopk.sort_candidates_labeled(*(jnp.asarray(a) for a in (d, i, lab)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sort_keys_order_every_float():
    # The int64 key orders like (distance, index) over negative, zero,
    # subnormal, finite and infinite distances.
    vals = np.array([-np.inf, -3.5, -1e-38, -1e-45, -0.0, 0.0, 1e-45, 1e-38,
                     2.0, np.inf], np.float32)
    d = np.repeat(vals, 3)
    i = np.tile(np.array([2, 0, 1], np.int32), vals.size)
    keys = topk.sort_keys(t(d), t(i)).numpy()
    order = np.lexsort((i, d))  # numpy ties -0.0 and +0.0
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), order)
    back_d, back_i = topk.unpack_sort_keys(t(keys))
    np.testing.assert_array_equal(back_d.numpy(), d)
    np.testing.assert_array_equal(back_i.numpy(), i)


# ---- ops/distance.py: the three metrics -------------------------------------


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("d", [0, 1, 7, 200])
@pytest.mark.parametrize("metric", METRICS)
def test_metric_distances_match_jax(metric, d, kind):
    x, _, qx = (grid if kind == "grid" else floats)(d + 1, n=90, q=17, d=d)
    if d:
        x[3] = 0.0  # a zero vector: cosine distance 1
    got = distance.DIST_FNS[metric](t(qx), t(x)).numpy()
    want = np.asarray(jdistance._DIST_FNS[metric](jnp.asarray(qx),
                                                  jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == (17, 90)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    if kind == "grid":
        assert got.tobytes() == want.tobytes()
    else:
        rtol, atol = float_tol(metric, qx, x)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_cosine_goes_negative_and_selects_as_jax_does():
    # Queries that are train rows: some self-distances round below 0, and
    # the packed float key of the kernels would order them wrongly.
    rng = np.random.default_rng(5)
    x = rng.integers(1, 9, (400, 13)).astype(np.float32)
    qx = x[rng.choice(400, 60, replace=False)]
    dm = distance.pairwise_cosine(t(qx), t(x)).numpy()
    assert (dm < 0).any()
    d_got, i_got = topk.topk_smallest(t(dm), 5)
    d_want, i_want = jtopk.topk_smallest(jnp.asarray(dm), 5)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))
    y = rng.integers(0, 4, 400).astype(np.int32)
    got = cuda.forward_candidates_core(t(x), t(y), t(qx), 400, 5, "cosine",
                                       query_tile=20, train_tile=80)
    want = jtpu.forward_candidates_core(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(qx), 400, 5, "cosine",
                                        query_tile=20, train_tile=80)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[:, 0] < 0).any()


# ---- backends/cuda.py: the XLA scans ----------------------------------------


@pytest.mark.parametrize("k", [1, 7, 40])
@pytest.mark.parametrize("form", FORMS)
def test_knn_forward_matches_jax(form, k):
    x, y, qx = grid(k, d=9)
    got = cuda.knn_forward(t(x), t(y), t(qx), k, 6, form).numpy()
    want = np.asarray(jtpu.knn_forward(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(qx), k=k, num_classes=6,
                                       precision=form))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_knn_forward_approx_names_b6():
    x, y, qx = grid(0)
    with pytest.raises(ValueError, match="B6"):
        cuda.knn_forward(t(x), t(y), t(qx), 3, 6, approx=True)


def padded(x, y, qx, query_tile, train_tile):
    tx = np.pad(x, ((0, -x.shape[0] % train_tile), (0, 0)))
    ty = np.pad(y, (0, -y.shape[0] % train_tile))
    return tx, ty, np.pad(qx, ((0, -qx.shape[0] % query_tile), (0, 0)))


@pytest.mark.parametrize("k", [1, 5, 40])
@pytest.mark.parametrize("form", FORMS)
def test_forward_tiled_core_matches_jax(form, k):
    # Padded tiles (300 rows in tiles of 32, 40 queries in tiles of 16),
    # rows past n_valid, NaN rows, and k past the train tile.
    x, y, qx = grid(k + 50, d=9)
    tx, ty, tq = padded(x, y, qx, 16, 32)
    for n_valid in (300, 250):
        got = cuda.forward_tiled_core(t(tx), t(ty), t(tq), n_valid, k, 6, form,
                                      query_tile=16, train_tile=32).numpy()
        want = np.asarray(jtpu.forward_tiled_core(
            jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(tq),
            jnp.asarray(n_valid, jnp.int32), k, 6, form, query_tile=16,
            train_tile=32))
        assert got.shape == (tq.shape[0],)
        np.testing.assert_array_equal(got, want)


def test_forward_tiled_core_rejects_unpadded_shapes():
    x, y, qx = grid(0)
    with pytest.raises(ValueError, match="multiples"):
        cuda.forward_tiled_core(t(x), t(y), t(qx), 300, 3, 6, "exact",
                                query_tile=16, train_tile=32)


@pytest.mark.parametrize("index_base", [0, 5000])
@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("form", ["exact", "manhattan", "chebyshev", "cosine"])
def test_forward_candidates_core_matches_jax(form, kind, index_base):
    x, y, qx = (grid if kind == "grid" else floats)(7, d=11)
    tx, ty, tq = padded(x, y, qx, 8, 64)
    k = 12
    got = cuda.forward_candidates_core(t(tx), t(ty), t(tq), 280, k, form,
                                       query_tile=8, train_tile=64,
                                       index_base=index_base)
    want = jtpu.forward_candidates_core(
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(tq),
        jnp.asarray(280, jnp.int32), k, form, query_tile=8, train_tile=64,
        index_base=index_base)
    d_got, i_got, l_got = (a.numpy() for a in got)
    d_want, i_want, l_want = (np.asarray(a) for a in want)
    assert_candidates_agree(form, tq, tx[:280], d_got, i_got - index_base,
                            d_want, i_want - index_base, kind == "grid")
    np.testing.assert_array_equal(l_got, ty[i_got - index_base])
    if kind == "grid":
        np.testing.assert_array_equal(l_got, l_want)


def test_forward_candidates_core_k_past_the_rows():
    # More slots than columns: the carry's (+inf, INT32_MAX) start and
    # label 0 survive in the tail, as in JAX.
    x, y, qx = grid(2, n=40, q=8)
    tx, ty, tq = padded(x, y, qx, 8, 16)
    got = cuda.forward_candidates_core(t(tx), t(ty), t(tq), 30, 60, "exact",
                                       query_tile=8, train_tile=16)
    want = jtpu.forward_candidates_core(
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(tq),
        jnp.asarray(30, jnp.int32), 60, "exact", query_tile=8, train_tile=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy()[:, -12:] == INT_MAX).all()


class TestTieOrderEveryRoute:
    """The twin of tests/test_ivf.py::TestTieOrderEveryRung for the port:
    every selection the port has reproduces the shared helper's
    (distance, index) order on tie-heavy data."""

    def test_every_route_matches_the_helper(self):
        x, y, qx = grid(11, n=400, q=25, d=7)
        k = 7
        full = distance.pairwise_sq_dists(t(qx), t(x)).numpy()
        want_d, want_i = lexicographic_topk(full, np.arange(400), k)
        routes = {
            "topk_smallest": topk.topk_smallest(t(full), k),
            "forward_candidates_core": cuda.forward_candidates_core(
                t(x), t(y), t(qx[:24]), 400, k, query_tile=8,
                train_tile=80)[:2],
            "stripe": cuda_knn.knn_stripe_candidates(t(x), t(qx), 400, k),
            "tile": tile_knn.knn_tile_candidates(t(x), t(qx), 400, k, "exact"),
        }
        for name, (d, i) in routes.items():
            rows = d.shape[0]
            np.testing.assert_array_equal(i.numpy(), want_i[:rows], name)
            np.testing.assert_array_equal(d.numpy(), want_d[:rows], name)


# ---- predict_arrays: routing, against the JAX tpu backend ------------------


def mixed(seed, d=11, n=700, q=60):
    """Float rows with tie plateaus (half the rows on an integer grid,
    duplicated) and six classes: neighbor lists and votes that differ
    between queries, so equal prediction vectors say something."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[: n // 2] = rng.integers(0, 3, (n // 2, d))
    x[n // 2 : n // 2 + 60] = x[:60]
    qx = np.concatenate([x[rng.choice(n, q // 3, replace=False)],
                         rng.integers(0, 3, (q // 3, d)).astype(np.float32),
                         rng.standard_normal((q - 2 * (q // 3), d))
                         .astype(np.float32)])
    y = rng.integers(0, 6, n).astype(np.int32)
    return x, y, qx


ROUTE_CASES = {
    "k20": (11, 20, {}),
    "k300": (11, 300, {}),
    "fast": (11, 5, {"precision": "fast"}),
    "manhattan": (11, 5, {"metric": "manhattan"}),
    "chebyshev": (11, 5, {"metric": "chebyshev"}),
    "cosine": (11, 5, {"metric": "cosine"}),
    "engine-xla": (11, 5, {"engine": "xla"}),
    "query-batch": (11, 20, {"query_batch": 16}),
    "tiled": (11, 20, {"force_tiled": True, "query_tile": 16,
                       "train_tile": 128}),
    "exact-d200": (200, 5, {}),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_predict_arrays_matches_jax(case):
    d, k, opts = ROUTE_CASES[case]
    x, y, qx = mixed(len(case), d=d)
    want = jtpu.predict_arrays(x, y, qx, k, 6, **opts)
    got = cuda.predict_arrays(x, y, qx, k, 6, device="cpu", **opts)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1


# (d, k, options, whether engine "auto" sends the problem to the kernels'
# host entry, stripe_classify_arrays): every euclidean problem at any k and
# form, and nothing of the metrics, force_tiled, engine "xla" or a
# query_batch outside stripe_route_ok.
AUTO_ROUTES = {
    "exact-k17": (11, 17, {}, True),
    "exact-k32": (11, 32, {}, True),
    "fast-d11": (11, 5, {"precision": "fast"}, True),
    "fast-d11-k32": (11, 32, {"precision": "fast"}, True),
    "manhattan": (11, 5, {"metric": "manhattan"}, False),
    "chebyshev": (11, 5, {"metric": "chebyshev"}, False),
    "cosine": (11, 5, {"metric": "cosine"}, False),
    "tiled": (11, 32, {"force_tiled": True, "query_tile": 16,
                       "train_tile": 128}, False),
    "query-batch": (11, 32, {"query_batch": 16}, False),
    "engine-xla": (11, 32, {"engine": "xla"}, False),
}


@pytest.mark.parametrize("case", sorted(AUTO_ROUTES))
def test_auto_engine_sends_euclidean_problems_to_the_kernels(case,
                                                              monkeypatch):
    d, k, opts, routed = AUTO_ROUTES[case]
    calls = []
    entry = cuda.stripe_classify_arrays

    def counted(*args, **kwargs):
        calls.append(kwargs.get("precision"))
        return entry(*args, **kwargs)

    monkeypatch.setattr(cuda, "stripe_classify_arrays", counted)
    x, y, qx = mixed(len(case), d=d)
    got = cuda.predict_arrays(x, y, qx, k, 6, device="cpu", **opts)
    assert len(calls) == int(routed)
    if routed:
        assert calls == [opts.get("precision", "exact")]
    np.testing.assert_array_equal(got, jtpu.predict_arrays(x, y, qx, k, 6,
                                                           **opts))
    assert len(set(got.tolist())) > 1


@pytest.mark.parametrize("query_batch", [None, 16])
def test_tiled_route_keeps_the_padded_train_in_the_cache(query_batch):
    """The tiled scan's zero-padded train and labels are made once per
    (device, train tile) and reused by the next call on the same cache."""
    x, y, qx = mixed(3)
    opts = {"force_tiled": True, "query_tile": 16, "train_tile": 128,
            "query_batch": query_batch}
    cache = {}
    first = cuda.predict_arrays(x, y, qx, 7, 6, device="cpu",
                                device_cache=cache, **opts)
    key = ("train_padded", "cpu", 128)
    tx, ty = cache[key]
    assert tx.shape == (768, 11) and ty.shape == (768,)
    again = cuda.predict_arrays(x, y, qx, 7, 6, device="cpu",
                                device_cache=cache, **opts)
    assert cache[key][0] is tx and cache[key][1] is ty
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(first, jtpu.predict_arrays(x, y, qx, 7, 6,
                                                             **opts))


def test_predict_arrays_rejects_what_tpu_rejects():
    x, y, qx = mixed(0)
    for opts, match in (({"engine": "tiled"}, "engine"),
                        ({"query_batch": 0}, "query_batch"),
                        ({"metric": "cosine", "precision": "fast"}, "single"),
                        ({"metric": "hamming"}, "metric"),
                        ({"engine": "stripe", "metric": "cosine"}, "stripe"),
                        ({"approx": True}, "B6")):
        with pytest.raises(ValueError, match=match):
            cuda.predict_arrays(x, y, qx, 3, 6, device="cpu", **opts)


def test_windowed_dispatch_keeps_order_and_bounds_the_window():
    live, peak = set(), [0]

    def dispatch(i):
        live.add(i)
        peak[0] = max(peak[0], len(live))
        return i * 10

    def fetch(out, i):
        live.discard(i)
        return out + i

    assert windowed_dispatch(range(9), dispatch, fetch, window=3) == \
        [i * 11 for i in range(9)]
    assert peak[0] == 4 and not live


# ---- the CLI, against the JAX CLI -------------------------------------------

_MS = re.compile(r"required \d+ ms")


def _line(runner, argv):
    out = io.StringIO()
    assert runner(argv, stdout=out) == 0
    return _MS.sub("required <ms> ms", out.getvalue())


def _medium():
    d = fixtures.datasets_dir()
    return str(d / "medium-train.arff"), str(d / "medium-test.arff")


def write_arff(path, x, y):
    head = ["@relation wide", ""]
    head += [f"@attribute a{i} NUMERIC" for i in range(x.shape[1])]
    head += ["@attribute class NUMERIC", "", "@data"]
    rows = [",".join(map(str, r)) + f",{c}" for r, c in zip(x.tolist(), y)]
    path.write_text("\n".join(head + rows) + "\n")
    return str(path)


CLI_CASES = {
    "k20": ["20"],
    "k300": ["300"],
    "fast": ["5", "--precision", "fast"],
    "manhattan": ["5", "--metric", "manhattan"],
    "chebyshev": ["5", "--metric", "chebyshev"],
    "cosine": ["5", "--metric", "cosine"],
    "engine-xla": ["5", "--engine", "xla", "--query-tile", "64",
                   "--train-tile", "512"],
    "query-batch": ["5", "--query-batch", "100"],
}


def _backend_opts(argv):
    """The backend keywords the two CLIs pass for ``argv``'s flags."""
    names = {"--precision": "precision", "--metric": "metric",
             "--engine": "engine", "--query-tile": "query_tile",
             "--train-tile": "train_tile", "--query-batch": "query_batch"}
    opts = {}
    for flag, value in zip(argv[1::2], argv[2::2]):
        opts[names[flag]] = value if flag in ("--precision", "--metric",
                                              "--engine") else int(value)
    return opts


@pytest.mark.parametrize("case", sorted(CLI_CASES) + ["exact-d200"])
def test_cli_matches_jax_tpu(case, tmp_path):
    if case == "exact-d200":
        x, y, qx = mixed(9, d=200, n=400, q=40)
        rng = np.random.default_rng(1)
        tr = write_arff(tmp_path / "train.arff", x, y)
        te = write_arff(tmp_path / "test.arff", qx, rng.integers(0, 6, 40))
        argv = ["5"]
    else:
        (tr, te), argv = _medium(), CLI_CASES[case]
    want = _line(jcli.run, [tr, te, *argv, "--backend", "tpu",
                            "--platform", "cpu"])
    assert want.startswith(f"The {argv[0]}-NN classifier")
    got = _line(cli.run, [tr, te, *argv, "--backend", "cuda", "--device",
                          "cpu"])
    assert got == want
    k, opts = int(argv[0]), _backend_opts(argv)
    jtrain, jtest = jload_arff(tr), jload_arff(te)
    train, test = load_arff(tr), load_arff(te)
    np.testing.assert_array_equal(
        get_backend("cuda")(train, test, k, device="cpu", **opts),
        jget_backend("tpu")(jtrain, jtest, k, **opts))


def test_cli_cuda_tile_k300_matches_tpu_pallas():
    tr, te = _medium()
    want = _line(jcli.run, [tr, te, "300", "--backend", "tpu-pallas",
                            "--platform", "cpu"])
    assert want.startswith("The 300-NN classifier for 370 test instances")
    got = _line(cli.run, [tr, te, "300", "--backend", "cuda-tile",
                          "--device", "cpu"])
    assert got == want
    train, test = load_arff(tr), load_arff(te)
    got = get_backend("cuda-tile")(train, test, 300, device="cpu")
    np.testing.assert_array_equal(
        got, knn_oracle(train.features, train.labels, test.features, 300,
                        train.num_classes))
