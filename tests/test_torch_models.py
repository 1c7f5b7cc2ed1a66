"""The port's model layer (``knn_tpu_torch/models/knn.py``) against the JAX
package's, on the CPU.

The same numpy inputs go through ``knn_tpu.models.knn`` (JAX on the CPU;
its stripe engine is the Pallas kernel in interpret mode) and through
``knn_tpu_torch.models.knn`` with ``device="cpu"`` (the kernels' plain
versions and the torch scan). Twins of ``tests/test_models_engine.py``,
``test_radius.py``, ``test_regression.py``, ``test_weighted_vote.py``, the
pure cases of ``test_bucketing.py``, ``test_ivf.py::TestTieOrderEveryRung``
(the rungs the port has) and two cases of ``test_oracle.py``.

Tolerances. Indices and predictions: exact. Distances: bit-equal on integer
grids (every partial sum is an exact integer); on float rows XLA:CPU
contracts ``acc + diff*diff`` into an FMA where the port rounds twice, so
each side of a d-term sum of non-negative terms is off the exact value by at
most ``d * 2**-24`` of it: ``rtol = d * 2**-24``. Regressor outputs: equal on
integer grids, ``rtol = 1e-6`` on float rows (inverse-distance weights of
such distances).
"""

import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.data.arff import load_arff as jload_arff  # noqa: E402
from knn_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from knn_tpu.models import knn as jknn  # noqa: E402
from knn_tpu_torch import KNNClassifier, KNNRegressor, sweep_k, write_arff  # noqa: E402
from knn_tpu_torch.backends.oracle import oracle_kneighbors  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models import knn  # noqa: E402
from knn_tpu_torch.models.ordering import lexicographic_topk  # noqa: E402
from knn_tpu_torch.ops.distance import pairwise_sq_dists  # noqa: E402

CPU = {"device": "cpu"}


def _tie_problem(rng, n=400, q=50, d=5, c=6):
    """test_models_engine.py's integer grid: ties and repeated train rows."""
    train_x = rng.integers(0, 4, (n, d)).astype(np.float32)
    train_y = rng.integers(0, c, n).astype(np.int32)
    test_x = np.concatenate(
        [train_x[rng.choice(n, q // 2, replace=False)],
         rng.integers(0, 4, (q - q // 2, d)).astype(np.float32)]
    )
    return train_x, train_y, test_x, c


def _float_problem(rng, n=300, q=40, d=5, c=6):
    """test_weighted_vote.py's float rows, half the queries train rows."""
    train_x = rng.uniform(0, 10, (n, d)).astype(np.float32)
    train_y = rng.integers(0, c, n).astype(np.int32)
    test_x = np.concatenate(
        [train_x[rng.choice(n, q // 2, replace=False)],
         rng.uniform(0, 10, (q - q // 2, d)).astype(np.float32)]
    )
    return train_x, train_y, test_x, c


def _pair(train_x, train_y, test_x, raw_targets=None, test_targets=None):
    """The same arrays as (JAX train, JAX test, port train, port test)."""
    q = test_x.shape[0]
    return (JDataset(train_x, train_y, raw_targets=raw_targets),
            JDataset(test_x, np.zeros(q, np.int32), raw_targets=test_targets),
            Dataset(train_x, train_y, raw_targets=raw_targets),
            Dataset(test_x, np.zeros(q, np.int32), raw_targets=test_targets))


def _float_rtol(d: int) -> float:
    return d * 2.0**-24


# ---------------------------------------------------------------------------
# test_models_engine.py


class TestKneighborsEngines:
    @pytest.mark.parametrize("k", [1, 5, 12])
    @pytest.mark.parametrize("engine", ["stripe", "xla", "auto"])
    def test_each_engine_matches_jax(self, k, engine):
        train_x, _, test_x, _ = _tie_problem(np.random.default_rng(k))
        want_d, want_i = jknn._kneighbors_arrays(train_x, test_x, k,
                                                 engine=engine)
        got_d, got_i = knn._kneighbors_arrays(train_x, test_x, k,
                                              engine=engine, **CPU)
        assert got_i.dtype == np.int32 and got_d.dtype == np.float32
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)

    @pytest.mark.parametrize("k", [1, 5, 12])
    def test_stripe_matches_xla(self, k):
        train_x, _, test_x, _ = _tie_problem(np.random.default_rng(10 + k))
        d_x, i_x = knn._kneighbors_arrays(train_x, test_x, k, engine="xla",
                                          **CPU)
        d_s, i_s = knn._kneighbors_arrays(train_x, test_x, k,
                                          engine="stripe", **CPU)
        np.testing.assert_array_equal(i_s, i_x)
        np.testing.assert_array_equal(d_s, d_x)

    def test_float_rows_match_jax_within_ulps(self):
        rng = np.random.default_rng(3)
        train_x = rng.standard_normal((300, 9)).astype(np.float32)
        test_x = rng.standard_normal((17, 9)).astype(np.float32)
        test_x[2] = np.nan  # a NaN query: every distance +inf
        for engine in ("stripe", "xla"):
            want_d, want_i = jknn._kneighbors_arrays(train_x, test_x, 20,
                                                     engine=engine)
            got_d, got_i = knn._kneighbors_arrays(train_x, test_x, 20,
                                                  engine=engine, **CPU)
            np.testing.assert_array_equal(got_i, want_i, err_msg=engine)
            np.testing.assert_allclose(got_d, want_d, rtol=_float_rtol(9),
                                       err_msg=engine)

    @pytest.mark.parametrize("metric", ["manhattan", "chebyshev", "cosine"])
    def test_other_metrics_take_the_scan_as_jax_does(self, metric):
        # Integer grids: every metric's sums are exact, cosine's norms
        # rounded alike, so distances compare at the cosine tolerance.
        train_x, _, test_x, _ = _tie_problem(np.random.default_rng(4))
        for engine in ("auto", "xla"):
            want_d, want_i = jknn._kneighbors_arrays(
                train_x, test_x, 6, metric=metric, engine=engine)
            got_d, got_i = knn._kneighbors_arrays(
                train_x, test_x, 6, metric=metric, engine=engine, **CPU)
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_allclose(got_d, want_d, rtol=0,
                                       atol=4 * 7 * 2.0**-24)

    def test_candidates_match_brute_force(self, rng):
        train_x, _, test_x, _ = _tie_problem(rng, n=120, q=16)
        k = 7
        for engine in ("xla", "stripe"):
            d, i = knn._kneighbors_arrays(train_x, test_x, k, engine=engine,
                                          **CPU)
            for row in range(test_x.shape[0]):
                full = ((test_x[row][None, :] - train_x) ** 2).sum(-1)
                order = np.lexsort((np.arange(len(full)), full))[:k]
                np.testing.assert_array_equal(i[row], order, err_msg=engine)

    def test_unknown_engine_rejected(self, rng):
        train_x, _, test_x, _ = _tie_problem(rng, n=32, q=4)
        with pytest.raises(ValueError, match="engine"):
            knn._kneighbors_arrays(train_x, test_x, 3, engine="warp", **CPU)
        with pytest.raises(ValueError, match="engine"):
            jknn._kneighbors_arrays(train_x, test_x, 3, engine="warp")

    def test_stripe_rejects_non_euclidean(self, rng):
        train_x, _, test_x, _ = _tie_problem(rng, n=32, q=4)
        with pytest.raises(ValueError, match="euclidean"):
            knn._kneighbors_arrays(train_x, test_x, 3, metric="manhattan",
                                   engine="stripe", **CPU)

    @pytest.mark.parametrize("engine", ["auto", "stripe", "xla"])
    def test_no_queries_give_empties(self, engine):
        # JAX's XLA retrieval fails on zero queries (a tile of 0 rows;
        # its auto engine takes it off a TPU); the port returns the (0, k)
        # empties on every engine, as JAX's stripe entry does.
        train_x, _, _, _ = _tie_problem(np.random.default_rng(5), n=40)
        none = np.empty((0, 5), np.float32)
        got_d, got_i = knn._kneighbors_arrays(train_x, none, 4,
                                              engine=engine, **CPU)
        assert got_d.shape == got_i.shape == (0, 4)
        assert got_d.dtype == np.float32 and got_i.dtype == np.int32
        resolve = knn._kneighbors_arrays(train_x, none, 4, engine=engine,
                                         deferred=True, **CPU)
        assert resolve()[1].shape == (0, 4)
        want_d, want_i = jknn._kneighbors_arrays(train_x, none, 4,
                                                 engine="stripe")
        assert want_d.shape == want_i.shape == (0, 4)


class TestModelEngineRouting:
    def test_classifier_kneighbors_engine_opt(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
        for engine in ("xla", "stripe"):
            d, i = KNNClassifier(k=5, engine=engine, **CPU).fit(
                train).kneighbors(test)
            want_d, want_i = jknn.KNNClassifier(k=5, engine=engine).fit(
                jtrain).kneighbors(jtest)
            np.testing.assert_array_equal(i, want_i)
            np.testing.assert_array_equal(d, want_d)

    def test_ring_engine_opt_does_not_break_retrieval(self, rng):
        # 'tiled'/'full' are ring-only per-step scorers; retrieval maps them
        # to auto, as JAX does.
        train_x, train_y, test_x, _ = _tie_problem(rng)
        _, _, train, test = _pair(train_x, train_y, test_x)
        m = KNNClassifier(k=5, engine="tiled", **CPU).fit(train)
        assert m._retrieval_engine() == "auto"
        want = KNNClassifier(k=5, **CPU).fit(train)
        np.testing.assert_array_equal(m.kneighbors(test)[1],
                                      want.kneighbors(test)[1])

    def test_weighted_vote_accepts_engine_and_device(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
        want = jknn.KNNClassifier(k=5, weights="distance").fit(
            jtrain).predict(jtest)
        for engine in ("auto", "stripe", "xla"):
            got = KNNClassifier(k=5, weights="distance", engine=engine,
                                **CPU).fit(train).predict(test)
            np.testing.assert_array_equal(got, want)

    def test_weighted_vote_still_rejects_other_opts(self):
        with pytest.raises(ValueError, match="engine"):
            KNNClassifier(k=5, weights="distance", query_tile=64)
        with pytest.raises(ValueError, match="silently ignored"):
            KNNClassifier(k=5, weights="distance", backend="cuda-tile")

    def test_regressor_engine_parity(self, rng):
        train_x, _, test_x, _ = _tie_problem(rng)
        targets = rng.normal(size=len(train_x)).astype(np.float32)
        jtrain, jtest, train, test = _pair(
            train_x, np.zeros(len(train_x), np.int32), test_x, targets)
        want = jknn.KNNRegressor(k=5, weights="distance", engine="xla").fit(
            jtrain).predict(jtest)
        for engine in ("xla", "stripe", "auto"):
            got = KNNRegressor(k=5, weights="distance", engine=engine,
                               **CPU).fit(train).predict(test)
            np.testing.assert_array_equal(got, want)

    def test_predict_matches_jax_on_each_backend(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
        want = jknn.KNNClassifier(k=5).fit(jtrain).predict(jtest)
        for backend in ("cuda", "cuda-tile", "oracle"):
            got = KNNClassifier(k=5, backend=backend, **CPU).fit(
                train).predict(test)
            np.testing.assert_array_equal(got, want, err_msg=backend)


class TestDeviceCache:
    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_kneighbors_populates_and_reuses_cache(self, rng, engine):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        _, _, train, test = _pair(train_x, train_y, test_x)
        m = KNNClassifier(k=5, engine=engine, **CPU).fit(train)
        d1, i1 = m.kneighbors(test)
        assert train.device_cache, "first call must populate the cache"
        snapshot = dict(train.device_cache)
        d2, i2 = m.kneighbors(test)
        for key in snapshot:
            assert train.device_cache[key] is snapshot[key], key
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)

    def test_pickle_round_trip_drops_cache_and_stays_frozen(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        _, _, train, test = _pair(train_x.copy(), train_y, test_x)
        m = KNNClassifier(k=3, engine="stripe", **CPU).fit(train)
        _, idx1 = m.kneighbors(test)
        assert m.train_.device_cache
        m2 = pickle.loads(pickle.dumps(m))
        assert m2.train_.device_cache == {}
        with pytest.raises(ValueError, match="read-only"):
            m2.train_.features[:] = 0
        np.testing.assert_array_equal(idx1, m2.kneighbors(test)[1])

    def test_dataclasses_replace_gets_fresh_cache(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        _, _, train, test = _pair(train_x.copy(), train_y, test_x)
        KNNClassifier(k=3, engine="stripe", **CPU).fit(train).kneighbors(test)
        assert train.device_cache
        flipped = np.flipud(np.asarray(train.features).copy())
        train2 = dataclasses.replace(train, features=flipped)
        assert train2.device_cache == {}
        _, idx = KNNClassifier(k=3, engine="stripe", **CPU).fit(
            train2).kneighbors(test)
        want = jknn.KNNClassifier(k=3, engine="stripe").fit(
            JDataset(flipped.copy(), train_y)).kneighbors(
                JDataset(test_x, np.zeros(len(test_x), np.int32)))[1]
        np.testing.assert_array_equal(idx, want)

    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_rebinding_arrays_clears_device_cache(self, rng, engine):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        _, _, train, test = _pair(train_x.copy(), train_y, test_x)
        m = KNNClassifier(k=3, engine=engine, **CPU).fit(train)
        m.kneighbors(test)
        assert train.device_cache
        train.features = np.flipud(np.asarray(train.features).copy())
        assert not train.device_cache
        _, idx = m.kneighbors(test)
        want = jknn.KNNClassifier(k=3, engine=engine).fit(
            JDataset(np.asarray(train.features).copy(), train_y)).kneighbors(
                JDataset(test_x, np.zeros(len(test_x), np.int32)))[1]
        np.testing.assert_array_equal(idx, want)


class TestSweepK:
    @pytest.mark.parametrize("engine", ["auto", "stripe", "xla"])
    def test_matches_individual_predicts_and_jax(self, rng, engine):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
        ks = [1, 3, 7, 12]
        got = sweep_k(train, test, ks, engine=engine, **CPU)
        assert sorted(got) == ks
        want = jknn.sweep_k(jtrain, jtest, ks,
                            engine="xla" if engine == "stripe" else engine)
        for k in ks:
            single = KNNClassifier(k=k, engine=engine, **CPU).fit(
                train).predict(test)
            np.testing.assert_array_equal(got[k], single)
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == np.int32

    def test_metric_matches_jax(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng)
        jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
        got = sweep_k(train, test, [1, 4], metric="manhattan", **CPU)
        want = jknn.sweep_k(jtrain, jtest, [1, 4], metric="manhattan")
        for k in (1, 4):
            np.testing.assert_array_equal(got[k], want[k])

    def test_duplicate_and_unsorted_ks(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng, n=64, q=8)
        _, _, train, test = _pair(train_x, train_y, test_x)
        assert sorted(sweep_k(train, test, [5, 1, 5], **CPU)) == [1, 5]

    def test_rejects_bad_ks(self, rng):
        train_x, train_y, test_x, _ = _tie_problem(rng, n=64, q=8)
        _, _, train, test = _pair(train_x, train_y, test_x)
        for ks in ([], [0, 5], [len(train_x) + 1]):
            with pytest.raises(ValueError):
                sweep_k(train, test, ks, **CPU)


# ---------------------------------------------------------------------------
# test_radius.py


def _radius_problem(rng, n=250, q=30, d=4):
    return (rng.uniform(0, 10, (n, d)).astype(np.float32),
            rng.uniform(0, 10, (q, d)).astype(np.float32))


class TestRadiusNeighbors:
    def test_matches_jax_and_bruteforce_sets(self, rng):
        train_x, test_x = _radius_problem(rng)
        radius = 6.0  # squared-distance radius
        d, i, mask = knn.radius_neighbors_arrays(train_x, test_x, radius, 64,
                                                 **CPU)
        jd, ji, jmask = jknn.radius_neighbors_arrays(train_x, test_x, radius,
                                                     64)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(d, jd, rtol=_float_rtol(4))
        bf = ((test_x[:, None, :] - train_x[None, :, :]) ** 2).sum(-1)
        for row in range(test_x.shape[0]):
            want = set(np.nonzero(bf[row] <= radius)[0].tolist())
            assert set(i[row][mask[row]].tolist()) == want, f"row {row}"
            # Masks agree except where a distance sits on the radius within
            # the two packages' rounding.
            off = mask[row] != jmask[row]
            assert np.allclose(d[row][off], radius, rtol=_float_rtol(4))
        left, right = d[:, :-1], d[:, 1:]
        finite = np.isfinite(left)
        assert (left[finite] <= right[finite]).all()

    def test_default_max_neighbors_is_the_large_k_path(self, rng):
        train_x, test_x = _radius_problem(rng, n=300, q=12)
        d, i, mask = knn.radius_neighbors_arrays(train_x, test_x, 2.0, **CPU)
        assert d.shape == (12, 128)
        jd, ji, _ = jknn.radius_neighbors_arrays(train_x, test_x, 2.0)
        np.testing.assert_array_equal(i, ji)

    def test_truncation_raises(self, rng):
        train_x, test_x = _radius_problem(rng, n=100)
        with pytest.raises(ValueError, match="raise max_neighbors"):
            knn.radius_neighbors_arrays(train_x, test_x, np.inf,
                                        max_neighbors=8, **CPU)

    def test_max_neighbors_at_n_never_truncates(self, rng):
        train_x, test_x = _radius_problem(rng, n=40, q=5)
        _, _, mask = knn.radius_neighbors_arrays(train_x, test_x, np.inf, 40,
                                                 **CPU)
        assert mask.all()

    def test_model_methods(self, rng):
        train_x, test_x = _radius_problem(rng, n=60, q=8)
        targets = rng.normal(size=60).astype(np.float32)
        _, _, train, test = _pair(train_x, np.zeros(60, np.int32), test_x,
                                  targets)
        for model in (KNNClassifier(k=1, **CPU).fit(train),
                      KNNRegressor(k=1, **CPU).fit(train)):
            d, i, mask = model.radius_neighbors(test, 3.0, max_neighbors=60)
            assert d.shape == i.shape == mask.shape == (8, 60)

    def test_metric_respected(self):
        train_x = np.array([[0.0, 0.0], [2.0, 2.0]], np.float32)
        test_x = np.array([[1.0, 1.0]], np.float32)
        _, _, mask_c = knn.radius_neighbors_arrays(
            train_x, test_x, 1.0, 2, metric="chebyshev", **CPU)
        assert mask_c.sum() == 2
        _, _, mask_m = knn.radius_neighbors_arrays(
            train_x, test_x, 1.0, 2, metric="manhattan", **CPU)
        assert mask_m.sum() == 0


# ---------------------------------------------------------------------------
# test_regression.py


def _brute_neighbors(train_x, test_x, k):
    d = ((test_x[:, None, :] - train_x[None, :, :]) ** 2).sum(-1)
    n = train_x.shape[0]
    order = np.lexsort((np.broadcast_to(np.arange(n), d.shape), d),
                       axis=1)[:, :k]
    return np.take_along_axis(d, order, axis=1), order


def _regression(rng, n=400, q=60, d=6):
    train_x = rng.integers(0, 5, (n, d)).astype(np.float32)
    targets = rng.normal(0, 10, n).astype(np.float32)
    test_x = np.concatenate(
        [train_x[rng.choice(n, q // 2, replace=False)],
         rng.integers(0, 5, (q - q // 2, d)).astype(np.float32)]
    )
    # Negative int-cast labels: the regressor never trips the classifier's
    # label validation.
    return _pair(train_x, targets.astype(np.int32), test_x, targets,
                 rng.normal(0, 10, q).astype(np.float32))


class TestKNNRegressor:
    @pytest.mark.parametrize("k", [1, 5])
    @pytest.mark.parametrize("weights", ["uniform", "distance"])
    def test_matches_jax_and_bruteforce(self, rng, k, weights):
        jtrain, jtest, train, test = _regression(rng)
        got = KNNRegressor(k=k, weights=weights, **CPU).fit(train).predict(
            test)
        want = jknn.KNNRegressor(k=k, weights=weights).fit(jtrain).predict(
            jtest)
        np.testing.assert_array_equal(got, want)  # integer grid
        if weights == "uniform":
            _, order = _brute_neighbors(train.features, test.features, k)
            np.testing.assert_allclose(got, train.raw_targets[order].mean(1),
                                       rtol=1e-6)

    @pytest.mark.parametrize("weights", ["uniform", "distance"])
    def test_float_rows_match_jax(self, rng, weights):
        train_x, _, test_x, _ = _float_problem(rng)
        targets = rng.normal(0, 10, len(train_x)).astype(np.float32)
        jtrain, jtest, train, test = _pair(
            train_x, np.zeros(len(train_x), np.int32), test_x, targets)
        got = KNNRegressor(k=4, weights=weights, **CPU).fit(train).predict(
            test)
        want = jknn.KNNRegressor(k=4, weights=weights).fit(jtrain).predict(
            jtest)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_distance_weighted_bruteforce(self, rng):
        _, _, train, test = _regression(rng)
        k = 4
        got = KNNRegressor(k=k, weights="distance", **CPU).fit(
            train).predict(test)
        dists, order = _brute_neighbors(train.features, test.features, k)
        want = np.empty(test.num_instances, np.float64)
        for i in range(test.num_instances):
            t = train.raw_targets[order[i]].astype(np.float64)
            if (dists[i] == 0).any():
                want[i] = t[dists[i] == 0].mean()
            else:
                w = 1.0 / dists[i]
                want[i] = (w * t).sum() / w.sum()
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5)

    def test_exact_match_query_returns_exact_target(self):
        train_x = np.array([[0.0, 0.0], [10.0, 10.0], [0.1, 0.0]], np.float32)
        targets = np.array([7.0, 100.0, -50.0], np.float32)
        train = Dataset(train_x, np.zeros(3, np.int32), raw_targets=targets)
        test = Dataset(train_x[:1], np.zeros(1, np.int32))
        got = KNNRegressor(k=2, weights="distance", **CPU).fit(train).predict(
            test)
        np.testing.assert_allclose(got, [7.0])

    def test_tiny_nonzero_distances_stay_finite(self):
        train = Dataset(np.array([[0.0], [1e-20], [1.0]], np.float32),
                        np.zeros(3, np.int32),
                        raw_targets=np.array([2.0, 4.0, 100.0], np.float32))
        test = Dataset(np.array([[5e-21]], np.float32), np.zeros(1, np.int32))
        got = KNNRegressor(k=2, weights="distance", **CPU).fit(train).predict(
            test)
        assert np.isfinite(got).all() and 2.0 <= got[0] <= 4.0

    def test_nan_query_falls_back_to_uniform_mean(self):
        train = Dataset(np.array([[1.0], [2.0], [3.0]], np.float32),
                        np.zeros(3, np.int32),
                        raw_targets=np.array([1.0, 2.0, 9.0], np.float32))
        test = Dataset(np.array([[np.nan]], np.float32), np.zeros(1, np.int32))
        got = KNNRegressor(k=2, weights="distance", **CPU).fit(train).predict(
            test)
        np.testing.assert_allclose(got, [(1.0 + 2.0) / 2])

    def test_score_is_r2_as_jax(self, rng):
        jtrain, jtest, train, test = _regression(rng, n=200, q=30)
        model = KNNRegressor(k=3, **CPU).fit(train)
        assert model.score(test) == jknn.KNNRegressor(k=3).fit(
            jtrain).score(jtest)
        uniq = Dataset(np.arange(12, dtype=np.float32).reshape(6, 2),
                       np.zeros(6, np.int32),
                       raw_targets=np.linspace(-3, 3, 6).astype(np.float32))
        assert KNNRegressor(k=1, **CPU).fit(uniq).score(uniq) == \
            pytest.approx(1.0)

    def test_validation_errors(self, rng):
        _, _, train, test = _regression(rng, n=10, q=4)
        with pytest.raises(ValueError, match="k must be"):
            KNNRegressor(k=0)
        with pytest.raises(ValueError, match="weights"):
            KNNRegressor(k=1, weights="gaussian")
        with pytest.raises(ValueError, match="engine"):
            KNNRegressor(k=1, engine="warp")
        with pytest.raises(ValueError, match="exceeds"):
            KNNRegressor(k=11).fit(train)
        bad = Dataset(np.zeros((4, 3), np.float32), np.zeros(4, np.int32))
        with pytest.raises(ValueError, match="features"):
            KNNRegressor(k=1, **CPU).fit(train).predict(bad)
        with pytest.raises(RuntimeError, match="fit"):
            KNNRegressor(k=1).predict(test)


class TestRawTargets:
    def test_write_arff_round_trips_float_targets(self, tmp_path):
        ds = Dataset(np.array([[1.0], [2.0]], np.float32),
                     np.array([5, 0], np.int32),
                     raw_targets=np.array([5.7, 0.25], np.float32))
        out = tmp_path / "o.arff"
        write_arff(ds, str(out))
        back = load_arff(str(out))
        np.testing.assert_array_equal(back.labels, ds.labels)
        np.testing.assert_allclose(back.raw_targets, ds.raw_targets,
                                   rtol=1e-6)
        # The JAX package reads the file to the same arrays.
        jback = jload_arff(str(out))
        np.testing.assert_array_equal(jback.labels, back.labels)
        np.testing.assert_array_equal(jback.raw_targets, back.raw_targets)

    def test_write_arff_writes_what_jax_writes(self, tmp_path):
        from knn_tpu.data.arff import write_arff as jwrite_arff

        src = tmp_path / "src.arff"
        src.write_text(
            "@relation 'r el'\n"
            "@attribute x NUMERIC\n"
            "@attribute 'c o' {'a b',\"it's\",c}\n"
            "@attribute y NUMERIC\n"
            "@data\n"
            "1.5,'a b',5.7\n"
            "?,\"it's\",-2\n"
            "3,c,0.25\n"
        )
        write_arff(load_arff(str(src)), str(tmp_path / "port.arff"))
        jwrite_arff(jload_arff(str(src)), str(tmp_path / "jax.arff"))
        assert (tmp_path / "port.arff").read_text() == \
            (tmp_path / "jax.arff").read_text()

    def test_unrepresentable_values_raise(self, tmp_path):
        from knn_tpu_torch.data.dataset import Attribute

        ds = Dataset(np.array([[0.0]], np.float32), np.zeros(1, np.int32),
                     attributes=[Attribute("x", "nominal", ["?"]),
                                 Attribute("class", "numeric")])
        with pytest.raises(ValueError, match="missing value"):
            write_arff(ds, str(tmp_path / "q.arff"))
        ds = Dataset(np.array([[0.0]], np.float32), np.zeros(1, np.int32),
                     attributes=[Attribute("x", "nominal", ["'\""]),
                                 Attribute("class", "numeric")])
        with pytest.raises(ValueError, match="both quote"):
            write_arff(ds, str(tmp_path / "b.arff"))

    def test_regressor_trains_on_written_targets(self, rng, tmp_path):
        train_x = rng.integers(0, 5, (80, 3)).astype(np.float32)
        targets = rng.normal(0, 3, 80).astype(np.float32)
        ds = Dataset(train_x, targets.astype(np.int32), raw_targets=targets)
        path = tmp_path / "reg.arff"
        write_arff(ds, str(path))
        back, jback = load_arff(str(path)), jload_arff(str(path))
        test = Dataset(train_x[:9], np.zeros(9, np.int32))
        got = KNNRegressor(k=3, **CPU).fit(back).predict(test)
        want = jknn.KNNRegressor(k=3).fit(jback).predict(
            JDataset(train_x[:9], np.zeros(9, np.int32)))
        np.testing.assert_array_equal(got, want)

    def test_targets_fallback_without_raw(self):
        ds = Dataset(np.zeros((2, 1), np.float32), np.array([3, 1], np.int32))
        np.testing.assert_array_equal(ds.targets, [3.0, 1.0])
        assert ds.targets.dtype == np.float32


# ---------------------------------------------------------------------------
# test_weighted_vote.py


class TestWeightedVote:
    def test_matches_jax_and_manual_weighted_argmax(self, rng):
        train_x, train_y, test_x, _ = _float_problem(rng)
        jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
        model = KNNClassifier(k=7, weights="distance", **CPU).fit(train)
        got = model.predict(test)
        np.testing.assert_array_equal(got, jknn.KNNClassifier(
            k=7, weights="distance").fit(jtrain).predict(jtest))
        dists, idx = model.kneighbors(test)
        labels = train.labels[idx]
        want = np.empty(test.num_instances, np.int32)
        for i in range(test.num_instances):
            d = dists[i].astype(np.float64)
            w = (d == 0).astype(np.float64) if (d == 0).any() else 1.0 / d
            scores = np.zeros(train.num_classes)
            for lbl, wt in zip(labels[i], w):
                scores[lbl] += wt
            want[i] = np.argmax(scores)
        np.testing.assert_array_equal(got, want)

    def test_exact_match_dominates(self):
        train = Dataset(np.array([[0.0], [0.01], [0.02], [0.03]], np.float32),
                        np.array([3, 1, 1, 1], np.int32))
        test = Dataset(np.array([[0.0]], np.float32), np.zeros(1, np.int32))
        model = KNNClassifier(k=4, weights="distance", **CPU).fit(train)
        assert model.predict(test)[0] == 3
        assert model.predict_proba(test)[0, 3] == pytest.approx(1.0)

    def test_uniform_default_unchanged(self, rng):
        train_x, train_y, test_x, _ = _float_problem(rng)
        _, _, train, test = _pair(train_x, train_y, test_x)
        a = KNNClassifier(k=5, **CPU).fit(train).predict(test)
        b = KNNClassifier(k=5, weights="uniform", **CPU).fit(train).predict(
            test)
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("weights", ["uniform", "distance"])
    def test_proba_matches_jax_and_is_normalized(self, rng, weights):
        train_x, train_y, test_x, _ = _float_problem(rng)
        jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
        proba = KNNClassifier(k=5, weights=weights, **CPU).fit(
            train).predict_proba(test)
        want = jknn.KNNClassifier(k=5, weights=weights).fit(
            jtrain).predict_proba(jtest)
        np.testing.assert_allclose(proba, want, rtol=1e-6)
        np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-9)
        assert (proba >= 0).all()

    def test_bad_weights_rejected(self):
        with pytest.raises(ValueError, match="weights"):
            KNNClassifier(k=1, weights="rank")

    def test_backend_options_rejected_with_weighted_vote(self):
        with pytest.raises(ValueError, match="silently ignored"):
            KNNClassifier(k=1, backend="oracle", weights="distance")
        with pytest.raises(ValueError, match="silently ignored"):
            KNNClassifier(k=1, weights="distance", precision="fast")


def test_vote_and_aggregation_helpers_equal_jax(rng):
    dists = rng.uniform(0, 3, (50, 6)).astype(np.float32)
    dists[3, 2] = 0.0
    dists[7] = np.inf
    labels = rng.integers(0, 4, (50, 6)).astype(np.int32)
    targets = rng.normal(size=(50, 6)).astype(np.float32)
    for weights in ("uniform", "distance"):
        np.testing.assert_array_equal(
            knn.vote_from_labels(dists, labels, 4, weights),
            jknn.vote_from_labels(dists, labels, 4, weights))
        np.testing.assert_array_equal(
            knn.aggregate_targets(dists, targets, weights),
            jknn.aggregate_targets(dists, targets, weights))


# ---------------------------------------------------------------------------
# test_bucketing.py, the pure cases: the ladder is an argument, not state.


class TestQueryBucketLadder:
    def test_legacy_quantum_without_ladder(self):
        assert knn.query_padded_rows(1) == 128
        assert knn.query_padded_rows(128) == 128
        assert knn.query_padded_rows(129) == 256
        assert knn.query_padded_rows(0) == 0
        for rows in (0, 1, 127, 128, 129, 1000):
            assert knn.query_padded_rows(rows) == jknn.query_padded_rows(rows)

    def test_ladder_pads_to_smallest_bucket(self):
        ladder = (16, 32, 64)
        assert knn.query_padded_rows(1, ladder) == 16
        assert knn.query_padded_rows(16, ladder) == 16
        assert knn.query_padded_rows(17, ladder) == 32
        assert knn.query_padded_rows(64, ladder) == 64
        # Past the top bucket: multiples of it (bounded shape set).
        assert knn.query_padded_rows(65, ladder) == 128
        assert knn.query_padded_rows(129, ladder) == 192
        with jknn.query_bucket_ladder(ladder):
            for rows in (0, 1, 16, 17, 64, 65, 129, 1000):
                assert knn.query_padded_rows(rows, [64, 16, 32, 32]) == \
                    jknn.query_padded_rows(rows)
        assert not hasattr(knn, "set_query_buckets")
        assert not hasattr(knn, "_QUERY_BUCKETS")

    def test_normalize_validation(self):
        assert knn.normalize_buckets([32, 8, 8, 16]) == (8, 16, 32)
        for bad in ([], [0, 8], [-1], ["x"], None):
            with pytest.raises(ValueError):
                knn.normalize_buckets(bad)
            with pytest.raises(ValueError):
                jknn.normalize_buckets(bad)

    def test_candidate_ladder_equals_jax(self):
        assert knn.DEFAULT_CANDIDATE_BUCKETS == jknn.DEFAULT_CANDIDATE_BUCKETS
        assert knn.DEFAULT_BATCH_BUCKETS == jknn.DEFAULT_BATCH_BUCKETS
        for rows in (0, 1, 256, 257, 16384, 16385, 40000):
            assert knn.candidate_padded_rows(rows) == \
                jknn.candidate_padded_rows(rows)


# ---------------------------------------------------------------------------
# test_ivf.py::TestTieOrderEveryRung (with its IVF leg since ROADMAP A9) and
# test_oracle.py


class TestTieOrderEveryRung:
    def test_all_rungs_match_helper(self, rng):
        # test_ivf.py's data: an integer grid with duplicated rows.
        x = rng.integers(0, 4, (400, 6)).astype(np.float32)
        x[200:260] = x[:60]
        qx = np.concatenate([x[:10], rng.integers(0, 4, (15, 6))
                             .astype(np.float32)])
        k = 7
        full = pairwise_sq_dists(torch.from_numpy(qx),
                                 torch.from_numpy(x)).numpy()
        want_d, want_i = lexicographic_topk(full, np.arange(x.shape[0]), k)
        got_d, got_i = oracle_kneighbors(x, qx, k)
        np.testing.assert_array_equal(got_i, want_i)
        for engine in ("xla", "auto", "stripe"):
            got_d, got_i = knn._kneighbors_arrays(x, qx, k, engine=engine,
                                                  **CPU)
            np.testing.assert_array_equal(got_i.astype(np.int64), want_i,
                                          err_msg=engine)
            np.testing.assert_array_equal(got_d, want_d, err_msg=engine)
            jd, ji = jknn._kneighbors_arrays(x, qx, k, engine=engine)
            np.testing.assert_array_equal(got_i, ji, err_msg=engine)

    @pytest.mark.parametrize("scorer", ["host", "device"])
    def test_ivf_full_probe_matches_helper(self, scorer):
        """The IVF leg: at full probe both scorers give the helper's order
        and distances, bit for bit, as the JAX package's IVF does. (Its own
        generator: drawing from the shared ``rng`` fixture would shift the
        data of the tests after it.)"""
        from knn_tpu.index.ivf import IVFIndex as JIVFIndex

        from knn_tpu_torch.index.ivf import IVFIndex

        rng = np.random.default_rng(11)
        x = rng.integers(0, 4, (400, 6)).astype(np.float32)
        x[200:260] = x[:60]
        qx = np.concatenate([x[:10], rng.integers(0, 4, (15, 6))
                             .astype(np.float32)])
        k = 7
        full = pairwise_sq_dists(torch.from_numpy(qx),
                                 torch.from_numpy(x)).numpy()
        want_d, want_i = lexicographic_topk(full, np.arange(x.shape[0]), k)
        ivf = IVFIndex.build(x, 8, seed=0, **CPU)
        got_d, got_i, _ = ivf.search(x, qx, k, 8, scorer=scorer, **CPU)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
        jd, ji, _ = JIVFIndex.build(x, 8, seed=0).search(x, qx, k, 8,
                                                          scorer=scorer)
        np.testing.assert_array_equal(got_i, ji)
        np.testing.assert_array_equal(got_d.view(np.uint32),
                                      jd.view(np.uint32))


def test_kneighbors_matches_oracle_order(rng):
    base = rng.integers(0, 3, (40, 4)).astype(np.float32)
    train_x = np.tile(base, (4, 1))  # duplicates -> dist==0 ties
    train_y = rng.integers(0, 5, 160).astype(np.int32)
    test_x = base[:12]
    jtrain, jtest, train, test = _pair(train_x, train_y, test_x)
    k = 6
    d, i = KNNClassifier(k=k, **CPU).fit(train).kneighbors(test)
    assert d.shape == (12, k) and i.shape == (12, k)
    diff = test_x[:, None, :] - train_x[None, :, :]
    dists = np.einsum("qnd,qnd->qn", diff, diff, dtype=np.float32)
    for row in range(12):
        want = np.lexsort((np.arange(160), dists[row]))[:k]
        np.testing.assert_array_equal(i[row], want)
    np.testing.assert_array_equal(
        i, jknn.KNNClassifier(k=k, backend="tpu").fit(jtrain).kneighbors(
            jtest)[1])


def test_predict_proba_consistent_with_predict(small):
    from knn_tpu_torch.convert import dataset_from_arrays

    jtrain, jtest = small
    train = dataset_from_arrays(jtrain.features, jtrain.labels)
    test = dataset_from_arrays(jtest.features, jtest.labels)
    model = KNNClassifier(k=5, **CPU).fit(train)
    proba = model.predict_proba(test)
    assert proba.shape == (test.num_instances, train.num_classes)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0)
    np.testing.assert_array_equal(proba.argmax(axis=1), model.predict(test))
    np.testing.assert_array_equal(
        proba, jknn.KNNClassifier(k=5).fit(jtrain).predict_proba(jtest))
