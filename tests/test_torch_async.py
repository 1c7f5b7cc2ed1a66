"""The port's async surface (``kneighbors_async``, ``predict_async``,
``AsyncResult``, the deferred retrieval entries) against the JAX package's,
on the CPU: twins of ``tests/test_async_api.py``, every case.

Resolving a handle must give bit-identical results to the synchronous
methods — on every engine, on query sets cut into several chunks, for both
model families and the weighted vote — and equal the JAX package's answers
(integer grids: indices, distances and predictions exact).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from knn_tpu.models import knn as jknn  # noqa: E402
from knn_tpu.ops.pallas_knn import (  # noqa: E402
    stripe_candidates_arrays as jstripe_candidates_arrays,
)
from knn_tpu_torch.backends import cuda as cuda_backend  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models.knn import (  # noqa: E402
    AsyncResult,
    KNNClassifier,
    KNNRegressor,
)
from knn_tpu_torch.ops import cuda_knn  # noqa: E402
from knn_tpu_torch.resilience.errors import DeadlineExceededError  # noqa: E402
from knn_tpu_torch.utils.windowed import windowed_dispatch_deferred  # noqa: E402

CPU = {"device": "cpu"}


def _problem(rng, n=400, q=50, d=5, c=6):
    train_x = rng.integers(0, 4, (n, d)).astype(np.float32)  # grid -> ties
    train_y = rng.integers(0, c, n).astype(np.int32)
    test_x = np.concatenate(
        [train_x[rng.choice(n, q // 2, replace=False)],
         rng.integers(0, 4, (q - q // 2, d)).astype(np.float32)]
    )
    zeros = np.zeros(len(test_x), np.int32)
    return (Dataset(train_x, train_y), Dataset(test_x, zeros),
            JDataset(train_x, train_y), JDataset(test_x, zeros))


class TestKneighborsAsync:
    @pytest.mark.parametrize("engine", ["xla", "stripe", "auto"])
    def test_matches_sync_and_jax(self, rng, engine):
        train, test, jtrain, jtest = _problem(rng)
        model = KNNClassifier(k=5, engine=engine, **CPU).fit(train)
        want_d, want_i = model.kneighbors(test)
        got_d, got_i = model.kneighbors_async(test).result()
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
        jd, ji = jknn.KNNClassifier(k=5, engine=engine).fit(
            jtrain).kneighbors_async(jtest).result()
        np.testing.assert_array_equal(got_i, ji)
        np.testing.assert_array_equal(got_d, jd)

    def test_result_memoized_and_interleaved(self, rng):
        train, test, _, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.kneighbors(test)
        handles = [model.kneighbors_async(test) for _ in range(4)]
        for h in reversed(handles):  # resolve out of dispatch order
            np.testing.assert_array_equal(h.result()[1], want[1])
        first = handles[0].result()
        assert first is handles[0].result()  # memoized, no second wait

    @pytest.mark.parametrize("chunk_rows", [64, 100, 301, 1000])
    def test_multi_chunk_matches_sync_and_jax(self, rng, chunk_rows):
        # 301 queries: several chunks at 64 and 100 rows, the last one
        # short (q is no multiple of the chunk), one chunk at 301 and 1000.
        train, test, _, _ = _problem(rng, n=256, q=40)
        big_x = np.tile(test.features, (8, 1))[:301]
        big = Dataset(big_x, np.zeros(301, np.int32))
        model = KNNClassifier(k=4, engine="stripe", **CPU).fit(train)
        want_d, want_i = model.kneighbors(big)
        resolve = cuda_knn.stripe_candidates_arrays(
            train.features, big.features, 4, chunk_rows=chunk_rows,
            deferred=True, **CPU)
        got_d, got_i = resolve()
        assert got_d.shape == want_d.shape == (301, 4)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
        again = resolve()  # memoized, not a second drain
        assert again[1] is got_i
        jd, ji = jstripe_candidates_arrays(
            train.features, big.features, 4, block_q=8, chunk_rows=64,
            deferred=True)()
        np.testing.assert_array_equal(got_i, ji)
        np.testing.assert_array_equal(got_d, jd)

    def test_chunked_wide_and_large_k_routes(self, rng):
        # The tile kernel's routes (d > 128, k > 16) chunk the same way.
        train_x = rng.integers(0, 3, (300, 130)).astype(np.float32)
        test_x = rng.integers(0, 3, (77, 130)).astype(np.float32)
        for k in (5, 20):
            whole = cuda_knn.stripe_candidates_arrays(train_x, test_x, k,
                                                      **CPU)
            parts = cuda_knn.stripe_candidates_arrays(
                train_x, test_x, k, chunk_rows=30, deferred=True, **CPU)()
            for a, b in zip(parts, whole):
                np.testing.assert_array_equal(a, b)

    def test_bad_chunk_rows_rejected(self, rng):
        train, test, _, _ = _problem(rng, n=32, q=4)
        with pytest.raises(ValueError, match="chunk_rows"):
            cuda_knn.stripe_candidates_arrays(train.features, test.features,
                                              3, chunk_rows=0, **CPU)

    def test_regressor_matches_sync_and_jax(self, rng):
        train, test, _, jtest = _problem(rng)
        targets = rng.standard_normal(train.num_instances).astype(np.float32)
        reg_train = Dataset(train.features, train.labels, raw_targets=targets)
        model = KNNRegressor(k=5, weights="distance", **CPU).fit(reg_train)
        want_d, want_i = model.kneighbors(test)
        got_d, got_i = model.kneighbors_async(test).result()
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
        got = model.predict_async(test).result()
        np.testing.assert_array_equal(got, model.predict(test))
        jmodel = jknn.KNNRegressor(k=5, weights="distance").fit(JDataset(
            train.features, train.labels, raw_targets=targets))
        np.testing.assert_array_equal(got, jmodel.predict_async(jtest).result())

    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_no_queries(self, rng, engine):
        train, _, _, _ = _problem(rng, n=40)
        none = Dataset(np.empty((0, 5), np.float32), np.empty(0, np.int32))
        model = KNNClassifier(k=3, engine=engine, **CPU).fit(train)
        d, i = model.kneighbors_async(none).result()
        assert d.shape == i.shape == (0, 3)
        assert model.predict_async(none).result().shape == (0,)


class TestPredictAsync:
    @pytest.mark.parametrize("weights", ["uniform", "distance"])
    def test_matches_sync_and_jax(self, rng, weights):
        train, test, jtrain, jtest = _problem(rng)
        model = KNNClassifier(k=5, weights=weights, **CPU).fit(train)
        got = model.predict_async(test).result()
        np.testing.assert_array_equal(got, model.predict(test))
        np.testing.assert_array_equal(got, jknn.KNNClassifier(
            k=5, weights=weights).fit(jtrain).predict_async(jtest).result())

    def test_matches_oracle_backend_predictions(self, rng):
        train, test, _, _ = _problem(rng)
        async_preds = KNNClassifier(k=5, **CPU).fit(train).predict_async(
            test).result()
        oracle = KNNClassifier(k=5, backend="oracle").fit(train).predict(test)
        np.testing.assert_array_equal(async_preds, oracle)

    def test_requires_fit(self, rng):
        _, test, _, _ = _problem(rng)
        with pytest.raises(RuntimeError, match="fit"):
            KNNClassifier(k=5).predict_async(test)

    def test_handle_type(self, rng):
        train, test, _, _ = _problem(rng)
        model = KNNClassifier(k=5, **CPU).fit(train)
        assert isinstance(model.predict_async(test), AsyncResult)
        assert isinstance(model.kneighbors_async(test), AsyncResult)


class TestAsyncResultTimeout:
    def test_timeout_raises_then_collects(self):
        gate = threading.Event()

        def finish():
            gate.wait(10)
            return 7

        h = AsyncResult(finish)
        with pytest.raises(DeadlineExceededError, match="not ready"):
            h.result(timeout=0.01)
        gate.set()
        assert h.result() == 7
        assert h.result(timeout=0.01) == 7  # memoized

    def test_failure_is_memoized(self):
        calls = []

        def finish():
            calls.append(1)
            raise ValueError("boom")

        h = AsyncResult(finish)
        for _ in range(2):
            with pytest.raises(ValueError, match="boom"):
                h.result(timeout=5)
        assert len(calls) == 1

    def test_accepts_timeout_closure_gets_the_timeout(self):
        seen = []

        def finish(timeout=None):
            seen.append(timeout)
            return "done"

        finish.__accepts_timeout__ = True
        h = AsyncResult(finish, meta={"rung": "stripe"})
        assert h.result(timeout=0.5) == "done" and seen == [0.5]
        assert h.meta == {"rung": "stripe"}


def test_windowed_dispatch_deferred_keeps_the_window():
    in_flight, peak, log = [], [], []

    def dispatch(item):
        in_flight.append(item)
        peak.append(len(in_flight))
        log.append(("dispatch", item))
        return item * 10

    def fetch(out, item):
        in_flight.remove(item)
        log.append(("fetch", item))
        return out + item

    resolve = windowed_dispatch_deferred(range(7), dispatch, fetch, window=2)
    assert [e for e in log if e[0] == "dispatch"] == [("dispatch", i)
                                                     for i in range(7)]
    assert max(peak) == 3  # window + 1
    out = resolve()
    assert out == [i * 11 for i in range(7)]
    assert resolve() is out


def test_xla_entry_deferred_equals_sync_and_trims_padding(rng):
    train, test, _, _ = _problem(rng, q=130)  # two query tiles, padded
    sync = cuda_backend.candidates_arrays(train.features, test.features, 6,
                                          **CPU)
    resolve = cuda_backend.candidates_arrays(train.features, test.features, 6,
                                             deferred=True, **CPU)
    got = resolve()
    assert got[0].shape == (130, 6)
    for a, b in zip(got, sync):
        np.testing.assert_array_equal(a, b)
    assert resolve() is got
