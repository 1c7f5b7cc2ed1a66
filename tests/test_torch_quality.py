"""Answer quality and drift on the port (the twin of
``tests/test_quality.py``), against the JAX package's, on the CPU.

The port's modules (``knn_tpu_torch.obs.{shedqueue,drift,quality}``) hold
the JAX contracts: honest streaming estimators, a shadow path that never
blocks serving, detection attributed to the answering rung, and the
distinct no-baseline drift state. Beside each mirrored case, the two
packages meet on the same seeded numpy inputs:

- both shadow scorers score the same served answers (exact and corrupted)
  into equal per-rung recall and divergence counts;
- one row stream gives bit-equal sketches and drift scores;
- the serving routes (``/debug/quality``, ``/healthz``'s ``quality``
  block) carry JAX's keys with each layer on and off, and the SIGUSR2
  corruption hook is installed only under
  ``KNN_TPU_TEST_QUALITY_CORRUPT``;
- on the large fixture's IVF index at nprobe 1 with shadow rate 1.0, the
  quality burn widens ``nprobe`` in both packages (compared by moves, not
  by ``stats.nprobe``: ROADMAP Queue C, tied centroids).

Tolerances: exact (equal counts, bit-equal sketches) unless a case says
otherwise; the P² estimator is held to numpy as the JAX test holds it.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from knn_tpu.models.knn import KNNClassifier as JKNNClassifier  # noqa: E402
from knn_tpu.obs import drift as jdrift  # noqa: E402
from knn_tpu.obs import quality as jquality  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier  # noqa: E402
from knn_tpu_torch.obs.drift import (  # noqa: E402
    DriftMonitor,
    P2Quantile,
    StreamSketch,
    drift_scores,
    sketch_summary,
)
from knn_tpu_torch.obs.quality import (  # noqa: E402
    ShadowScorer,
    recall_at_k,
    true_distances,
)
from knn_tpu_torch.obs.slo import SLOTracker  # noqa: E402
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401
from tests.test_torch_serve import Served, http_get  # noqa: E402

CPU = {"device": "cpu"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def obs_on():
    """The port's observability on and isolated (global_state restores
    the previous state)."""
    obs.enable()
    obs.reset()
    return obs.registry()


def _grid(rng, n=200, d=5, c=3):
    """An integer grid (ties on purpose): ``(features, labels)``."""
    return (rng.integers(0, 4, (n, d)).astype(np.float32),
            rng.integers(0, c, n).astype(np.int32))


def _problem(rng, n=200, d=5, c=3):
    return Dataset(*_grid(rng, n, d, c))


def _named(registry, name):
    return [i for i in registry.instruments() if i.name == name]


# ---------------------------------------------------------------------------
# P² quantile estimator vs numpy


class TestP2Quantile:
    @pytest.mark.parametrize("p", [0.25, 0.5, 0.75, 0.9])
    @pytest.mark.parametrize("dist", ["normal", "uniform", "exponential"])
    def test_tracks_numpy_and_jax_on_fixed_seeds(self, p, dist):
        rng = np.random.default_rng(42)
        xs = getattr(rng, dist)(size=5000)
        est, jest = P2Quantile(p), jdrift.P2Quantile(p)
        for x in xs:
            est.update(x)
            jest.update(x)
        want = float(np.quantile(xs, p))
        spread = float(np.quantile(xs, 0.9) - np.quantile(xs, 0.1))
        # P² is an approximation: within 5 % of the 10-90 spread at
        # n = 5000 (the JAX test's bound); bit-equal to JAX's estimator.
        assert est.value == pytest.approx(want, abs=0.05 * spread)
        assert est.value == jest.value

    def test_small_n_is_exact(self):
        est = P2Quantile(0.5)
        for x in (5.0, 1.0, 3.0):
            est.update(x)
        assert est.value == pytest.approx(3.0)
        assert P2Quantile(0.5).value is None

    def test_five_values_exact_median(self):
        est = P2Quantile(0.5)
        for x in (9.0, 1.0, 7.0, 3.0, 5.0):
            est.update(x)
        assert est.value == pytest.approx(5.0)

    def test_rejects_bad_p(self):
        with pytest.raises(ValueError, match="quantile"):
            P2Quantile(0.0)
        with pytest.raises(ValueError, match="quantile"):
            P2Quantile(1.0)


# ---------------------------------------------------------------------------
# StreamSketch: Welford moments + serialization


class TestStreamSketch:
    def test_welford_matches_numpy_in_chunks(self):
        rng = np.random.default_rng(7)
        data = rng.normal(3.0, 2.0, (1000, 4)) * np.array([1.0, 10.0, 0.1, 5])
        s = StreamSketch(4)
        for lo in range(0, 1000, 37):  # ragged chunk sizes
            s.update(data[lo:lo + 37])
        assert s.count == 1000
        np.testing.assert_allclose(s.mean(), data.mean(axis=0), rtol=1e-10)
        np.testing.assert_allclose(
            s.variance(), data.var(axis=0, ddof=1), rtol=1e-9)

    def test_p2_quartiles_track_numpy(self):
        rng = np.random.default_rng(3)
        data = rng.normal(0.0, 1.0, (4000, 2))
        s = StreamSketch(2)
        for lo in range(0, 4000, 256):
            s.update(data[lo:lo + 256])
        for p in (0.25, 0.5, 0.75):
            got = np.asarray(s.quantile(p), np.float64)
            want = np.quantile(data, p, axis=0)
            np.testing.assert_allclose(got, want, atol=0.1)

    def test_from_data_is_exact(self):
        rng = np.random.default_rng(1)
        data = rng.normal(size=(321, 3))
        s = StreamSketch.from_data(data)
        assert s.count == 321
        np.testing.assert_allclose(s.mean(), data.mean(axis=0), rtol=1e-12)
        np.testing.assert_allclose(
            s.variance(), data.var(axis=0, ddof=1), rtol=1e-12)
        for p in (0.25, 0.5, 0.75):
            np.testing.assert_allclose(
                np.asarray(s.quantile(p)), np.quantile(data, p, axis=0),
                rtol=1e-12)

    def test_serialization_round_trip(self):
        rng = np.random.default_rng(2)
        data = rng.normal(size=(100, 3))
        doc = StreamSketch.from_data(data).to_dict()
        norm = sketch_summary(doc)
        assert norm["count"] == 100 and norm["num_features"] == 3
        np.testing.assert_allclose(norm["mean"], data.mean(axis=0),
                                   atol=1e-7)
        assert set(norm["quantiles"]) == {0.25, 0.5, 0.75}

    def test_malformed_sketch_rejected(self):
        with pytest.raises((ValueError, KeyError, TypeError)):
            sketch_summary({"num_features": 3, "count": 1,
                            "mean": [1.0], "var": [1.0, 1.0, 1.0]})
        with pytest.raises(ValueError):
            sketch_summary("not a sketch")

    def test_feature_width_enforced(self):
        s = StreamSketch(3)
        with pytest.raises(ValueError, match="features"):
            s.update(np.zeros((2, 4)))

    def test_one_stream_is_bit_equal_in_both_packages(self):
        """The same ragged row stream through both sketches: the same
        serialized document, the same normalized summary, and bit-equal
        drift scores against a shared training sketch."""
        rng = np.random.default_rng(11)
        train = rng.normal(0.0, 1.5, (700, 5)).astype(np.float32)
        live = (rng.normal(0.4, 2.0, (900, 5)) + [0, 1, 0, 3, 0]) \
            .astype(np.float32)
        ref, jref = (StreamSketch.from_data(train).to_dict(),
                     jdrift.StreamSketch.from_data(train).to_dict())
        assert ref == jref
        s, js = StreamSketch(5), jdrift.StreamSketch(5)
        lo = 0
        for n in (1, 7, 64, 3, 200, 1, 300):
            s.update(live[lo:lo + n])
            js.update(live[lo:lo + n])
            lo += n
        assert s.to_dict() == js.to_dict()
        got = drift_scores(sketch_summary(ref), sketch_summary(s.to_dict()))
        want = jdrift.drift_scores(jdrift.sketch_summary(jref),
                                   jdrift.sketch_summary(js.to_dict()))
        np.testing.assert_array_equal(got, want)
        assert got.max() > 1.0  # the shifted columns score


# ---------------------------------------------------------------------------
# recall@k on hand-built neighbor lists


class TestRecallAtK:
    def test_exact_match_is_one(self):
        oracle_i = np.array([[0, 1], [2, 3]])
        oracle_d = np.array([[0.0, 1.0], [2.0, 3.0]])
        r = recall_at_k(oracle_i, oracle_i, oracle_d, oracle_d)
        np.testing.assert_allclose(r, [1.0, 1.0])

    def test_tie_broken_the_other_way_is_not_a_loss(self):
        oracle_i = np.array([[0, 1]])
        oracle_d = np.array([[0.0, 1.0]])
        served_i = np.array([[0, 2]])
        true_d = np.array([[0.0, 1.0]])  # recomputed: index 2 IS at d=1
        np.testing.assert_allclose(
            recall_at_k(served_i, oracle_i, oracle_d, true_d), [1.0])

    def test_wrong_neighbor_counts_against(self):
        oracle_i = np.array([[0, 1]])
        oracle_d = np.array([[0.0, 1.0]])
        served_i = np.array([[0, 7]])
        true_d = np.array([[0.0, 9.0]])  # index 7 is genuinely far
        np.testing.assert_allclose(
            recall_at_k(served_i, oracle_i, oracle_d, true_d), [0.5])

    def test_claimed_distance_cannot_fake_a_tie(self):
        # The tie clause uses the RECOMPUTED distance: a served index that
        # claims d=1.0 but sits at d=9.0 is a miss.
        oracle_i = np.array([[0, 1]])
        oracle_d = np.array([[0.0, 1.0]])
        served_i = np.array([[0, 7]])
        true_d = np.array([[0.0, 9.0]])
        np.testing.assert_allclose(
            recall_at_k(served_i, oracle_i, oracle_d, true_d), [0.5])

    def test_duplicate_served_indices_count_once(self):
        oracle_i = np.array([[0, 1, 2]])
        oracle_d = np.array([[0.0, 1.0, 2.0]])
        served_i = np.array([[0, 0, 0]])
        true_d = np.array([[0.0, 0.0, 0.0]])
        np.testing.assert_allclose(
            recall_at_k(served_i, oracle_i, oracle_d, true_d), [1 / 3])

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="shapes differ"):
            recall_at_k(np.zeros((1, 2)), np.zeros((1, 3)),
                        np.zeros((1, 3)), np.zeros((1, 2)))

    def test_true_distances_match_oracle_and_jax(self):
        from knn_tpu_torch.backends.oracle import oracle_kneighbors

        rng = np.random.default_rng(4)
        train = rng.normal(size=(50, 4)).astype(np.float32)
        queries = rng.normal(size=(6, 4)).astype(np.float32)
        d, i = oracle_kneighbors(train, queries, 3)
        td = true_distances(train, queries, i, "euclidean")
        np.testing.assert_allclose(td, d, rtol=1e-6)
        for metric in ("euclidean", "manhattan", "chebyshev", "cosine"):
            np.testing.assert_array_equal(
                true_distances(train, queries, i, metric),
                jquality.true_distances(train, queries, i, metric))


# ---------------------------------------------------------------------------
# Drift scoring


class TestDriftScores:
    def test_identical_distributions_score_zero(self):
        rng = np.random.default_rng(5)
        data = rng.normal(size=(500, 3))
        ref = sketch_summary(StreamSketch.from_data(data).to_dict())
        live = sketch_summary(StreamSketch.from_data(data).to_dict())
        np.testing.assert_allclose(drift_scores(ref, live), 0.0, atol=1e-6)

    def test_mean_shift_scores_in_sigma_units(self):
        rng = np.random.default_rng(6)
        data = rng.normal(0.0, 1.0, (2000, 2))
        shifted = data + np.array([3.0, 0.0])
        ref = sketch_summary(StreamSketch.from_data(data).to_dict())
        live = sketch_summary(StreamSketch.from_data(shifted).to_dict())
        s = drift_scores(ref, live)
        assert s[0] == pytest.approx(3.0, rel=0.3)
        assert s[1] < 0.3

    def test_constant_reference_feature_does_not_blow_up(self):
        data = np.ones((100, 1))
        live_data = np.full((100, 1), 2.0)
        ref = sketch_summary(StreamSketch.from_data(data).to_dict())
        live = sketch_summary(StreamSketch.from_data(live_data).to_dict())
        s = drift_scores(ref, live)
        assert np.all(np.isfinite(s)) and s[0] > 0


class TestDriftMonitor:
    def test_no_baseline_state_is_distinct(self, obs_on):
        m = DriftMonitor(None, rate=1.0, num_features=3, autostart=False)
        m.offer(np.zeros((2, 3), np.float32))
        summary = m.export()
        assert summary["baseline"] == "absent"
        assert summary["scores"] is None  # never fabricated
        present = _named(obs_on, "knn_drift_baseline_present")
        assert len(present) == 1 and present[0].value == 0
        assert not _named(obs_on, "knn_drift_score")
        m.close()

    def test_live_vs_training_distribution(self, obs_on):
        rng = np.random.default_rng(8)
        train = rng.normal(0.0, 1.0, (2000, 3)).astype(np.float32)
        ref = StreamSketch.from_data(train).to_dict()
        m = DriftMonitor(ref, rate=1.0, num_features=3)
        m2 = DriftMonitor(ref, rate=1.0, num_features=3)
        try:
            for lo in range(0, 1000, 50):
                m.offer(train[lo:lo + 50])
                m2.offer(train[lo:lo + 50] + 5.0)
            assert m.drain(20) and m2.drain(20)
            same = m.export()["scores"]["max"]
            far = m2.export()["scores"]["max"]
            assert far > 2.0 > 0.5 > same
        finally:
            m.close()
            m2.close()

    def test_shed_on_overload_never_blocks(self, obs_on):
        m = DriftMonitor(None, rate=1.0, num_features=2, queue_cap=2,
                         autostart=False)  # no thread: queue can only fill
        rows = np.zeros((1, 2), np.float32)
        assert m.offer(rows) and m.offer(rows)
        t0 = time.monotonic()
        assert not m.offer(rows)  # full -> shed, immediately
        assert time.monotonic() - t0 < 0.1
        assert m.shed == 1
        shed = _named(obs_on, "knn_drift_shed_total")
        assert len(shed) == 1 and shed[0].value == 1
        m.close()

    def test_set_reference_swaps_baseline(self):
        train = np.random.default_rng(9).normal(size=(100, 2))
        m = DriftMonitor(None, rate=1.0, num_features=2, autostart=False)
        assert not m.baseline_present
        m.set_reference(StreamSketch.from_data(train).to_dict())
        assert m.baseline_present
        m.set_reference(None)  # a pre-sketch rollback
        assert not m.baseline_present
        m.close()

    def test_rate_validation(self):
        with pytest.raises(ValueError, match="rate"):
            DriftMonitor(None, rate=1.5, num_features=1, autostart=False)
        with pytest.raises(ValueError, match="queue_cap"):
            DriftMonitor(None, rate=0.5, num_features=1, queue_cap=0,
                         autostart=False)

    def test_wrong_width_reference_fails_at_boot_not_scrape(self):
        ref = StreamSketch.from_data(
            np.random.default_rng(10).normal(size=(50, 4))).to_dict()
        with pytest.raises(ValueError, match="4 features"):
            DriftMonitor(ref, rate=1.0, num_features=3, autostart=False)
        m = DriftMonitor(None, rate=1.0, num_features=3, autostart=False)
        with pytest.raises(ValueError, match="4 features"):
            m.set_reference(ref)
        assert not m.baseline_present  # the failed swap changed nothing
        m.close()

    def test_malformed_sketch_is_a_value_error(self):
        with pytest.raises(ValueError, match="malformed drift sketch"):
            DriftMonitor({"count": 3}, rate=1.0, num_features=2,
                         autostart=False)

    def test_baseline_removal_zeroes_exported_scores(self, obs_on):
        train = np.random.default_rng(12).normal(size=(200, 2))
        ref = StreamSketch.from_data(train).to_dict()
        m = DriftMonitor(ref, rate=1.0, num_features=2, autostart=False)
        with m._sketch_lock:
            m.live.update(train[:50] + 10.0)  # thread held off: fold direct
        assert m.export()["scores"]["max"] > 0
        gauges = {dict(i.labels)["stat"]: i
                  for i in _named(obs_on, "knn_drift_score")}
        assert gauges["max"].value > 0
        m.set_reference(None)  # the pre-sketch rollback
        summary = m.export()
        assert summary["baseline"] == "absent" and summary["scores"] is None
        assert gauges["max"].value == 0.0 and gauges["mean"].value == 0.0
        m.close()

    def test_export_equals_jax_on_one_stream(self):
        """Both monitors, fed the same blocks with the threads held off
        and the folds done in order: equal summaries."""
        rng = np.random.default_rng(13)
        train = rng.normal(size=(300, 4)).astype(np.float32)
        ref = StreamSketch.from_data(train).to_dict()
        m = DriftMonitor(ref, rate=0.5, num_features=4, seed=3,
                         autostart=False)
        jm = jdrift.DriftMonitor(ref, rate=0.5, num_features=4, seed=3,
                                 autostart=False)
        blocks = [rng.normal(0.3, 1.2, (int(rng.integers(1, 9)), 4))
                  .astype(np.float32) for _ in range(40)]
        picked = [m.offer(b) for b in blocks]
        assert picked == [jm.offer(b) for b in blocks]
        assert 5 < sum(picked) < 35  # sampling, seeded alike
        for mon in (m, jm):
            mon._sq.start()
            assert mon.drain(20)
        assert m.export() == jm.export()
        m.close()
        jm.close()


# ---------------------------------------------------------------------------
# ShadowScorer


class TestShadowScorer:
    def test_shed_on_overload_never_blocks_the_producer(self, obs_on):
        train = _problem(np.random.default_rng(20))
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        s = ShadowScorer(1.0, queue_cap=2, autostart=False)  # thread off
        kw = dict(features=train.features[:1], kind="kneighbors",
                  dists=np.zeros((1, 3)), idx=np.zeros((1, 3), np.int64),
                  preds=None, rung="fast", model=model, version="v1")
        assert s.offer(**kw) and s.offer(**kw)
        t0 = time.monotonic()
        assert not s.offer(**kw)  # full -> shed, immediately, never blocks
        assert time.monotonic() - t0 < 0.1
        assert s.shed == 1
        shed = _named(obs_on, "knn_quality_shed_total")
        assert len(shed) == 1 and shed[0].value == 1
        s.close()

    def test_producer_not_blocked_while_worker_scores(self, obs_on):
        train = _problem(np.random.default_rng(21), n=400)
        model = KNNClassifier(k=5, engine="xla", **CPU).fit(train)
        s = ShadowScorer(1.0, queue_cap=512)
        d, i = model.kneighbors(Dataset(
            train.features[:50], np.zeros(50, np.int32)))
        kw = dict(features=train.features[:50], kind="kneighbors",
                  dists=d, idx=i, preds=None, rung="fast", model=model,
                  version=None)
        walls = []
        for _ in range(40):
            t0 = time.monotonic()
            s.offer(**kw)
            walls.append(time.monotonic() - t0)
        assert max(walls) < 0.1  # every offer O(1), scoring notwithstanding
        assert s.drain(30)
        s.close()
        assert s.export()["rungs"]["fast"]["recall"] == 1.0

    def test_exact_serving_scores_recall_one(self, obs_on):
        rng = np.random.default_rng(22)
        model = KNNClassifier(k=3, **CPU).fit(_problem(rng))
        slo = SLOTracker(windows_s=(60,))
        scorer = ShadowScorer(1.0, seed=0, slo=slo)
        with MicroBatcher(model, max_batch=8, max_wait_ms=0.5,
                          quality=scorer) as b:
            for r in rng.integers(0, 4, (12, 5)).astype(np.float32):
                b.predict(r, timeout=30)
            assert scorer.drain(30)
        summary = scorer.export()
        scorer.close()
        fast = summary["rungs"]["fast"]
        assert fast["recall"] == 1.0 and fast["vote_accuracy"] == 1.0
        assert fast["divergence"] == {}
        assert slo.burn_rates()["quality"]["1m"] == 0.0
        recall_g = _named(obs_on, "knn_quality_recall")
        assert recall_g and all(g.value == 1.0 for g in recall_g)

    def test_corrupted_index_detected_and_attributed(self, obs_on):
        """A silently-wrong index (every response still 200) burns the
        quality SLI and localizes to the answering rung."""
        rng = np.random.default_rng(23)
        model = KNNClassifier(k=3, **CPU).fit(_problem(rng))
        slo = SLOTracker(windows_s=(60,))
        scorer = ShadowScorer(1.0, seed=0, slo=slo)
        with MicroBatcher(model, max_batch=8, max_wait_ms=0.5,
                          quality=scorer) as b:
            b.corrupt_serving = True
            for r in rng.integers(0, 4, (12, 5)).astype(np.float32):
                b.predict(r, timeout=30)  # still answers "successfully"
            assert scorer.drain(30)
        summary = scorer.export()
        scorer.close()
        fast = summary["rungs"]["fast"]
        assert fast["recall"] < 1.0
        assert fast["divergence"].get("neighbors", 0) > 0
        assert slo.burn_rates()["quality"]["1m"] > 1.0
        div = [dict(i.labels) for i in
               _named(obs_on, "knn_quality_divergence_total")]
        assert any(lab["rung"] == "fast" for lab in div)

    def test_kneighbors_requests_scored_without_vote(self, obs_on):
        train = _problem(np.random.default_rng(24))
        model = KNNClassifier(k=3, **CPU).fit(train)
        scorer = ShadowScorer(1.0, seed=0)
        with MicroBatcher(model, max_batch=8, max_wait_ms=0.5,
                          quality=scorer) as b:
            b.kneighbors(train.features[0], timeout=30)
            assert scorer.drain(30)
        summary = scorer.export()
        scorer.close()
        fast = summary["rungs"]["fast"]
        assert fast["recall"] == 1.0 and fast["vote_accuracy"] is None

    def test_sampling_is_seeded_and_deterministic_as_jax(self):
        draws = []
        for cls in (ShadowScorer, ShadowScorer, jquality.ShadowScorer):
            s = cls(0.5, seed=123, autostart=False)
            draws.append([s.offer(
                features=np.zeros((1, 2), np.float32), kind="kneighbors",
                dists=np.zeros((1, 1)), idx=np.zeros((1, 1), np.int64),
                preds=None, rung="fast", model=None, version=None)
                for _ in range(50)])
            s.close()
        assert draws[0] == draws[1] == draws[2]
        assert 5 < sum(draws[0]) < 45  # actually sampling, not all/none

    def test_score_across_model_snapshot(self, obs_on):
        """A sample carries ITS batch's model: answers served by the old
        index are scored against the old index even after a swap."""
        train_a = _problem(np.random.default_rng(25))
        train_b = Dataset(train_a.features + 100.0, train_a.labels)
        model_a = KNNClassifier(k=3, **CPU).fit(train_a)
        model_b = KNNClassifier(k=3, **CPU).fit(train_b)
        scorer = ShadowScorer(1.0, seed=0, autostart=False)
        d, i = model_a.kneighbors(Dataset(
            train_a.features[:2], np.zeros(2, np.int32)))
        with MicroBatcher(model_a, max_batch=8, max_wait_ms=0.0) as b:
            b.swap_model(model_b, "b")  # the swap happens before scoring
        assert scorer.offer(features=train_a.features[:2],
                            kind="kneighbors", dists=d, idx=i, preds=None,
                            rung="fast", model=model_a, version="a")
        scorer._sq.start()
        assert scorer.drain(30)
        scorer.close()
        assert scorer.export()["rungs"]["fast"]["recall"] == 1.0

    def test_rate_validation(self):
        with pytest.raises(ValueError, match="shadow rate"):
            ShadowScorer(0.0, autostart=False)
        with pytest.raises(ValueError, match="shadow rate"):
            ShadowScorer(1.5, autostart=False)
        with pytest.raises(ValueError, match="queue_cap"):
            ShadowScorer(0.5, queue_cap=0, autostart=False)
        with pytest.raises(ValueError, match="floor"):
            ShadowScorer(0.5, approx_floors={"ivf": 0.0}, autostart=False)

    def test_scoring_errors_counted_not_raised(self, obs_on):
        scorer = ShadowScorer(1.0, seed=0)
        # model=None makes _score raise; the thread must absorb it.
        assert scorer.offer(features=np.zeros((1, 2), np.float32),
                            kind="kneighbors", dists=np.zeros((1, 1)),
                            idx=np.zeros((1, 1), np.int64), preds=None,
                            rung="fast", model=None, version=None)
        assert scorer.drain(10)
        scorer.close()
        assert scorer.score_errors == 1
        errs = _named(obs_on, "knn_quality_errors_total")
        assert len(errs) == 1 and errs[0].value == 1

    def test_a_mutable_view_is_a_scoring_error_not_a_pass(self, obs_on):
        """A sample that carries a live mutable view is scored against the
        merged oracle of that view (JAX's rule), never passed and never a
        scoring error: the base-only answer that ignored a fresh delta row
        and served a deleted one diverges, as it does under JAX's scorer."""
        from knn_tpu.mutable.state import MutableView as JMutableView
        from knn_tpu_torch.mutable.state import MutableView

        train = _problem(np.random.default_rng(26))
        model = KNNClassifier(k=3, **CPU).fit(train)
        jmodel = JKNNClassifier(k=3).fit(JDataset(train.features,
                                                  train.labels))
        # Three delta rows AT a far query: the live top-3 is delta-only,
        # so the base-only (stale) answer scores recall 0.
        q = np.full((1, train.num_features), 50.0, np.float32)
        d, i = model.kneighbors(Dataset(q, np.zeros(1, np.int32)))
        n = train.num_instances
        fields = dict(
            features=np.repeat(q, 3, axis=0), values=np.ones(3, np.float32),
            stable=np.arange(n, n + 3, dtype=np.int64), count=3,
            tomb_pos=frozenset({int(i[0, 1])}),
            tomb_base=np.array([i[0, 1]], np.int64),
            tomb_delta_slots=np.empty(0, np.int64), seq=2, base_n=n,
            generation=0)
        stats = []
        for cls, m, view in ((ShadowScorer, model, MutableView(**fields)),
                             (jquality.ShadowScorer, jmodel,
                              JMutableView(**fields))):
            scorer = cls(1.0, seed=0)
            scorer.offer(features=q, kind="kneighbors", dists=d, idx=i,
                         preds=None, rung="fast", model=m, version=None,
                         mview=view)
            assert scorer.drain(10)
            scorer.close()
            assert scorer.score_errors == 0 and scorer.scored == 1
            stats.append(scorer.export()["rungs"]["fast"])
        assert stats[0] == stats[1]
        assert stats[0]["recall"] == 0.0 and stats[0]["divergence"]


class TestScorersAgree:
    """Both packages' scorers on the same served answers."""

    @staticmethod
    def _score_both(model, jmodel, answers, approx_floors=None):
        out = []
        for cls, m, o in ((ShadowScorer, model, obs),
                          (jquality.ShadowScorer, jmodel, jobs)):
            s = cls(1.0, seed=0, autostart=False, approx_floors=approx_floors)
            for feats, kind, d, i, p, rung in answers:
                assert s.offer(features=feats, kind=kind, dists=d, idx=i,
                               preds=p, rung=rung, model=m, version="v")
            s._sq.start()
            assert s.drain(30)
            s.close()
            doc = s.export()
            out.append((doc["scored"], doc["score_errors"], doc["rungs"]))
        return out

    @pytest.mark.parametrize("corrupt", [False, True])
    def test_equal_recall_and_divergence_counts(self, corrupt):
        rng = np.random.default_rng(30 + corrupt)
        x = rng.normal(0.0, 2.0, (300, 6)).astype(np.float32)
        y = rng.integers(0, 4, 300).astype(np.int32)
        model = KNNClassifier(k=5, **CPU).fit(Dataset(x, y))
        jmodel = JKNNClassifier(k=5, engine="xla").fit(JDataset(x, y))
        answers = []
        for j in range(16):
            feats = rng.normal(0.0, 2.0, (1 + j % 3, 6)).astype(np.float32)
            d, i = model.kneighbors(Dataset(feats, np.zeros(len(feats),
                                                            np.int32)))
            if corrupt:  # the batcher's test hook, applied by hand
                i = (i + 1) % 300
            kind = "kneighbors" if j % 4 == 0 else "predict"
            p = (model.predict_from_candidates(d, i) if kind == "predict"
                 else None)
            answers.append((feats, kind, d, i, p,
                            "ivf" if j % 5 == 0 else "fast"))
        got, want = self._score_both(model, jmodel, answers,
                                     approx_floors={"ivf": 0.9})
        assert got == want
        assert got[0] == 16 and got[1] == 0
        total = sum(sum(r["divergence"].values()) for r in got[2].values())
        assert (total > 0) == corrupt


# ---------------------------------------------------------------------------
# The quality SLI in the SLO tracker


class TestQualitySLO:
    def test_quality_burn_from_shadow_events(self):
        s = SLOTracker(quality_target=0.9, windows_s=(60,))
        for good in (True, True, False, False):
            s.record_quality(good)
        burns = s.burn_rates()
        assert burns["quality"]["1m"] == pytest.approx(5.0)
        assert burns["availability"]["1m"] == 0.0

    def test_http_outcomes_do_not_move_quality(self):
        s = SLOTracker(windows_s=(60,))
        for _ in range(10):
            s.record(ok=True, latency_ms=1.0)
        assert s.burn_rates()["quality"]["1m"] == 0.0

    def test_quality_target_validated_and_exported(self):
        with pytest.raises(ValueError, match="quality_target"):
            SLOTracker(quality_target=1.0)
        doc = SLOTracker(windows_s=(60,)).export()
        assert "quality" in doc["burn_rates"]
        assert doc["targets"]["quality"] == 0.999


# ---------------------------------------------------------------------------
# The serving routes, against the JAX server's answer shape


def _shape(doc):
    """The key structure of a JSON document (values dropped)."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    return type(doc).__name__ if doc is None else "value"


def _servers(rng, **layers):
    """The port's and JAX's warmed servers over one grid model, with the
    same layer flags."""
    from knn_tpu.serve.server import ServeApp as JServeApp
    from knn_tpu.serve.server import make_server as jmake_server
    from knn_tpu_torch.serve.server import ServeApp, make_server

    x, y = _grid(rng, n=240, d=4)
    sketch = StreamSketch.from_data(x).to_dict()
    jobs.enable()
    s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(
        Dataset(x, y)), warm=(1,), reference_sketch=sketch, max_wait_ms=0.5,
        **layers)
    js = Served(JServeApp, jmake_server, JKNNClassifier(k=3, engine="xla")
                .fit(JDataset(x, y)), warm=(1,), reference_sketch=sketch,
                max_wait_ms=0.5, **layers)
    return s, js, x


class TestQualityRoutes:
    @pytest.mark.parametrize("layers", [
        {}, {"shadow_rate": 1.0}, {"drift_rate": 1.0},
        {"shadow_rate": 1.0, "drift_rate": 1.0, "quality_seed": 7},
    ], ids=["off", "shadow", "drift", "both"])
    def test_debug_quality_and_healthz_as_jax(self, obs_on, layers):
        rng = np.random.default_rng(40)
        s, js, x = _servers(rng, **layers)
        try:
            docs = []
            for srv in (s, js):
                app = srv.app
                for j in range(6):
                    app.batcher.submit(x[j:j + 2], "predict").result(
                        timeout=30)
                for layer in (app.quality, app.drift):
                    if layer is not None:
                        assert layer.drain(30)
                st, body, _ = http_get(srv.base, "/debug/quality")
                assert st == 200
                hz = json.loads(http_get(srv.base, "/healthz")[1])
                docs.append((json.loads(body), hz["quality"]))
            (doc, hq), (jdoc, jhq) = docs
            assert _shape(doc) == _shape(jdoc)
            assert _shape(hq) == _shape(jhq)
            assert doc["enabled"] == jdoc["enabled"] == {
                "shadow": "shadow_rate" in layers,
                "drift": "drift_rate" in layers}
            if "shadow_rate" in layers:
                for key in ("offered", "scored", "shed", "score_errors",
                            "rungs"):
                    assert doc["shadow"][key] == jdoc["shadow"][key], key
                assert doc["shadow"]["rungs"]["fast"]["recall"] == 1.0
            if "drift_rate" in layers:
                assert doc["drift"]["baseline"] == "present"
                assert doc["drift"] == jdoc["drift"]
        finally:
            s.close()
            js.close()

    def test_metrics_carry_the_quality_instruments(self, obs_on):
        s, js, x = _servers(np.random.default_rng(41), shadow_rate=1.0,
                            drift_rate=1.0)
        try:
            s.app.batcher.submit(x[:2], "predict").result(timeout=30)
            assert s.app.quality.drain(30) and s.app.drift.drain(30)
            st, text, _ = http_get(s.base, "/metrics")
            assert st == 200
            for name in ("knn_quality_scored_total", "knn_quality_recall",
                         "knn_quality_queue_depth", "knn_drift_score",
                         "knn_drift_baseline_present",
                         "knn_drift_rows_total"):
                assert name in text, name
        finally:
            s.close()
            js.close()

    def test_pre_sketch_artifact_reports_absent_and_bad_sketch_exits_2(
            self, obs_on, tmp_path, capsys):
        """A format-1 artifact (no sketch) serves with ``baseline:
        "absent"``; a wrong-width sketch in the manifest is a usage error
        at boot (exit 2), as in JAX."""
        from knn_tpu_torch import cli
        from knn_tpu_torch.serve.artifact import save_index
        from knn_tpu_torch.serve.server import ServeApp

        x, y = _grid(np.random.default_rng(42), n=60, d=3)
        app = ServeApp(KNNClassifier(k=3, **CPU).fit(Dataset(x, y)),
                       drift_rate=1.0, reference_sketch=None)
        try:
            assert app.quality_block()["drift"]["baseline"] == "absent"
        finally:
            app.close()
        idx = save_index(KNNClassifier(k=3).fit(Dataset(x, y)),
                         tmp_path / "idx")
        mf = json.loads((idx / "manifest.json").read_text())
        mf["drift_sketch"] = StreamSketch.from_data(
            np.ones((5, 7), np.float32)).to_dict()
        (idx / "manifest.json").write_text(json.dumps(mf))
        rc = cli.run(["serve", str(idx), "--device", "cpu", "--port", "0",
                      "--drift-rate", "0.5"])
        err = capsys.readouterr().err
        assert rc == 2 and "drift sketch covers 7 features" in err

    def test_reload_swaps_the_drift_baseline(self, obs_on, tmp_path):
        from knn_tpu_torch.serve.artifact import (
            read_manifest,
            reference_sketch,
            save_index,
        )
        from knn_tpu_torch.serve.server import ServeApp

        rng = np.random.default_rng(43)
        x, y = _grid(rng, n=80, d=3)
        idx = save_index(KNNClassifier(k=3).fit(Dataset(x, y)),
                         tmp_path / "idx")
        app = ServeApp(KNNClassifier(k=3, **CPU).fit(Dataset(x, y)),
                       drift_rate=1.0, reference_sketch=None,
                       index_path=str(idx), device="cpu")
        try:
            assert not app.drift.baseline_present
            app.reload()
            assert app.drift.baseline_present
            assert app.drift._reference["count"] == reference_sketch(
                read_manifest(idx))["count"]
        finally:
            app.close()


class TestCorruptionHook:
    def test_sigusr2_handler_only_under_the_env(self, monkeypatch):
        """``serve_forever`` installs the SIGUSR2 hook iff
        ``KNN_TPU_TEST_QUALITY_CORRUPT`` is set, as JAX's does; the hook
        arms ``corrupt_serving``."""
        from knn_tpu_torch.serve import server as server_mod

        class FakeBatcher:
            corrupt_serving = False

        class FakeApp:
            batcher = FakeBatcher()

            def close(self):
                pass

        seen = {}

        class FakeServer:
            app = FakeApp()

            def serve_forever(self, poll_interval):
                seen["handler"] = signal.getsignal(signal.SIGUSR2)

            def server_close(self):
                pass

        before = signal.getsignal(signal.SIGUSR2)
        for env in (None, "1"):
            if env is None:
                monkeypatch.delenv("KNN_TPU_TEST_QUALITY_CORRUPT",
                                   raising=False)
            else:
                monkeypatch.setenv("KNN_TPU_TEST_QUALITY_CORRUPT", env)
            fake = FakeServer()
            assert server_mod.serve_forever(fake) == 0
            if env is None:
                assert seen["handler"] is before
            else:
                assert seen["handler"] is not before
                seen["handler"](signal.SIGUSR2, None)
                assert fake.app.batcher.corrupt_serving is True
            assert signal.getsignal(signal.SIGUSR2) is before

    def test_sigusr2_corruption_is_caught_by_the_shadow_scorer(
            self, tmp_path):
        """The subprocess lifecycle: ``serve --shadow-rate 1`` under the
        env, SIGUSR2, then requests: ``/debug/quality`` attributes
        ``neighbors`` divergences to ``fast`` and the quality burn rises
        above 1 (JAX's answer shape, checked key by key against an
        in-process JAX server with its hook armed the same way)."""
        import queue
        import re
        import threading
        import urllib.request

        from knn_tpu.serve.server import ServeApp as JServeApp
        from knn_tpu.serve.server import make_server as jmake_server
        from knn_tpu_torch.serve.artifact import save_index

        x, y = _grid(np.random.default_rng(44), n=200, d=5)
        idx = save_index(KNNClassifier(k=3).fit(Dataset(x, y)),
                         tmp_path / "idx")
        env = dict(os.environ, KNN_TPU_TEST_QUALITY_CORRUPT="1")
        proc = subprocess.Popen(
            [sys.executable, "-m", "knn_tpu_torch", "serve", str(idx),
             "--port", "0", "--device", "cpu", "--shadow-rate", "1.0",
             "--max-wait-ms", "0.5", "--slo-windows", "60"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO)
        lines = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()
        jobs.enable()
        js = Served(JServeApp, jmake_server,
                    JKNNClassifier(k=3, engine="xla").fit(JDataset(x, y)),
                    warm=(1,), shadow_rate=1.0, max_wait_ms=0.5)
        try:
            m = re.search(r"ready on (http://[\d.]+:\d+)",
                          lines.get(timeout=120))
            assert m
            base = m.group(1)
            proc.send_signal(signal.SIGUSR2)
            js.app.batcher.corrupt_serving = True
            time.sleep(0.3)  # the handler runs between the server's polls
            for srv_base in (base, js.base):
                for j in range(8):
                    req = urllib.request.Request(
                        srv_base + "/predict",
                        data=json.dumps({"instances": x[j:j + 1].tolist()})
                        .encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=30) as r:
                        assert r.status == 200
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                doc = json.loads(http_get(base, "/debug/quality")[1])
                if doc["shadow"]["scored"] == 8:
                    break
                time.sleep(0.05)
            assert js.app.quality.drain(30)
            jdoc = json.loads(http_get(js.base, "/debug/quality")[1])
            # The subprocess keeps its own SLO windows and version tag.
            assert set(doc) == set(jdoc)
            assert _shape(doc["shadow"]) == _shape(jdoc["shadow"])
            fast = doc["shadow"]["rungs"]["fast"]
            assert fast["divergence"]["neighbors"] > 0
            assert fast["recall"] < 1.0
            assert doc["slo_quality"]["burn_rates"]["1m"] > 1.0
            assert jdoc["shadow"]["rungs"]["fast"]["divergence"][
                "neighbors"] > 0
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
            assert "TEST HOOK engaged" in proc.stderr.read()
        finally:
            js.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# The probe policy's loop, closed by the shadow scorer


@pytest.fixture(scope="module")
def large_ivf_artifact(tmp_path_factory):
    """The large fixture's train in an IVF artifact of ~sqrt(N) = 176
    cells, built by the port on the CPU (either package loads it)."""
    from knn_tpu_torch.index.ivf import IVFIndex
    from knn_tpu_torch.serve.artifact import save_index

    train, test = fixtures.load_pair("large")
    x, y = train.features, train.labels
    ivf = IVFIndex.build(x, 176, seed=0, iters=25, device="cpu")
    idx = save_index(KNNClassifier(k=5).fit(Dataset(x, y)),
                     tmp_path_factory.mktemp("large-ivf") / "idx", ivf=ivf)
    return idx, test.features


class TestProbePolicyLoop:
    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_quality_burn_widens_nprobe(self, obs_on, large_ivf_artifact,
                                        package):
        """``ivf_probes=1`` with shadow rate 1.0: answers at nprobe 1
        miss the 0.95 recall floor, the quality SLI burns, and the probe
        policy widens ``nprobe`` — the loop A9 left open, in both
        packages on one artifact."""
        idx, queries = large_ivf_artifact
        if package == "port":
            from knn_tpu_torch.serve.artifact import load_index
            from knn_tpu_torch.serve.server import ServeApp

            model = load_index(idx, device="cpu")
        else:
            from knn_tpu.serve.artifact import load_index
            from knn_tpu.serve.server import ServeApp

            jobs.enable()
            model = load_index(idx)
        app = ServeApp(model, ivf_probes=1, shadow_rate=1.0,
                       max_wait_ms=0.5)
        try:
            policy = app.ivf.policy
            assert policy.current() == 1
            t0 = time.monotonic()
            j = 0
            while (policy.moves["widen"] == 0
                   and time.monotonic() - t0 < 60):
                h = app.batcher.submit(queries[j:j + 4], "predict")
                h.result(timeout=30)
                assert h.meta["rung"] == "ivf"
                j = (j + 4) % (len(queries) - 4)
            assert policy.moves["widen"] >= 1, policy.export()
            assert policy.current() >= 2
            assert policy.export()["last_quality_burn"] > 1.0
            assert app.quality.drain(30)
            ivf = app.quality.export()["rungs"]["ivf"]
            assert ivf["recall"] < 0.95
            assert ivf["divergence"]["neighbors"] > 0
        finally:
            app.close()
