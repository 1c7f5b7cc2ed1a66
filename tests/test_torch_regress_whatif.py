"""The perf-regression rule and the what-if batching simulator on the port
(``knn_tpu_torch/obs/regress.py``, ``obs/whatif.py``), against the JAX
package's, on the CPU.

The twins of ``tests/test_regress.py``'s ``TestMad``, ``TestCompareMetric``
and ``TestCompareRecords`` and of ``tests/test_workload.py``'s
``TestWhatIfSimulator``, pointed at the port; then, on seeded inputs, the
two packages side by side: ``simulate``, ``frontier`` and
``default_policy_candidates`` bit-equal (the autotuner picks its candidate
from them), and ``compare_records`` giving equal verdicts.
"""

import json

import numpy as np
import pytest

from knn_tpu.obs import regress as jregress
from knn_tpu.obs import whatif as jwhatif
from knn_tpu_torch.obs import regress, whatif


def record(metrics: dict) -> dict:
    return {
        "env": {"platform": "cpu", "device_kind": "cpu", "cpus": 2},
        "metrics": {
            name: {"trials": trials, "direction": direction, "unit": "ms"}
            for name, (trials, direction) in metrics.items()
        },
    }


class TestMad:
    def test_median_and_mad(self):
        assert regress.median([3.0, 1.0, 2.0]) == 2.0
        assert regress.median([4.0, 1.0, 2.0, 3.0]) == 2.5
        assert regress.mad([10.0, 12.0, 11.0, 50.0]) == 1.0  # robust to 50
        assert regress.mad([7.0]) == 0.0


class TestCompareMetric:
    BASE = [10.0, 10.5, 11.0, 10.2, 10.8]  # best 10, MAD 0.3

    def test_clean_pass(self):
        c = regress.compare_metric("m", self.BASE, [10.1, 10.4, 10.9])
        assert not c["regressed"] and not c["improved"]

    def test_injected_regression_fails(self):
        c = regress.compare_metric("m", self.BASE,
                                   [t * 2 for t in self.BASE])
        assert c["regressed"]
        assert c["delta"] == pytest.approx(10.0)

    def test_noise_within_mad_tolerance_passes(self):
        c = regress.compare_metric("m", self.BASE, [11.2, 11.4, 11.3])
        assert c["tolerance"] == pytest.approx(1.5)
        assert not c["regressed"]
        c2 = regress.compare_metric("m", self.BASE, [11.6, 12.0])
        assert c2["regressed"]

    def test_higher_is_better_direction(self):
        base = [100.0, 98.0, 99.0]
        ok = regress.compare_metric("q", base, [97.0, 96.5],
                                    direction="higher")
        assert not ok["regressed"]
        bad = regress.compare_metric("q", base, [50.0, 49.0],
                                     direction="higher")
        assert bad["regressed"]

    def test_improvement_reported_not_failed(self):
        c = regress.compare_metric("m", self.BASE, [5.0, 5.2])
        assert c["improved"] and not c["regressed"]

    def test_abs_floor_shields_microsecond_metrics(self):
        c = regress.compare_metric("m", [0.01, 0.012], [0.3, 0.31])
        assert not c["regressed"]

    def test_empty_trials_fail(self):
        assert regress.compare_metric("m", [], [1.0])["regressed"]
        assert regress.compare_metric("m", [1.0], [])["regressed"]

    def test_bad_direction_raises(self):
        with pytest.raises(ValueError):
            regress.compare_metric("m", [1.0], [1.0], direction="sideways")


class TestCompareRecords:
    def test_verdict_shape_and_pass(self):
        base = record({"a": ([10.0, 10.1], "lower"),
                       "b": ([5.0, 5.1], "lower")})
        v = regress.compare_records(base, base)
        assert v["pass"] is True
        assert len(v["checks"]) == 2
        assert v["new_metrics"] == []

    def test_missing_metric_fails(self):
        base = record({"a": ([10.0], "lower"), "b": ([5.0], "lower")})
        fresh = record({"a": ([10.0], "lower")})
        v = regress.compare_records(base, fresh)
        assert v["pass"] is False
        missing = [c for c in v["checks"] if "reason" in c]
        assert missing and missing[0]["metric"] == "b"

    def test_new_metric_reported_not_gated(self):
        base = record({"a": ([10.0], "lower")})
        fresh = record({"a": ([10.0], "lower"), "c": ([1.0], "lower")})
        v = regress.compare_records(base, fresh)
        assert v["pass"] is True
        assert v["new_metrics"] == ["c"]

    def test_summarize_names_the_regression(self):
        base = record({"a": ([10.0, 10.1], "lower")})
        fresh = record({"a": ([30.0, 30.5], "lower")})
        v = regress.compare_records(base, fresh)
        assert "REGRESSED a:" in regress.summarize(v)


class TestWhatIfSimulator:
    def test_single_requests_no_coalescing(self):
        sim = whatif.simulate(
            [(0.0, 1), (100.0, 1), (200.0, 1)],
            max_batch=8, max_wait_ms=2.0, a_ms=3.0, b_ms_per_row=0.5,
        )
        assert sim["dispatches"] == 3
        assert sim["p50_ms"] == pytest.approx(5.5)
        assert sim["p99_ms"] == pytest.approx(5.5)
        assert sim["occupancy_mean"] == pytest.approx(1 / 8)

    def test_batch_closes_at_max_batch(self):
        sim = whatif.simulate(
            [(0.0, 1), (1.0, 1), (2.0, 1), (3.0, 1)],
            max_batch=4, max_wait_ms=10.0, a_ms=2.0, b_ms_per_row=1.0,
        )
        assert sim["dispatches"] == 1
        assert sim["mean_ms"] == pytest.approx(7.5)
        assert sim["occupancy_mean"] == pytest.approx(1.0)

    def test_busy_worker_coalesces_backlog(self):
        sim = whatif.simulate(
            [(0.0, 4), (1.0, 1), (2.0, 1)],
            max_batch=4, max_wait_ms=1.0, a_ms=10.0, b_ms_per_row=0.0,
        )
        assert sim["dispatches"] == 2
        assert sim["p50_ms"] == pytest.approx(18.0)
        assert sim["mean_ms"] == pytest.approx((10 + 19 + 18) / 3, abs=0.01)
        assert sim["duty_cycle"] == pytest.approx(1.0, abs=0.01)

    def test_bucket_policy_prices_padding(self):
        sim = whatif.simulate(
            [(0.0, 3)], max_batch=8, max_wait_ms=0.0, a_ms=1.0,
            b_ms_per_row=1.0, buckets=[4, 8],
        )
        assert sim["padded_row_waste_ratio"] == pytest.approx(0.25)
        assert sim["p50_ms"] == pytest.approx(5.0)

    def test_frontier_shapes(self):
        rows = whatif.frontier(
            [(0.0, 1), (5.0, 1)],
            [{"max_batch": 8, "max_wait_ms": 2.0},
             {"max_batch": 1, "max_wait_ms": 0.0, "buckets": [1]}],
            a_ms=1.0, b_ms_per_row=0.1,
        )
        assert len(rows) == 2
        assert rows[0]["policy"]["max_batch"] == 8
        assert rows[1]["p50_ms"] is not None

    def test_validation(self):
        with pytest.raises(ValueError):
            whatif.simulate([], max_batch=0, max_wait_ms=1, a_ms=1,
                            b_ms_per_row=0)
        with pytest.raises(ValueError):
            whatif.simulate([], max_batch=1, max_wait_ms=1, a_ms=-1,
                            b_ms_per_row=0)
        empty = whatif.simulate([], max_batch=1, max_wait_ms=0, a_ms=1,
                                b_ms_per_row=0)
        assert empty["requests"] == 0 and empty["p50_ms"] is None

    def test_padded_rows_takes_the_ladder_as_an_argument(self):
        assert whatif.padded_rows(3, None, 8) == 3
        assert whatif.padded_rows(3, [4, 8], 8) == 4
        assert whatif.padded_rows(9, [4, 8], 16) == 16


def _arrivals(seed: int, n: int = 400):
    """Seeded arrivals: exponential gaps (mean 0.5-4 ms), 1-64 rows with
    a heavy single-row share, as captured serving traffic looks."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(rng.uniform(0.5, 4.0), n))
    rows = np.where(rng.random(n) < 0.7, 1, rng.integers(1, 65, n))
    return [(float(a), int(r)) for a, r in zip(t, rows)]


POLICIES = [
    {"max_batch": 256, "max_wait_ms": 2.0, "buckets": None},
    {"max_batch": 256, "max_wait_ms": 0.0, "buckets": [16, 32, 64, 128, 256]},
    {"max_batch": 32, "max_wait_ms": 8.0, "buckets": [8, 16, 32]},
    {"max_batch": 8, "max_wait_ms": 0.5, "buckets": None},
]


class TestAgainstJAX:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("policy", range(len(POLICIES)))
    def test_simulate_bit_equal(self, seed, policy):
        arr = _arrivals(seed)
        p = POLICIES[policy]
        kw = dict(max_batch=p["max_batch"], max_wait_ms=p["max_wait_ms"],
                  a_ms=0.3 + 0.1 * seed, b_ms_per_row=0.004 * (seed + 1),
                  buckets=p["buckets"])
        got, want = whatif.simulate(arr, **kw), jwhatif.simulate(arr, **kw)
        assert json.dumps(got) == json.dumps(want)

    @pytest.mark.parametrize("seed", range(4))
    def test_frontier_over_the_autotuner_grid_bit_equal(self, seed):
        arr = _arrivals(100 + seed)
        wait = [0.0, 0.5, 2.0, 10.0][seed]
        buckets = [16, 32, 64, 128, 256] if seed % 2 else None
        cands = whatif.default_policy_candidates(256, wait, buckets)
        assert cands == jwhatif.default_policy_candidates(256, wait, buckets)
        got = whatif.frontier(arr, cands, a_ms=0.7, b_ms_per_row=0.01)
        want = jwhatif.frontier(arr, cands, a_ms=0.7, b_ms_per_row=0.01)
        assert json.dumps(got) == json.dumps(want)

    @pytest.mark.parametrize("max_batch,wait,buckets", [
        (1, 0.0, None), (8, 0.25, None), (256, 1.0, [16, 256]),
        (256, 2.0, None), (64, 3.3333, [8, 64]), (256, 50.0, None),
    ])
    def test_default_policy_candidates_equal(self, max_batch, wait, buckets):
        assert (whatif.default_policy_candidates(max_batch, wait, buckets)
                == jwhatif.default_policy_candidates(max_batch, wait,
                                                     buckets))

    @pytest.mark.parametrize("seed", range(6))
    def test_compare_records_equal_verdicts(self, seed):
        rng = np.random.default_rng(seed)
        names = [f"m{i}" for i in range(5)]

        def rec(scale, drop=()):
            return record({
                n: ([float(x) for x in rng.normal(10 + i, 0.3 * scale, 5)],
                    "lower" if i % 2 else "higher")
                for i, n in enumerate(names) if n not in drop})

        base = rec(1.0)
        fresh = rec(1.0 + seed, drop=("m4",) if seed % 3 == 0 else ())
        if seed % 2:
            fresh["metrics"]["extra"] = {"trials": [1.0], "unit": "ms"}
        kw = {"rel_tol": 0.02 * (seed + 1), "mad_k": 3.0, "abs_floor": 0.1}
        got = regress.compare_records(base, fresh, **kw)
        want = jregress.compare_records(base, fresh, **kw)
        assert json.dumps(got) == json.dumps(want)
        assert regress.summarize(got) == jregress.summarize(want)
