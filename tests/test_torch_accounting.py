"""Cost and capacity on the port (the twin of ``tests/test_accounting.py``),
on the CPU.

Attribution conservation carries over unchanged: the per-request device-ms
shares of every dispatch attempt sum to the measured wall, over any mix of
classes, rungs, coalesced batches and concurrent clients. The unit cases
run the same sequence on the port's ``CostAccountant``,
``CapacityTracker`` and ``SecondRing`` and on the JAX package's, and hold
the results equal.

What differs on purpose: padded rows are the card's own. JAX counts the
TPU stripe kernel's ``block_q`` grid and its 128-row XLA quantum; the
port's kernels take any query count (a kernel dispatch sweeps its live
rows), and its XLA route pads to whole query tiles of ``min(rows, 128)``
(``backends/cuda.py::retrieval_padded_rows``, the one definition the scan
and the accounting share). The cases below pin the port's rule against
the pad its scan really makes.

Tolerances: float sums to ``rel=1e-9``; counts exact.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.obs import accounting as jacct  # noqa: E402
from knn_tpu.obs import capacity as jcapacity  # noqa: E402
from knn_tpu.obs import slo as jslo  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.backends.cuda import retrieval_padded_rows  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier  # noqa: E402
from knn_tpu_torch.obs import accounting as acct  # noqa: E402
from knn_tpu_torch.obs import capacity, slo  # noqa: E402
from knn_tpu_torch.obs.accounting import (  # noqa: E402
    CostAccountant,
    dispatch_padded_rows,
    padded_query_rows,
)
from knn_tpu_torch.resilience.errors import (  # noqa: E402
    DeadlineExceededError,
    DeviceError,
    OverloadError,
)
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401
from tests.test_torch_serve import (  # noqa: E402,F401
    CPU,
    Served,
    http_get,
    http_post,
    obs_on,
    problem,
)

PACKAGES = {"port": (obs, acct, capacity, slo),
            "jax": (jobs, jacct, jcapacity, jslo)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """``(obs, accounting, capacity, slo)`` of one package, with its obs
    enabled and reset."""
    o = PACKAGES[request.param][0]
    o.enable()
    o.reset()
    return PACKAGES[request.param]


def counter_sum(registry, name):
    return sum(i.value for i in registry.instruments() if i.name == name)


def assert_conservation(registry):
    dev = counter_sum(registry, "knn_cost_device_ms_total")
    wall = counter_sum(registry, "knn_cost_dispatch_wall_ms_total")
    assert wall > 0 and dev == pytest.approx(wall, rel=1e-9)


class _Req:
    def __init__(self, rows, cls):
        self.rows, self.request_class = rows, cls
        self.meta, self.trace = {}, None


class TestRequestClass:
    @pytest.mark.parametrize("cls,ok", [
        ("interactive", True), ("bulk.v2-a_b", True), ("", False),
        ("UPPER", False), ("x" * 33, False), ("sp ace", False)])
    def test_validation_equals_jax(self, cls, ok):
        assert acct.valid_request_class(cls) is ok
        assert jacct.valid_request_class(cls) is ok

    def test_cardinality_capped_as_jax(self):
        for m in (acct, jacct):
            a = m.CostAccountant()
            admitted = {a.admit_class(f"c{i}") for i in range(200)}
            assert len(admitted - {m.OVERFLOW_CLASS}) == m.MAX_CLASSES - 2
            assert a.admit_class("one-too-many") == m.OVERFLOW_CLASS
            assert a.admit_class(m.DEFAULT_CLASS) == "interactive"


class TestPaddedRowsOnTheCard:
    def test_kernel_route_sweeps_live_rows(self):
        for rows in (1, 5, 127, 128, 129, 4000):
            assert padded_query_rows("stripe", rows) == rows
        assert padded_query_rows("oracle", 7) == 7
        assert padded_query_rows("stripe", 0) == 0

    @pytest.mark.parametrize("rows,want", [
        (1, 1), (5, 5), (128, 128), (129, 256), (300, 384), (0, 0)])
    def test_xla_route_pads_whole_query_tiles(self, rows, want):
        assert padded_query_rows("xla", rows) == want == \
            retrieval_padded_rows(rows)

    def test_the_scan_pads_by_the_same_rule(self, rng, obs_on):
        """The XLA route's ``distance`` span reports the pad the scan
        really made; accounting's rule gives the same number."""
        from knn_tpu_torch.models.knn import _kneighbors_arrays

        train, test, _, _ = problem(rng, q=40)
        feats = np.tile(test.features, (4, 1))[:150]
        _kneighbors_arrays(train.features, feats, 3, engine="xla",
                           device="cpu")
        span = [s for s in obs.tracer().spans() if s.name == "distance"][-1]
        assert (span.attrs["rows"], span.attrs["padded_rows"]) == \
            (150, padded_query_rows("xla", 150)) == (150, 256)
        _kneighbors_arrays(train.features, feats, 3, device="cpu")
        span = [s for s in obs.tracer().spans() if s.name == "distance"][-1]
        assert span.attrs["padded_rows"] == 150  # the kernel route

    def test_dispatch_chunking_sums_per_chunk(self, rng):
        train, _, _, _ = problem(rng)
        xla = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        auto = KNNClassifier(k=3, **CPU).fit(train)
        # Chunks of 200 and 100: 200 rows sweep two 128-row tiles.
        assert dispatch_padded_rows(xla, "fast", 300, 200) == 256 + 100
        assert dispatch_padded_rows(xla, "xla", 300, 129) == 256 + 256 + 42
        assert dispatch_padded_rows(auto, "fast", 300, 4) == 300
        assert acct.resolved_retrieval_engine(auto) == "stripe"
        assert acct.resolved_retrieval_engine(xla) == "xla"

    def test_serving_the_kernel_route_counts_no_waste(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        a = CostAccountant()
        with MicroBatcher(model, max_batch=16, max_wait_ms=50.0,
                          buckets=(16,), accounting=a) as b:
            hs = [b.submit(test.features[i:i + 3]) for i in range(0, 9, 3)]
            for h in hs:
                h.result(timeout=60)
        totals = a.export()["totals"]
        assert totals["padded_rows"] == totals["rows"] == 9
        assert counter_sum(obs_on, "knn_cost_padded_rows_total") == 0


class TestAttribution:
    def test_proportional_shares_in_one_coalesced_batch(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        a = CostAccountant()
        with MicroBatcher(model, max_batch=4, max_wait_ms=5000.0,
                          accounting=a) as b:
            ha = b.submit(test.features[:1], "predict",
                          request_class="interactive")
            hb = b.submit(test.features[1:4], "kneighbors",
                          request_class="bulk")
            ha.result(timeout=60)
            hb.result(timeout=60)
        ca, cb = ha.meta["cost"], hb.meta["cost"]
        assert (ca["class"], cb["class"]) == ("interactive", "bulk")
        assert cb["device_ms"] == pytest.approx(3 * ca["device_ms"], rel=1e-6)
        assert cb["bytes"] >= ca["bytes"]
        assert_conservation(obs_on)
        # The XLA route's tile pad of a 4-row batch is 4: no waste.
        assert counter_sum(obs_on, "knn_cost_padded_rows_total") == 0

    def test_conservation_under_concurrent_mixed_load(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        a = CostAccountant()
        costs, lock = [], threading.Lock()

        def client(cid):
            mine = []
            for i in range(10):
                kind = "predict" if (cid + i) % 2 == 0 else "kneighbors"
                lo = (cid * 10 + i) % (test.num_instances - 3)
                h = batcher.submit(test.features[lo:lo + 1 + (i % 3)], kind,
                                   request_class=("bulk" if i % 3 == 0
                                                  else None))
                h.result(timeout=60)
                mine.append(h.meta["cost"])
            with lock:
                costs.extend(mine)

        with MicroBatcher(model, max_batch=8, max_wait_ms=1.0,
                          buckets=(4, 8), accounting=a) as batcher:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        assert len(costs) == 60 and all(c["device_ms"] > 0 for c in costs)
        assert_conservation(obs_on)
        wall = counter_sum(obs_on, "knn_cost_dispatch_wall_ms_total")
        assert sum(c["device_ms"] for c in costs) == pytest.approx(
            wall, rel=1e-9)
        exp = a.export()
        assert exp["totals"]["attributed_ms"] == pytest.approx(
            exp["totals"]["dispatch_wall_ms"], rel=1e-9)
        assert set(exp["classes"]) == {"interactive", "bulk"}

    def test_expired_mid_retry_attributed_only_ridden_attempts(
            self, rng, obs_on, monkeypatch):
        """The port's attempts are retries of the one rung: the expired
        request rode only the failed attempt, the survivor that attempt
        and the retry that answered."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        real = model.kneighbors
        n = {"calls": 0}

        def slow_once(ds):
            n["calls"] += 1
            if n["calls"] == 1:
                time.sleep(0.4)
                raise DeviceError("slow transient", transient=True)
            return real(ds)

        a = CostAccountant()
        b = MicroBatcher(model, max_batch=64, max_wait_ms=50.0, accounting=a)
        try:
            monkeypatch.setattr(model, "kneighbors", slow_once)
            ha = b.submit(test.features[0], deadline_ms=200,
                          request_class="interactive")
            hb = b.submit(test.features[1], request_class="bulk")
            with pytest.raises(DeadlineExceededError):
                ha.result(timeout=60)
            hb.result(timeout=60)
        finally:
            monkeypatch.undo()
            b.close()
        expired, survivor = ha.meta["cost"], hb.meta["cost"]
        assert set(expired["rungs"]) == set(survivor["rungs"]) == {"fast"}
        assert survivor["device_ms"] > expired["device_ms"]
        assert_conservation(obs_on)
        exp = a.export()
        assert exp["classes"]["interactive"]["outcomes"] == {"expired": 1}
        assert exp["classes"]["bulk"]["outcomes"] == {"ok": 1}
        assert exp["classes"]["interactive"]["rows"] == 0
        assert exp["classes"]["bulk"]["rows"] == 1
        assert exp["totals"]["dispatches"] == 2  # two attempts

    def test_class_survives_rejection_and_expiry(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        a = CostAccountant()
        with MicroBatcher(model, max_batch=2, max_queue_rows=2,
                          max_wait_ms=2000.0, accounting=a) as batcher:
            parked = batcher.submit(test.features[:1], request_class="bulk")
            with pytest.raises(OverloadError):
                batcher.submit(test.features[1:3], request_class="bulk")
            parked.result(timeout=30)
        with MicroBatcher(model, max_batch=64, max_wait_ms=2000.0,
                          accounting=a) as b:
            h = b.submit(test.features[:1], deadline_ms=20,
                         request_class="late")
            with pytest.raises(DeadlineExceededError):
                h.result(timeout=30)
        exp = a.export()["classes"]
        assert exp["bulk"]["outcomes"] == {"rejected": 1, "ok": 1}
        assert exp["late"]["outcomes"] == {"expired": 1}
        assert "cost" not in h.meta

    def test_embedded_submit_rejects_invalid_class(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        with MicroBatcher(model, max_batch=2,
                          accounting=CostAccountant()) as batcher:
            for bad in ("UPPER", "new\nline", "x" * 33):
                with pytest.raises(ValueError, match="request_class"):
                    batcher.submit(test.features[:1], request_class=bad)
        with MicroBatcher(model, max_batch=2) as untagged:
            untagged.submit(test.features[:1],
                            request_class="UPPER").result(timeout=30)

    def test_no_accounting_means_no_cost_instruments(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        with MicroBatcher(model, max_batch=4, max_wait_ms=0.0) as b:
            h = b.submit(test.features[:1], request_class="bulk")
            h.result(timeout=60)
        assert "cost" not in h.meta
        assert not [i.name for i in obs_on.instruments()
                    if i.name.startswith(("knn_cost_", "knn_capacity_"))]


@pytest.fixture
def fake_clock(monkeypatch):
    """One clock for both packages' slo/capacity modules (stdlib time)."""
    clock = [10_000.0]
    for m in (slo, jslo):
        monkeypatch.setattr(m.time, "monotonic", lambda: clock[0])
    assert capacity.time is slo.time and jcapacity.time is jslo.time
    return clock


def jax_view(out: dict) -> dict:
    """The port's capacity export as JAX's: without the front end's host
    time, which only the port's model prices (0 when none was recorded,
    and then every other field is JAX's)."""
    assert out["frontend_ms_per_request"] == 0.0
    assert out["frontend_clock"] is None
    return {k: v for k, v in out.items()
            if k not in ("frontend_ms_per_request", "frontend_clock")}


class TestCapacityMath:
    """Each case drives both packages' trackers with the same calls and
    holds their exports equal, then pins the numbers."""

    def both(self, *args, **kw):
        return capacity.CapacityTracker(*args, **kw), \
            jcapacity.CapacityTracker(*args, **kw)

    def test_duty_cycle_and_rates(self, fake_clock, obs_on):
        ts = self.both(8, window_s=60)
        fake_clock[0] += 10.0
        for t in ts:
            for _ in range(5):
                t.note_arrival(2)
            for _ in range(4):
                t.note_served(2, 50.0)
                t.note_dispatch(500.0, 2, 2, 8, compiled=False)
        out, jout = (t.export() for t in ts)
        assert jax_view(out) == jout
        assert out["duty_cycle"] == pytest.approx(0.2)
        assert out["arrival_qps"] == pytest.approx(0.5)
        # The kernel route pads nothing: occupancy is rows / max_batch.
        assert out["occupancy_mean"] == pytest.approx(2 / 8, abs=1e-4)
        assert out["padded_row_waste_ratio"] == 0.0
        assert out["littles_law_concurrency"] == pytest.approx(0.02)

    def test_seeded_and_observed_headroom_models(self, fake_clock, obs_on):
        ts = self.both(16, window_s=60)
        for t in ts:
            t.seed_dispatch_model(1, 100.0)
            t.seed_dispatch_model(16, 200.0)
        fake_clock[0] += 5.0
        seeded = [t.export()["dispatch_model"] for t in ts]
        assert seeded[0] == seeded[1] and seeded[0]["source"] == "seed"
        for t in ts:
            for rows in (1, 4, 8, 16, 2, 12):
                t.note_dispatch(2.0 + 0.5 * rows, rows, rows, 16)
            t.note_dispatch(2 * 2.0 + 0.5 * 32 + 100.0, 32, 32, 16)
        out, jout = (t.export() for t in ts)
        assert jax_view(out) == jout
        m = out["dispatch_model"]
        assert m["source"] == "observed"
        assert m["a_ms"] == pytest.approx(2.0, abs=1e-6)
        assert m["b_ms_per_row"] == pytest.approx(0.5, abs=1e-6)
        assert out["occupancy_mean"] <= 1.0

    def test_headroom_ratio_vs_arrival(self, fake_clock, obs_on):
        ts = self.both(4, window_s=60)
        fake_clock[0] += 10.0
        for t in ts:
            t.seed_dispatch_model(1, 5.0)
            t.seed_dispatch_model(4, 8.0)
            for _ in range(100):
                t.note_arrival(1)
                t.note_served(1, 10.0)
        out, jout = (t.export() for t in ts)
        assert jax_view(out) == jout
        assert out["sustainable_qps"] == pytest.approx(500.0, rel=1e-3)
        assert out["headroom_ratio"] == pytest.approx(50.0, rel=1e-3)

    def test_front_end_host_time_prices_the_headroom(self, fake_clock,
                                                     obs_on):
        # The fault the capacity probe found on the card (NVIDIA H100 80GB
        # HBM3, 700.00 W; python -m knn_tpu_torch.gates.capacity_probe at
        # xl): seeded as there (1 and 128 rows, 1.8398 ms each), JAX's
        # dispatch-only model prices 128-row requests at 543.5 q/s while
        # the replica's knee sat at 99.85 q/s (0.18x, outside [0.2, 3.0]):
        # its handlers' host time shares the worker's interpreter.
        ts = self.both(128, window_s=30)
        fake_clock[0] += 5.0
        for t in ts:
            t.seed_dispatch_model(1, 1.8398)
            t.seed_dispatch_model(128, 1.8398)
            for _ in range(6):
                t.note_arrival(128)
                t.note_served(128, 3.0)
        port, jax = ts
        for _ in range(6):
            port.note_frontend(1.5, 1.5)
        out, jout = port.export(), jax.export()
        assert jout["sustainable_qps"] == pytest.approx(543.54, abs=0.01)
        assert out["frontend_ms_per_request"] == pytest.approx(1.5)
        # One full batch: the dispatch and one request's front end.
        assert out["sustainable_rows_per_s"] == pytest.approx(
            128 / ((1.8398 + 1.5) / 1e3), abs=0.1)
        assert out["sustainable_qps"] == pytest.approx(
            1e3 / (1.8398 + 1.5), abs=0.01)
        assert out["dispatch_model"] == jout["dispatch_model"]
        # A single-row mix pays the front end once per row.
        fake_clock[0] += 60.0
        for _ in range(50):
            port.note_arrival(1)
            port.note_served(1, 2.0)
            port.note_frontend(0.5, 0.5)
        out = port.export()
        assert out["rows_per_request"] == 1.0
        assert out["sustainable_rows_per_s"] == pytest.approx(
            128 / ((1.8398 + 0.5 * 128) / 1e3), abs=0.1)
        # The samples age out with the window.
        fake_clock[0] += 60.0
        assert port.export()["frontend_ms_per_request"] == 0.0

    @pytest.mark.parametrize("ticks", [(0,) * 6, (0, 0, 0, 0, 10, 10),
                                       (0, 0, 10, 0, 10, 10)])
    def test_front_end_reads_the_wall_until_the_cpu_clock_has_ticks(
            self, fake_clock, obs_on, ticks):
        # The fault the capacity probe found on the card (NVIDIA H100 80GB
        # HBM3, 700.00 W; python -m knn_tpu_torch.gates.capacity_probe at
        # xl): the host's thread CPU clock advances in 10 ms ticks, so six
        # low-load requests read a front end of 0.0, 3.3333 or 5.0 ms, and
        # at 0.0 the estimate fell back to the dispatch-only model (0.18x
        # and 0.28x the knee). Below FRONTEND_CPU_MIN_MS of CPU the model
        # takes the handlers' wall.
        t = capacity.CapacityTracker(128, window_s=30)
        fake_clock[0] += 5.0
        t.seed_dispatch_model(1, 1.4)
        t.seed_dispatch_model(128, 1.4)
        for cpu in ticks:
            t.note_arrival(128)
            t.note_served(128, 3.0)
            t.note_frontend(cpu, 1.6)
        out = t.export()
        assert out["frontend_clock"] == "wall"
        assert out["frontend_ms_per_request"] == pytest.approx(1.6)
        assert out["sustainable_qps"] == pytest.approx(1e3 / (1.4 + 1.6),
                                                       abs=0.01)
        # Under load the CPU clock has ticked enough: its mean, not the
        # wall, which also counts the waits for the interpreter lock.
        for i in range(420):
            t.note_arrival(128)
            t.note_served(128, 9.0)
            t.note_frontend(10.0 if i % 7 == 0 else 0.0, 2.9)
        out = t.export()
        cpu_ms = sum(ticks) + 60 * 10.0
        assert cpu_ms >= capacity.FRONTEND_CPU_MIN_MS
        assert out["frontend_clock"] == "cpu"
        assert out["frontend_ms_per_request"] == pytest.approx(
            cpu_ms / (len(ticks) + 420), abs=1e-4)

    def test_window_expires_old_traffic(self, fake_clock, obs_on):
        t = capacity.CapacityTracker(8, window_s=10)
        fake_clock[0] += 5.0
        t.note_arrival(1)
        assert t.export()["arrival_qps"] > 0
        fake_clock[0] += 30.0
        assert t.export()["arrival_qps"] == 0.0

    def test_gauges_exported(self, fake_clock, obs_on):
        t = capacity.CapacityTracker(8, window_s=60)
        fake_clock[0] += 2.0
        t.note_dispatch(10.0, 4, 4, 8)
        t.export()
        prom = obs_on.to_prometheus()
        for needle in ("knn_capacity_duty_cycle",
                       "knn_capacity_occupancy_mean",
                       "knn_capacity_batch_occupancy_bucket"):
            assert needle in prom, needle

    def test_validation(self):
        with pytest.raises(ValueError, match="max_batch"):
            capacity.CapacityTracker(0)
        with pytest.raises(ValueError, match="window_s"):
            capacity.CapacityTracker(8, window_s=0)


class TestSecondRing:
    def test_window_sums_equal_jax(self, fake_clock):
        rings = [m.SecondRing(2, 30) for m in (slo, jslo)]
        for r in rings:
            r.add(1, 2.5)
        fake_clock[0] += 3
        for r in rings:
            r.add(1, 1.5)
        for r in rings:
            assert r.window_sums(30) == (2, 4.0)
            assert r.window_sums(2) == (1, 1.5)
        with pytest.raises(ValueError, match="field deltas"):
            rings[0].add(1)


class TestAccountantUnits:
    def test_export_rung_breakdown_equals_jax(self, pkg):
        o, m = pkg[0], pkg[1]
        a = m.CostAccountant()
        r1, r2 = _Req(1, "interactive"), _Req(3, "bulk")
        a.attribute([r1, r2], 8.0, rung="fast", rows=4, padded_rows=128,
                    nbytes=400, ok=False)
        a.attribute([r1, r2], 4.0, rung="fast", rows=4, padded_rows=4,
                    nbytes=400, ok=True)
        exp = a.export()
        assert exp["totals"]["dispatch_wall_ms"] == pytest.approx(12.0)
        assert exp["totals"]["padded_rows"] == 132
        assert exp["classes"]["interactive"]["rungs"]["fast"] == \
            pytest.approx(3.0)
        assert exp["classes"]["bulk"]["rows"] == 3
        assert r1.meta["cost"]["padded_rows_share"] == pytest.approx(31.0)
        assert_conservation(o.registry())

    def test_attribute_nothing_on_empty_batch(self, pkg):
        a = pkg[1].CostAccountant()
        a.attribute([], 5.0, rung="fast", rows=0, padded_rows=0)
        assert a.export()["totals"]["dispatches"] == 0


@pytest.fixture
def served_with_cost(rng, obs_on):
    from knn_tpu_torch.serve.server import ServeApp, make_server

    train, test, _, _ = problem(rng)
    s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
               max_batch=16, max_wait_ms=1.0, cost_accounting=True)
    try:
        yield s.base, test, s.app
    finally:
        s.close()


class TestServerCostCapacity:
    def test_debug_capacity_joins_cost_and_headroom(self, served_with_cost):
        base, test, _ = served_with_cost
        assert http_post(base, "/predict",
                         {"instances": test.features[:2].tolist()})[0] == 200
        import json

        doc = json.loads(http_get(base, "/debug/capacity")[1])
        assert doc["enabled"] is True and doc["policy"]["max_batch"] == 16
        totals = doc["cost"]["totals"]
        assert totals["attributed_ms"] == pytest.approx(
            totals["dispatch_wall_ms"], rel=1e-9)
        cap = doc["capacity"]
        assert cap["dispatch_model"]["source"] in ("seed", "observed")
        assert cap["sustainable_qps"] > 0

    def test_served_requests_price_their_front_end(self, obs_on):
        import json

        from knn_tpu_torch.serve.server import ServeApp, make_server

        # A generator of its own: the session rng's draws stay those of
        # the tests after this one.
        train, test, _, _ = problem(np.random.default_rng(16))
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   max_batch=16, max_wait_ms=1.0, cost_accounting=True)
        try:
            for i in range(3):
                assert http_post(s.base, "/predict", {
                    "instances": test.features[i:i + 4].tolist()})[0] == 200
            cap = json.loads(http_get(s.base, "/debug/capacity")[1])[
                "capacity"]
        finally:
            s.close()
        f = cap["frontend_ms_per_request"]
        assert f > 0
        m = cap["dispatch_model"]
        full_ms = (m["a_ms"] + m["b_ms_per_row"] * 16
                   + f * 16 / cap["rows_per_request"])
        assert cap["sustainable_rows_per_s"] == pytest.approx(
            16 / (full_ms / 1e3), rel=1e-3)

    def test_timeline_cost_block_and_class_sources(self, served_with_cost):
        import json

        base, test, app = served_with_cost
        http_post(base, "/predict", {"instances": test.features[:1].tolist()},
                  {"x-request-id": "cost-1", "x-knn-class": "bulk"})
        tl = json.loads(http_get(base, "/debug/requests?id=cost-1")[1])[
            "requests"][0]
        assert tl["request_class"] == "bulk" == tl["cost"]["class"]
        assert tl["cost"]["device_ms"] > 0 and tl["cost"]["rungs"] == {
            "fast": pytest.approx(tl["cost"]["device_ms"])}
        http_post(base, "/predict", {"instances": test.features[:1].tolist(),
                                     "class": "batchjob"},
                  {"x-knn-class": "ignored"})
        http_post(base, "/predict", {"instances": test.features[:1].tolist(),
                                     "class": None},
                  {"x-knn-class": "nullfallback"})
        classes = app.accounting.export()["classes"]
        assert {"bulk", "batchjob", "nullfallback"} <= set(classes)
        assert "ignored" not in classes

    def test_off_reports_null_and_skips_class_parsing(self, rng, obs_on):
        import json

        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, test, _, _ = problem(rng)
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=(1,), max_batch=8, max_wait_ms=1.0)
        try:
            assert s.app.accounting is None and s.app.capacity is None
            st, _ = http_post(s.base, "/predict",
                              {"instances": test.features[:1].tolist()},
                              {"x-knn-class": "NOT VALID"})
            assert st == 200
            doc = json.loads(http_get(s.base, "/debug/capacity")[1])
            assert doc["enabled"] is False and doc["cost"] is None
            assert json.loads(http_get(s.base, "/healthz")[1])[
                "capacity"] is None
        finally:
            s.close()
