"""Self-healing serving on the port (the twin of
``tests/test_serve_resilience.py``), on the CPU, against the JAX package.

What carries over unchanged: the circuit breaker (window, thresholds,
environment knobs, half-open probes, metrics), the OOM ``max_batch``
halving, the supervisor, shutdown under load, hot reload and drain.

Where the two must differ, and each test shows it by running both: the
serving ladder stops at the card. JAX's batcher answers a failing fast
rung from ``xla`` or ``oracle``; the port has no such rung — a persistent
typed failure fails the batch's requests with their typed error (HTTP
500, as JAX gives an exhausted ladder), ``knn_serve_fallback_total``
never records a move to another rung, and an open breaker fails batches
at once instead of short-circuiting to a lower rung. A transient failure
is retried in place, and a deadline that passes during the retry ends
the request with ``DeadlineExceededError``.

Tolerances: predictions exact (integer grids).
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.models import knn as jknn  # noqa: E402
from knn_tpu.resilience import errors as jerrors  # noqa: E402
from knn_tpu.resilience import faults as jfaults  # noqa: E402
from knn_tpu.resilience.breaker import CircuitBreaker as JBreaker  # noqa: E402
from knn_tpu.serve.batcher import MicroBatcher as JMicroBatcher  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor  # noqa: E402
from knn_tpu_torch.resilience import faults  # noqa: E402
from knn_tpu_torch.resilience.breaker import CircuitBreaker  # noqa: E402
from knn_tpu_torch.resilience.errors import (  # noqa: E402
    DeadlineExceededError,
    DeviceError,
    OverloadError,
)
from knn_tpu_torch.serve import artifact  # noqa: E402
from knn_tpu_torch.serve import batcher as batcher_mod  # noqa: E402
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from knn_tpu_torch.serve.server import ServeApp, make_server  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401
from tests.test_torch_serve import (  # noqa: E402,F401
    CPU,
    Served,
    http_get,
    http_post,
    obs_on,
    problem,
)


def moves(registry):
    """``knn_serve_fallback_total`` entries as (from, to, reason)."""
    return sorted((dict(i.labels)["from_rung"], dict(i.labels)["to"],
                   dict(i.labels)["reason"]) for i in registry.instruments()
                  if i.name == "knn_serve_fallback_total")


class TestCircuitBreaker:
    """The port's copy against JAX's: the same call sequence gives the
    same states, counts and metrics."""

    def both(self, **kw):
        return CircuitBreaker("t", **kw), JBreaker("t", **kw)

    def test_trips_open_at_threshold(self):
        for b in self.both(window=4, threshold=2, cooldown_ms=10_000,
                           probe_successes=1):
            assert b.decide() == "closed"
            b.record_failure()
            assert b.state == "closed"
            b.record_failure()
            assert b.state == "open"
            assert b.decide() == "open"
            assert b.short_circuits == 1

    def test_window_slides_failures_out(self):
        for b in self.both(window=3, threshold=2, cooldown_ms=10_000):
            b.record_failure()
            for _ in range(3):
                b.record_success()
            b.record_failure()
            assert b.state == "closed"

    def test_half_open_probe_recloses_after_successes(self):
        for b in self.both(window=4, threshold=1, cooldown_ms=1,
                           probe_successes=2):
            b.record_failure()
            assert b.state == "open"
            time.sleep(0.005)
            assert b.decide() == "probe"
            b.record_success()
            assert b.state == "half-open"
            assert b.decide() == "probe"
            b.record_success()
            assert b.state == "closed"

    def test_failed_probe_reopens(self):
        for b in self.both(window=4, threshold=1, cooldown_ms=1,
                           probe_successes=1):
            b.record_failure()
            time.sleep(0.005)
            assert b.decide() == "probe"
            b.record_failure()
            assert b.state == "open"
            assert b.decide() == "open"

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("KNN_TPU_BREAKER_WINDOW", "7")
        monkeypatch.setenv("KNN_TPU_BREAKER_THRESHOLD", "3")
        monkeypatch.setenv("KNN_TPU_BREAKER_COOLDOWN_MS", "123")
        monkeypatch.setenv("KNN_TPU_BREAKER_PROBES", "4")
        for b in (CircuitBreaker("env"), JBreaker("env")):
            assert (b.window, b.threshold, b.cooldown_ms,
                    b.probe_successes) == (7, 3, 123.0, 4)

    def test_bad_config_rejected(self):
        with pytest.raises(ValueError, match="threshold"):
            CircuitBreaker("t", window=2, threshold=5)

    def test_transition_metrics_match_jax(self, obs_on):
        jobs.enable()
        jobs.reset()
        for b in self.both(window=2, threshold=1, cooldown_ms=10_000):
            b.record_failure()
            b.decide()
        for reg in (obs_on, jobs.registry()):
            assert reg.counter(
                "knn_breaker_transitions_total", breaker="t",
                from_state="closed", to_state="open").value == 1
            assert reg.gauge("knn_breaker_state", breaker="t").value == 1
            assert reg.counter("knn_breaker_short_circuits_total",
                               breaker="t").value == 1


class TestServingLadder:
    def test_card_failure_is_typed_where_jax_degrades(self, rng, obs_on,
                                                      monkeypatch):
        """A persistent failure of the fast rung: JAX answers from its
        oracle rung; the port fails the request typed and moves nowhere."""
        train, test, jtrain, jtest = problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        jmodel = jknn.KNNClassifier(k=3, engine="xla").fit(jtrain)
        want = jmodel.predict(jtest)

        def boom(ds):
            raise DeviceError("dead device", transient=False)

        def jboom(ds):
            raise jerrors.DeviceError("dead device")

        jobs.enable()
        jobs.reset()
        with JMicroBatcher(jmodel, max_batch=64, max_wait_ms=1.0) as jb:
            monkeypatch.setattr(jmodel, "kneighbors", jboom)
            jh = jb.submit(jtest.features)
            np.testing.assert_array_equal(jh.result(timeout=60), want)
        assert jh.meta["rung"] == "oracle"
        with MicroBatcher(model, max_batch=64, max_wait_ms=1.0) as b:
            monkeypatch.setattr(model, "kneighbors", boom)
            h = b.submit(test.features)
            with pytest.raises(DeviceError, match="dead device"):
                h.result(timeout=60)
        assert "rung" not in h.meta
        assert moves(obs_on) == []
        assert obs_on.counter("knn_serve_errors_total",
                              type="DeviceError").value == 1

    def test_http_status_of_a_card_failure_is_jax_exhausted_ladders(
            self, rng, obs_on):
        """Every rung failing in JAX and the one rung failing in the port
        give the same HTTP answer: 500 with the typed error's name."""
        from knn_tpu.serve.server import ServeApp as JServeApp
        from knn_tpu.serve.server import make_server as jmake_server

        train, test, jtrain, _ = problem(rng)
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=(1,), max_wait_ms=1.0)
        js = Served(JServeApp, jmake_server,
                    jknn.KNNClassifier(k=3, engine="xla").fit(jtrain),
                    warm=(1,), max_wait_ms=1.0)
        try:
            def boom(*a, **kw):
                raise DeviceError("dead device", transient=False)

            def jboom(*a, **kw):
                raise jerrors.DeviceError("dead device")

            s.app.model.kneighbors = boom
            js.app.model.kneighbors = jboom
            import knn_tpu.backends.oracle as joracle
            import knn_tpu.serve.batcher as jbatcher_mod

            saved = (jbatcher_mod._kneighbors_arrays,
                     joracle.oracle_kneighbors)
            jbatcher_mod._kneighbors_arrays = jboom
            joracle.oracle_kneighbors = jboom
            try:
                row = {"instances": [test.features[0].tolist()]}
                st, body = http_post(s.base, "/predict", row)
                jst, jbody = http_post(js.base, "/predict", row)
            finally:
                jbatcher_mod._kneighbors_arrays, \
                    joracle.oracle_kneighbors = saved
            assert st == jst == 500
            assert body["error"].startswith("DeviceError: dead device")
            assert jbody["error"].startswith("DeviceError: dead device")
        finally:
            s.close()
            js.close()

    @pytest.mark.parametrize("engine", ["auto", "xla"])
    def test_injected_oom_halves_max_batch_in_place(self, rng, obs_on,
                                                    engine):
        """As in JAX: the OOM halves ``max_batch`` and the same rung reruns
        (the kernel route at engine auto, the torch scan at xla)."""
        train, test, jtrain, jtest = problem(rng)
        model = KNNClassifier(k=3, engine=engine, **CPU).fit(train)
        want = model.predict(test)
        with MicroBatcher(model, max_batch=8, max_wait_ms=1.0,
                          buckets=(4, 8)) as b:
            with faults.inject("serve.dispatch=once:oom"):
                h = b.submit(test.features[:8])
                got = h.result(timeout=60)
            assert b.max_batch == 4
            assert h.meta["rung"] == "fast"
        np.testing.assert_array_equal(got, want[:8])
        jmodel = jknn.KNNClassifier(k=3, engine="xla").fit(jtrain)
        with JMicroBatcher(jmodel, max_batch=8, max_wait_ms=1.0) as jb:
            with jfaults.inject("serve.dispatch=once:oom"):
                jgot = jb.predict(jtest.features[:8], timeout=60)
            assert jb.max_batch == 4
        np.testing.assert_array_equal(got, jgot)
        assert moves(obs_on) == [("fast", "fast", "oom_halve_batch")]

    def test_transient_failure_retried_in_place(self, rng, obs_on):
        """A transient fault at the dispatch is retried on the same rung
        (JAX moves to its xla rung for it); one retry, no move."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.predict(test)
        with MicroBatcher(model, max_batch=64, max_wait_ms=1.0) as b:
            with faults.inject("serve.dispatch=once") as plan:
                h = b.submit(test.features)
                np.testing.assert_array_equal(h.result(timeout=60), want)
        assert plan.stats()["serve.dispatch"]["fired"] == 1
        assert h.meta["rung"] == "fast"
        assert obs_on.counter("knn_retry_total",
                              site="serve.dispatch").value == 1
        assert moves(obs_on) == []

    def test_breaker_opens_fails_at_once_and_recloses(self, rng, obs_on,
                                                      monkeypatch):
        """The self-healing cycle without a lower rung: sustained faults
        trip the breaker open, after which batches fail typed WITHOUT a
        dispatch; once the faults clear and the cooldown passes, a
        half-open probe answers and re-closes it. JAX's same cycle answers
        every request (degraded)."""
        monkeypatch.setenv("KNN_TPU_BREAKER_WINDOW", "4")
        monkeypatch.setenv("KNN_TPU_BREAKER_THRESHOLD", "2")
        monkeypatch.setenv("KNN_TPU_BREAKER_COOLDOWN_MS", "250")
        monkeypatch.setenv("KNN_TPU_BREAKER_PROBES", "1")
        train, test, jtrain, jtest = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.predict(test)
        calls = []
        real = batcher_mod.MicroBatcher._call_rung

        def counting(self, fn, feats, prefetched=None):
            calls.append(len(feats))
            return real(self, fn, feats, prefetched)

        monkeypatch.setattr(batcher_mod.MicroBatcher, "_call_rung", counting)
        b = MicroBatcher(model, max_batch=4, max_wait_ms=0.5)
        try:
            with faults.inject("serve.dispatch=always"):
                for i in range(6):
                    with pytest.raises(DeviceError):
                        b.predict(test.features[i], timeout=60)
                assert b.breaker.state == "open"
                assert b.breaker.short_circuits >= 1
                with pytest.raises(DeviceError, match="breaker"):
                    b.predict(test.features[0], timeout=60)
            assert calls == []  # the fault point fired before any dispatch
            time.sleep(0.3)
            h = b.submit(test.features[0])
            np.testing.assert_array_equal(h.result(timeout=60), want[0])
            assert b.breaker.state == "closed" and h.meta["rung"] == "fast"
        finally:
            b.close()
        assert obs_on.counter(
            "knn_breaker_transitions_total", breaker="serve.dispatch",
            from_state="half-open", to_state="closed").value >= 1
        assert moves(obs_on) == []
        jmodel = jknn.KNNClassifier(k=3, engine="xla").fit(jtrain)
        jb = JMicroBatcher(jmodel, max_batch=4, max_wait_ms=0.5)
        try:
            with jfaults.inject("serve.dispatch=always"):
                for i in range(4):
                    np.testing.assert_array_equal(
                        jb.predict(jtest.features[i], timeout=60), want[i])
            assert jb.breaker.state == "open"
        finally:
            jb.close()

    def test_deadline_expires_mid_retry(self, rng, obs_on, monkeypatch):
        """A request whose deadline passes while its dispatch is retried
        gets its 504; a deadline-free request of the same batch gets the
        retried answer (JAX: the same split, across its fallback)."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.predict(test)
        real = model.kneighbors
        state = {"n": 0}

        def slow_once(ds):
            state["n"] += 1
            if state["n"] == 1:
                time.sleep(0.4)
                raise DeviceError("slow transient failure", transient=True)
            return real(ds)

        b = MicroBatcher(model, max_batch=64, max_wait_ms=50.0)
        try:
            monkeypatch.setattr(model, "kneighbors", slow_once)
            ha = b.submit(test.features[0], deadline_ms=200)
            hb = b.submit(test.features[1])
            with pytest.raises(DeadlineExceededError, match="retried"):
                ha.result(timeout=60)
            np.testing.assert_array_equal(hb.result(timeout=60), want[1])
            assert hb.meta["rung"] == "fast"
        finally:
            monkeypatch.undo()
            b.close()
        assert obs_on.counter("knn_serve_deadline_expired_total").value == 1

    def test_supervisor_restarts_dead_worker(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.predict(test)
        b = MicroBatcher(model, max_batch=8, max_wait_ms=1.0)
        try:
            orig = b._collect
            died = {"n": 0}

            def dying_collect():
                if died["n"] == 0:
                    died["n"] = 1
                    raise RuntimeError("synthetic worker death")
                return orig()

            b._collect = dying_collect
            np.testing.assert_array_equal(
                b.predict(test.features[0], timeout=60), want[0])
            deadline = time.monotonic() + 10
            while b.restarts == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert b.restarts == 1
            np.testing.assert_array_equal(
                b.predict(test.features[1], timeout=60), want[1])
        finally:
            b.close()
        assert obs_on.counter("knn_serve_worker_restarts_total").value == 1


class TestShutdownUnderLoad:
    def test_close_under_load_leaves_typed_outcomes(self, rng, monkeypatch):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        real = model.kneighbors

        def slow(ds):
            time.sleep(0.1)
            return real(ds)

        monkeypatch.setattr(model, "kneighbors", slow)
        b = MicroBatcher(model, max_batch=1, max_wait_ms=0.0)
        handles = [b.submit(test.features[i]) for i in range(8)]
        time.sleep(0.05)
        b.close(timeout=0.25)
        served, failed = 0, 0
        for h in handles:
            try:
                assert h.result(timeout=5) is not None
                served += 1
            except OverloadError:
                failed += 1
            except DeadlineExceededError as e:
                assert "not served within" not in str(e)
                failed += 1
        assert served + failed == 8 and failed > 0


@pytest.fixture
def two_indexes(rng, tmp_path):
    train, test, _, _ = problem(rng)
    idx_a = artifact.save_index(
        KNNClassifier(k=1, **CPU).fit(train), tmp_path / "a")
    idx_b = artifact.save_index(
        KNNClassifier(k=5, **CPU).fit(train), tmp_path / "b")
    return train, test, idx_a, idx_b


@pytest.fixture
def reload_server(two_indexes, obs_on):
    train, test, idx_a, idx_b = two_indexes
    model = artifact.load_index(idx_a, device="cpu")
    version = artifact.index_version(artifact.read_manifest(idx_a))
    s = Served(ServeApp, make_server, model, max_batch=16, max_wait_ms=1.0,
               index_path=str(idx_a), index_version=version,
               batch_buckets=(16,), cost_accounting=True, device="cpu")
    try:
        yield s.base, s.app, test, idx_a, idx_b, version
    finally:
        s.close()


def _want(idx, test):
    return artifact.load_index(idx, device="cpu").predict(test).tolist()


class TestHotReload:
    def test_reload_swaps_version_atomically(self, reload_server):
        base, app, test, idx_a, idx_b, va = reload_server
        want_b = _want(idx_b, test)
        st, body = http_post(base, "/admin/reload", {"index": str(idx_b)})
        assert st == 200, body
        vb = body["index_version"]
        assert vb != va and body["previous_version"] == va
        assert body["warmup_ms"]
        assert json.loads(http_get(base, "/healthz")[1])["index_version"] \
            == vb
        st, body = http_post(base, "/predict",
                             {"instances": test.features.tolist()})
        assert st == 200 and body["index_version"] == vb
        assert body["predictions"] == want_b
        assert app.model.device == "cpu"

    def test_corrupt_replacement_rolls_back(self, reload_server):
        base, app, test, idx_a, idx_b, va = reload_server
        want_a = _want(idx_a, test)
        (idx_b / "arrays.npz").write_bytes(b"not a zip archive")
        st, body = http_post(base, "/admin/reload", {"index": str(idx_b)})
        assert st == 400 and body["rolled_back"] is True
        assert body["index_version"] == va
        st, body = http_post(base, "/predict",
                             {"instances": test.features.tolist()})
        assert body["index_version"] == va
        assert body["predictions"] == want_a

    def test_unservable_replacement_rolls_back(self, reload_server):
        """A replacement that carries the mutable tier's parts (an epoch
        log, a generation's ``mutable`` block) is an ordinary artifact to
        a ``--mutable off`` reload, as in JAX: it swaps in and serves."""
        base, app, test, idx_a, idx_b, va = reload_server
        want_b = _want(idx_b, test)
        (idx_b / "epochs").mkdir()
        st, body = http_post(base, "/admin/reload", {"index": str(idx_b)})
        assert st == 200 and body["previous_version"] == va
        vb = body["index_version"]
        st, body = http_post(base, "/predict",
                             {"instances": test.features.tolist()})
        assert body["index_version"] == vb and app.index_version == vb
        assert body["predictions"] == want_b

    def test_family_change_rejected(self, reload_server, rng, tmp_path):
        base, app, test, idx_a, idx_b, va = reload_server
        train, _, _, _ = problem(rng)
        reg_idx = artifact.save_index(
            KNNRegressor(k=3, **CPU).fit(train), tmp_path / "reg")
        st, body = http_post(base, "/admin/reload", {"index": str(reg_idx)})
        assert st == 400 and "family" in body["error"]
        assert app.index_version == va

    def test_reload_under_load_never_serves_a_mix(self, reload_server):
        base, app, test, idx_a, idx_b, va = reload_server
        want_a, want_b = _want(idx_a, test), _want(idx_b, test)
        assert want_a != want_b
        rows = test.features.tolist()
        results, errors = [], []
        stop = threading.Event()

        def client():
            while not stop.is_set():
                st, body = http_post(base, "/predict", {"instances": rows})
                if st != 200:
                    errors.append((st, body))
                else:
                    results.append((body["index_version"],
                                    body["predictions"]))

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        st, body = http_post(base, "/admin/reload", {"index": str(idx_b)})
        vb = body["index_version"]
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert st == 200 and not errors, errors[:3]
        seen = set()
        for version, preds in results:
            assert preds == (want_a if version == va else want_b)
            assert version in (va, vb)
            seen.add(version)
        assert va in seen

    def test_reload_warms_and_seeds_off_the_served_model(
            self, reload_server, monkeypatch):
        """The reload thread warms the replacement and seeds the capacity
        model from it BEFORE the swap; it never runs the model the worker
        is serving."""
        base, app, test, idx_a, idx_b, va = reload_server
        served = app.model
        touched = []
        monkeypatch.setattr(served, "kneighbors",
                            lambda ds: touched.append(1) or (_ for _ in
                                                             ()).throw(
                                AssertionError("served model touched")))
        seeded = []
        real = app._seed_capacity_model
        monkeypatch.setattr(app, "_seed_capacity_model",
                            lambda m: seeded.append(m) or real(m))
        result = app.reload(str(idx_b))
        assert result["index_version"] != va
        assert seeded and seeded[0] is app.model and seeded[0] is not served
        assert touched == []

    def test_concurrent_reload_conflicts_409(self, reload_server,
                                             monkeypatch):
        base, app, test, idx_a, idx_b, va = reload_server
        release = threading.Event()
        real_warm = artifact.warmup

        def slow_warm(*a, **kw):
            release.wait(10)
            return real_warm(*a, **kw)

        monkeypatch.setattr(artifact, "warmup", slow_warm)
        first = {}
        t = threading.Thread(target=lambda: first.update(
            resp=http_post(base, "/admin/reload", {"index": str(idx_b)})))
        t.start()
        deadline = time.monotonic() + 10
        while (not app._reload_lock.locked()
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert app._reload_lock.locked()
        st, body = http_post(base, "/admin/reload", {"index": str(idx_b)})
        release.set()
        t.join(timeout=30)
        assert st == 409, body
        assert first["resp"][0] == 200

    def test_swap_replaces_the_stager(self, rng):
        """The stager belongs to the served model: after a swap the worker
        makes a new one, so the old model's pinned buffers go with it."""
        train, test, _, _ = problem(rng)
        a = KNNClassifier(k=3, **CPU).fit(train)
        b2 = KNNClassifier(k=5, **CPU).fit(train)
        with MicroBatcher(a, max_batch=8, buckets=(8,)) as b:
            b.predict(test.features[:2], timeout=60)
            first = b._stager
            assert first is not None and first.model is a
            b.swap_model(b2, "v2")
            np.testing.assert_array_equal(b.predict(test.features[:2], 60),
                                          b2.predict(Dataset(
                                              test.features[:2],
                                              np.zeros(2, np.int32))))
            assert b._stager is not first and b._stager.model is b2


class TestDrain:
    def test_drain_flips_health_refuses_and_answers(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=(1,), max_batch=64, max_wait_ms=2000.0)
        try:
            parked = {}
            t = threading.Thread(target=lambda: parked.update(
                resp=http_post(s.base, "/predict",
                               {"instances": [test.features[0].tolist()]})))
            t.start()
            deadline = time.monotonic() + 10
            while (s.app.batcher.pending_rows() == 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert s.app.batcher.pending_rows() > 0
            summary = {}
            dt = threading.Thread(
                target=lambda: summary.update(s.app.drain(10.0)))
            dt.start()
            deadline = time.monotonic() + 10
            while not s.app.draining and time.monotonic() < deadline:
                time.sleep(0.01)
            st, h, _ = http_get(s.base, "/healthz")
            assert st == 503 and json.loads(h)["draining"] is True
            st, body = http_post(s.base, "/predict", {
                "instances": [test.features[1].tolist()]})
            assert st == 503 and "draining" in body["error"]
            dt.join(timeout=30)
            t.join(timeout=30)
            assert parked["resp"][0] == 200
            assert summary["drained_clean"] is True
        finally:
            s.close()

    def test_expired_drain_fails_remainders_typed(self, rng, obs_on,
                                                  monkeypatch):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        real = model.kneighbors

        def slow(ds):
            time.sleep(0.5)
            return real(ds)

        monkeypatch.setattr(model, "kneighbors", slow)
        app = ServeApp(model, max_batch=1, max_wait_ms=0.0)
        handles = [app.batcher.submit(test.features[i]) for i in range(6)]
        summary = app.drain(timeout_s=0.2)
        assert summary["expired"] > 0
        for h in handles:
            try:
                assert h.result(timeout=5) is not None
            except DeadlineExceededError as e:
                assert "not served within" not in str(e)
                assert "drained" in str(e)
        time.sleep(0.7)
        assert app.batcher.restarts == 0
        app.close()
