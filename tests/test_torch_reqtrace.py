"""Request tracing, exemplars and SLOs on the port (the twin of
``tests/test_reqtrace.py``), on the CPU.

The port keeps its own copies of ``obs/reqtrace.py``, ``obs/slo.py`` and
the exemplar half of ``obs/metrics.py``. The unit cases run the same
sequence on the port's module and on the JAX package's
(``pkg`` parametrizes both), so the copies cannot drift apart. The
batcher and HTTP cases hold the port's serving weave: every response's
request id resolves to one closed timeline (under a fault burst that the
port retries in place), ``x-request-id`` is echoed on every response,
``/debug`` endpoints, the access log and the ``/healthz`` SLO block.
Also here: a host-rung move of the classify ladder lands in the active
request contexts, in both packages (``degrade._record_fallback``'s
``reqtrace.emit``).

Tolerances: exact (integer counts and the JAX package's float math on
the same inputs).
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.obs import metrics as jmetrics  # noqa: E402
from knn_tpu.obs import reqtrace as jreqtrace  # noqa: E402
from knn_tpu.obs import slo as jslo  # noqa: E402
from knn_tpu.resilience import degrade as jdegrade  # noqa: E402
from knn_tpu.resilience import faults as jfaults  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier  # noqa: E402
from knn_tpu_torch.obs import metrics, reqtrace, slo  # noqa: E402
from knn_tpu_torch.obs.reqtrace import FlightRecorder  # noqa: E402
from knn_tpu_torch.resilience import degrade, faults  # noqa: E402
from knn_tpu_torch.resilience.errors import (  # noqa: E402
    DeadlineExceededError,
    DeviceError,
    OverloadError,
)
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from tests.test_torch_resilience import global_state, golden  # noqa: E402,F401
from tests.test_torch_serve import (  # noqa: E402,F401
    CPU,
    Served,
    http_get,
    http_post,
    obs_on,
    problem,
)

PACKAGES = {
    "port": (obs, reqtrace, slo, metrics),
    "jax": (jobs, jreqtrace, jslo, jmetrics),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """``(obs, reqtrace, slo, metrics)`` of one package."""
    return PACKAGES[request.param]


class TestRequestIds:
    def test_generated_ids_are_valid_and_distinct(self, pkg):
        rt = pkg[1]
        ids = {rt.gen_request_id() for _ in range(64)}
        assert len(ids) == 64 and all(rt.valid_request_id(i) for i in ids)

    @pytest.mark.parametrize("bad", [
        "", "x" * 129, "has space", "tab\tchar", "new\nline", "unicode-é",
        "ctrl\x01"])
    def test_invalid_ids_rejected(self, pkg, bad):
        assert not pkg[1].valid_request_id(bad)

    def test_boundary_ok(self, pkg):
        rt = pkg[1]
        assert rt.valid_request_id("x" * rt.MAX_REQUEST_ID_LEN)
        assert rt.valid_request_id("a-b_c.d/e:f")


class TestRequestTrace:
    def test_phases_close_and_sum(self, pkg):
        t = pkg[1].RequestTrace("predict", 1)
        for phase in ("queue_wait", "dispatch"):
            t.phase_start(phase)
            t.phase_end(phase)
        t.finish("ok")
        d = t.to_dict()
        assert [p["phase"] for p in d["phases"]] == ["queue_wait", "dispatch"]
        assert sum(p["ms"] for p in d["phases"]) <= d["request_ms"] + 0.001

    def test_finish_closes_open_phases_and_is_idempotent(self, pkg):
        t = pkg[1].RequestTrace("predict", 1)
        t.phase_start("queue_wait")
        t.finish("expired")
        t.finish("ok")
        d = t.to_dict()
        assert d["outcome"] == "expired" and d["phases"][0]["ms"] is not None

    def test_annotations_visible_after_finish(self, pkg):
        rec = pkg[1].FlightRecorder(capacity=2)
        t = rec.new_trace("predict", 1, request_id="late-note")
        t.finish("ok")
        t.annotate(status=200)
        assert rec.find("late-note")["status"] == 200

    def test_to_dict_is_a_snapshot(self, pkg):
        t = pkg[1].RequestTrace("predict", 1)
        t.phase_start("queue_wait")
        t.finish("ok")
        d = t.to_dict()
        d["outcome"] = "tampered"
        assert t.to_dict()["outcome"] == "ok"

    def test_same_timeline_keys_as_jax(self):
        def run(rt):
            rec = rt.FlightRecorder(capacity=4)
            t = rec.new_trace("kneighbors", 3, request_id="same")
            t.phase_start("queue_wait")
            t.phase_end("queue_wait")
            t.attempt("fast", False, 0.5, error="DeviceError")
            t.event("fallback", from_rung="fast", to="fast")
            t.annotate(rung="fast", batch_requests=2)
            t.finish("ok")
            return rec.find("same")

        a, b = run(reqtrace), run(jreqtrace)
        assert set(a) == set(b)
        assert a["attempts"][0].keys() == b["attempts"][0].keys()
        assert a["events"][0]["event"] == b["events"][0]["event"]


class TestFlightRecorder:
    def test_ring_keeps_newest_n(self, pkg):
        rec = pkg[1].FlightRecorder(capacity=4, slowest_k=0)
        for i in range(10):
            rec.new_trace("predict", 1, request_id=f"r{i}").finish("ok")
        assert [tl["request_id"] for tl in rec.recent()] == \
            ["r9", "r8", "r7", "r6"]
        assert rec.stats()["completed"] == 10

    def test_slowest_reservoir(self, pkg):
        rt = pkg[1]
        rec = rt.FlightRecorder(capacity=2, slowest_k=3)
        for i, ms in enumerate([5.0, 50.0, 1.0, 30.0, 2.0, 40.0]):
            t = rt.RequestTrace("predict", 1, request_id=f"s{i}",
                                recorder=None)
            t.outcome = "ok"
            t.request_ms = ms
            rec.record(t)
        assert [tl["request_id"] for tl in rec.slowest()] == \
            ["s1", "s5", "s3"]
        assert rec.find("s1")["request_ms"] == 50.0

    def test_perfetto_export_balanced(self, pkg):
        rec = pkg[1].FlightRecorder(capacity=8)
        for i in range(3):
            t = rec.new_trace("predict", 1, request_id=f"p{i}")
            t.phase_start("queue_wait")
            t.phase_end("queue_wait")
            t.phase_start("dispatch")
            t.attempt("fast", False, 0.5, error="DeviceError")
            t.attempt("fast", True, 0.4)
            t.finish("ok")
        ev = rec.to_chrome_trace()["traceEvents"]
        assert sum(e["ph"] == "B" for e in ev) == sum(e["ph"] == "E"
                                                      for e in ev)
        assert len({e["tid"] for e in ev if e["ph"] == "M"}) == 3

    def test_bounds_validated(self, pkg):
        with pytest.raises(ValueError, match="capacity"):
            pkg[1].FlightRecorder(capacity=0)
        with pytest.raises(ValueError, match="slowest_k"):
            pkg[1].FlightRecorder(capacity=1, slowest_k=-1)


class TestActiveContext:
    def test_emit_lands_in_all_armed_traces(self, pkg):
        rt = pkg[1]
        a, b = rt.RequestTrace("predict", 1), rt.RequestTrace("predict", 1)
        rt.emit("nothing", x=1)  # unarmed: a no-op
        with rt.activate([a, b]):
            rt.emit("breaker.transition", to_state="open")
        rt.emit("after", x=1)
        for t in (a, b):
            assert [e["event"] for e in t.to_dict()["events"]] == \
                ["breaker.transition"]

    def test_in_place_list_update_and_nesting(self, pkg):
        rt = pkg[1]
        a, b = rt.RequestTrace("predict", 1), rt.RequestTrace("predict", 1)
        armed = [a, b]
        with rt.activate(armed):
            armed[:] = [a]
            rt.emit("fallback")
            with rt.activate([b]):
                rt.emit("inner")
        assert [e["event"] for e in a.to_dict()["events"]] == ["fallback"]
        assert [e["event"] for e in b.to_dict()["events"]] == ["inner"]

    def test_host_rung_move_in_classify_emits_fallback(self, golden):
        """``degrade._record_fallback`` lands in the active request
        contexts: the same events in both packages for the same ladder
        walk (``native-mt -> native -> oracle``)."""
        train, test, jtrain, jtest, want = golden
        events = {}
        for name, deg, flt, rt, tr, te in (
                ("port", degrade, faults, reqtrace, train, test),
                ("jax", jdegrade, jfaults, jreqtrace, jtrain, jtest)):
            t = rt.RequestTrace("predict", test.num_instances)
            with flt.inject("native.load=always"), rt.activate([t]):
                res = deg.predict_with_ladder("native-mt", tr, te, 3)
            np.testing.assert_array_equal(res.predictions, want)
            events[name] = [(e["event"], e["from_backend"], e["to"],
                             e["reason"]) for e in t.to_dict()["events"]]
        assert events["port"] == events["jax"]
        assert [e[1:3] for e in events["port"]] == [
            ("native-mt", "native"), ("native", "oracle")]


class TestExemplars:
    def test_last_exemplar_wins_per_bucket(self, pkg):
        h = pkg[3].MetricsRegistry().histogram("lat_ms", buckets=(1.0, 10.0))
        h.observe(0.5, exemplar={"trace_id": "first"})
        h.observe(0.7, exemplar={"trace_id": "second"})
        h.observe(5.0)
        ex = h.exemplars()
        assert ex[0][0] == (("trace_id", "second"),) and ex[1] is None

    def test_openmetrics_text_equals_jax(self):
        """The same observations give the same OpenMetrics document, the
        exemplars' timestamps aside."""
        docs = []
        for m in (metrics, jmetrics):
            reg = m.MetricsRegistry()
            reg.counter("reqs_total", help="requests").add(3)
            reg.gauge("temp").set(1.5)
            h = reg.histogram("lat_ms", buckets=(1.0, 5.0), help="latency")
            h.observe(0.5, exemplar={"trace_id": "t1"})
            h.observe(7.0)
            docs.append([ln.rsplit(" ", 1)[0] if "# {" in ln else ln
                         for ln in reg.to_openmetrics().splitlines()])
        assert docs[0] == docs[1]
        assert docs[0][-1] == "# EOF"
        assert "# TYPE reqs counter" in docs[0]

    def test_prometheus_exposition_has_no_exemplars(self, pkg):
        reg = pkg[3].MetricsRegistry()
        reg.histogram("lat_ms", buckets=(1.0,)).observe(
            0.5, exemplar={"trace_id": "t1"})
        prom = reg.to_prometheus()
        assert "# {" not in prom and 'lat_ms_bucket{le="1"} 1' in prom

    def test_merge_counts(self, pkg):
        reg = pkg[3].MetricsRegistry()
        h = reg.histogram("m", buckets=(1.0, 2.0))
        h.merge_counts([1, 2, 3], 10.0, 6)
        assert h.bucket_counts() == [1, 2, 3] and h.count == 6
        with pytest.raises(ValueError, match="merge"):
            h.merge_counts([1], 1.0, 1)

    def test_helper_routes_exemplar(self, obs_on):
        obs.histogram_observe("x_ms", 0.5, buckets=(1.0,),
                              exemplar={"trace_id": "via-helper"})
        assert 'trace_id="via-helper"' in obs_on.to_openmetrics()


class TestSLOTracker:
    def test_burn_math_equals_jax(self):
        burns = []
        for m in (slo, jslo):
            s = m.SLOTracker(availability_target=0.99, latency_target_ms=10.0,
                             latency_target=0.9, fast_rung_target=0.9,
                             windows_s=(60,))
            for i in range(9):
                s.record(True, 1.0 + 5 * i, degraded=i == 3)
            s.record(False, 1.0)
            burns.append(s.burn_rates())
        assert burns[0] == burns[1]
        assert burns[0]["availability"]["1m"] == pytest.approx(10.0)

    def test_ring_rotation_expires_old_outcomes(self, pkg, monkeypatch):
        m = pkg[2]
        clock = [1000.0]
        monkeypatch.setattr(m.time, "monotonic", lambda: clock[0])
        s = m.SLOTracker(windows_s=(2, 5))
        s.record(False, 1.0)
        assert s.burn_rates()["availability"]["2s"] > 0
        clock[0] += 3
        burns = s.burn_rates()
        assert burns["availability"]["2s"] == 0.0
        assert burns["availability"]["5s"] > 0

    def test_long_windows_bounded_ring(self, pkg):
        month = 30 * 24 * 3600
        s = pkg[2].SLOTracker(windows_s=(3600, month))
        assert len(s._ring) <= 3600
        assert pkg[2].SLOTracker().slot_s == 1

    def test_validation(self, pkg):
        with pytest.raises(ValueError, match="availability_target"):
            pkg[2].SLOTracker(availability_target=1.0)
        with pytest.raises(ValueError, match="windows_s"):
            pkg[2].SLOTracker(windows_s=())

    def test_export_sets_gauges(self, obs_on):
        s = slo.SLOTracker(windows_s=(300, 3600))
        s.record(True, 1.0)
        assert s.export()["windows"] == ["5m", "1h"]
        prom = obs_on.to_prometheus()
        assert ('knn_slo_burn_rate{objective="availability",window="5m"}'
                in prom)
        assert slo.window_label(3600) == "1h"


class TestBatcherTracePropagation:
    def _check_timeline(self, tl):
        assert tl["outcome"] is not None
        assert not [p for p in tl["phases"] if p["ms"] is None]
        assert sum(p["ms"] for p in tl["phases"]) <= \
            tl["request_ms"] * 1.05 + 2.0, tl
        if tl["outcome"] == "ok":
            assert tl["rung"] == "fast"
            assert tl["phases"][-1]["phase"] == "dispatch"

    def test_concurrent_mixed_load_every_id_resolves(self, rng, obs_on):
        """Under a seeded fault burst at the dispatch (retried in place on
        the card's rung, never moved), every request id maps to one closed
        timeline, and the retried ones show their failed attempt."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        rec = FlightRecorder(capacity=4096, slowest_k=8)
        results, lock = {}, threading.Lock()

        def client(cid):
            mine = {}
            for i in range(12):
                kind = "predict" if (cid + i) % 2 == 0 else "kneighbors"
                lo = (cid * 12 + i) % (test.num_instances - 3)
                rows = test.features[lo:lo + 1 + (i % 3)]
                trace = rec.new_trace(kind, rows.shape[0])
                try:
                    batcher.submit(rows, kind, trace=trace).result(timeout=60)
                    mine[trace.request_id] = "ok"
                except Exception as e:  # noqa: BLE001 — recorded
                    mine[trace.request_id] = type(e).__name__
            with lock:
                results.update(mine)

        with MicroBatcher(model, max_batch=8, max_wait_ms=1.0, recorder=rec,
                          buckets=(4, 8)) as batcher:
            with faults.inject("serve.dispatch=2:device", seed=11):
                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(6)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
        assert len(results) == 72
        timelines = {tl["request_id"]: tl for tl in rec.recent()}
        assert len(timelines) == len(results)
        retried = 0
        for rid, outcome in results.items():
            tl = timelines[rid]
            self._check_timeline(tl)
            assert outcome == "ok" == tl["outcome"]
            assert {a["rung"] for a in tl["attempts"]} == {"fast"}
            retried += any(not a["ok"] for a in tl["attempts"])
        assert retried > 0, "the fault burst never failed an attempt"

    def test_expired_in_queue_timeline(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        rec = FlightRecorder(capacity=64)
        with MicroBatcher(model, max_batch=64, max_wait_ms=2000.0,
                          recorder=rec) as batcher:
            h = batcher.submit(test.features[:1], "predict", deadline_ms=20)
            with pytest.raises(DeadlineExceededError):
                h.result(timeout=30)
            rid = h.meta["request_id"]
            deadline = time.monotonic() + 10
            while rec.find(rid) is None and time.monotonic() < deadline:
                time.sleep(0.01)
        tl = rec.find(rid)
        assert tl["outcome"] == "expired" and tl["expired_where"] == "queue"
        self._check_timeline(tl)

    def test_expired_mid_retry_timeline(self, rng, obs_on, monkeypatch):
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

        rec = FlightRecorder(capacity=16)
        b = MicroBatcher(model, max_batch=64, max_wait_ms=50.0, recorder=rec)
        try:
            monkeypatch.setattr(model, "kneighbors", slow_once)
            ha = b.submit(test.features[0], deadline_ms=200)
            hb = b.submit(test.features[1])
            with pytest.raises(DeadlineExceededError, match="retried"):
                ha.result(timeout=60)
            hb.result(timeout=60)
        finally:
            monkeypatch.undo()
            b.close()
        expired = rec.find(ha.meta["request_id"])
        assert expired["expired_where"] == "mid-retry"
        assert [(a["rung"], a["ok"]) for a in expired["attempts"]] == \
            [("fast", False)]
        self._check_timeline(expired)
        survivor = rec.find(hb.meta["request_id"])
        assert [(a["rung"], a["ok"]) for a in survivor["attempts"]] == \
            [("fast", False), ("fast", True)]
        self._check_timeline(survivor)

    def test_rejected_submission_resolves_too(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        rec = FlightRecorder(capacity=8)
        with MicroBatcher(model, max_batch=2, max_queue_rows=2,
                          max_wait_ms=2000.0, recorder=rec) as batcher:
            parked = batcher.submit(test.features[:1], "predict")
            with pytest.raises(OverloadError):
                batcher.submit(test.features[1:3], "predict")
            parked.result(timeout=30)
        rejected = [tl for tl in rec.recent() if tl["outcome"] == "rejected"]
        assert len(rejected) == 1 and "OverloadError" in rejected[0]["error"]

    def test_no_recorder_means_no_traces(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        with MicroBatcher(model, max_batch=4, max_wait_ms=0.5) as batcher:
            h = batcher.submit(test.features[:1], "predict")
            h.result(timeout=60)
        assert "request_id" not in h.meta


@pytest.fixture
def served(rng, obs_on, tmp_path):
    from knn_tpu_torch.serve.server import ServeApp, make_server

    train, test, _, _ = problem(rng)
    log_path = tmp_path / "access.log"
    s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
               max_batch=16, max_wait_ms=1.0, access_log=str(log_path),
               slo=slo.SLOTracker(windows_s=(5, 60)))
    try:
        yield s.base, test, s.app, log_path
    finally:
        s.close()


class TestServerWeave:
    def test_request_id_echoed_and_generated(self, served):
        base, test, _, _ = served
        st, body = http_post(base, "/predict",
                             {"instances": test.features[:2].tolist()},
                             {"x-request-id": "caller-1"})
        assert st == 200 and body["request_id"] == "caller-1"
        st, body = http_post(base, "/predict",
                             {"instances": test.features[:1].tolist()})
        assert reqtrace.valid_request_id(body["request_id"])

    def test_request_id_on_error_bodies(self, served):
        base, test, _, _ = served
        st, body = http_post(base, "/predict", {"rows": [[1.0]]},
                             {"x-request-id": "err-1"})
        assert st == 400 and body["request_id"] == "err-1"
        st, body = http_post(base, "/train", {"instances": []},
                             {"x-request-id": "err-2"})
        assert st == 404 and body["request_id"] == "err-2"
        st, raw, hdrs = http_get(base, "/nope", {"x-request-id": "err-3"})
        assert st == 404 and json.loads(raw)["request_id"] == "err-3"
        assert hdrs.get("x-request-id") == "err-3"

    @pytest.mark.parametrize("bad", ["x" * 4096, "has spaces here"])
    def test_malformed_header_is_400(self, served, bad):
        base, test, _, _ = served
        st, body = http_post(base, "/predict",
                             {"instances": test.features[:1].tolist()},
                             {"x-request-id": bad})
        assert st == 400 and "invalid x-request-id" in body["error"]
        assert reqtrace.valid_request_id(body["request_id"])

    def test_debug_endpoints(self, served):
        base, test, _, _ = served
        http_post(base, "/predict", {"instances": test.features[:2].tolist()},
                  {"x-request-id": "dbg-1"})
        tl = json.loads(http_get(base, "/debug/requests?id=dbg-1")[1])[
            "requests"][0]
        assert tl["outcome"] == "ok" and tl["status"] == 200
        assert {"queue_wait", "dispatch"} == {p["phase"]
                                              for p in tl["phases"]}
        assert http_get(base, "/debug/requests?id=missing")[0] == 404
        assert http_get(base, "/debug/requests?format=xml")[0] == 400
        assert http_get(base, "/debug/requests?n=zap")[0] == 400
        ev = json.loads(http_get(base, "/debug/slowest?format=perfetto")[1])[
            "traceEvents"]
        assert sum(e["ph"] == "B" for e in ev) == sum(e["ph"] == "E"
                                                      for e in ev)

    def test_disabled_recorder_is_404(self, rng, obs_on):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, _, _, _ = problem(rng)
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=None, flight_recorder_size=0)
        try:
            st, raw, _ = http_get(s.base, "/debug/requests")
            assert st == 404 and "disabled" in json.loads(raw)["error"]
            assert s.app.batcher.recorder is None
        finally:
            s.close()

    def test_healthz_slo_block(self, served):
        base, test, _, _ = served
        http_post(base, "/predict", {"instances": test.features[:1].tolist()})
        h = json.loads(http_get(base, "/healthz")[1])
        assert set(h["slo"]["burn_rates"]) == {"availability", "latency",
                                               "fast_rung", "quality"}
        assert h["slo"]["burn_rates"]["availability"]["5s"] == 0.0
        assert h["flight_recorder"]["completed"] >= 1

    def test_access_log_one_line_per_terminal_outcome(self, served):
        base, test, app, log_path = served
        http_post(base, "/predict", {"instances": test.features[:2].tolist()},
                  {"x-request-id": "log-ok"})
        http_post(base, "/predict", {"rows": "bad"},
                  {"x-request-id": "log-bad"})
        by_id = {}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            app.access_log._file.flush()
            by_id = {e["request_id"]: e for e in map(
                json.loads, log_path.read_text().splitlines())}
            if {"log-ok", "log-bad"} <= by_id.keys():
                break
            time.sleep(0.01)
        ok = by_id["log-ok"]
        assert (ok["status"], ok["outcome"], ok["rows"], ok["rung"]) == \
            (200, "ok", 2, "fast")
        assert ok["attempts"] == ["fast:ok"] and "queue_wait" in ok["phases"]
        assert (by_id["log-bad"]["status"], by_id["log-bad"]["outcome"]) == \
            (400, "invalid")

    def test_card_failure_spends_availability_and_fast_rung(self, served,
                                                           monkeypatch):
        base, test, app, _ = served

        def boom(ds):
            raise DeviceError("dead", transient=False)

        monkeypatch.setattr(app.model, "kneighbors", boom)
        st, body = http_post(base, "/predict",
                             {"instances": test.features[:1].tolist()})
        assert st == 500
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            burns = app.slo.burn_rates()
            if burns["availability"]["5s"] > 0:
                break
            time.sleep(0.01)
        assert burns["availability"]["5s"] > 0
        assert burns["fast_rung"]["5s"] > 0
