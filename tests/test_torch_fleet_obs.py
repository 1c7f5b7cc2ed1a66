"""The fleet's observability plane on the port (the twin of
``tests/test_fleet_obs.py``, pointed at ``knn_tpu_torch`` with
``device="cpu"``).

The load-bearing claims:

1. **Cross-tier tracing**: the router records its own timeline per
   forwarded request (``route`` + ``dispatch`` phases, one attempt per
   replica tried) and ``GET /debug/requests?id=`` stitches it LIVE with
   the answering replicas' timelines — one document, no orphans, even on
   the racy paths (retry after demotion, a hedge where both attempts
   complete, a 502-INDETERMINATE write).
2. **Audit events**: health transitions, promotions, hedges, reloads and
   the failover window land in the append-only event log, stamped with
   the triggering request_id where one exists.
3. **Replication SLIs**: follower lag in seqs AND milliseconds, read
   staleness annotated on lagging-follower responses, and the
   failover-window histogram measured 503-onset -> first post-promote 200.
4. **Federation**: router ``/metrics`` merges per-replica registry
   snapshots under a ``{replica=…}`` label (obs/aggregate.py — never a
   lossy pre-sum).
"""

import json
import threading
import time

import numpy as np
import pytest

from knn_tpu_torch import obs
from knn_tpu_torch.fleet.events import FleetEventLog
from knn_tpu_torch.models.knn import KNNClassifier
from knn_tpu_torch.obs import reqtrace
from knn_tpu_torch.resilience import faults

from tests.test_torch_fleet import _Replica, _artifact, _http, _problem


def _local_rng():
    # Deliberately NOT the session-scoped ``rng`` fixture: that generator is
    # shared and stateful, so drawing from it here would shift the random
    # stream seen by every test module collected after this one.
    return np.random.default_rng(1016)


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.enable()
    obs.reset()
    yield obs.registry()
    obs.reset()
    if not was:
        obs.disable()


def _router(urls, **kw):
    from knn_tpu_torch.fleet.router import RouterApp, make_router_server

    kw.setdefault("health_interval_s", 0.1)
    app = RouterApp(urls, **kw)
    server = make_router_server(app)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return app, server, f"http://{host}:{port}"


def _close_router(app, server):
    server.shutdown()
    server.server_close()
    app.close()


def _rid_of(app):
    """The newest router timeline's request_id."""
    recent = app.recorder.recent(1)
    assert recent, "the router recorded no timeline"
    return recent[0]["request_id"]


# -- 1. the event log --------------------------------------------------------


class TestFleetEventLog:
    def test_ring_file_and_taxonomy(self, tmp_path):
        path = tmp_path / "events.jsonl"
        log = FleetEventLog(str(path), capacity=4)
        try:
            log.emit("demote", replica="http://r1", role="primary")
            log.emit("promote", request_id="abc", replica="http://r2")
            for i in range(5):
                log.emit("hedge-fired", hop=i)
        finally:
            log.close()
        # The ring keeps only the newest `capacity`; the FILE keeps all.
        assert log.export()["emitted"] == 7
        assert log.export()["retained"] == 4
        recs = log.recent()
        assert [r["event"] for r in recs] == ["hedge-fired"] * 4
        assert log.recent(2)[-1]["hop"] == 4  # newest-n, chronological
        lines = [json.loads(ln) for ln in
                 path.read_text().strip().splitlines()]
        assert len(lines) == 7
        assert lines[0]["event"] == "demote"
        assert lines[1]["request_id"] == "abc"
        assert all("ts" in ln for ln in lines)

    def test_no_path_is_ring_only(self):
        log = FleetEventLog(None)
        log.emit("rejoin", replica="http://r1")
        assert log.find("rejoin")[0]["replica"] == "http://r1"
        assert log.export()["path"] is None
        log.close()


# -- 2. cross-tier stitching (pure export math) ------------------------------


def _fake_timeline(rid, start_unix, ms, phases=(), attempts=()):
    return {
        "request_id": rid, "kind": "kneighbors", "rows": 1,
        "start_unix": start_unix, "outcome": "ok", "request_ms": ms,
        "phases": [dict(p) for p in phases],
        "attempts": [dict(a) for a in attempts], "events": [],
    }


class TestStitching:
    def test_one_process_per_tier_shared_epoch(self):
        router_tl = _fake_timeline(
            "r1", 100.0, 5.0,
            phases=({"phase": "route", "start_ms": 0.0, "ms": 0.1},
                    {"phase": "dispatch", "start_ms": 0.1, "ms": 4.8}),
            attempts=({"rung": "http://a", "ok": True, "ms": 4.7},))
        replica_tl = _fake_timeline("r1", 100.001, 4.0)
        doc = reqtrace.stitch_chrome_trace(
            [("router", [router_tl]), ("http://a", [replica_tl])])
        assert doc["otherData"]["tiers"] == ["router", "http://a"]
        procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("name") == "process_name"}
        assert procs == {1: "router", 2: "http://a"}
        # Shared epoch: the replica's envelope begin is offset by the
        # wall-clock delta (1 ms = 1000 us), not re-zeroed.
        rep_begin = [e for e in doc["traceEvents"]
                     if e["pid"] == 2 and e["ph"] == "B"
                     and e["name"].startswith("request:")]
        assert rep_begin and abs(rep_begin[0]["ts"] - 1000.0) < 1e-6

    def test_missing_replica_timeline_is_skipped_not_an_orphan(self):
        router_tl = _fake_timeline("r2", 50.0, 3.0)
        doc = reqtrace.stitch_chrome_trace(
            [("router", [router_tl]), ("http://dead", [None])])
        pids = {e["pid"] for e in doc["traceEvents"]
                if e.get("cat") == "knn_tpu_torch.request"}
        assert pids == {1}  # only the router tier has slices
        assert doc["otherData"]["tiers"] == ["router", "http://dead"]

    def test_empty_stitch_is_empty(self):
        assert reqtrace.stitch_trace_events([("router", [])]) == []


# -- 3. the router's request timelines + /debug surfaces ---------------------


class TestRouterTracing:
    @pytest.fixture
    def plain_pair(self, tmp_path, obs_on):
        import shutil

        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(_local_rng()))
        a_dir = _artifact(model, tmp_path, "a")
        b_dir = tmp_path / "b"
        shutil.copytree(a_dir, b_dir)
        from knn_tpu_torch.serve.artifact import index_version, read_manifest

        version = index_version(read_manifest(a_dir))
        a = _Replica(model, a_dir, index_version=version)
        b = _Replica(model, b_dir, index_version=version)
        yield a, b, model
        a.close()
        b.close()

    def test_retry_after_demotion_one_timeline_no_orphans(
            self, plain_pair):
        """Racy path #1: the first replica dies mid-fleet; the read
        retries on the survivor. EXACTLY one router timeline with both
        attempts; the stitched document links the survivor's timeline
        (carrying the retry's hop number) and reports the dead replica
        as absent — not an orphan, not an error."""
        a, b, model = plain_pair
        # Freeze the poller (boot poll marked both healthy) so the DEAD
        # replica is still routed to — the per-request retry is on trial
        # here, not the health loop.
        app, server, url = _router([a.url, b.url], event_log=True,
                                   health_interval_s=3600.0)
        try:
            q = model.train_.features[:1].tolist()
            a.kill()
            app._rr = 1  # next read starts its walk at a (the corpse)
            st, doc = _http(url, "/kneighbors", {"instances": q})
            assert st == 200, doc
            rid = _rid_of(app)
            # Exactly one router timeline for this id.
            assert sum(1 for t in app.recorder.recent()
                       if t["request_id"] == rid) == 1
            tl = app.recorder.find(rid)
            assert tl["outcome"] == "ok"
            phases = {p["phase"] for p in tl["phases"]}
            assert phases == {"route", "dispatch"}
            # Attempt 1 failed on the dead replica, attempt 2 answered.
            assert [a_["ok"] for a_ in tl["attempts"]] == [False, True]
            assert tl["attempts"][0]["rung"] == a.url
            assert tl["attempts"][1]["rung"] == b.url
            assert [a_["hop"] for a_ in tl["attempts"]] == [1, 2]
            # The stitched doc: survivor linked with the right hop,
            # dead replica explicitly None.
            st, stitched = _http(url, f"/debug/requests?id={rid}")
            assert st == 200
            assert stitched["router"]["request_id"] == rid
            assert stitched["replicas"][a.url] is None
            rep = stitched["replicas"][b.url]
            assert rep["request_id"] == rid
            assert rep["upstream_attempt"] == 2
            # The passive demotion was audited with this request's id.
            demotes = app.events.find("passive-demote")
            assert demotes and demotes[0]["request_id"] == rid
            assert demotes[0]["replica"] == a.url
            # Perfetto render carries both tiers.
            st, trace = _http(url,
                              f"/debug/requests?id={rid}&format=perfetto")
            assert st == 200
            assert trace["otherData"]["tiers"] == ["router", a.url, b.url]
        finally:
            _close_router(app, server)
            a.app.close()

    def test_hedge_both_complete_loser_drained_and_counted(
            self, plain_pair, monkeypatch, obs_on):
        """Racy path #2: the hedge fires and BOTH attempts complete. One
        router timeline records hedge-fired + hedge-won; the loser is
        drained (counted ``knn_fleet_hedge_wasted_total``, never
        silently discarded) and BOTH replica timelines stitch in."""
        a, b, model = plain_pair
        from knn_tpu_torch.fleet import router as router_mod

        q = model.train_.features[:1].tolist()
        # Warm both replicas' compile caches directly (bypassing the
        # router) so the race below is decided by the injected delay,
        # not by whoever compiles first.
        for rep in (a, b):
            st, _doc = _http(rep.url, "/kneighbors", {"instances": q})
            assert st == 200
        real_fb = router_mod.forward_bytes
        slow_url = a.url

        def delayed(method, url, body, timeout, headers):
            if url.startswith(slow_url):
                time.sleep(0.25)
            return real_fb(method, url, body, timeout, headers)

        monkeypatch.setattr(router_mod, "forward_bytes", delayed)
        app, server, url = _router([a.url, b.url], hedge="40",
                                   event_log=True)
        try:
            # Pin the round-robin start so candidates[0] is the slow one.
            app._rr = 1
            st, doc = _http(url, "/kneighbors", {"instances": q})
            assert st == 200, doc
            rid = _rid_of(app)
            tl = app.recorder.find(rid)
            ev = [e["event"] for e in tl["events"]]
            assert "hedge-fired" in ev and "hedge-won" in ev
            fired = app.events.find("hedge-fired")
            assert fired and fired[0]["request_id"] == rid
            assert fired[0]["slow_replica"] == a.url
            # Wait for the slow loser to complete, then: it was drained
            # and counted, not dropped.
            deadline = time.monotonic() + 5
            wasted = None
            while time.monotonic() < deadline:
                wasted = [i for i in obs.registry().instruments()
                          if i.name == "knn_fleet_hedge_wasted_total"]
                if wasted:
                    break
                time.sleep(0.02)
            assert wasted, "the hedge loser was never counted"
            assert dict(wasted[0].labels)["outcome"] == "completed"
            # Both replicas served it -> both stitch in, hop-tagged.
            st, stitched = _http(url, f"/debug/requests?id={rid}")
            assert st == 200
            reps = stitched["replicas"]
            assert reps[a.url]["upstream_attempt"] == 1
            assert reps[b.url]["upstream_attempt"] == 2
            # Still exactly one router timeline (the hedge is attempts
            # WITHIN one request, not a second request).
            assert sum(1 for t in app.recorder.recent()
                       if t["request_id"] == rid) == 1
        finally:
            _close_router(app, server)

    def test_write_indeterminate_502_no_replica_orphan(
            self, tmp_path, obs_on):
        """Racy path #3: a write fails mid-flight (injected io fault at
        the fleet.forward point — BEFORE the wire, so the primary never
        saw it). The router answers the typed 502 INDETERMINATE with one
        failed-attempt timeline; the primary's recorder has NO entry for
        the id — the stitched doc shows that, rather than inventing an
        orphan."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(_local_rng()))
        f = _Replica(model, _artifact(model, tmp_path, "f"),
                     mutable=True, follower_of="http://127.0.0.1:9",
                     replicate_ack="none")
        p = _Replica(model, _artifact(model, tmp_path, "p"),
                     mutable=True, replicate_to=[f.url])
        app, server, url = _router([f.url, p.url], event_log=True)
        try:
            with faults.inject("fleet.forward=once:io"):
                st, doc = _http(url, "/insert",
                                {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 502 and "INDETERMINATE" in doc["error"]
            rid = _rid_of(app)
            tl = app.recorder.find(rid)
            assert tl["outcome"] == "http_502"
            assert len(tl["attempts"]) == 1
            assert tl["attempts"][0]["ok"] is False
            assert tl["attempts"][0]["rung"] == p.url
            # The fault fired before the wire: the primary never traced
            # this id (checked in-process AND via the stitched fetch).
            assert p.app.recorder.find(rid) is None
            st, stitched = _http(url, f"/debug/requests?id={rid}")
            assert st == 200
            assert stitched["replicas"][p.url] is None
            # The passive demotion is audited with the write's id.
            demotes = app.events.find("passive-demote")
            assert demotes and demotes[-1]["request_id"] == rid
        finally:
            _close_router(app, server)
            p.app.close()
            f.close()

    def test_debug_requests_listing_and_disabled_404(self, plain_pair):
        a, b, model = plain_pair
        app, server, url = _router([a.url, b.url])
        try:
            q = model.train_.features[:1].tolist()
            for _ in range(3):
                st, _doc = _http(url, "/kneighbors", {"instances": q})
                assert st == 200
            st, doc = _http(url, "/debug/requests?n=2")
            assert st == 200 and len(doc["requests"]) == 2
            assert doc["completed"] >= 3
            st, doc = _http(url, "/debug/requests?id=nope")
            assert st == 404
            st, doc = _http(url, "/debug/events")
            assert st == 404  # no --event-log -> typed 404, not []
        finally:
            _close_router(app, server)
        app2, server2, url2 = _router([a.url], flight_recorder_size=0)
        try:
            st, doc = _http(url2, "/debug/requests")
            assert st == 404 and "disabled" in doc["error"]
        finally:
            _close_router(app2, server2)

    def test_access_log_one_line_per_routed_request(self, plain_pair,
                                                    tmp_path):
        a, b, model = plain_pair
        log_path = tmp_path / "router-access.jsonl"
        app, server, url = _router([a.url, b.url],
                                   access_log=str(log_path),
                                   health_interval_s=3600.0)
        try:
            q = model.train_.features[:1].tolist()
            st, _doc = _http(url, "/kneighbors", {"instances": q})
            assert st == 200
            a.kill()
            app._rr = 1  # the retry walk starts at the corpse
            st, _doc = _http(url, "/kneighbors", {"instances": q})
            assert st == 200
        finally:
            _close_router(app, server)
            a.app.close()
        # The handler writes its line AFTER the response goes out — poll
        # (bounded) rather than reading once.
        lines = []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            lines = [json.loads(ln) for ln in
                     log_path.read_text().strip().splitlines() if ln]
            if len(lines) >= 2:
                break
            time.sleep(0.01)
        assert len(lines) == 2
        for ln in lines:
            assert ln["kind"] == "kneighbors" and ln["status"] == 200
            assert ln["replica"] in (a.url, b.url)
            assert ln["request_id"]
            assert "dispatch" in ln["phases"]
        # The retried request shows both attempts in its line.
        retried = lines[1]
        assert retried["replicas_tried"] == 2
        assert len(retried["attempts"]) == 2


# -- 4. federation + fleet debug ---------------------------------------------


class TestFederation:
    @pytest.fixture
    def pair_router(self, tmp_path, obs_on):
        import shutil

        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(_local_rng()))
        a_dir = _artifact(model, tmp_path, "a")
        b_dir = tmp_path / "b"
        shutil.copytree(a_dir, b_dir)
        a = _Replica(model, a_dir)
        b = _Replica(model, b_dir)
        app, server, url = _router([a.url, b.url])
        yield a, b, model, app, url
        _close_router(app, server)
        a.close()
        b.close()

    def test_metrics_json_snapshot_shape(self, pair_router):
        a, _b, model, _app, _url = pair_router
        q = model.train_.features[:1].tolist()
        st, _doc = _http(a.url, "/kneighbors", {"instances": q})
        assert st == 200
        st, doc = _http(a.url, "/metrics?format=json")
        assert st == 200 and isinstance(doc["snapshot"], list)
        names = {r["name"] for r in doc["snapshot"]}
        assert "knn_serve_requests_total" in names
        hist = next(r for r in doc["snapshot"]
                    if r["kind"] == "histogram")
        assert {"buckets", "counts", "sum", "count"} <= set(hist)

    def test_router_metrics_federate_with_replica_label(self,
                                                        pair_router):
        a, b, model, _app, url = pair_router
        q = model.train_.features[:1].tolist()
        st, _doc = _http(url, "/kneighbors", {"instances": q})
        assert st == 200
        import urllib.request

        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        # Per-replica attribution survives the merge...
        assert f'replica="{a.url}"' in text
        assert f'replica="{b.url}"' in text
        # ...the router's own instruments overlay unlabeled...
        assert "knn_fleet_router_requests_total" in text
        # ...and the scrape self-reports.
        assert 'knn_fleet_scrape_total{' in text

    def test_debug_fleet_joins_live_documents_and_events(self,
                                                         tmp_path,
                                                         obs_on):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(_local_rng()))
        a = _Replica(model, _artifact(model, tmp_path, "a"))
        app, server, url = _router([a.url], event_log=True)
        try:
            app.events.emit("demote", replica=a.url, role=None)
            st, doc = _http(url, "/debug/fleet")
            assert st == 200
            live = doc["live"][a.url]
            assert live["healthz"]["ready"] is True
            assert "mutable" in live["capacity"]
            assert "enabled" in live["quality"]
            assert doc["events"][-1]["event"] == "demote"
            assert doc["event_log"]["emitted"] >= 1
            assert doc["flight_recorder"]["capacity"] == 256
        finally:
            _close_router(app, server)
            a.close()


# -- 5. replication-lag + staleness + failover-window SLIs -------------------


class TestReplicationSLIs:
    @pytest.fixture
    def fleet(self, tmp_path, obs_on):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(_local_rng()))
        f = _Replica(model, _artifact(model, tmp_path, "f"),
                     mutable=True, follower_of="http://127.0.0.1:9",
                     replicate_ack="none")
        p = _Replica(model, _artifact(model, tmp_path, "p"),
                     mutable=True, replicate_to=[f.url])
        yield p, f, model
        p.app.close()
        f.close()

    def test_lag_clock_and_gauges(self, fleet):
        p, f, _model = fleet
        st, doc = _http(p.url, "/insert",
                        {"rows": [[1.0] * 4], "labels": [0]})
        assert st == 200 and doc["seq"] == 1
        # The semi-sync ack confirmed seq 1 -> the primary holds a
        # wall-clock lag for this follower, and exports it.
        deadline = time.monotonic() + 5
        while (time.monotonic() < deadline
               and p.app.fleet.follower_lag_ms(f.url) is None):
            time.sleep(0.02)
        lag = p.app.fleet.follower_lag_ms(f.url)
        assert lag is not None and 0.0 <= lag < 5000.0
        shipper = next(iter(p.app.fleet._shippers.values()))
        assert shipper.export()["lag_ms"] == lag
        gauges = {i.name for i in obs.registry().instruments()}
        assert "knn_fleet_replication_lag_ms" in gauges

    def test_follower_staleness_annotates_reads(self, fleet):
        p, f, model = fleet
        st, doc = _http(p.url, "/insert",
                        {"rows": [[1.0] * 4], "labels": [0]})
        assert st == 200
        deadline = time.monotonic() + 5
        while (time.monotonic() < deadline
               and f.app.fleet.engine.seq < 1):
            time.sleep(0.02)
        q = model.train_.features[:1].tolist()
        # Caught up: no staleness field.
        st, doc = _http(f.url, "/kneighbors", {"instances": q})
        assert st == 200 and "staleness_seq" not in doc
        assert f.app.fleet.staleness_seq() == 0
        # The follower has SEEN primary seq 4 but only applied 1: its
        # answers are 3 writes behind and must say so.
        f.app.fleet.primary_seq_seen = 4
        assert f.app.fleet.staleness_seq() == 3
        st, doc = _http(f.url, "/kneighbors", {"instances": q})
        assert st == 200 and doc["staleness_seq"] == 3
        tl = f.app.recorder.recent(1)[0]
        assert tl["staleness_seq"] == 3
        # A primary never reports staleness.
        st, doc = _http(p.url, "/kneighbors", {"instances": q})
        assert st == 200 and "staleness_seq" not in doc

    def test_failover_window_measured_and_audited(self, fleet):
        p, f, _model = fleet
        app, server, url = _router([f.url, p.url], event_log=True)
        try:
            st, doc = _http(url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 200
            p.kill()
            app.set.poll_once()
            st, doc = _http(url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 503  # the onset
            onset_rid = _rid_of(app)
            st, doc = _http(url, "/admin/promote", {})
            assert st == 200
            st, doc = _http(url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 200  # closes the window
            wins = app.events.find("failover-window")
            assert len(wins) == 1
            assert wins[0]["window_ms"] > 0
            assert wins[0]["onset_request_id"] == onset_rid
            promotes = app.events.find("promote")
            assert promotes and promotes[0]["replica"] == f.url
            hists = [i for i in obs.registry().instruments()
                     if i.name == "knn_fleet_failover_window_ms"]
            assert hists and hists[0].count == 1
            # A second healthy write does NOT observe another window.
            st, doc = _http(url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 200
            assert hists[0].count == 1
        finally:
            _close_router(app, server)
