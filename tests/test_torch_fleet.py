"""Replica-set contracts on the port (the twin of ``tests/test_fleet.py``,
pointed at ``knn_tpu_torch`` with ``device="cpu"``).

The load-bearing claims, replica-side first:

1. **Replicated apply** rides the exact local-mutation validation path:
   in-order records apply AND land in the follower's own WAL (flushed —
   promote and reboot both depend on it); a seq gap is a typed
   :class:`ReplicationGap` carrying the resync cursor; an already-applied
   seq is an idempotent no-op guarded by a content digest; a divergent
   record is a typed refusal, never silent corruption.
2. **Shipping**: the primary's per-follower cursor drains lag, survives
   the ``fleet.wal_ship`` fault point, and the semi-synchronous ack
   holds a mutation's 200 until a follower confirmed its seq.
3. **Promotion** flips a follower to primary in place and records the
   takeover seq; :func:`truncate_wal` drops the unacknowledged tail past
   it (the ex-primary rejoin primitive).
4. **Routing**: reads retry transport failures on a DIFFERENT replica
   (zero client-visible failures while one replica survives), writes go
   only to the primary, typed 503 is the ONLY total-failure answer, and
   a coordinated reload is all-or-nothing with rollback.

The port's hazards get their own class at the end: a follower applies
every shipped record on its batcher's worker thread, and a primary whose
follower acks slowly keeps answering reads. The kill-replicas-under-load
legs run on the card in ``chip_smoke.py``'s fleet phase.
"""

import json
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from knn_tpu_torch import obs
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.models.knn import KNNClassifier
from knn_tpu_torch.mutable.engine import MutableEngine, truncate_wal
from knn_tpu_torch.mutable.state import (
    MutationConflict,
    ReplicationGap,
)
from knn_tpu_torch.resilience import faults
from knn_tpu_torch.resilience.errors import DataError
from knn_tpu_torch.serve.artifact import save_index
from knn_tpu_torch.serve.server import ServeApp, make_server


@pytest.fixture
def rng():
    # This module's own stream: the session generator is shared, so
    # drawing from it here would shift what later modules see.
    return np.random.default_rng(0)


def _problem(rng, n=80, d=4, c=3):
    train_x = rng.integers(0, 4, (n, d)).astype(np.float32)
    train_y = rng.integers(0, c, n).astype(np.int32)
    return Dataset(train_x, train_y)


def _artifact(model, tmp_path, name):
    out = tmp_path / name
    if not (out / "manifest.json").exists():
        save_index(model, out)
    return out


def _http(base, path, payload=None, method=None, timeout=10):
    req = urllib.request.Request(
        base + path,
        data=(json.dumps(payload).encode() if payload is not None
              else None),
        headers=({"Content-Type": "application/json"} if payload
                 else {}),
        method=method,
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Replica:
    """One in-process serve replica (no warmup — tests flip ready)."""

    def __init__(self, model, index_dir, **kw):
        self.app = ServeApp(model, max_batch=8, max_wait_ms=0.2,
                            index_path=str(index_dir), **kw)
        self.server = make_server(self.app)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.app.ready = True
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}"

    def kill(self):
        """SIGKILL-equivalent: listener + handlers gone, no drain."""
        self.server.shutdown()
        self.server.server_close()

    def close(self):
        self.kill()
        self.app.close()


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.enable()
    obs.reset()
    yield obs.registry()
    obs.reset()
    if not was:
        obs.disable()


# -- 1. replicated apply (engine level) -------------------------------------


class TestApplyReplicated:
    def _engine(self, rng, tmp_path, name="idx"):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        return model, MutableEngine(
            model, _artifact(model, tmp_path, name), delta_cap=256)

    def test_in_order_apply_is_durable_in_own_wal(self, rng, tmp_path):
        model, src = self._engine(rng, tmp_path, "src")
        dst_dir = _artifact(model, tmp_path, "dst")
        dst = MutableEngine(model, dst_dir, delta_cap=256)
        try:
            src.apply_insert(np.ones((2, 4), np.float32), [0, 1], 0)
            src.apply_delete([10], 0)
            records, seq = src.records_since(0)
            for rec in records:
                assert dst.apply_replicated(rec)["applied"]
            assert dst.seq == seq == 2
            a, b = src.snapshot(), dst.snapshot()
            assert a.count == b.count and a.tomb_pos == b.tomb_pos
            np.testing.assert_array_equal(a.features[:a.count],
                                          b.features[:b.count])
            np.testing.assert_array_equal(a.stable[:a.count],
                                          b.stable[:b.count])
        finally:
            src.close()
            dst.close()
        # The replica's OWN WAL now replays the same state (what promote
        # and reboot both ride).
        dst2 = MutableEngine(model, dst_dir, delta_cap=256)
        try:
            assert dst2.seq == 2
            assert dst2.snapshot().tomb_pos == frozenset({10})
        finally:
            dst2.close()

    def test_gap_is_typed_with_resync_cursor(self, rng, tmp_path):
        model, src = self._engine(rng, tmp_path, "src")
        dst = MutableEngine(model, _artifact(model, tmp_path, "dst"),
                            delta_cap=256)
        try:
            for v in range(3):
                src.apply_insert(np.full((1, 4), float(v), np.float32),
                                 [0], 0)
            records, _ = src.records_since(0)
            dst.apply_replicated(records[0])
            with pytest.raises(ReplicationGap) as exc:
                dst.apply_replicated(records[2])  # skips seq 2
            assert exc.value.applied_seq == 1
            assert dst.seq == 1  # nothing applied past the refusal
        finally:
            src.close()
            dst.close()

    def test_divergent_record_is_typed_refusal(self, rng, tmp_path):
        """Wrong width / out-of-range label = full local validation:
        never applied, never WAL-appended."""
        model, dst = self._engine(rng, tmp_path, "dst")
        try:
            with pytest.raises(ValueError, match=r"insert rows"):
                dst.apply_replicated({"seq": 1, "op": "insert", "sid0": 80,
                                      "rows": [[1.0, 2.0]],
                                      "values": [0]})
            with pytest.raises(ValueError, match="labels must be in"):
                dst.apply_replicated({"seq": 1, "op": "insert", "sid0": 80,
                                      "rows": [[1.0] * 4],
                                      "values": [99]})
            with pytest.raises(MutationConflict, match="no such row"):
                dst.apply_replicated({"seq": 1, "op": "delete",
                                      "sids": [12345]})
            with pytest.raises(DataError, match="unknown op"):
                dst.apply_replicated({"seq": 1, "op": "merge"})
            assert dst.seq == 0
            records, _ = dst.records_since(0)
            assert records == []  # the WAL is untouched
        finally:
            dst.close()

    def test_truncate_wal_drops_only_the_tail(self, rng, tmp_path):
        model, eng = self._engine(rng, tmp_path, "idx")
        root = _artifact(model, tmp_path, "idx")
        for v in range(4):
            eng.apply_insert(np.full((1, 4), float(v), np.float32),
                             [0], 0)
        eng.close()
        assert truncate_wal(root, cap_seq=2) == 2
        eng2 = MutableEngine(model, root, delta_cap=256)
        try:
            assert eng2.seq == 2
            assert eng2.snapshot().count == 2
        finally:
            eng2.close()

    def test_shipper_cursor_starts_at_the_fold_point(self, rng,
                                                     tmp_path):
        """A primary booted from an ever-compacted artifact (or a
        follower promoted after one) must not ask the WAL for records
        below the fold — the cursor starts AT folded_seq, and only a
        follower that is genuinely behind the fold (gap-409 resync below
        it) reaches the terminal re-seed state."""
        from knn_tpu_torch.fleet.replica import FleetReplica

        model, eng = self._engine(rng, tmp_path, "idx")
        try:
            eng._folded_seq = eng._seq = 7  # as a compacted boot sets
            fleet = FleetReplica(eng, role="primary",
                                 replicate_to=["http://127.0.0.1:9"])
            try:
                shipper = fleet._shippers["http://127.0.0.1:9"]
                assert shipper.acked_seq == 7
                time.sleep(0.15)  # idle ticks: caught-up cursor must
                # never scan below the fold and go terminal
                assert shipper.state == "ok"
            finally:
                fleet.close()
        finally:
            eng.close()

    def test_records_since_behind_fold_is_typed(self, rng, tmp_path):
        """A cursor older than the oldest surviving record means the
        follower must re-seed — typed, never a partial ship. But while
        the records BELOW the fold still exist on disk (the retention
        floor held them for exactly this lagging cursor), the same call
        serves them — behind-the-fold is about missing records, not the
        fold point itself."""
        from knn_tpu_torch.serve import artifact

        model, eng = self._engine(rng, tmp_path, "idx")
        root = _artifact(model, tmp_path, "idx")
        try:
            eng.apply_insert(np.ones((1, 4), np.float32), [0], 0)
            eng._folded_seq = 1  # as a compaction commit would set it
            records, seq = eng.records_since(0)  # epoch retained: serves
            assert [r["seq"] for r in records] == [1] and seq == 1
            for _n, path in artifact.list_epochs(root):
                path.unlink()  # now the pre-fold records are GONE
            with pytest.raises(DataError, match="re-seed"):
                eng.records_since(0)
        finally:
            eng.close()


# -- 2/3. follower + primary over HTTP --------------------------------------


class TestFollowerEndpoints:
    @pytest.fixture
    def follower(self, rng, tmp_path, obs_on):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        idx = _artifact(model, tmp_path, "f")
        rep = _Replica(model, idx, mutable=True,
                       follower_of="http://127.0.0.1:9")
        yield rep, model
        rep.close()

    def test_client_writes_refused_409(self, follower):
        rep, _model = follower
        st, doc = _http(rep.url, "/insert",
                        {"rows": [[1.0] * 4], "labels": [0]})
        assert st == 409 and "read-only follower" in doc["error"]
        st, doc = _http(rep.url, "/delete", {"ids": [0]})
        assert st == 409 and "read-only follower" in doc["error"]

    def test_wal_append_applies_and_surfaces_in_healthz(self, follower):
        rep, _model = follower
        st, doc = _http(rep.url, "/admin/wal-append", {
            "records": [{"seq": 1, "op": "insert", "sid0": 80,
                         "rows": [[1.0] * 4], "values": [1]}],
            "primary_seq": 1,
        })
        assert st == 200
        assert doc["applied_seq"] == 1 and doc["applied"] == 1
        st, h = _http(rep.url, "/healthz")
        assert h["fleet"]["role"] == "follower"
        assert h["fleet"]["applied_seq"] == 1
        assert h["fleet"]["primary_url"] == "http://127.0.0.1:9"
        assert h["mutable"]["seq"] == 1
        # The applied row is VISIBLE to reads through the normal merge.
        st, doc = _http(rep.url, "/kneighbors",
                        {"instances": [[1.0] * 4]})
        assert st == 200 and doc["mutation_seq"] == 1
        assert 80 in doc["indices"][0]

    def test_wal_append_gap_and_divergence_are_typed(self, follower):
        rep, _model = follower
        st, doc = _http(rep.url, "/admin/wal-append", {
            "records": [{"seq": 5, "op": "insert", "sid0": 84,
                         "rows": [[1.0] * 4], "values": [1]}],
        })
        assert st == 409 and doc["applied_seq"] == 0
        rec = {"seq": 1, "op": "insert", "sid0": 80,
               "rows": [[1.0] * 4], "values": [1]}
        assert _http(rep.url, "/admin/wal-append",
                     {"records": [rec]})[0] == 200
        evil = {**rec, "values": [2]}
        st, doc = _http(rep.url, "/admin/wal-append",
                        {"records": [evil]})
        assert st == 409 and doc.get("diverged") is True
        st, doc = _http(rep.url, "/admin/wal-append", {"records": []})
        assert st == 400

    def test_promote_flips_role_in_place(self, follower):
        rep, _model = follower
        st, doc = _http(rep.url, "/admin/promote", {})
        assert st == 200 and doc["role"] == "primary"
        assert doc["promoted_at_seq"] == 0
        # Writes now accepted; wal-append now refused (split brain).
        st, doc = _http(rep.url, "/insert",
                        {"rows": [[1.0] * 4], "labels": [0]})
        assert st == 200 and doc["seq"] == 1
        st, doc = _http(rep.url, "/admin/wal-append", {
            "records": [{"seq": 2, "op": "delete", "sids": [0]}]})
        assert st == 409 and "primary" in doc["error"]
        st, doc = _http(rep.url, "/admin/promote", {})
        assert st == 409 and "already the primary" in doc["error"]

    def test_fleet_off_endpoints_404(self, rng, tmp_path, obs_on):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        rep = _Replica(model, _artifact(model, tmp_path, "p"),
                       mutable=True)
        try:
            assert rep.app.fleet is None
            st, doc = _http(rep.url, "/admin/wal-append",
                            {"records": []})
            assert st == 404
            st, doc = _http(rep.url, "/admin/promote", {})
            assert st == 404
            # wal-since needs only --mutable on, not a fleet role: any
            # replica can export its own log (the rejoin source).
            st, doc = _http(rep.url, "/admin/wal-since?seq=0")
            assert st == 200 and doc["records"] == []
        finally:
            rep.close()


class TestPrimaryShipping:
    def _pair(self, rng, tmp_path, **primary_kw):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        f = _Replica(model, _artifact(model, tmp_path, "f"),
                     mutable=True, follower_of="http://127.0.0.1:9")
        p = _Replica(model, _artifact(model, tmp_path, "p"),
                     mutable=True, replicate_to=[f.url], **primary_kw)
        return model, p, f

    def _wait_seq(self, rep, seq, timeout=10):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if rep.app.mutable.seq >= seq:
                return True
            time.sleep(0.02)
        return False

    def test_acked_writes_ship_and_ack_waits_for_follower(
            self, rng, tmp_path, obs_on):
        model, p, f = self._pair(rng, tmp_path)
        try:
            st, doc = _http(p.url, "/insert",
                            {"rows": [[1.0] * 4, [2.0] * 4],
                             "labels": [0, 1]})
            assert st == 200 and doc["seq"] == 1
            # Semi-sync: by the time the 200 landed, the follower holds
            # the seq (no sleep needed — that is the whole point).
            assert f.app.mutable.seq == 1
            st, h = _http(p.url, "/healthz")
            ship = h["fleet"]["followers"][f.url]
            assert ship["acked_seq"] == 1 and ship["lag"] == 0
            assert ship["state"] == "ok"
        finally:
            p.close()
            f.close()

    def test_ack_timeout_is_typed_applied_true(self, rng, tmp_path,
                                               obs_on):
        """With the follower dead, a write is applied + locally durable
        but CANNOT claim replicated durability: 503 with applied=true,
        never a 200, never a traceback."""
        model, p, f = self._pair(rng, tmp_path,
                                 replicate_ack_timeout_s=0.3)
        try:
            f.kill()
            st, doc = _http(p.url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 503
            assert doc["applied"] is True and doc["seq"] == 1
            assert "do not re-send" in doc["error"]
            assert p.app.mutable.seq == 1  # applied, WAL-durable
        finally:
            p.close()
            f.app.close()

    def test_shipping_rides_the_fault_point_and_recovers(
            self, rng, tmp_path, obs_on):
        """An injected fleet.wal_ship fault delays the shipment; the
        cursor retries without skipping and the follower converges."""
        model, p, f = self._pair(rng, tmp_path,
                                 replicate_ack_timeout_s=20.0)
        try:
            with faults.inject("fleet.wal_ship=2:io"):
                st, doc = _http(p.url, "/insert",
                                {"rows": [[3.0] * 4], "labels": [0]},
                                timeout=30)
            assert st == 200
            assert self._wait_seq(f, 1)
            a, b = p.app.mutable.snapshot(), f.app.mutable.snapshot()
            np.testing.assert_array_equal(a.features[:a.count],
                                          b.features[:b.count])
        finally:
            p.close()
            f.close()

    def test_promote_then_reship_is_digest_checked_noop(
            self, rng, tmp_path, obs_on):
        """After a promote, the new primary re-ships from cursor 0; the
        overlap is digest-verified and skipped, not re-applied."""
        model, p, f = self._pair(rng, tmp_path)
        try:
            _http(p.url, "/insert", {"rows": [[1.0] * 4], "labels": [0]})
            p.kill()
            st, doc = _http(f.url, "/admin/promote",
                            {"replicate_to": []})
            assert st == 200 and doc["promoted_at_seq"] == 1
            st, doc = _http(f.url, "/insert",
                            {"rows": [[2.0] * 4], "labels": [1]})
            assert st == 200 and doc["seq"] == 2
            assert f.app.mutable.snapshot().count == 2
        finally:
            p.app.close()
            f.close()


# -- 4. the router -----------------------------------------------------------


class TestRouter:
    @pytest.fixture
    def plain_pair(self, rng, tmp_path, obs_on):
        """Two immutable replicas over byte-identical artifact copies
        (same index_version — the fleet deployment shape)."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
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

    def _router(self, urls, **kw):
        from knn_tpu_torch.fleet.router import RouterApp, make_router_server

        kw.setdefault("health_interval_s", 0.1)
        app = RouterApp(urls, **kw)
        server = make_router_server(app)
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        host, port = server.server_address[:2]
        return app, server, f"http://{host}:{port}"

    def _close_router(self, app, server):
        server.shutdown()
        server.server_close()
        app.close()

    def test_reads_survive_a_dead_replica(self, plain_pair):
        a, b, model = plain_pair
        app, server, url = self._router([a.url, b.url])
        try:
            q = model.train_.features[:2].tolist()
            st, doc = _http(url, "/kneighbors", {"instances": q})
            assert st == 200 and "indices" in doc
            a.kill()
            # Every read keeps succeeding: transport failures retry on
            # the surviving replica (passive demotion after the first).
            for _ in range(6):
                st, doc = _http(url, "/kneighbors", {"instances": q})
                assert st == 200, doc
            st, h = _http(url, "/healthz")
            assert st == 200 and h["ready"]
            assert h["replicas"][a.url]["healthy"] is False
            assert h["replicas"][b.url]["healthy"] is True
        finally:
            self._close_router(app, server)
            a.app.close()

    def test_zero_usable_is_typed_503_everywhere(self, plain_pair):
        a, b, model = plain_pair
        app, server, url = self._router([a.url, b.url])
        try:
            a.kill()
            b.kill()
            q = model.train_.features[:1].tolist()
            st, doc = _http(url, "/kneighbors", {"instances": q})
            assert st == 503 and "error" in doc
            st, doc = _http(url, "/insert",
                            {"rows": q, "labels": [0]})
            assert st == 503 and "error" in doc
            st, h = _http(url, "/healthz")
            assert st == 503 and h["ready"] is False
        finally:
            self._close_router(app, server)
            a.app.close()
            b.app.close()

    def test_writes_route_only_to_the_primary(self, rng, tmp_path,
                                              obs_on):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        # ack="none" on the follower: after its promote its only peer is
        # the dead ex-primary, and this test pins ROUTING, not the
        # semi-sync ack bar (TestPrimaryShipping owns that).
        f = _Replica(model, _artifact(model, tmp_path, "f"),
                     mutable=True, follower_of="http://127.0.0.1:9",
                     replicate_ack="none")
        p = _Replica(model, _artifact(model, tmp_path, "p"),
                     mutable=True, replicate_to=[f.url])
        app, server, url = self._router([f.url, p.url])
        try:
            st, doc = _http(url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 200 and doc["seq"] == 1
            assert p.app.mutable.seq == 1
            # No primary usable -> typed 503, never a forward to a
            # follower.
            p.kill()
            app.set.poll_once()
            st, doc = _http(url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 503 and "primary" in doc["error"]
            st, doc = _http(url, "/admin/promote", {})
            assert st == 200 and doc["replica"] == f.url
            st, doc = _http(url, "/insert",
                            {"rows": [[1.0] * 4], "labels": [0]})
            assert st == 200 and doc["seq"] == 2
        finally:
            self._close_router(app, server)
            p.app.close()
            f.close()

    def test_coordinated_reload_is_all_or_nothing(self, rng, tmp_path,
                                                  obs_on):
        """Replica B refuses the reload (mutable serving disables it):
        the router must roll A back — both stay on v0 — and report
        typed rolled_back. With B gone from the set, the reload flips
        everyone."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        a_dir = _artifact(model, tmp_path, "a")
        new_dir = tmp_path / "new"
        save_index(model, new_dir)
        from knn_tpu_torch.serve.artifact import index_version, read_manifest

        v0 = index_version(read_manifest(a_dir))
        a = _Replica(model, a_dir, index_version=v0)
        b = _Replica(model, _artifact(model, tmp_path, "bm"),
                     index_version=v0, mutable=True)
        app, server, url = self._router([a.url, b.url])
        try:
            st, doc = _http(url, "/admin/reload",
                            {"index": str(new_dir)}, timeout=120)
            assert st == 502 and doc["rolled_back"] is True
            assert doc["flipped_then_rolled_back"] == [a.url]
            st, h = _http(a.url, "/healthz")
            assert h["index_version"] == v0  # rolled back
        finally:
            self._close_router(app, server)
        app2, server2, url2 = self._router([a.url])
        try:
            st, doc = _http(url2, "/admin/reload",
                            {"index": str(new_dir)}, timeout=120)
            assert st == 200 and doc["replicas"] == 1
            st, h = _http(a.url, "/healthz")
            assert h["index_version"] == doc["index_version"] != v0
        finally:
            self._close_router(app2, server2)
            a.close()
            b.close()

    def test_forward_fault_point_retries_on_another_replica(
            self, plain_pair):
        """An injected fleet.forward fault on the first attempt is a
        transport failure: the read must answer 200 from the other
        replica, not surface the fault."""
        a, b, model = plain_pair
        app, server, url = self._router([a.url, b.url])
        try:
            q = model.train_.features[:1].tolist()
            with faults.inject("fleet.forward=once:io"):
                st, doc = _http(url, "/kneighbors", {"instances": q})
            assert st == 200, doc
        finally:
            self._close_router(app, server)

    def test_hedge_delay_needs_evidence(self, plain_pair):
        a, b, _model = plain_pair
        app, server, url = self._router([a.url, b.url], hedge="auto")
        try:
            assert app.hedge_delay_s() is None  # <50 observations
            for ms in range(60):
                app._note_latency(float(ms))
            d = app.hedge_delay_s()
            assert d is not None and 0.0 < d <= 0.06
            app2 = type(app)([a.url], hedge="25")
            assert app2.hedge_delay_s() == 0.025
            app2.close()
            with pytest.raises(ValueError):
                type(app)([a.url], hedge="-3")
        finally:
            self._close_router(app, server)

    def test_unknown_route_and_bad_body_are_typed(self, plain_pair):
        a, b, _model = plain_pair
        app, server, url = self._router([a.url, b.url])
        try:
            st, doc = _http(url, "/nope", {"x": 1})
            assert st == 404 and "error" in doc
            st, doc = _http(url, "/healthz")
            assert st == 200
        finally:
            self._close_router(app, server)


# -- 5. the port's hazards ---------------------------------------------------


class TestPortHazards:
    def test_replicated_records_apply_on_the_batcher_worker(
            self, rng, tmp_path, obs_on):
        """A follower under concurrent reads and ``/admin/wal-append``:
        every replicated record is applied, and every delta-tail sync it
        makes is run, by the batcher's worker thread — the one thread that
        touches the card — never by an HTTP handler thread."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(
            _problem(rng))
        f = _Replica(model, _artifact(model, tmp_path, "f"), mutable=True,
                     follower_of="http://127.0.0.1:9")
        eng = f.app.mutable
        seen = {"apply": [], "sync": []}
        real_apply, real_sync = eng.apply_replicated, eng._sync_device_tail

        def apply(rec):
            seen["apply"].append(threading.current_thread().name)
            return real_apply(rec)

        def sync(*a, **kw):
            seen["sync"].append(threading.current_thread().name)
            return real_sync(*a, **kw)

        eng.apply_replicated, eng._sync_device_tail = apply, sync
        q = model.train_.features[:2].tolist()
        stop = threading.Event()
        reads = []

        def reader():
            while not stop.is_set():
                reads.append(_http(f.url, "/kneighbors",
                                   {"instances": q})[0])

        readers = [threading.Thread(target=reader) for _ in range(4)]
        try:
            for t in readers:
                t.start()
            seq = 0
            for b in range(12):
                recs = []
                for _ in range(3):
                    seq += 1
                    recs.append({"seq": seq, "op": "insert",
                                 "sid0": 80 + seq - 1,
                                 "rows": [[float(b % 4)] * 4],
                                 "values": [b % 3]})
                st, doc = _http(f.url, "/admin/wal-append",
                                {"records": recs, "primary_seq": seq})
                assert st == 200 and doc["applied"] == 3, doc
            seq += 1
            st, doc = _http(f.url, "/admin/wal-append", {
                "records": [{"seq": seq, "op": "delete", "sids": [80]}]})
            assert st == 200 and doc["applied_seq"] == seq == 37
        finally:
            stop.set()
            for t in readers:
                t.join(timeout=30)
            f.close()
        assert not any(t.is_alive() for t in readers)
        assert reads and set(reads) == {200}
        assert len(seen["apply"]) == 37
        assert set(seen["apply"]) == {"knn-serve-batcher"}
        assert len(seen["sync"]) == 36  # one per inserted record
        assert set(seen["sync"]) == {"knn-serve-batcher"}

    def test_slow_follower_ack_never_stalls_primary_reads(
            self, rng, tmp_path, obs_on):
        """The semi-synchronous ack waits on the write's handler thread:
        while a follower takes 1.5 s to ack, the primary's reads keep
        answering at once and the write's 200 arrives after the ack."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class SlowFollower(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802 — stdlib dispatch name
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                time.sleep(1.5)
                seq = max(int(r["seq"]) for r in body["records"])
                raw = json.dumps({"applied_seq": seq, "applied": len(
                    body["records"]), "skipped": 0}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        slow = ThreadingHTTPServer(("127.0.0.1", 0), SlowFollower)
        slow.daemon_threads = True
        threading.Thread(target=slow.serve_forever, daemon=True).start()
        host, port = slow.server_address[:2]
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(
            _problem(rng))
        p = _Replica(model, _artifact(model, tmp_path, "p"), mutable=True,
                     replicate_to=[f"http://{host}:{port}"])
        q = model.train_.features[:1].tolist()
        write = {}

        def writer():
            t0 = time.monotonic()
            write["status"] = _http(p.url, "/insert",
                                    {"rows": [[1.0] * 4], "labels": [0]},
                                    timeout=30)[0]
            write["s"] = time.monotonic() - t0

        try:
            _http(p.url, "/kneighbors", {"instances": q})  # warm
            w = threading.Thread(target=writer)
            w.start()
            time.sleep(0.2)  # the write is applied and waiting on the ack
            lat = []
            while w.is_alive() and len(lat) < 20:
                t0 = time.monotonic()
                st, doc = _http(p.url, "/kneighbors", {"instances": q})
                lat.append(time.monotonic() - t0)
                assert st == 200 and doc["mutation_seq"] == 1
            w.join(timeout=30)
            assert not w.is_alive()
        finally:
            p.close()
            slow.shutdown()
            slow.server_close()
        assert write["status"] == 200 and write["s"] >= 1.3
        assert len(lat) >= 5 and max(lat) < 1.0
