"""Snapshot-shipping bootstrap on the port (the twin of
``tests/test_fleet_bootstrap.py``, pointed at ``knn_tpu_torch`` with
``device="cpu"``).

The load-bearing claims:

1. **Export**: any mutable replica serves its committed generation over
   ``GET /admin/snapshot`` — a digest-stamped manifest plus ranged
   chunks, with a generation precondition so a compaction mid-transfer
   is a typed 409 (restart), never a file stitched from two generations.
2. **Install is atomic**: every failure leg — torn chunk, digest
   mismatch, the ``fleet.snapshot_ship`` fault point standing in for a
   full disk — leaves the prior state serving and no staged debris.
3. **In-process re-seed**: ``POST /admin/bootstrap`` on a divergent
   follower abandons its lineage (epochs cleared BEFORE the pointer
   commit — no abandoned record may replay onto the new base) and the
   primary's parked shipper resumes on its re-probe with no primary
   restart.
4. **Retention floor**: a primary compaction never prunes WAL epochs a
   live follower's cursor still needs — a merely-lagging follower keeps
   catching up from the WAL instead of being force-parked behind the
   fold.

The blank-follower join under live traffic runs on the card in
``chip_smoke.py``'s fleet phase.
"""

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from knn_tpu_torch import obs
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.fleet import bootstrap
from knn_tpu_torch.fleet.bootstrap import SnapshotInstallError
from knn_tpu_torch.fleet.replica import FleetReplica
from knn_tpu_torch.models.knn import KNNClassifier
from knn_tpu_torch.mutable.compact import Compactor
from knn_tpu_torch.mutable.engine import MutableEngine
from knn_tpu_torch.resilience import faults
from knn_tpu_torch.resilience.errors import DataError
from knn_tpu_torch.serve import artifact
from knn_tpu_torch.serve.artifact import save_index
from knn_tpu_torch.serve.server import ServeApp, make_server


def _problem(rng, n=80, d=4, c=3):
    train_x = rng.integers(0, 4, (n, d)).astype(np.float32)
    train_y = rng.integers(0, c, n).astype(np.int32)
    return Dataset(train_x, train_y)


def _artifact(model, tmp_path, name):
    out = tmp_path / name
    if not (out / "manifest.json").exists():
        save_index(model, out)
    return out


def _http(base, path, payload=None, method=None, timeout=30):
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


def _http_raw(base, path, timeout=30):
    req = urllib.request.Request(base + path)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


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

    def close(self):
        self.server.shutdown()
        self.server.server_close()
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


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# -- 1. snapshot export ------------------------------------------------------


class TestSnapshotExport:
    def test_manifest_digests_match_disk(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        root = _artifact(model, tmp_path, "idx")
        man = bootstrap.snapshot_manifest(root)
        assert [f["name"] for f in man["files"]] == [
            artifact.MANIFEST_NAME, artifact.ARRAYS_NAME]
        assert man["generation"] == 0 and man["wal_cursor"] == 0
        for entry in man["files"]:
            data = (root / entry["name"]).read_bytes()
            assert entry["size"] == len(data)
            assert entry["sha256"] == hashlib.sha256(data).hexdigest()

    def test_chunk_generation_precondition_is_typed(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        root = _artifact(model, tmp_path, "idx")
        with pytest.raises(DataError, match="superseded"):
            bootstrap.read_chunk(root, artifact.ARRAYS_NAME, 0, 64,
                                 generation=5)

    def test_chunk_refuses_non_snapshot_files(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        root = _artifact(model, tmp_path, "idx")
        for name in ("CURRENT.json", "../secrets", "epochs/epoch-1.jsonl"):
            with pytest.raises(DataError, match="not a snapshot file"):
                bootstrap.read_chunk(root, name, 0, 64, generation=0)

    def test_http_chunks_reassemble_bit_exact(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        root = _artifact(model, tmp_path, "idx")
        rep = _Replica(model, root, mutable=True)
        try:
            st, man = _http(rep.url, "/admin/snapshot")
            assert st == 200
            entry = next(f for f in man["files"]
                         if f["name"] == artifact.ARRAYS_NAME)
            got = b""
            while len(got) < entry["size"]:
                st, chunk = _http_raw(
                    rep.url,
                    f"/admin/snapshot?file={entry['name']}"
                    f"&offset={len(got)}&length=1024"
                    f"&generation={man['generation']}")
                assert st == 200 and chunk
                got += chunk
            assert got == (root / entry["name"]).read_bytes()
            # Stale generation precondition: typed 409, not bytes.
            st, doc = _http(rep.url,
                            f"/admin/snapshot?file={entry['name']}"
                            f"&offset=0&length=64&generation=9")
            assert st == 409 and "superseded" in doc["error"]
        finally:
            rep.close()


# -- 2. boot-time install (blank directory) ---------------------------------


class TestInstallSnapshot:
    def test_blank_dir_install_is_bootable(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        src_root = _artifact(model, tmp_path, "src")
        rep = _Replica(model, src_root, mutable=True)
        blank = tmp_path / "blank"
        try:
            assert not bootstrap.artifact_present(blank)
            doc = bootstrap.install_snapshot(blank, rep.url)
            assert doc["folded_seq"] == 0 and doc["bytes"] > 0
            assert bootstrap.artifact_present(blank)
            base_dir, current = artifact.resolve_mutable_base(blank)
            assert current["base"].startswith("generations/")
            loaded = artifact.load_index(base_dir)
            eng = MutableEngine(loaded, blank, delta_cap=64,
                                current=current, base_dir=base_dir)
            try:
                assert eng.seq == 0  # the WAL cursor the shipper resumes at
            finally:
                eng.close()
        finally:
            rep.close()

    def test_fault_point_leaves_blank_dir_blank(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        rep = _Replica(model, _artifact(model, tmp_path, "src"),
                       mutable=True)
        blank = tmp_path / "blank2"
        try:
            with faults.inject("fleet.snapshot_ship=once") as plan:
                with pytest.raises(OSError, match="injected"):
                    bootstrap.install_snapshot(blank, rep.url)
            assert plan.stats()["fleet.snapshot_ship"]["fired"] == 1
            assert not bootstrap.artifact_present(blank)
            assert not list(blank.glob(".bootstrap-*"))  # staging removed
        finally:
            rep.close()

    def test_torn_chunk_and_digest_mismatch_are_typed(self, rng, tmp_path,
                                                      monkeypatch):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        rep = _Replica(model, _artifact(model, tmp_path, "src"),
                       mutable=True)
        blank = tmp_path / "blank3"
        real = bootstrap.forward_bytes
        try:
            def torn(method, url, body, timeout):
                status, data = real(method, url, body, timeout=timeout)
                return status, data[:-1]  # one byte short of the range

            monkeypatch.setattr(bootstrap, "forward_bytes", torn)
            with pytest.raises(SnapshotInstallError, match="torn chunk"):
                bootstrap.download_snapshot(rep.url, blank)
            assert not list(blank.glob(".bootstrap-*"))

            def corrupt(method, url, body, timeout):
                status, data = real(method, url, body, timeout=timeout)
                return status, bytes(len(data))  # right size, wrong bytes

            monkeypatch.setattr(bootstrap, "forward_bytes", corrupt)
            with pytest.raises(SnapshotInstallError,
                               match="digest mismatch"):
                bootstrap.download_snapshot(rep.url, blank)
            assert not list(blank.glob(".bootstrap-*"))
        finally:
            rep.close()


# -- 3. in-process re-seed + parked-shipper resume ---------------------------


class TestInProcessBootstrap:
    def test_primary_refuses_to_bootstrap_itself(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        rep = _Replica(model, _artifact(model, tmp_path, "p"),
                       mutable=True,
                       replicate_to=["http://127.0.0.1:9"],
                       replicate_ack="none")
        try:
            st, doc = _http(rep.url, "/admin/bootstrap",
                            {"from": "http://127.0.0.1:9"})
            assert st == 409 and "SOURCE" in doc["error"]
        finally:
            rep.close()

    def test_install_failure_leaves_prior_state_serving(self, rng,
                                                        tmp_path, obs_on):
        """The mid-transfer failure leg: the ``fleet.snapshot_ship``
        fault fires between verify and commit — the 502 carries
        ``prior_state_serving`` and the target's own lineage (model,
        version, WAL) is untouched."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        src = _Replica(model, _artifact(model, tmp_path, "src"),
                       mutable=True)
        tgt = _Replica(model, _artifact(model, tmp_path, "tgt"),
                       mutable=True)
        try:
            tgt.app.mutable.apply_insert(
                np.ones((1, 4), np.float32), [0], 0)
            before_seq = tgt.app.mutable.seq
            before_version = tgt.app.index_version
            with faults.inject("fleet.snapshot_ship=once"):
                st, doc = _http(tgt.url, "/admin/bootstrap",
                                {"from": src.url})
            assert st == 502 and doc["prior_state_serving"] is True
            assert tgt.app.mutable.seq == before_seq
            assert tgt.app.index_version == before_version
            st, doc = _http(tgt.url, "/predict",
                            {"instances": [[1.0, 0.0, 1.0, 2.0]]})
            assert st == 200 and len(doc["predictions"]) == 1
            # The abandoned staging dir is gone; the lineage's WAL is not.
            assert not list(tgt.app.mutable.root.glob(".bootstrap-*"))
            assert artifact.list_epochs(tgt.app.mutable.root)
        finally:
            src.close()
            tgt.close()

    def test_diverged_follower_recovers_and_shipper_resumes(
            self, rng, tmp_path, obs_on, monkeypatch):
        """The tentpole end to end, in process: a follower with a
        divergent record at the same seq parks the primary's shipper as
        ``diverged`` (typed — never a divergent answer shipped onward);
        ``POST /admin/bootstrap`` re-seeds it from the primary's
        snapshot; the parked shipper's re-probe then resyncs and resumes
        WITHOUT a primary restart."""
        from knn_tpu_torch.fleet import replica as replica_mod

        monkeypatch.setattr(replica_mod, "TERMINAL_RETRY_S", 0.2)
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        follower = _Replica(model, _artifact(model, tmp_path, "f"),
                            mutable=True,
                            follower_of="http://127.0.0.1:9")
        primary = _Replica(model, _artifact(model, tmp_path, "p"),
                           mutable=True, replicate_to=[follower.url],
                           replicate_ack="none")
        try:
            # Divergence: the follower holds seq 1 with DIFFERENT content
            # than the primary's seq 1 (a partitioned ex-primary's
            # unreplicated tail, in miniature).
            follower.app.mutable.apply_insert(
                np.full((1, 4), 9.0, np.float32), [2], 0)
            st, doc = _http(primary.url, "/insert",
                            {"rows": [[1.0, 1.0, 1.0, 1.0]],
                             "labels": [0]})
            assert st == 200

            def shipper_state():
                return primary.app.fleet.export()["followers"][
                    follower.url]["state"]

            deadline = time.monotonic() + 10
            while (shipper_state() != "diverged"
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert shipper_state() == "diverged"

            # Out-of-band re-seed (what the router's auto path drives).
            st, doc = _http(follower.url, "/admin/bootstrap",
                            {"from": primary.url})
            assert st == 200 and doc["bootstrapped"] is True
            # The abandoned lineage's RECORDS are gone (the reseed opens
            # a fresh empty epoch) — its divergent record can never
            # replay onto the new base.
            for _n, path in artifact.list_epochs(
                    follower.app.mutable.root):
                records, _torn = artifact.read_epoch_records(
                    path, tolerate_torn=True)
                assert records == []

            # The parked shipper re-probes (0.2s here) and resumes: the
            # primary's seq-1 record applies cleanly on the re-seeded
            # follower. No primary restart happened.
            deadline = time.monotonic() + 10
            while (shipper_state() != "ok"
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert shipper_state() == "ok"
            assert follower.app.mutable.seq == primary.app.mutable.seq
            # The shipper-state gauge is exported for the follower.
            gauges = {i.name for i in obs.registry().instruments()}
            assert "knn_fleet_shipper_state" in gauges
        finally:
            primary.close()
            follower.close()


# -- 4. router-driven re-seed ------------------------------------------------


class TestRouterBootstrap:
    def _diverged_pair(self, rng, tmp_path):
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        follower = _Replica(model, _artifact(model, tmp_path, "f"),
                            mutable=True,
                            follower_of="http://127.0.0.1:9")
        primary = _Replica(model, _artifact(model, tmp_path, "p"),
                           mutable=True, replicate_to=[follower.url],
                           replicate_ack="none")
        # Same seq, different content: the divergence drill in miniature.
        follower.app.mutable.apply_insert(
            np.full((1, 4), 9.0, np.float32), [2], 0)
        primary.app.mutable.apply_insert(
            np.ones((1, 4), np.float32), [0], 0)
        return primary, follower

    def _wait(self, cond, timeout=10.0):
        deadline = time.monotonic() + timeout
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert cond()

    def test_manual_bootstrap_route_reseeds_and_audits(
            self, rng, tmp_path, obs_on, monkeypatch):
        from knn_tpu_torch.fleet import replica as replica_mod
        from knn_tpu_torch.fleet.router import RouterApp

        monkeypatch.setattr(replica_mod, "TERMINAL_RETRY_S", 0.2)
        primary, follower = self._diverged_pair(rng, tmp_path)
        app = RouterApp([primary.url, follower.url],
                        health_interval_s=0.1, event_log=True)
        try:
            def parked():
                f = app.set.state(primary.url).followers or {}
                return (f.get(follower.url) or {}).get(
                    "state") == "diverged"

            self._wait(parked)
            # The shipper state is joined into the router's health doc
            # (and therefore /debug/fleet) via the primary's healthz.
            h = app.health()
            assert h["replicas"][primary.url]["followers"][
                follower.url]["state"] == "diverged"
            result = app.bootstrap()  # no follower named: picks the
            assert result["status"] == 200  # parked one
            assert result["body"]["replica"] == follower.url
            assert [e["event"] for e in app.events.recent()
                    if e["event"].startswith("reseed")] == [
                "reseed-begin", "reseed-complete"]
            self._wait(lambda: primary.app.fleet.export()["followers"][
                follower.url]["state"] == "ok")
            assert (follower.app.mutable.seq
                    == primary.app.mutable.seq)
        finally:
            app.close()
            primary.close()
            follower.close()

    def test_auto_failover_flag_drives_the_reseed(self, rng, tmp_path,
                                                  obs_on, monkeypatch):
        """The self-healing loop end to end: ``--auto-failover`` alone —
        no operator call — notices the parked shipper on a health poll,
        drives the bootstrap, and the fleet converges."""
        from knn_tpu_torch.fleet import replica as replica_mod
        from knn_tpu_torch.fleet.router import RouterApp

        monkeypatch.setattr(replica_mod, "TERMINAL_RETRY_S", 0.2)
        primary, follower = self._diverged_pair(rng, tmp_path)
        app = RouterApp([primary.url, follower.url],
                        health_interval_s=0.1, auto_failover=True,
                        event_log=True)
        try:
            self._wait(lambda: primary.app.fleet.export()["followers"][
                follower.url]["state"] == "ok", timeout=15.0)
            assert (follower.app.mutable.seq
                    == primary.app.mutable.seq)
            done = app.events.find("reseed-complete")
            assert done and done[0]["trigger"] == "auto"
            assert app.reseeds == 1
        finally:
            app.close()
            primary.close()
            follower.close()


# -- 5. WAL retention floor --------------------------------------------------


class TestRetentionFloor:
    def _compactor(self, eng, model, floor):
        def swap(new_model, version, hook):
            hook()
            return version

        return Compactor(eng, swap=swap, warm=lambda m: None,
                         threshold=10_000, interval_s=0,
                         retention_floor=floor)

    def test_lagging_follower_holds_epochs_then_prunes(self, rng,
                                                       tmp_path, obs_on):
        """The silent-retention-hazard fix: a fold with a live follower
        cursor behind it defers epoch pruning (counted + surfaced), so
        ``records_since`` still serves the lagging cursor; once the
        follower catches up, the NEXT compaction's cleanup prunes what
        the floor released."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        root = _artifact(model, tmp_path, "idx")
        eng = MutableEngine(model, root, delta_cap=256)
        cursor = {"acked": 0}
        comp = self._compactor(eng, model, lambda: cursor["acked"])
        try:
            for v in range(3):
                eng.apply_insert(np.full((1, 4), float(v), np.float32),
                                 [v % 3], 0)
            out = comp.run_once(force=True)
            assert out["compacted"] and out["folded_seq"] == 3
            assert out["epochs_held"] >= 1 and out["epochs_pruned"] == 0
            assert out["retention_floor"] == 0
            held = [i for i in obs.registry().instruments()
                    if i.name == "knn_fleet_wal_retention_held_total"]
            assert held and held[0].value >= 1
            # The lagging cursor is still servable — gapless from seq 1.
            records, seq = eng.records_since(0)
            assert [r["seq"] for r in records] == [1, 2, 3] and seq == 3
            # Follower catches up; the next fold's cleanup prunes.
            eng.apply_insert(np.full((1, 4), 7.0, np.float32), [1], 0)
            cursor["acked"] = eng.seq
            out = comp.run_once(force=True)
            assert out["compacted"] and out["epochs_pruned"] >= 1
            assert out["epochs_held"] == 0
        finally:
            comp.stop()
            eng.close()

    def test_slow_follower_never_parks_behind_fold(self, rng, tmp_path,
                                                   obs_on):
        """Pin the end-to-end hazard: a shipper whose cursor lags a
        compaction must go right on shipping from the retained epochs —
        'lagging' must never become 'terminally parked' merely because
        the primary compacted."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        follower = _Replica(model, _artifact(model, tmp_path, "f"),
                            mutable=True,
                            follower_of="http://127.0.0.1:9")
        root = _artifact(model, tmp_path, "p")
        eng = MutableEngine(model, root, delta_cap=256)
        fleet = FleetReplica(eng, role="primary",
                             replicate_to=[follower.url],
                             ship_interval_s=0.02, ack_mode="none")
        comp = self._compactor(eng, model, fleet.retention_floor)
        try:
            # Park the WIRE, not the protocol: with the follower's
            # listener down, the shipper stays 'unreachable' (live — it
            # holds the floor) while the primary writes and compacts.
            follower.server.shutdown()
            follower.server.server_close()
            for v in range(4):
                eng.apply_insert(np.full((1, 4), float(v), np.float32),
                                 [v % 3], 0)
            out = comp.run_once(force=True)
            assert out["compacted"] and out["epochs_held"] >= 1
            assert out["retention_floor"] == 0
            state = fleet.export()["followers"][follower.url]["state"]
            assert state in ("ok", "unreachable")  # NEVER behind_fold
            # The records a catch-up needs survived the fold.
            records, _ = eng.records_since(0)
            assert [r["seq"] for r in records] == [1, 2, 3, 4]
        finally:
            comp.stop()
            fleet.close()
            eng.close()
            follower.app.close()

    def test_router_audits_the_retention_hold(self, rng, tmp_path,
                                              obs_on):
        """A coordinated compaction whose verdict reports held epochs
        lands an ``epoch-retention-hold`` event in the router's audit
        log — 'why is the primary's disk growing' joins to the follower
        holding the floor."""
        from knn_tpu_torch.fleet.router import RouterApp

        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        p = _Replica(model, _artifact(model, tmp_path, "p"),
                     mutable=True,
                     replicate_to=["http://127.0.0.1:9"],
                     replicate_ack="none")
        app = RouterApp([p.url], health_interval_s=0.1, event_log=True)
        try:
            for v in range(3):
                p.app.mutable.apply_insert(
                    np.full((1, 4), float(v), np.float32), [0], 0)
            result = app.coordinated_compact()
            assert result["status"] == 200
            assert result["body"]["epochs_held"] >= 1
            holds = app.events.find("epoch-retention-hold")
            assert holds and holds[0]["retention_floor"] == 0
        finally:
            app.close()
            p.close()

    def test_parked_shippers_do_not_pin_the_log(self, rng, tmp_path):
        """A diverged/behind-fold shipper recovers via bootstrap, not the
        WAL — the floor excludes it, else one dead follower would hold
        every epoch forever."""
        model = KNNClassifier(k=3, engine="xla", device="cpu").fit(_problem(rng))
        root = _artifact(model, tmp_path, "idx")
        eng = MutableEngine(model, root, delta_cap=256)
        fleet = FleetReplica(eng, role="primary",
                             replicate_to=["http://127.0.0.1:9"],
                             ack_mode="none")
        try:
            shipper = fleet._shippers["http://127.0.0.1:9"]
            shipper.state = "diverged"
            assert fleet.retention_floor() is None
            shipper.state = "ok"
            assert fleet.retention_floor() == 0
        finally:
            fleet.close()
            eng.close()
