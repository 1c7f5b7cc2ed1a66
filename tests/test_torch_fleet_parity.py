"""The fleet across the packages, on the CPU: a mixed replica set of the
JAX package's serve processes (``knn_tpu.serve.server.ServeApp``) and the
port's (``knn_tpu_torch``, ``device="cpu"``), in one process.

- **Replication both ways**: a JAX primary ships to a port follower and a
  port primary to a JAX follower. After the same seeded inserts and
  deletes, all four answer ``/kneighbors`` and ``/predict`` with equal
  indices and predictions (distances bit-equal: integer grids), and their
  epoch files are byte-equal.
- **Bootstrap both ways**: a blank port directory installs a JAX primary's
  compacted generation over ``/admin/snapshot`` (and the reverse), with
  equal ``snapshot_manifest`` digests, then serves the primary's answers;
  a running port follower re-seeds from a JAX primary through ``POST
  /admin/bootstrap``.
- **Routing both ways**: the port's router and JAX's, each in front of the
  same JAX replicas (and of port replicas), give the same routed answers
  and the same typed statuses and bodies (409 conflict, 503 no primary,
  503 zero usable).
- **The autoscaler**: both routers, with ``scale_cmd`` set to a recording
  script, in front of the same stub replicas that report the same
  capacity under the same offered load, run ``CMD down URL`` and ``CMD up
  URL`` for the same URLs in the same order and write the same events.
"""

import json
import shutil
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from knn_tpu import obs as jobs
from knn_tpu.data.dataset import Dataset as JDataset
from knn_tpu.fleet import bootstrap as jbootstrap
from knn_tpu.fleet.router import RouterApp as JRouterApp
from knn_tpu.fleet.router import make_router_server as jmake_router_server
from knn_tpu.models.knn import KNNClassifier as JKNNClassifier
from knn_tpu.serve import artifact as jartifact
from knn_tpu.serve.server import ServeApp as JServeApp
from knn_tpu.serve.server import make_server as jmake_server
from knn_tpu_torch import obs
from knn_tpu_torch.fleet import bootstrap
from knn_tpu_torch.fleet.router import RouterApp, make_router_server
from knn_tpu_torch.serve import artifact
from knn_tpu_torch.serve.server import ServeApp, make_server
from tests.test_torch_fleet import _http

N, D, C, K = 80, 4, 3, 3


@pytest.fixture
def obs_both():
    was, jwas = obs.enabled(), jobs.enabled()
    obs.enable()
    jobs.enable()
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()
    if not was:
        obs.disable()
    if not jwas:
        jobs.disable()


@pytest.fixture
def index(tmp_path):
    """One JAX-written artifact (the shared format 3); each replica serves
    a byte-identical copy, so every replica carries one index_version."""
    rng = np.random.default_rng(15)
    x = rng.integers(0, 4, (N, D)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    src = tmp_path / "src"
    jartifact.save_index(JKNNClassifier(k=K, engine="xla").fit(
        JDataset(x, y)), src)
    return src


class _Replica:
    """One in-process serve replica of either package over a copy of the
    index (no warmup; ready flipped by hand)."""

    def __init__(self, pkg, src, root, **kw):
        if not root.exists():
            shutil.copytree(src, root)
        if pkg == "jax":
            base, cur = jartifact.resolve_mutable_base(root)
            model = jartifact.load_index(base)
            app_cls, make = JServeApp, jmake_server
        else:
            base, cur = artifact.resolve_mutable_base(root)
            model = artifact.load_index(base, device="cpu")
            app_cls, make = ServeApp, make_server
        self.root = root
        self.app = app_cls(model, max_batch=8, max_wait_ms=0.2,
                           index_path=str(root), mutable=True,
                           mutable_current=cur, mutable_base_dir=base,
                           compact_interval_s=0.0, **kw)
        self.server = make(self.app)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.app.ready = True
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}"

    def kill(self):
        self.server.shutdown()
        self.server.server_close()

    def close(self):
        self.kill()
        self.app.close()


def _writes(rng):
    """Seeded inserts and deletes (positional ids of the base rows and of
    the first inserted rows)."""
    ops = []
    for j in range(6):
        rows = rng.integers(0, 4, (2, D)).astype(float).tolist()
        ops.append(("/insert", {"rows": rows,
                                "labels": [int(j % C), int((j + 1) % C)]}))
        if j % 2:
            ops.append(("/delete", {"ids": [3 * j, N + j]}))
    return ops


def _answers(url, queries):
    st, kn = _http(url, "/kneighbors", {"instances": queries})
    st2, pr = _http(url, "/predict", {"instances": queries})
    assert st == st2 == 200, (kn, pr)
    return kn["indices"], kn["distances"], pr["predictions"], \
        kn["mutation_seq"]


def _epoch_bytes(root):
    return [p.read_bytes() for _n, p in artifact.list_epochs(root)]


class TestMixedReplication:
    def test_both_directions_answer_equal_and_wal_byte_equal(
            self, index, tmp_path, obs_both):
        ft = _Replica("torch", index, tmp_path / "ft",
                      follower_of="http://127.0.0.1:9")
        pj = _Replica("jax", index, tmp_path / "pj", replicate_to=[ft.url])
        fj = _Replica("jax", index, tmp_path / "fj",
                      follower_of="http://127.0.0.1:9")
        pt = _Replica("torch", index, tmp_path / "pt",
                      replicate_to=[fj.url])
        reps = (pj, ft, pt, fj)
        try:
            for primary, follower in ((pj, ft), (pt, fj)):
                for path, body in _writes(np.random.default_rng(3)):
                    st, doc = _http(primary.url, path, body)
                    assert st == 200, doc
                    # Semi-synchronous: the follower holds it already.
                    assert follower.app.mutable.seq == doc["seq"]
            queries = np.random.default_rng(4).integers(
                0, 4, (12, D)).astype(float).tolist()
            want = _answers(pj.url, queries)
            assert want[3] == 9
            for rep in reps[1:]:
                assert _answers(rep.url, queries) == want, rep.url
            for pkg_follower in (ft, fj):
                h = _http(pkg_follower.url, "/healthz")[1]
                assert h["fleet"]["role"] == "follower"
                assert h["fleet"]["applied_seq"] == 9
            ship = _http(pt.url, "/healthz")[1]["fleet"]["followers"]
            jship = _http(pj.url, "/healthz")[1]["fleet"]["followers"]
            assert ship[fj.url]["acked_seq"] == jship[ft.url]["acked_seq"]
            assert ship[fj.url]["state"] == jship[ft.url]["state"] == "ok"
        finally:
            for rep in reps:
                rep.close()
        epochs = [_epoch_bytes(rep.root) for rep in reps]
        assert epochs[0] and all(e == epochs[0] for e in epochs)

    def test_gap_and_divergence_bodies_equal(self, index, tmp_path,
                                             obs_both):
        ft = _Replica("torch", index, tmp_path / "ft",
                      follower_of="http://127.0.0.1:9")
        fj = _Replica("jax", index, tmp_path / "fj",
                      follower_of="http://127.0.0.1:9")
        rec = {"seq": 1, "op": "insert", "sid0": N, "rows": [[1.0] * D],
               "values": [1]}
        try:
            for body in ({"records": [{**rec, "seq": 5}]},
                         {"records": [rec]},
                         {"records": [{**rec, "values": [2]}]},
                         {"records": []},
                         {"records": [{"seq": 2, "op": "delete",
                                       "sids": [12345]}]}):
                got = _http(ft.url, "/admin/wal-append", body)
                want = _http(fj.url, "/admin/wal-append", body)
                assert got[0] == want[0], (body, got, want)
                assert set(got[1]) == set(want[1])
                for key in ("applied_seq", "diverged", "applied"):
                    assert got[1].get(key) == want[1].get(key), key
            for path in ("/insert", "/delete"):
                got = _http(ft.url, path, {"ids": [0]})
                want = _http(fj.url, path, {"ids": [0]})
                assert got[0] == want[0] == 409
                assert got[1]["error"] == want[1]["error"]
        finally:
            ft.close()
            fj.close()


class TestMixedBootstrap:
    def _compacted_primary(self, pkg, index, tmp_path, name):
        p = _Replica(pkg, index, tmp_path / name,
                     replicate_to=["http://127.0.0.1:9"],
                     replicate_ack="none")
        for path, body in _writes(np.random.default_rng(5))[:4]:
            assert _http(p.url, path, body)[0] == 200
        assert p.app.compactor.run_once(force=True)["compacted"]
        st, doc = _http(p.url, "/insert", {"rows": [[3.0] * D],
                                           "labels": [2]})
        assert st == 200
        return p

    @pytest.mark.parametrize("source,target", [("jax", "torch"),
                                               ("torch", "jax")])
    def test_blank_directory_installs_the_other_packages_snapshot(
            self, index, tmp_path, obs_both, source, target):
        p = self._compacted_primary(source, index, tmp_path, "p")
        blank = tmp_path / "blank"
        install = (bootstrap if target == "torch" else jbootstrap)
        man_of = {"torch": bootstrap.snapshot_manifest,
                  "jax": jbootstrap.snapshot_manifest}
        try:
            doc = install.install_snapshot(blank, p.url)
            assert doc["generation"] == 1 and doc["folded_seq"] == 4
            want = man_of[source](p.root)
            for pkg in ("torch", "jax"):
                got = man_of[pkg](blank)
                assert got["files"] == want["files"], pkg
                assert got["generation"] == want["generation"]
                assert got["wal_cursor"] == want["wal_cursor"]
            st, wire = _http(p.url, "/admin/snapshot")
            assert st == 200 and wire == want
            f = _Replica(target, index, blank, follower_of=p.url)
            try:
                # A shipper to the new follower starts at the fold point:
                # it catches up to the primary's seq through wal-append.
                p.app.fleet._start_shipper(f.url)
                deadline = time.monotonic() + 10
                while (f.app.mutable.seq < p.app.mutable.seq
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                queries = np.random.default_rng(6).integers(
                    0, 4, (8, D)).astype(float).tolist()
                assert _answers(f.url, queries) == _answers(p.url, queries)
            finally:
                f.close()
        finally:
            p.close()

    def test_running_port_follower_reseeds_from_a_jax_primary(
            self, index, tmp_path, obs_both):
        p = self._compacted_primary("jax", index, tmp_path, "p")
        f = _Replica("torch", index, tmp_path / "f",
                     follower_of=p.url)
        try:
            st, doc = _http(f.url, "/admin/bootstrap", {"from": p.url})
            assert st == 200 and doc["bootstrapped"] is True
            assert doc["generation"] == 1 and doc["folded_seq"] == 4
            assert f.app.mutable.seq == 4
            assert (bootstrap.snapshot_manifest(f.root)["files"]
                    == jbootstrap.snapshot_manifest(p.root)["files"])
            queries = np.random.default_rng(7).integers(
                0, 4, (8, D)).astype(float).tolist()
            want = _answers(p.url, queries)
            got = _answers(f.url, queries)
            # The primary is one write past its fold point; the re-seeded
            # follower is at the fold until the shipper catches it up.
            p.app.fleet._start_shipper(f.url)
            deadline = time.monotonic() + 10
            while f.app.mutable.seq < 5 and time.monotonic() < deadline:
                time.sleep(0.02)
            got = _answers(f.url, queries)
            assert got == want
        finally:
            f.close()
            p.close()


def _router(cls, make, urls, **kw):
    kw.setdefault("health_interval_s", 3600.0)
    app = cls(urls, **kw)
    server = make(app)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return app, server, f"http://{host}:{port}"


def _strip(doc):
    return {k: v for k, v in doc.items() if k not in ("ms", "request_id")}


class TestRouterParity:
    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_same_answers_and_typed_statuses(self, index, tmp_path,
                                             obs_both, pkg):
        f = _Replica(pkg, index, tmp_path / "f",
                     follower_of="http://127.0.0.1:9",
                     replicate_ack="none")
        p = _Replica(pkg, index, tmp_path / "p", replicate_to=[f.url])
        routers = [_router(RouterApp, make_router_server, [f.url, p.url]),
                   _router(JRouterApp, jmake_router_server,
                           [f.url, p.url])]
        queries = np.random.default_rng(8).integers(
            0, 4, (3, D)).astype(float).tolist()
        try:
            for _app, _srv, url in routers:
                st, doc = _http(url, "/insert", {"rows": [[1.0] * D],
                                                 "labels": [0]})
                assert st == 200 and set(doc) >= {"seq", "ids", "epoch"}
            got = [[_strip(_http(url, path, {"instances": queries})[1])
                    for path in ("/kneighbors", "/predict")]
                   for _a, _s, url in routers]
            assert got[0] == got[1] and got[0][0]["mutation_seq"] == 2
            # 409: a conflict at the primary passes through unchanged.
            codes = [_http(url, "/delete", {"ids": [10 ** 6]})
                     for _a, _s, url in routers]
            assert codes[0][0] == codes[1][0] == 409
            assert codes[0][1]["error"] == codes[1][1]["error"]
            # 503: no usable primary.
            p.kill()
            for app, _s, _u in routers:
                app.set.poll_once()
            codes = [_http(url, "/insert", {"rows": [[1.0] * D],
                                            "labels": [0]})
                     for _a, _s, url in routers]
            assert codes[0][0] == codes[1][0] == 503
            assert codes[0][1] == codes[1][1]
            # 503: zero usable replicas for a read.
            f.kill()
            for app, _s, _u in routers:
                app.set.poll_once()
            codes = [_http(url, "/kneighbors", {"instances": queries})
                     for _a, _s, url in routers]
            assert codes[0][0] == codes[1][0] == 503
            assert codes[0][1]["error"] == codes[1][1]["error"]
            assert set(codes[0][1]["replicas"]) == set(codes[1][1][
                "replicas"])
            healths = [_http(url, "/healthz") for _a, _s, url in routers]
            assert healths[0][0] == healths[1][0] == 503
        finally:
            for app, srv, _u in routers:
                srv.shutdown()
                srv.server_close()
                app.close()
            p.app.close()
            f.app.close()


class _Stub(BaseHTTPRequestHandler):
    """A replica that reports a fixed capacity and answers every read."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _reply(self, doc):
        raw = json.dumps(doc).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):  # noqa: N802 — stdlib dispatch name
        self._reply({"ready": True, "draining": False,
                     "index_version": "v0",
                     "capacity": {"sustainable_qps": 1.0}})

    def do_POST(self):  # noqa: N802 — stdlib dispatch name
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self._reply({"predictions": [0]})


_RECORD = """import sys
with open(sys.argv[1], "a") as f:
    f.write(" ".join(sys.argv[2:]) + "\\n")
"""


class TestAutoscaleParity:
    def test_same_commands_same_order_same_events(self, tmp_path,
                                                  obs_both):
        stubs = []
        for _ in range(2):
            s = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
            s.daemon_threads = True
            threading.Thread(target=s.serve_forever, daemon=True).start()
            stubs.append(s)
        urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in stubs]
        urls.append("http://127.0.0.1:9")  # a registered, down slot
        script = tmp_path / "record.py"
        script.write_text(_RECORD)
        runs = {}
        try:
            for name, cls in (("torch", RouterApp), ("jax", JRouterApp)):
                out = tmp_path / f"{name}.txt"
                cmd = f"{sys.executable} {script} {out}"
                # The boot poll sees 2 usable replicas of 1 QPS each and no
                # load: scale the last non-primary down. Then 60 reads in
                # the 30 s window (2 QPS > 0.8 x 2): scale the down slot up.
                app = cls(urls, health_interval_s=3600.0, scale_cmd=cmd,
                          scale_cooldown_s=0.3, event_log=True)
                try:
                    self._wait(app, 1)
                    for _ in range(60):
                        st, _doc, _ = app.forward_read(
                            "/predict", b'{"instances": [[0, 0, 0, 0]]}',
                            {"Content-Type": "application/json"})
                        assert st == 200
                    time.sleep(0.35)  # past the cooldown
                    app.set.poll_once()
                    self._wait(app, 2)
                    events = [{k: v for k, v in e.items() if k != "ts"}
                              for e in app.events.recent()
                              if e["event"].startswith("scale-")]
                finally:
                    app.close()
                runs[name] = (out.read_text().splitlines(), events)
        finally:
            for s in stubs:
                s.shutdown()
                s.server_close()
        assert runs["torch"] == runs["jax"]
        lines, events = runs["torch"]
        assert lines == [f"down {urls[1]}", f"up {urls[2]}"]
        assert [e["event"] for e in events] == [
            "scale-down-begin", "scale-down-complete",
            "scale-up-begin", "scale-up-complete"]

    @staticmethod
    def _wait(app, n, timeout=20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done = [e for e in app.events.recent()
                    if e["event"].endswith("-complete")
                    or e["event"].endswith("-failed")]
            if len(done) >= n and not app._scale_inflight:
                return
            time.sleep(0.02)
        raise AssertionError(f"{n} scale operations did not finish")
