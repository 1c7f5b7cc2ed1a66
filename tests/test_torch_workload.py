"""Workload capture and replay on the port (the twin of
``tests/test_workload.py``, less its mutable-tier, what-if and ARFF-warning
cases, which belong to ROADMAP A10 and A12), against the JAX package's, on
the CPU.

The enforced promises: the workload artifact round-trips exactly and
refuses corruption typed (``DataError``); the capture tap sheds under
overload and never blocks the producer; the burn trigger arms a window and
the window auto-finalizes; replay is deterministic — a capture replayed
against the same serving state verifies bit-identical, twice — and the
``replay`` subcommand drives it. Between the packages:

- ``answer_digest`` is equal, and a workload captured by either package
  loads in the other with the same ``schema_hash``;
- on an integer grid, a JAX-captured workload replays through the port's
  batcher (``verify="always"``) with zero divergences;
- the committed ``tests/data/replay-workload`` (captured by JAX) replays
  through the port with 120 ok: every ``predict`` digest matches, and
  every ``kneighbors`` row has JAX's indices with distances within
  ``rtol = d * 2^-24`` (the two sum the features in different orders,
  so those digests are environment-pinned, ``tests/data/README.md``);
- ``/debug/capture`` and ``POST /admin/capture`` answer as JAX's do
  (start, stop, 404 while off, 409 on a contradiction).
"""

import io
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from knn_tpu.models.knn import KNNClassifier as JKNNClassifier  # noqa: E402
from knn_tpu.obs import workload as jworkload  # noqa: E402
from knn_tpu.serve.batcher import MicroBatcher as JMicroBatcher  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier  # noqa: E402
from knn_tpu_torch.obs.replay import replay_workload  # noqa: E402
from knn_tpu_torch.obs.reqtrace import FlightRecorder  # noqa: E402
from knn_tpu_torch.obs.workload import (  # noqa: E402
    CaptureStateError,
    WorkloadCapture,
    answer_digest,
    load_workload,
)
from knn_tpu_torch.resilience.errors import DataError  # noqa: E402
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401
from tests.test_torch_serve import Served, http_get, http_post  # noqa: E402

D = 6
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return (rng.normal(0, 2, (160, D)).astype(np.float32),
            rng.integers(0, 4, 160).astype(np.int32))


@pytest.fixture(scope="module")
def model(data):
    return KNNClassifier(k=3, **CPU).fit(Dataset(*data))


def _capture_some(model, tmp_path, n=12, version="v1", rate=1.0,
                  package="port", rows=None):
    """Capture ``n`` requests of 1-3 rows (every fourth a kneighbors)
    through ``package``'s batcher and WorkloadCapture; returns the stop
    summary."""
    rng = np.random.default_rng(3)
    cap_cls, b_cls = ((WorkloadCapture, MicroBatcher) if package == "port"
                      else (jworkload.WorkloadCapture, JMicroBatcher))
    cap = cap_cls(tmp_path / "captures", num_features=model.train_
                  .num_features, k=3, rate=rate,
                  policy={"max_batch": 8, "max_wait_ms": 0.5})
    batcher = b_cls(model, max_batch=8, max_wait_ms=0.5,
                    index_version=version, workload=cap)
    try:
        cap.start()
        futures = []
        for i in range(n):
            if rows is None:
                q = rng.normal(0, 2, (int(rng.integers(1, 4)), D)) \
                    .astype(np.float32)
            else:
                q = rows[i]
            kind = "kneighbors" if i % 4 == 0 else "predict"
            futures.append(batcher.submit(q, kind))
            time.sleep(0.002)
        for f in futures:
            f.result(timeout=30)
        assert cap.drain(20)
        summary = cap.stop()
    finally:
        batcher.close()
        cap.close()
    return summary


class TestArtifactRoundTrip:
    def test_round_trip(self, model, tmp_path):
        summary = _capture_some(model, tmp_path, n=12)
        assert summary["requests"] == 12
        wl = load_workload(summary["path"])
        assert wl.manifest["format"] == 1
        assert wl.manifest["num_features"] == D
        assert wl.manifest["policy"]["max_batch"] == 8
        assert len(wl.read_events) == 12
        assert wl.rows.dtype == np.float32 and wl.rows.shape[1] == D
        t_last, total = -1.0, 0
        for ev in wl.read_events:
            assert ev["t_ms"] >= t_last
            t_last = ev["t_ms"]
            assert ev["outcome"] == "ok" and ev["rung"] == "fast"
            assert ev["index_version"] == "v1"
            assert ev["digest"] and ev["ms"] > 0
            assert wl.rows_for(ev).shape == (ev["rows"], D)
            total += ev["rows"]
        assert total == wl.manifest["total_rows"]
        # The digest is transport-canonical: recomputed from a float64
        # JSON round trip of the answer, it matches.
        ev = next(e for e in wl.read_events if e["kind"] == "predict")
        preds = model.predict(Dataset(wl.rows_for(ev),
                                      np.zeros(ev["rows"], np.int32)))
        again = np.asarray(json.loads(json.dumps(
            np.asarray(preds, np.float64).tolist())))
        assert answer_digest("predict", again) == ev["digest"]

    def test_arrivals_and_summary(self, model, tmp_path):
        wl = load_workload(_capture_some(model, tmp_path, n=6)["path"])
        arr = wl.arrivals()
        assert len(arr) == 6 and all(r >= 1 for _t, r in arr)
        s = wl.captured_latency_summary()
        assert s["requests"] == 6 and s["ok"] == 6 and s["p50_ms"] > 0

    def test_answer_digest_equals_jax(self):
        rng = np.random.default_rng(5)
        d = rng.normal(size=(3, 4)).astype(np.float32)
        i = rng.integers(0, 99, (3, 4)).astype(np.int64)
        p = rng.integers(0, 5, 3).astype(np.int32)
        assert answer_digest("predict", p) == \
            jworkload.answer_digest("predict", p)
        assert answer_digest("kneighbors", (d, i)) == \
            jworkload.answer_digest("kneighbors", (d, i))
        # float64 from a JSON body hashes as the float32 it came from
        assert answer_digest("kneighbors", (d.astype(np.float64), i)) == \
            jworkload.answer_digest("kneighbors", (d, i))

    @pytest.mark.parametrize("captured_by", ["port", "jax"])
    def test_artifacts_load_both_ways(self, data, tmp_path, captured_by):
        """A workload captured by either package loads in the other with
        the same manifest, ``schema_hash``, events and rows."""
        model = (KNNClassifier(k=3, **CPU).fit(Dataset(*data))
                 if captured_by == "port"
                 else JKNNClassifier(k=3, engine="xla")
                 .fit(JDataset(*data)))
        path = _capture_some(model, tmp_path, n=8,
                             package=captured_by)["path"]
        wl, jwl = load_workload(path), jworkload.load_workload(path)
        assert wl.manifest == jwl.manifest
        assert wl.manifest["schema_hash"] == jwl.manifest["schema_hash"]
        assert wl.events == jwl.events
        np.testing.assert_array_equal(wl.rows, jwl.rows)
        assert wl.captured_latency_summary() == \
            jwl.captured_latency_summary()


class TestCorruptionRefusal:
    @pytest.fixture
    def artifact_dir(self, model, tmp_path):
        from pathlib import Path

        return Path(_capture_some(model, tmp_path, n=4)["path"])

    def test_missing_dir_typed(self, tmp_path):
        with pytest.raises(DataError, match="not found"):
            load_workload(tmp_path / "nope")

    def test_not_an_artifact_typed(self, tmp_path):
        (tmp_path / "junk").mkdir()
        with pytest.raises(DataError, match="not a workload artifact"):
            load_workload(tmp_path / "junk")

    def test_newer_format_refused(self, artifact_dir):
        mf = json.loads((artifact_dir / "manifest.json").read_text())
        mf["format"] = 99
        (artifact_dir / "manifest.json").write_text(json.dumps(mf))
        with pytest.raises(DataError, match="newer"):
            load_workload(artifact_dir)

    def test_edited_manifest_refused(self, artifact_dir):
        mf = json.loads((artifact_dir / "manifest.json").read_text())
        mf["num_features"] = D + 1  # schema lie
        (artifact_dir / "manifest.json").write_text(json.dumps(mf))
        with pytest.raises(DataError, match="schema hash"):
            load_workload(artifact_dir)
        with pytest.raises(jworkload.DataError, match="schema hash"):
            jworkload.load_workload(artifact_dir)

    def test_tampered_events_refused(self, artifact_dir):
        p = artifact_dir / "events.jsonl"
        p.write_text(p.read_text().replace('"outcome":"ok"',
                                           '"outcome":"no"', 1))
        with pytest.raises(DataError, match="schema hash"):
            load_workload(artifact_dir)

    def test_truncated_queries_refused(self, artifact_dir):
        p = artifact_dir / "queries.npz"
        p.write_bytes(p.read_bytes()[:40])
        with pytest.raises(DataError):
            load_workload(artifact_dir)


class _FakeReq:
    kind = "predict"
    rows = 1
    deadline_ns = None
    request_class = None
    trace = None
    meta: dict = {}
    features = np.zeros((1, D), np.float32)
    value = None

    def __init__(self):
        self.enqueued_ns = time.monotonic_ns()


class TestShedNeverBlocks:
    def test_full_queue_sheds_fast(self, tmp_path):
        cap = WorkloadCapture(tmp_path, num_features=D, queue_cap=4,
                              autostart=False)
        cap.start()
        t0 = time.monotonic()
        captured = sum(1 for _ in range(200)
                       if cap.note_request(_FakeReq(), "ok") is not None)
        elapsed = time.monotonic() - t0
        assert captured == 4  # the queue cap; everything else shed
        assert cap.export()["shed"] == 196
        assert elapsed < 1.0  # 200 offers, no blocking anywhere
        cap._queue.start()  # let close() drain cleanly
        cap.close()

    def test_mutation_shed_marks_stream_incomplete(self, tmp_path):
        cap = WorkloadCapture(tmp_path, num_features=D, queue_cap=1,
                              autostart=False)
        cap.start()
        for _ in range(3):
            cap.note_mutation("delete", {"ids": [1]}, seq=1,
                              enqueued_ns=time.monotonic_ns())
        cap._queue.start()
        assert cap.drain(10)
        summary = cap.stop()
        cap.close()
        wl = load_workload(summary["path"])
        assert wl.manifest["mutations"] == 1
        assert wl.manifest["mutation_stream_complete"] is False

    def test_refused_admissions_are_captured(self, model, tmp_path):
        """A 429 is still workload: the batcher's refused admission is
        offered with outcome ``rejected``."""
        cap = WorkloadCapture(tmp_path, num_features=D)
        b = MicroBatcher(model, max_batch=1, max_wait_ms=0.0,
                         max_queue_rows=1, workload=cap)
        try:
            cap.start()
            b.begin_drain()  # every admission is refused from here
            with pytest.raises(Exception, match="draining"):
                b.submit(np.zeros(D, np.float32))
            assert cap.drain(10)
            summary = cap.stop()
        finally:
            b.close()
            cap.close()
        ev = load_workload(summary["path"]).read_events
        assert [e["outcome"] for e in ev] == ["rejected"]
        assert "digest" not in ev[0]


class TestBurnTrigger:
    def test_burn_arms_and_window_finalizes(self, model, tmp_path):
        from knn_tpu_torch.obs.slo import SLOTracker

        slo = SLOTracker(windows_s=(1, 2))
        cap = WorkloadCapture(
            tmp_path, num_features=D, slo=slo, burn_threshold=2.0,
            burn_objective="availability", burn_window_s=0.05,
            burn_check_interval_s=0.0,
        )
        batcher = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                               index_version="v1", workload=cap)
        try:
            batcher.predict(np.zeros(D, np.float32), timeout=30)
            assert cap.capturing is False
            for _ in range(50):
                slo.record(False, 1.0)
            batcher.predict(np.zeros(D, np.float32), timeout=30)
            assert cap.capturing is True
            assert cap.export()["reason"] == "burn:availability"
            batcher.predict(np.zeros(D, np.float32), timeout=30)
            time.sleep(0.08)
            batcher.predict(np.zeros(D, np.float32), timeout=30)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                status = cap.export()
                if not status["capturing"] and status["last"]:
                    break
                time.sleep(0.01)
            assert status["capturing"] is False
            assert status["last"]["reason"] == "burn:availability"
            assert status["last"]["stop_reason"] == "window_elapsed"
            assert status["last"]["requests"] >= 1
            load_workload(status["last"]["path"])  # validates
        finally:
            batcher.close()
            cap.close()

    def test_timed_window_finalizes_without_traffic(self, tmp_path):
        cap = WorkloadCapture(tmp_path, num_features=D)
        cap.start(window_s=0.02)
        time.sleep(0.05)
        status = cap.export()
        assert status["capturing"] is False
        assert status["last"]["stop_reason"] == "window_elapsed"
        load_workload(status["last"]["path"])  # validates
        cap.close()

    def test_record_ids_monotonic_across_windows(self, model, tmp_path):
        wl1 = load_workload(_capture_some(model, tmp_path, n=3)["path"])
        assert {e["id"] for e in wl1.events} == {0, 1, 2}
        cap = WorkloadCapture(tmp_path / "w3", num_features=D)
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0, workload=cap)
        try:
            cap.start()
            b.predict(np.zeros(D, np.float32), timeout=30)
            assert cap.drain(20)
            cap.stop()
            cap.start()
            b.predict(np.zeros(D, np.float32), timeout=30)
            assert cap.drain(20)
            second = cap.stop()
        finally:
            b.close()
            cap.close()
        assert load_workload(second["path"]).events[0]["id"] == 1

    def test_start_stop_state_errors(self, tmp_path):
        cap = WorkloadCapture(tmp_path, num_features=D)
        with pytest.raises(CaptureStateError):
            cap.stop()
        cap.start()
        with pytest.raises(CaptureStateError):
            cap.start()
        cap.stop()
        cap.close()

    def test_validation(self, tmp_path):
        for kw, match in (({"rate": 0.0}, "capture rate"),
                          ({"max_requests": 0}, "max_requests"),
                          ({"burn_threshold": 0.0}, "burn_threshold"),
                          ({"burn_window_s": 0.0}, "burn_window_s")):
            with pytest.raises(ValueError, match=match):
                WorkloadCapture(tmp_path, num_features=D, autostart=False,
                                **kw)


class TestReplayDeterminism:
    def test_capture_replays_bit_identical_twice(self, model, tmp_path):
        wl = load_workload(
            _capture_some(model, tmp_path, n=10, version="vX")["path"])
        for _round in range(2):
            b = MicroBatcher(model, max_batch=8, max_wait_ms=0.5,
                             index_version="vX")
            try:
                v = replay_workload(wl, batcher=b, speed=0.0, verify="tag")
            finally:
                b.close()
            assert v["measured"]["errors"] == 0
            assert v["verify"]["divergences"] == 0
            assert v["verify"]["verified"] == 10
            assert v["verify"]["skipped_tag_mismatch"] == 0

    def test_version_mismatch_skips_never_diverges(self, model, tmp_path):
        wl = load_workload(
            _capture_some(model, tmp_path, n=5, version="vX")["path"])
        for verify, key in (("tag", "skipped_tag_mismatch"),
                            ("always", "verified")):
            b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                             index_version="OTHER")
            try:
                v = replay_workload(wl, batcher=b, speed=0.0, verify=verify)
            finally:
                b.close()
            assert v["verify"][key] == 5
            assert v["verify"]["divergences"] == 0

    def test_divergence_detected(self, model, tmp_path):
        wl = load_workload(
            _capture_some(model, tmp_path, n=5, version="vX")["path"])
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                         index_version="vX")
        b.corrupt_serving = True
        try:
            v = replay_workload(wl, batcher=b, speed=0.0, verify="tag")
        finally:
            b.close()
        assert v["verify"]["divergences"] >= 1
        assert v["verify"]["verified"] < 5
        assert v["verify"]["divergence_samples"]

    def test_jax_capture_replays_through_the_port(self, tmp_path):
        """An integer grid (every distance exact in both packages): a
        workload JAX captured replays through the port's batcher with
        zero divergences under ``verify="always"``."""
        rng = np.random.default_rng(9)
        x = rng.integers(0, 4, (200, D)).astype(np.float32)
        y = rng.integers(0, 4, 200).astype(np.int32)
        rows = [rng.integers(0, 4, (1 + i % 3, D)).astype(np.float32)
                for i in range(16)]
        jmodel = JKNNClassifier(k=3, engine="xla").fit(JDataset(x, y))
        wl = load_workload(_capture_some(jmodel, tmp_path, n=16,
                                         package="jax", rows=rows)["path"])
        b = MicroBatcher(KNNClassifier(k=3, **CPU).fit(Dataset(x, y)),
                         max_batch=8, max_wait_ms=0.5, index_version="port")
        try:
            v = replay_workload(wl, batcher=b, speed=0.0, verify="always")
        finally:
            b.close()
        assert v["measured"]["errors"] == 0
        assert v["verify"]["verified"] == 16
        assert v["verify"]["divergences"] == 0

    def test_mutations_are_recorded_failures_not_drops(self, model,
                                                       tmp_path):
        """A mutation replayed into a batcher without a mutable engine is
        a recorded typed failure (JAX's outcome, the same error class);
        with the engine (``replay --mutable on``) it applies and acks at
        the captured seq."""
        from knn_tpu_torch.mutable.engine import MutableEngine
        from knn_tpu_torch.serve import artifact

        cap = WorkloadCapture(tmp_path, num_features=D)
        try:
            cap.start()
            cap.note_mutation("delete", {"ids": [3]}, seq=1,
                              enqueued_ns=time.monotonic_ns())
            assert cap.drain(10)
            wl = load_workload(cap.stop()["path"])
        finally:
            cap.close()
        verdicts = []
        for pkg_batcher in (MicroBatcher, JMicroBatcher):
            m = model if pkg_batcher is MicroBatcher else JKNNClassifier(
                k=3).fit(JDataset(model.train_.features,
                                  model.train_.labels))
            b = pkg_batcher(m, max_batch=8, max_wait_ms=0.0,
                            index_version="v")
            try:
                verdicts.append(replay_workload(wl, batcher=b, speed=0.0))
            finally:
                b.close()
        for v in verdicts:
            assert v["mutations"]["fired"] == 1
            assert v["mutations"]["ok"] == 0
            assert v["mutations"]["error_samples"][0].startswith(
                "ValueError: this batcher serves an immutable index")
        idx = artifact.save_index(model, tmp_path / "idx")
        eng = MutableEngine(model, idx)
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                         index_version="v", mutable=eng)
        try:
            v = replay_workload(wl, batcher=b, speed=0.0)
        finally:
            b.close()
            eng.close()
        assert v["mutations"]["fired"] == v["mutations"]["ok"] == 1
        assert v["mutations"]["seq_aligned"] == 1

    def test_mutable_capture_replays_aligned(self, model, tmp_path):
        """The twin of tests/test_workload.py's case: reads and acknowledged
        mutations captured from a mutable batcher, replayed into a fresh
        engine over a copy of the same artifact — every mutation at its
        captured seq, every read verified at its tag."""
        wl, dir_b, version = _mutable_capture(model, tmp_path)
        from knn_tpu_torch.mutable.engine import MutableEngine
        from knn_tpu_torch.serve import artifact

        model_b = artifact.load_index(dir_b, **CPU)
        engine_b = MutableEngine(model_b, dir_b, version=version)
        b_b = MicroBatcher(model_b, max_batch=8, max_wait_ms=0.0,
                           index_version=version, mutable=engine_b)
        try:
            v = replay_workload(wl, batcher=b_b, speed=0.0, verify="tag")
        finally:
            b_b.close()
            engine_b.close()
        assert v["mutations"]["fired"] == 4
        assert v["mutations"]["ok"] == 4
        assert v["mutations"]["seq_aligned"] == 4
        assert v["verify"]["divergences"] == 0
        assert v["verify"]["verified"] == 8

    def test_committed_fixture_replays(self):
        """The JAX-captured fixture through the port's batcher: 120 ok, 0
        errors; every predict digest equal; each kneighbors answer has
        JAX's indices and distances within rtol = d * 2^-24 (d = 8), its
        digest equal or counted as a divergence."""
        wl = load_workload(fixtures.REPLAY_WORKLOAD_DIR)
        assert wl.manifest["requests"] == 120
        rng = np.random.default_rng(1234)  # fixtures.replay_fixture_model
        x = rng.normal(0.0, 2.0, (512, 8)).astype(np.float32)
        y = rng.integers(0, 6, 512).astype(np.int32)
        model = KNNClassifier(k=3, **CPU).fit(Dataset(x, y))
        jmodel = fixtures.replay_fixture_model()
        b = MicroBatcher(model, max_batch=16, max_wait_ms=1.0,
                         index_version=fixtures.REPLAY_FIXTURE_VERSION)
        try:
            v = replay_workload(wl, batcher=b, speed=0.0, verify="always")
        finally:
            b.close()
        assert v["measured"]["errors"] == 0 and v["measured"]["ok"] == 120
        mismatched = {"predict": 0, "kneighbors": 0}
        for ev in wl.read_events:
            q = wl.rows_for(ev)
            ds = Dataset(q, np.zeros(len(q), np.int32))
            if ev["kind"] == "predict":
                got = model.predict(ds)
                mismatched["predict"] += \
                    answer_digest("predict", got) != ev["digest"]
                continue
            d, i = model.kneighbors(ds)
            jd, ji = jmodel.kneighbors(JDataset(q, np.zeros(len(q),
                                                            np.int32)))
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_allclose(d, jd, rtol=8 * 2.0 ** -24, atol=0)
            mismatched["kneighbors"] += \
                answer_digest("kneighbors", (d, i)) != ev["digest"]
        assert mismatched["predict"] == 0
        assert v["verify"]["verified"] + v["verify"]["divergences"] == 120
        assert v["verify"]["divergences"] == mismatched["kneighbors"]


def _mutable_capture(model, tmp_path, package="port"):
    """Capture 8 reads and 4 acknowledged mutations (3 inserts, a delete of
    the first delta row) from ``package``'s mutable batcher over artifact
    ``a``, serialized so every sequence point is stable; returns the loaded
    workload, a pristine copy ``b`` of the artifact and its version."""
    import shutil

    if package == "port":
        from knn_tpu_torch.mutable.engine import MutableEngine
        from knn_tpu_torch.serve import artifact
        cap_cls, b_cls, kw = WorkloadCapture, MicroBatcher, CPU
    else:
        from knn_tpu.mutable.engine import MutableEngine
        from knn_tpu.serve import artifact
        cap_cls, b_cls, kw = jworkload.WorkloadCapture, JMicroBatcher, {}
        model = JKNNClassifier(k=3).fit(JDataset(model.train_.features,
                                                 model.train_.labels))
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    artifact.save_index(model, dir_a)
    shutil.copytree(dir_a, dir_b)
    version = artifact.index_version(artifact.read_manifest(dir_a))
    rng = np.random.default_rng(11)
    model_a = artifact.load_index(dir_a, **kw)
    engine_a = MutableEngine(model_a, dir_a, version=version)
    cap = cap_cls(tmp_path / "captures", num_features=D, k=3)
    b_a = b_cls(model_a, max_batch=8, max_wait_ms=0.0,
                index_version=version, workload=cap, mutable=engine_a)
    try:
        cap.start()
        for i in range(12):
            if i % 4 == 1:
                f = b_a.submit_mutation("insert", {
                    "rows": rng.normal(0, 2, (1, D)).astype(np.float32),
                    "values": [int(rng.integers(0, 4))]})
            elif i == 10:
                f = b_a.submit_mutation(
                    "delete", {"ids": [model.train_.num_instances]})
            else:
                f = b_a.submit(rng.normal(0, 2, (2, D)).astype(np.float32),
                               "predict")
            f.result(timeout=30)  # serialize: stable seq points
        assert cap.drain(20)
        summary = cap.stop()
    finally:
        b_a.close()
        engine_a.close()
        cap.close()
    assert summary["mutations"] == 4
    return load_workload(summary["path"]), dir_b, version


class TestLinkage:
    def test_trace_carries_workload_record(self, model, tmp_path):
        cap = WorkloadCapture(tmp_path, num_features=D)
        rec = FlightRecorder(capacity=16, slowest_k=4)
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                         index_version="v1", recorder=rec, workload=cap)
        try:
            cap.start()
            handle = b.submit(np.zeros((1, D), np.float32), "predict")
            handle.result(timeout=30)
            rid = handle.meta["request_id"]
            tl = rec.find(rid)
            assert isinstance(tl.get("workload_record"), int)
            assert cap.drain(20)
            summary = cap.stop()
        finally:
            b.close()
            cap.close()
        ev = load_workload(summary["path"]).read_events[0]
        assert ev["id"] == tl["workload_record"]
        assert ev["request_id"] == rid

    def test_no_capture_no_annotation(self, model):
        rec = FlightRecorder(capacity=16, slowest_k=4)
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0, recorder=rec)
        try:
            handle = b.submit(np.zeros((1, D), np.float32), "predict")
            handle.result(timeout=30)
            tl = rec.find(handle.meta["request_id"])
        finally:
            b.close()
        assert "workload_record" not in tl


class TestReplayCLI:
    def test_bad_workload_exits_2_in_both_clis(self, tmp_path, capsys):
        from knn_tpu.cli import run as jrun
        from knn_tpu_torch.cli import run

        argv = ["replay", str(tmp_path / "missing"), "--index",
                str(tmp_path)]
        assert run(argv) == 2
        err = capsys.readouterr().err
        assert err.startswith("error:") and "not found" in err
        assert jrun(argv) == 2
        capsys.readouterr()

    @pytest.mark.parametrize("extra,needle", [
        (["--speed", "-1"], "--speed"),
        (["--max-batch", "0"], "--max-batch"),
        (["--max-wait-ms", "-1"], "--max-wait-ms"),
        (["--mutable", "maybe"], "--mutable"),
    ])
    def test_bad_flags_exit_2(self, model, tmp_path, capsys, extra, needle):
        from knn_tpu_torch.cli import run

        path = _capture_some(model, tmp_path, n=2)["path"]
        assert run(["replay", path, "--index", str(tmp_path), *extra]) == 2
        assert needle in capsys.readouterr().err

    def test_in_process_replay_via_cli(self, model, tmp_path, capsys):
        from knn_tpu_torch.cli import run
        from knn_tpu_torch.serve import artifact

        idx = tmp_path / "idx"
        artifact.save_index(model, idx)
        version = artifact.index_version(artifact.read_manifest(idx))
        summary = _capture_some(model, tmp_path, n=4, version=version)
        out = io.StringIO()
        rc = run(["replay", summary["path"], "--index", str(idx),
                  "--device", "cpu", "--speed", "0", "--verdict-out",
                  str(tmp_path / "verdict.json"), "--fail-on-divergence"],
                 stdout=out)
        assert rc == 0, out.getvalue() + capsys.readouterr().err
        assert out.getvalue().startswith("replayed 4 requests")
        verdict = json.loads((tmp_path / "verdict.json").read_text())
        assert verdict["verify"]["divergences"] == 0
        assert verdict["verify"]["verified"] == 4
        assert verdict["measured"]["errors"] == 0
        assert "capacity" in verdict

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_replay_mutable_on_verifies(self, model, tmp_path, capsys,
                                        package):
        """``replay --mutable on``: a mutable workload captured by either
        package replays in process through the port's CLI into a copy of
        its artifact, every mutation acknowledged at its seq, zero
        divergences."""
        from knn_tpu_torch.cli import run

        wl, dir_b, _version = _mutable_capture(model, tmp_path, package)
        out = io.StringIO()
        rc = run(["replay", str(wl.path), "--index", str(dir_b),
                  "--device", "cpu", "--speed", "0", "--mutable", "on",
                  "--verify", "always", "--fail-on-divergence"],
                 stdout=out)
        assert rc == 0, out.getvalue() + capsys.readouterr().err
        verdict = json.loads(out.getvalue().splitlines()[-1])
        assert verdict["mutations"]["fired"] == 4
        assert verdict["mutations"]["ok"] == 4
        assert verdict["mutations"]["seq_aligned"] == 4
        assert verdict["verify"]["divergences"] == 0
        assert verdict["verify"]["verified"] == 8

    def test_mutations_are_skipped_with_a_warning(self, model, tmp_path,
                                                  capsys):
        from knn_tpu_torch.cli import run
        from knn_tpu_torch.serve import artifact

        idx = tmp_path / "idx"
        artifact.save_index(model, idx)
        cap = jworkload.WorkloadCapture(tmp_path / "c", num_features=D)
        cap.start()
        cap.note_mutation("delete", {"ids": [3]}, seq=1,
                          enqueued_ns=time.monotonic_ns())
        assert cap.drain(10)
        path = cap.stop()["path"]
        cap.close()
        out = io.StringIO()
        assert run(["replay", path, "--index", str(idx), "--device", "cpu",
                    "--speed", "0"], stdout=out) == 0
        assert "skipping them" in capsys.readouterr().err
        verdict = json.loads(out.getvalue().splitlines()[-1])
        assert verdict["mutations"] == {"fired": 0, "ok": 0,
                                        "seq_aligned": 0, "skipped": 1,
                                        "error_samples": []}

    def test_http_replay_against_the_port_server(self, model, tmp_path,
                                                 capsys):
        """``replay --url``: a capture made through the port's own server
        (``POST /admin/capture``) replays over HTTP with every answer
        verified, and its mutation-free verdict says so."""
        from knn_tpu_torch import obs
        from knn_tpu_torch.cli import run
        from knn_tpu_torch.serve.server import ServeApp, make_server

        obs.enable()
        s = Served(ServeApp, make_server, model, warm=(1,),
                   capture_dir=str(tmp_path / "caps"), max_wait_ms=0.5,
                   index_version="http-v")
        try:
            assert http_post(s.base, "/admin/capture",
                             {"action": "start"})[0] == 200
            rng = np.random.default_rng(2)
            for j in range(6):
                kind = "/kneighbors" if j % 3 == 0 else "/predict"
                st, _ = http_post(s.base, kind, {"instances": rng.normal(
                    0, 2, (1 + j % 2, D)).tolist()})
                assert st == 200
            st, summary = http_post(s.base, "/admin/capture",
                                    {"action": "stop"})
            assert st == 200 and summary["requests"] == 6
            out = io.StringIO()
            rc = run(["replay", summary["path"], "--url", s.base, "--speed",
                      "0", "--fail-on-divergence"], stdout=out)
            assert rc == 0, capsys.readouterr().err
            verdict = json.loads(out.getvalue().splitlines()[-1])
            assert verdict["verify"]["verified"] == 6
            assert verdict["target"] == s.base
        finally:
            s.close()


class TestCaptureRoutes:
    def _pair(self, data, tmp_path, **kw):
        from knn_tpu.serve.server import ServeApp as JServeApp
        from knn_tpu.serve.server import make_server as jmake_server
        from knn_tpu_torch.serve.server import ServeApp, make_server

        jobs.enable()
        x, y = data
        s = Served(ServeApp, make_server,
                   KNNClassifier(k=3, **CPU).fit(Dataset(x, y)), warm=(1,),
                   index_version="v", max_wait_ms=0.5,
                   **({"capture_dir": str(tmp_path / "p")} if kw else {}))
        js = Served(JServeApp, jmake_server,
                    JKNNClassifier(k=3, engine="xla").fit(JDataset(x, y)),
                    warm=(1,), index_version="v", max_wait_ms=0.5,
                    **({"capture_dir": str(tmp_path / "j")} if kw else {}))
        return s, js

    def test_off_answers_as_jax(self, data, tmp_path):
        s, js = self._pair(data, tmp_path)
        try:
            for srv in (s, js):
                st, body, _ = http_get(srv.base, "/debug/capture")
                assert st == 200
                assert json.loads(body) == {"enabled": False,
                                            "index_version": "v"}
            got = http_post(s.base, "/admin/capture", {"action": "start"})
            want = http_post(js.base, "/admin/capture", {"action": "start"})
            assert got[0] == want[0] == 404
            assert got[1]["error"] == want[1]["error"]
            h = json.loads(http_get(s.base, "/healthz")[1])
            assert h["workload"] is None
        finally:
            s.close()
            js.close()

    def test_start_stop_and_contradictions_as_jax(self, data, tmp_path):
        """The same sequence on both servers: the same statuses and the
        same keys in every answer; the stopped window's artifact loads in
        both packages."""
        s, js = self._pair(data, tmp_path, capture=True)
        x = data[0]
        try:
            docs = []
            for srv in (s, js):
                seq = [http_post(srv.base, "/admin/capture",
                                 {"action": "stop"}),
                       http_post(srv.base, "/admin/capture",
                                 {"action": "start", "reason": "test"}),
                       http_post(srv.base, "/admin/capture",
                                 {"action": "start"}),
                       http_post(srv.base, "/admin/capture",
                                 {"action": "sideways"}),
                       http_post(srv.base, "/admin/capture",
                                 {"action": "start", "window_s": -1})]
                for j in range(3):
                    assert http_post(srv.base, "/predict", {
                        "instances": x[j:j + 1].tolist()})[0] == 200
                status = json.loads(http_get(srv.base, "/debug/capture")[1])
                stop = http_post(srv.base, "/admin/capture",
                                 {"action": "stop"})
                hz = json.loads(http_get(srv.base, "/healthz")[1])
                docs.append((seq, status, stop, hz["workload"]))
            (seq, status, stop, hz), (jseq, jstatus, jstop, jhz) = docs
            assert [st for st, _ in seq] == [st for st, _ in jseq] == \
                [409, 200, 409, 400, 400]
            assert [set(d) for _, d in seq] == [set(d) for _, d in jseq]
            assert set(status) == set(jstatus) and status["capturing"]
            assert status["reason"] == jstatus["reason"] == "test"
            assert stop[0] == jstop[0] == 200
            assert set(stop[1]) == set(jstop[1])
            assert stop[1]["requests"] == jstop[1]["requests"] == 3
            assert set(hz) == set(jhz) and hz["captures"] == 1
            for path in (stop[1]["path"], jstop[1]["path"]):
                assert load_workload(path).manifest["requests"] == 3
                jworkload.load_workload(path)
        finally:
            s.close()
            js.close()

    def test_drain_and_stop_finalizes_an_armed_window(self, data,
                                                      tmp_path):
        from knn_tpu_torch.serve.server import (
            ServeApp,
            drain_and_stop,
            make_server,
        )

        app = ServeApp(KNNClassifier(k=3, **CPU).fit(Dataset(*data)),
                       capture_dir=str(tmp_path / "caps"), shadow_rate=1.0,
                       drift_rate=1.0, max_wait_ms=0.0)
        server = make_server(app)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        app.ready = True
        try:
            app.workload.start()
            app.batcher.predict(data[0][:1], timeout=30)
            assert app.workload.drain(10)
            assert drain_and_stop(server, 5.0)["drained_clean"]
            assert not app.workload.capturing
            last = app.workload.export()["last"]
            assert last["requests"] == 1 and last["stop_reason"] == "manual"
            load_workload(last["path"])
            assert app.quality._sq._closed and app.drift._sq._closed
        finally:
            server.server_close()
            app.close()
