"""Serving on the port (the twin of ``tests/test_serve.py``): the
micro-batcher, the index artifact and the HTTP front-end of
``knn_tpu_torch.serve`` against the JAX package's, on the CPU.

The port runs at ``device="cpu"``, where the retrieval takes the kernels'
plain versions. The problems are integer grids (ties on purpose), so
predictions, neighbor indices AND distances must be exactly equal between
the port's batched path, its synchronous path and the JAX package's
``MicroBatcher`` on the same rows. The batchers run with a bucket ladder
(``serve --batch-buckets auto``'s), so the port's upload stager stages the
next batch while the current one runs.

Artifacts are shared both ways: an index the JAX package saved loads in the
port and serves the same answers with the same ``schema_hash``, and the
reverse; the backend names map by one table (``tpu ↔ cuda``).

Tolerances: exact everywhere (integer grids).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from knn_tpu.models import knn as jknn  # noqa: E402
from knn_tpu.serve import artifact as jartifact  # noqa: E402
from knn_tpu.serve.batcher import MicroBatcher as JMicroBatcher  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models import knn  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor  # noqa: E402
from knn_tpu_torch.resilience.errors import (  # noqa: E402
    DataError,
    DeadlineExceededError,
    DeviceError,
    OverloadError,
)
from knn_tpu_torch.serve import artifact  # noqa: E402
from knn_tpu_torch.serve import batcher as batcher_mod  # noqa: E402
from knn_tpu_torch.serve.artifact import (  # noqa: E402
    load_index,
    save_index,
    schema_hash,
    warmup,
)
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401

CPU = {"device": "cpu"}
#: ``serve --batch-buckets auto`` at ``--max-batch 16``.
LADDER = (16,)


def problem(rng, n=300, q=40, d=5, c=5):
    """An integer-grid problem (ties) for both packages: ``(train, test,
    jtrain, jtest)``; half the queries duplicate train rows."""
    train_x = rng.integers(0, 4, (n, d)).astype(np.float32)
    train_y = rng.integers(0, c, n).astype(np.int32)
    test_x = np.concatenate(
        [train_x[rng.choice(n, q // 2, replace=False)],
         rng.integers(0, 4, (q - q // 2, d)).astype(np.float32)])
    targets = rng.standard_normal(n).astype(np.float32)
    zeros = np.zeros(len(test_x), np.int32)
    return (Dataset(train_x, train_y, raw_targets=targets),
            Dataset(test_x, zeros),
            JDataset(train_x, train_y, raw_targets=targets),
            JDataset(test_x, zeros))


@pytest.fixture
def obs_on():
    """The port's observability enabled and isolated (global_state
    restores the previous on/off state)."""
    obs.enable()
    obs.reset()
    return obs.registry()


def models(train, jtrain):
    """``name -> (port model on the CPU, JAX model)``, the families and
    engines of ``tests/test_serve.py::_models``. JAX answers on its XLA
    engine: its stripe engine would run the interpreted kernel, and every
    JAX engine gives the same answers by its own contract."""
    return {
        "clf-xla": (KNNClassifier(k=5, engine="xla", **CPU),
                    jknn.KNNClassifier(k=5, engine="xla")),
        "clf-stripe": (KNNClassifier(k=5, engine="stripe", **CPU),
                       jknn.KNNClassifier(k=5, engine="xla")),
        "clf-auto": (KNNClassifier(k=5, **CPU),
                     jknn.KNNClassifier(k=5, engine="xla")),
        "clf-weighted": (KNNClassifier(k=5, weights="distance", **CPU),
                         jknn.KNNClassifier(k=5, weights="distance",
                                            engine="xla")),
        "reg-uniform": (KNNRegressor(k=5, engine="xla", **CPU),
                        jknn.KNNRegressor(k=5, engine="xla")),
        "reg-weighted": (KNNRegressor(k=5, weights="distance", **CPU),
                         jknn.KNNRegressor(k=5, weights="distance",
                                           engine="xla")),
    }


def requests_of(test):
    """24 requests of 1-3 rows, every fourth a kneighbors."""
    out = []
    for i in range(24):
        lo = (3 * i) % (test.num_instances - 3)
        out.append((test.features[lo:lo + 1 + (i % 3)],
                    "kneighbors" if i % 4 == 3 else "predict"))
    return out


def run_clients(b, requests):
    """Every request from its own thread; results in request order."""
    results, errors = [None] * len(requests), []

    def client(ix):
        try:
            rows, kind = requests[ix]
            results[ix] = b.submit(rows, kind).result(timeout=60)
        except Exception as e:  # noqa: BLE001 — surfaced by the caller
            errors.append((ix, e))

    threads = [threading.Thread(target=client, args=(ix,))
               for ix in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a client never returned"
    assert not errors, errors
    return results


def assert_same(got, want, kind, what):
    if kind == "kneighbors":
        np.testing.assert_array_equal(got[0], want[0], err_msg=what)
        np.testing.assert_array_equal(got[1], want[1], err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture
def stager_hits(monkeypatch):
    """Counts the dispatches that consumed a staged upload."""
    hits = []
    take = batcher_mod._UploadStager.take

    def counting(self, live):
        out = take(self, live)
        hits.append(out is not None)
        return out

    monkeypatch.setattr(batcher_mod._UploadStager, "take", counting)
    return hits


class TestBatcherBitIdentity:
    @pytest.mark.parametrize("name", ["clf-xla", "clf-stripe", "clf-auto",
                                      "clf-weighted", "reg-uniform",
                                      "reg-weighted"])
    def test_concurrent_clients_match_sync_and_jax(self, rng, name):
        """Every request's batched answer equals the port's synchronous
        API and JAX's MicroBatcher on the same rows, whatever batches the
        coalescers formed, with the bucket ladder (and the stager) on."""
        train, test, jtrain, jtest = problem(rng)
        model, jmodel = models(train, jtrain)[name]
        model.fit(train)
        jmodel.fit(jtrain)
        reqs = requests_of(test)
        sync = []
        for rows, kind in reqs:
            ds = Dataset(rows, np.zeros(len(rows), np.int32))
            sync.append(model.kneighbors(ds) if kind == "kneighbors"
                        else model.predict(ds))
        with MicroBatcher(model, max_batch=16, max_wait_ms=20.0,
                          buckets=LADDER) as b:
            got = run_clients(b, reqs)
        with jknn.query_bucket_ladder(LADDER):
            with JMicroBatcher(jmodel, max_batch=16, max_wait_ms=20.0,
                               buckets=LADDER) as jb:
                jgot = run_clients(jb, reqs)
        for ix, (rows, kind) in enumerate(reqs):
            assert_same(got[ix], sync[ix], kind, f"{name} req {ix} vs sync")
            assert_same(got[ix], jgot[ix], kind, f"{name} req {ix} vs JAX")

    @pytest.mark.parametrize("engine", ["auto", "xla"])
    def test_staged_uploads_are_consumed_and_bit_identical(
            self, rng, stager_hits, engine):
        """Requests queued ahead of the worker make the stager stage each
        next batch during the current one; the dispatches that read a
        staged block answer exactly as the synchronous path."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=5, engine=engine, **CPU).fit(train)
        want_d, want_i = model.kneighbors(test)
        with MicroBatcher(model, max_batch=8, max_wait_ms=200.0,
                          buckets=(4, 8)) as b:
            handles = [b.submit(test.features[i], "kneighbors")
                       for i in range(test.num_instances)]
            got = [h.result(timeout=60) for h in handles]
        assert any(stager_hits), "no dispatch consumed a staged upload"
        for i, (d, ix) in enumerate(got):
            np.testing.assert_array_equal(d[0], want_d[i])
            np.testing.assert_array_equal(ix[0], want_i[i])

    def test_stress_more_threads_than_cores(self, rng, stager_hits):
        """The queue, the stager's identity match and the futures are
        shared between the handler threads and the worker: 64 client
        threads under a 1 µs switch interval, each request answered once
        and exactly as the synchronous path answers it."""
        import sys

        train, test, _, _ = problem(rng, q=64)
        model = KNNClassifier(k=5, **CPU).fit(train)
        want_d, want_i = model.kneighbors(test)
        reqs = [(test.features[i:i + 1], "kneighbors") for i in range(64)]
        previous = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with MicroBatcher(model, max_batch=8, max_wait_ms=0.5,
                              buckets=(2, 4, 8)) as b:
                got = run_clients(b, reqs)
        finally:
            sys.setswitchinterval(previous)
        assert len(stager_hits) <= 64
        for i, (d, ix) in enumerate(got):
            np.testing.assert_array_equal(d[0], want_d[i])
            np.testing.assert_array_equal(ix[0], want_i[i])

    def test_single_row_convenience_roundtrip(self, rng):
        train, test, jtrain, jtest = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = jknn.KNNClassifier(k=3, engine="xla").fit(jtrain).predict(
            jtest)
        with MicroBatcher(model, max_batch=8, max_wait_ms=1.0,
                          buckets=(8,)) as b:
            got = np.concatenate([b.predict(test.features[i], timeout=60)
                                  for i in range(test.num_instances)])
        np.testing.assert_array_equal(got, want)


class TestPrefetchedQueries:
    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_staged_block_is_bit_identical(self, rng, engine):
        """``_kneighbors_arrays`` reading a staged [bucket, D] block (rows
        past Q are garbage on purpose) answers exactly as its own upload,
        on the kernel route and the XLA route."""
        train, test, _, _ = problem(rng)
        q = 11
        block = torch.full((16, test.num_features), 7e7)
        block[:q] = torch.tensor(test.features[:q])
        args = (train.features, test.features[:q], 5)
        want = knn._kneighbors_arrays(*args, engine=engine, device="cpu")
        got = knn._kneighbors_arrays(*args, engine=engine, device="cpu",
                                     prefetched_queries=block)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("bad", ["width", "rows", "dtype"])
    def test_unusable_block_is_not_read(self, rng, bad):
        train, test, _, _ = problem(rng)
        q, d = 8, test.num_features
        block = {"width": torch.zeros((16, d + 1)),
                 "rows": torch.zeros((q - 1, d)),
                 "dtype": torch.zeros((16, d), dtype=torch.float64)}[bad]
        args = (train.features, test.features[:q], 5)
        want = knn._kneighbors_arrays(*args, device="cpu")
        got = knn._kneighbors_arrays(*args, device="cpu",
                                     prefetched_queries=block)
        np.testing.assert_array_equal(got[1], want[1])

    def test_retrieval_route_is_the_dispatch_rule(self):
        assert knn.retrieval_route("auto", "euclidean") == "stripe"
        assert knn.retrieval_route("stripe", "euclidean") == "stripe"
        assert knn.retrieval_route("xla", "euclidean") == "xla"
        assert knn.retrieval_route("auto", "manhattan") == "xla"
        with pytest.raises(ValueError, match="engine"):
            knn.retrieval_route("ring")


class TestBatcherPolicy:
    def test_coalescing_actually_happens(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        with MicroBatcher(model, max_batch=32, max_wait_ms=250.0) as b:
            handles = [b.submit(test.features[i]) for i in range(8)]
            for h in handles:
                h.result(timeout=60)
        hist = obs_on.histogram("knn_serve_batch_size")
        assert hist.count >= 1 and hist.sum > hist.count

    def test_queue_overflow_typed_and_counted(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        b = MicroBatcher(model, max_batch=2, max_queue_rows=2,
                         max_wait_ms=2000.0)
        try:
            first = b.submit(test.features[0])
            with pytest.raises(OverloadError, match="queue full"):
                b.submit(test.features[:2])
            second = b.submit(test.features[1])
            assert first.result(timeout=60) is not None
            assert second.result(timeout=60) is not None
        finally:
            b.close()
        assert obs_on.counter("knn_serve_rejected_total",
                              reason="queue_full").value == 1

    def test_deadline_expires_in_queue(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        with MicroBatcher(model, max_batch=64, max_wait_ms=120.0) as b:
            h = b.submit(test.features[0], deadline_ms=5)
            with pytest.raises(DeadlineExceededError, match="expired"):
                h.result(timeout=60)
        assert obs_on.counter("knn_serve_deadline_expired_total").value == 1

    def test_result_timeout_then_collect(self, rng):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.predict(test)
        with MicroBatcher(model, max_batch=64, max_wait_ms=300.0) as b:
            h = b.submit(test.features)
            with pytest.raises(DeadlineExceededError):
                h.result(timeout=0.01)
            np.testing.assert_array_equal(h.result(timeout=60), want)

    def test_close_drains_then_rejects(self, rng):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        b = MicroBatcher(model, max_batch=64, max_wait_ms=500.0)
        handles = [b.submit(test.features[i]) for i in range(4)]
        b.close()
        for h in handles:
            assert h.result(timeout=60) is not None
        with pytest.raises(OverloadError, match="shut down"):
            b.submit(test.features[0])

    def test_failing_rung_delivers_typed_error(self, rng, monkeypatch):
        """The port's ladder is the one rung: its typed failure reaches the
        futures (JAX's would first walk to its oracle rung)."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)

        def boom(*args, **kwargs):
            raise DeviceError("synthetic dispatch failure", transient=False)

        monkeypatch.setattr(model, "kneighbors", boom)
        monkeypatch.setattr(batcher_mod, "_kneighbors_arrays", boom)
        with MicroBatcher(model, max_batch=8, max_wait_ms=1.0) as b:
            h1 = b.submit(test.features[0])
            h2 = b.submit(test.features[1], "kneighbors")
            for h in (h1, h2):
                with pytest.raises(DeviceError, match="synthetic"):
                    h.result(timeout=60)

    def test_worker_survives_instrumentation_failure(self, rng, obs_on,
                                                     monkeypatch):
        from knn_tpu_torch.obs import instrument

        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)

        def broken(ms, kind):
            raise ValueError("synthetic instrumentation bug")

        monkeypatch.setattr(instrument, "record_serve_queue_wait", broken)
        with MicroBatcher(model, max_batch=8, max_wait_ms=1.0) as b:
            with pytest.raises(ValueError, match="instrumentation"):
                b.submit(test.features[0]).result(timeout=60)
            monkeypatch.undo()
            assert b.predict(test.features[0], timeout=60) is not None

    def test_shape_and_kind_rejected_at_submit(self, rng):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        with MicroBatcher(model, max_wait_ms=0.0) as b:
            with pytest.raises(ValueError, match="features must be"):
                b.submit(test.features[:, :2])
            with pytest.raises(ValueError, match="kind"):
                b.submit(test.features[0], "explain")
            with pytest.raises(ValueError, match="empty"):
                b.submit(test.features[:0])

    def test_unfitted_model_rejected_at_build(self):
        with pytest.raises(RuntimeError, match="fit"):
            MicroBatcher(KNNClassifier(k=3, **CPU))

    def test_bad_policy_rejected(self, rng):
        train, _, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        with pytest.raises(ValueError, match="max_batch"):
            MicroBatcher(model, max_batch=0)
        with pytest.raises(ValueError, match="max_queue_rows"):
            MicroBatcher(model, max_batch=64, max_queue_rows=8)
        with pytest.raises(ValueError, match="positive"):
            MicroBatcher(model, buckets=(0, 4))

    def test_bucket_ladders_are_per_batcher(self, rng):
        """Two batchers with different ladders at once: each pads by its
        own, and nothing is installed process-wide (the JAX package's
        global ladder stays unset)."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.predict(test)
        with MicroBatcher(model, max_batch=8, buckets=(2, 8)) as a, \
                MicroBatcher(model, max_batch=16, buckets=(16,)) as b:
            assert a.buckets == (2, 8) and b.buckets == (16,)
            np.testing.assert_array_equal(a.predict(test.features[:5], 60),
                                          want[:5])
            np.testing.assert_array_equal(b.predict(test.features[:5], 60),
                                          want[:5])
        assert jknn.query_buckets() is None
        assert knn.query_padded_rows(5, (2, 8)) == 8
        assert knn.query_padded_rows(5, (16,)) == 16

    def test_result_cache_hits_are_bit_identical(self, rng, obs_on):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        want = model.predict(test)
        with MicroBatcher(model, max_batch=8, max_wait_ms=1.0,
                          result_cache_rows=64) as b:
            first = b.submit(test.features[:3])
            np.testing.assert_array_equal(first.result(60), want[:3])
            again = b.submit(test.features[:3])
            np.testing.assert_array_equal(again.result(60), want[:3])
            assert again.meta.get("cache") == "hit"
            assert b.cache.stats()["hits"] == 1


class TestArtifact:
    @pytest.mark.parametrize("backend", ["cuda", "cuda-tile", "oracle",
                                         "cuda-sharded", "cuda-train-sharded",
                                         "cuda-ring"])
    def test_round_trip_every_backend(self, rng, tmp_path, backend):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, backend=backend, **CPU).fit(train)
        want = model.predict(test)
        loaded = load_index(save_index(model, tmp_path / "idx"),
                            device="cpu")
        assert loaded.backend_name == backend and loaded.k == 3
        assert loaded.device == "cpu"
        np.testing.assert_array_equal(loaded.predict(test), want)

    @pytest.mark.parametrize("jname,name", [
        ("tpu-sharded", "cuda-sharded"),
        ("tpu-train-sharded", "cuda-train-sharded"),
        ("tpu-ring", "cuda-ring"),
    ])
    def test_sharded_backend_names_both_ways(self, rng, tmp_path, jname,
                                             name):
        """A JAX artifact saved with a sharded backend loads as the port's
        twin, and the port's save of it loads back in JAX under JAX's
        name, with the same predictions."""
        train, test, jtrain, jtest = problem(rng)
        jmodel = jknn.KNNClassifier(k=3, backend=jname).fit(jtrain)
        jout = jartifact.save_index(jmodel, tmp_path / "j")
        loaded = load_index(jout, device="cpu")
        assert loaded.backend_name == name
        want = jmodel.predict(jtest)
        np.testing.assert_array_equal(loaded.predict(test), want)
        out = save_index(loaded, tmp_path / "p")
        assert json.loads((out / "manifest.json").read_text())[
            "backend"] == jname
        back = jartifact.load_index(out)
        assert back.backend_name == jname
        np.testing.assert_array_equal(back.predict(jtest), want)

    def test_regressor_round_trip_with_raw_targets(self, rng, tmp_path):
        train, test, _, _ = problem(rng)
        model = KNNRegressor(k=4, weights="distance", **CPU).fit(train)
        want = model.predict(test)
        loaded = load_index(save_index(model, tmp_path / "reg"),
                            device="cpu")
        assert isinstance(loaded, KNNRegressor)
        assert loaded.weights == "distance" and loaded.device == "cpu"
        np.testing.assert_array_equal(loaded.predict(test), want)
        np.testing.assert_array_equal(loaded.train_.raw_targets,
                                      train.raw_targets)

    def test_manifest_matches_jax_field_for_field(self, rng, tmp_path):
        """The port's manifest is the JAX package's: the same keys, the
        same schema hash and drift sketch; only the creation time and the
        backend's spelling differ (the port writes the JAX name)."""
        train, _, jtrain, _ = problem(rng)
        out = save_index(KNNClassifier(k=5, **CPU).fit(train), tmp_path / "p")
        jout = jartifact.save_index(jknn.KNNClassifier(k=5).fit(jtrain),
                                    tmp_path / "j")
        doc = json.loads((out / "manifest.json").read_text())
        jdoc = json.loads((jout / "manifest.json").read_text())
        assert set(doc) == set(jdoc)
        for key in doc:
            if key != "created_unix":
                assert doc[key] == jdoc[key], key
        assert doc["format"] == 3 and doc["backend"] == "tpu"
        assert doc["backend_opts"] == {}  # device is not a manifest field
        assert doc["schema_hash"] == schema_hash(train) \
            == jartifact.schema_hash(jtrain)

    @pytest.mark.parametrize("port,jax", sorted(
        artifact.BACKEND_NAMES.items()))
    def test_backend_names_map_both_ways(self, rng, tmp_path, port, jax):
        train, _, jtrain, _ = problem(rng)
        out = save_index(KNNClassifier(k=3, backend=port, **CPU).fit(train),
                         tmp_path / "p")
        assert json.loads((out / "manifest.json").read_text())[
            "backend"] == jax
        jout = tmp_path / "j"
        jartifact.save_index(jknn.KNNClassifier(k=3, backend=jax).fit(jtrain),
                             jout)
        assert load_index(jout, device="cpu").backend_name == port

    @pytest.mark.parametrize("name", ["clf-auto", "clf-weighted",
                                      "reg-weighted"])
    def test_jax_saved_index_serves_the_same_in_the_port(self, rng,
                                                         tmp_path, name):
        train, test, jtrain, jtest = problem(rng)
        _, jmodel = models(train, jtrain)[name]
        jmodel.fit(jtrain)
        out = jartifact.save_index(jmodel, tmp_path / "j")
        loaded = load_index(out, device="cpu")
        np.testing.assert_array_equal(loaded.predict(test),
                                      jmodel.predict(jtest))
        for g, w in zip(loaded.kneighbors(test), jmodel.kneighbors(jtest)):
            np.testing.assert_array_equal(g, w)
        assert schema_hash(loaded.train_) == json.loads(
            (out / "manifest.json").read_text())["schema_hash"]

    @pytest.mark.parametrize("name", ["clf-auto", "clf-xla", "clf-weighted",
                                      "reg-uniform"])
    def test_port_saved_index_serves_the_same_in_jax(self, rng, tmp_path,
                                                     name):
        train, test, jtrain, jtest = problem(rng)
        model, _ = models(train, jtrain)[name]
        model.fit(train)
        out = save_index(model, tmp_path / "p")
        jloaded = jartifact.load_index(out)
        np.testing.assert_array_equal(jloaded.predict(jtest),
                                      model.predict(test))
        for g, w in zip(jloaded.kneighbors(jtest), model.kneighbors(test)):
            np.testing.assert_array_equal(g, w)
        assert jartifact.schema_hash(jloaded.train_) == schema_hash(
            model.train_)
        assert jartifact.reference_sketch(jartifact.read_manifest(out)) \
            is not None

    def test_ivf_artifact_refused_typed(self, rng, tmp_path):
        """Since the index family (ROADMAP A9) an IVF artifact is no longer
        refused: a JAX-built one round-trips through the port (load, serve
        on the ivf rung, re-save) with the JAX package's partition and
        answers, and the re-saved artifact loads back in JAX."""
        from knn_tpu.index.ivf import IVFIndex
        from knn_tpu.serve.server import ServeApp as JServeApp

        from knn_tpu_torch.serve.server import ServeApp

        _, test, jtrain, jtest = problem(rng)
        jivf = IVFIndex.build(jtrain.features, 4, seed=0)
        out = jartifact.save_index(
            jknn.KNNClassifier(k=3).fit(jtrain), tmp_path / "ivf", ivf=jivf)
        loaded = load_index(out, device="cpu")
        for key, arr in jivf.to_arrays().items():
            np.testing.assert_array_equal(loaded.ivf_.to_arrays()[key], arr)
        app = ServeApp(loaded, max_batch=8, max_wait_ms=0.0, ivf_probes=2)
        japp = JServeApp(jartifact.load_index(out), max_batch=8,
                         max_wait_ms=0.0, ivf_probes=2)
        try:
            h = app.batcher.submit(test.features[:5], "kneighbors")
            jh = japp.batcher.submit(jtest.features[:5], "kneighbors")
            for g, w in zip(h.result(timeout=30), jh.result(timeout=30)):
                np.testing.assert_array_equal(g, w)
            assert h.meta["rung"] == jh.meta["rung"] == "ivf"
        finally:
            app.close()
            japp.close()
        resaved = save_index(loaded, tmp_path / "resaved")
        np.testing.assert_array_equal(
            jartifact.load_index(resaved).ivf_.row_perm, jivf.row_perm)

    @pytest.mark.parametrize("part", ["epochs", "CURRENT.json"])
    def test_mutable_base_refused_typed(self, rng, tmp_path, part):
        """An artifact that carries the mutable tier's parts loads as a
        plain artifact (its mutable boot goes through
        ``resolve_mutable_base``), as the JAX package's ``load_index``
        does: same answers in both packages."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        out = save_index(model, tmp_path / "m")
        if part == "epochs":
            (out / part).mkdir()
        else:
            (out / part).write_text("{}")
        loaded = load_index(out, device="cpu")
        np.testing.assert_array_equal(loaded.predict(test),
                                      model.predict(test))
        np.testing.assert_array_equal(
            jartifact.load_index(out).predict(
                JDataset(test.features, test.labels)), model.predict(test))

    def test_pre_sketch_artifact_loads(self, rng, tmp_path):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        out = save_index(model, tmp_path / "v1")
        mf = out / "manifest.json"
        doc = json.loads(mf.read_text())
        doc["format"] = 1
        del doc["drift_sketch"]
        mf.write_text(json.dumps(doc))
        np.testing.assert_array_equal(
            load_index(out, device="cpu").predict(test), model.predict(test))
        assert artifact.reference_sketch(artifact.read_manifest(out)) is None

    def test_missing_artifact_typed(self, tmp_path):
        with pytest.raises(DataError, match="not found"):
            load_index(tmp_path / "nope", device="cpu")

    def test_not_an_artifact_typed(self, tmp_path):
        plain = tmp_path / "plain"
        plain.mkdir()
        (plain / "junk.txt").write_text("x")
        with pytest.raises(DataError, match="not an index artifact"):
            load_index(plain, device="cpu")

    @pytest.mark.parametrize("edit,match", [
        ({"format": 999}, "newer"),
        ({"schema_hash": "0" * 32}, "schema hash mismatch"),
        ({"backend": "tpu-warp"}, "not a backend of this package"),
        ({"family": "ranker"}, "family"),
    ])
    def test_bad_manifest_rejected(self, rng, tmp_path, edit, match):
        train, _, _, _ = problem(rng)
        out = save_index(KNNClassifier(k=3, **CPU).fit(train), tmp_path / "v")
        mf = out / "manifest.json"
        doc = json.loads(mf.read_text())
        doc.update(edit)
        mf.write_text(json.dumps(doc))
        with pytest.raises(DataError, match=match):
            load_index(out, device="cpu")

    def test_corrupt_arrays_typed(self, rng, tmp_path):
        train, _, _, _ = problem(rng)
        out = save_index(KNNClassifier(k=3, **CPU).fit(train), tmp_path / "c")
        (out / "arrays.npz").write_bytes(b"definitely not a zip archive")
        with pytest.raises(DataError, match="unreadable arrays"):
            load_index(out, device="cpu")

    def test_refuses_to_clobber_foreign_dir(self, rng, tmp_path):
        train, _, _, _ = problem(rng)
        victim = tmp_path / "precious"
        victim.mkdir()
        (victim / "thesis.txt").write_text("irreplaceable")
        with pytest.raises(ValueError, match="refusing"):
            save_index(KNNClassifier(k=3, **CPU).fit(train), victim)
        assert (victim / "thesis.txt").read_text() == "irreplaceable"

    def test_resave_over_artifact_allowed(self, rng, tmp_path):
        train, _, _, _ = problem(rng)
        out = save_index(KNNClassifier(k=3, **CPU).fit(train), tmp_path / "r")
        save_index(KNNClassifier(k=5, **CPU).fit(train), out)
        assert load_index(out, device="cpu").k == 5

    def test_warmup_reports_per_shape_wall(self, rng):
        train, _, _, _ = problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        out = warmup(model, batch_sizes=(1, 4),
                     kinds=("predict", "kneighbors"))
        assert set(out) == {"predict@1", "predict@4", "kneighbors@1",
                            "kneighbors@4"}
        with pytest.raises(ValueError, match=">= 1"):
            warmup(model, batch_sizes=(0,))
        with pytest.raises(ValueError, match="kind"):
            warmup(model, kinds=("segment",))


# ---------------------------------------------------------------------------
# HTTP front-end


def http_get(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def http_post(base, path, payload, headers=None):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class Served:
    """A warmed in-process server on 127.0.0.1:0, closed on exit."""

    def __init__(self, app_cls, make_server, model, warm=(1, 4), **kw):
        self.app = app_cls(model, **kw)
        self.server = make_server(self.app)
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        if warm:
            self.app.warm(warm)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.app.close()
        self.thread.join(timeout=10)


@pytest.fixture
def served(rng, obs_on):
    from knn_tpu_torch.serve.server import ServeApp, make_server

    train, test, jtrain, jtest = problem(rng)
    model = KNNClassifier(k=3, **CPU).fit(train)
    s = Served(ServeApp, make_server, model, max_batch=16, max_wait_ms=1.0,
               batch_buckets=LADDER, cost_accounting=True)
    try:
        yield s.base, model, test, s.app
    finally:
        s.close()


class TestServer:
    def test_healthz_gates_on_warmup(self, rng, obs_on):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, _, _, _ = problem(rng)
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=None)
        try:
            st, body, _ = http_get(s.base, "/healthz")
            assert st == 503 and not json.loads(body)["ready"]
            s.app.warm((1,))
            st, body, _ = http_get(s.base, "/healthz")
            health = json.loads(body)
            assert st == 200 and health["ready"] and health["warmup_ms"]
            assert health["breaker"] == "closed" and health["rung"] == "fast"
            mem = health["device"]["memory"]
            assert mem[0]["device"] == "cpu:0" and mem[0]["in_use"] == 0
        finally:
            s.close()

    def test_predict_matches_sync_and_jax(self, served, rng):
        base, model, test, _ = served
        st, body = http_post(base, "/predict",
                             {"instances": test.features.tolist()})
        assert st == 200
        assert body["predictions"] == model.predict(test).tolist()

    def test_kneighbors_endpoint(self, served):
        base, model, test, _ = served
        want_d, want_i = model.kneighbors(
            Dataset(test.features[:3], np.zeros(3, np.int32)))
        st, body = http_post(base, "/kneighbors",
                             {"instances": test.features[:3].tolist()})
        assert st == 200
        np.testing.assert_array_equal(np.asarray(body["indices"]), want_i)
        np.testing.assert_array_equal(
            np.asarray(body["distances"], np.float32), want_d)

    def test_metrics_both_expositions(self, served):
        base, _, test, _ = served
        http_post(base, "/predict", {"instances": test.features[:2].tolist()},
                  {"x-request-id": "om-1"})
        st, text, _ = http_get(base, "/metrics")
        assert st == 200
        for needle in ("knn_serve_requests_total", "knn_serve_batch_size",
                       "knn_serve_request_ms", "knn_cost_device_ms_total",
                       "knn_device_memory_bytes"):
            assert needle in text, needle
        st, om, hdrs = http_get(base, "/metrics", {
            "Accept": "application/openmetrics-text"})
        assert st == 200 and om.endswith("# EOF\n")
        assert "application/openmetrics-text" in hdrs["Content-Type"]
        assert '# {trace_id="om-1"}' in om

    def test_request_id_echo_and_resolve(self, served):
        base, _, test, _ = served
        st, body = http_post(base, "/predict",
                             {"instances": test.features[:1].tolist()},
                             {"x-request-id": "abc-123"})
        assert st == 200 and body["request_id"] == "abc-123"
        st, doc, _ = http_get(base, "/debug/requests?id=abc-123")
        tl = json.loads(doc)["requests"][0]
        assert tl["outcome"] == "ok" and tl["attempts"][0]["rung"] == "fast"
        assert "cost" in tl
        st, doc, _ = http_get(base, "/debug/requests?format=perfetto")
        assert st == 200 and json.loads(doc)["traceEvents"]
        st, _, _ = http_get(base, "/debug/slowest")
        assert st == 200
        st, body = http_post(base, "/predict", {"instances": [[1.0] * 5]},
                             {"x-request-id": "bad id"})
        assert st == 400

    def test_debug_capacity(self, served):
        base, _, test, app = served
        http_post(base, "/predict", {"instances": test.features[:4].tolist()})
        st, body, _ = http_get(base, "/debug/capacity")
        doc = json.loads(body)
        assert st == 200 and doc["enabled"] is True
        assert doc["policy"]["batch_buckets"] == list(LADDER)
        totals = doc["cost"]["totals"]
        assert totals["attributed_ms"] == pytest.approx(
            totals["dispatch_wall_ms"])
        # The kernel route sweeps the live rows: no padding on the card.
        assert totals["padded_rows"] == totals["rows"]

    def test_deadline_maps_to_504(self, rng, obs_on):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, test, _, _ = problem(rng)
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=(1,), max_batch=64, max_wait_ms=2000.0)
        try:
            st, body = http_post(s.base, "/predict", {
                "instances": [test.features[0].tolist()], "deadline_ms": 20})
            assert st == 504 and "error" in body
        finally:
            s.close()

    def test_overflow_maps_to_429(self, rng, obs_on):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, test, _, _ = problem(rng)
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=(1,), max_batch=2, max_queue_rows=2,
                   max_wait_ms=20000.0)
        try:
            first = {}
            t = threading.Thread(target=lambda: first.update(
                resp=http_post(s.base, "/predict",
                               {"instances": [test.features[0].tolist()]})))
            t.start()
            by = time.monotonic() + 10
            while (time.monotonic() < by
                   and s.app.batcher.pending_rows() == 0):
                time.sleep(0.005)
            assert s.app.batcher.pending_rows() == 1
            st, body = http_post(s.base, "/predict", {
                "instances": test.features[1:3].tolist()})
            assert st == 429 and "error" in body
            st_fill, _ = http_post(s.base, "/predict", {
                "instances": [test.features[3].tolist()]})
            assert st_fill == 200
            t.join(timeout=30)
            assert first["resp"][0] == 200
        finally:
            s.close()

    def test_malformed_requests_400(self, served):
        base, _, test, _ = served
        assert http_post(base, "/predict", {"rows": [[1.0]]})[0] == 400
        assert http_post(base, "/predict", {"instances": [[1.0, 2.0]]})[0] \
            == 400
        st, body = http_post(base, "/predict",
                             {"instances": test.features[:1].tolist(),
                              "deadline_ms": 1e400})
        assert st == 400 and "finite" in body["error"]
        st, body = http_post(base, "/predict",
                             {"instances": test.features[:1].tolist()},
                             {"x-knn-class": "NOT VALID"})
        assert st == 400 and "class" in body["error"]

    def test_unknown_endpoint_404(self, served):
        base = served[0]
        assert http_get(base, "/explain")[0] == 404
        assert http_post(base, "/train", {"instances": []})[0] == 404

    def test_disabled_layers_report_null_not_404(self, served):
        base, _, _, app = served
        st, body, _ = http_get(base, "/debug/quality")
        doc = json.loads(body)
        assert st == 200
        assert doc["enabled"] == {"shadow": False, "drift": False}
        assert doc["shadow"] is None and doc["drift"] is None
        st, body, _ = http_get(base, "/healthz")
        assert json.loads(body)["quality"] == {"shadow": None, "drift": None}

    def test_later_layers_answer_as_jax_with_the_layer_off(self, rng,
                                                           obs_on):
        """Every route of a later slice, on both servers with their
        layers off: the same status, and for the 200s the same keys and
        values (the version tag aside)."""
        from knn_tpu.serve.server import ServeApp as JServeApp
        from knn_tpu.serve.server import make_server as jmake_server
        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, _, jtrain, _ = problem(rng)
        jobs.enable()
        s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
                   warm=(1,))
        js = Served(JServeApp, jmake_server,
                    jknn.KNNClassifier(k=3, engine="xla").fit(jtrain),
                    warm=(1,))
        try:
            for route in ("/debug/quality", "/debug/capture",
                          "/debug/control", "/debug/history",
                          "/debug/alerts", "/admin/wal-since",
                          "/admin/snapshot"):
                st, body, _ = http_get(s.base, route)
                jst, jbody, _ = http_get(js.base, route)
                assert st == jst, route
                doc, jdoc = json.loads(body), json.loads(jbody)
                if st == 200:
                    assert doc == jdoc, route
                else:
                    assert doc["error"] == jdoc["error"], route
            for route in ("/insert", "/delete", "/admin/compact",
                          "/admin/capture", "/admin/wal-append",
                          "/admin/promote", "/admin/bootstrap"):
                st, doc = http_post(s.base, route, {})
                jst, jdoc = http_post(js.base, route, {})
                assert (st, doc["error"]) == (jst, jdoc["error"]), route
            h = json.loads(http_get(s.base, "/healthz")[1])
            jh = json.loads(http_get(js.base, "/healthz")[1])
            for block in ("ivf", "mutable", "workload", "shard", "fleet",
                          "control", "history", "alerts", "quality"):
                assert h[block] == jh[block], block
        finally:
            s.close()
            js.close()


class TestDrainOrdering:
    def test_listener_refuses_before_healthz_flips(self, rng, obs_on):
        import socket

        from knn_tpu_torch.serve.server import (
            ServeApp,
            drain_and_stop,
            make_server,
        )

        train, test, _, _ = problem(rng)
        app = ServeApp(KNNClassifier(k=3, **CPU).fit(train), max_batch=8,
                       max_wait_ms=300.0)
        server = make_server(app)
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        app.ready = True
        probe = {}
        orig_drain = app.drain

        def probing_drain(timeout_s):
            try:
                socket.create_connection((host, port), timeout=2).close()
                probe["refused"] = False
            except ConnectionRefusedError:
                probe["refused"] = True
            return orig_drain(timeout_s)

        app.drain = probing_drain
        results = []

        def client():
            st, _ = http_post(f"http://{host}:{port}", "/predict",
                              {"instances": [test.features[0].tolist()]})
            results.append(st)

        t = threading.Thread(target=client, daemon=True)
        t.start()
        time.sleep(0.1)
        try:
            summary = drain_and_stop(server, drain_timeout_s=10.0)
            t.join(timeout=15)
            assert probe["refused"] is True
            assert results == [200]
            assert summary["drained_clean"] is True
        finally:
            server.server_close()
            app.close()
