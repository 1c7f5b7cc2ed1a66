"""Sharded serving on the port (``knn_tpu_torch/shard/``), the twin of
``tests/test_shard.py`` (its plan, dispatch, model, IVF, mutable and
``ServeApp`` classes, and ``TestFleetShardGroups``, the router's shard
groups).

Every sharded answer is held two ways: bit-identical to the port's own
single-device rung on the same model, and equal to the JAX package's
sharded answer on the same seeded inputs (``knn_tpu.shard.model.
make_sharded``) — indices equal, distances bit-equal: the fixtures are
integer grids (plus a NaN query), where every distance is exact in both
packages. The port's engine ``auto`` runs the kernels' plain versions on
the CPU; ``xla`` the torch scan.
"""

from __future__ import annotations

import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from knn_tpu.index.ivf import IVF_ATTR as J_IVF_ATTR  # noqa: E402
from knn_tpu.index.ivf import IVFIndex as JIVFIndex  # noqa: E402
from knn_tpu.index.ivf import IVFServing as JIVFServing  # noqa: E402
from knn_tpu.models.knn import KNNClassifier as JKNNClassifier  # noqa: E402
from knn_tpu.models.knn import KNNRegressor as JKNNRegressor  # noqa: E402
from knn_tpu.shard import plan as jplan  # noqa: E402
from knn_tpu.shard.model import make_sharded as jmake_sharded  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.index.ivf import IVF_ATTR, IVFIndex, IVFServing  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor  # noqa: E402
from knn_tpu_torch.models.ordering import lexicographic_topk_torch  # noqa: E402
from knn_tpu_torch.mutable.engine import MutableEngine  # noqa: E402
from knn_tpu_torch.serve.artifact import save_index  # noqa: E402
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from knn_tpu_torch.shard import plan as plan_mod  # noqa: E402
from knn_tpu_torch.shard.model import make_sharded  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401

CPU = {"device": "cpu"}


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _tie_problem(rng, n=400, d=6, q=24):
    """Grid-valued features -> plentiful exact distance ties, plus an
    exact-match query and a NaN query (the adversarial corners)."""
    x = rng.integers(0, 4, (n, d)).astype(np.float32)
    h = min(10, n // 4)
    x[4 * h - h:4 * h] = x[0:h]  # duplicate rows: exact ties across shards
    qx = rng.integers(0, 4, (q, d)).astype(np.float32)
    qx[1] = x[min(17, n - 1)]  # exact match (distance 0 ties)
    qx[3, 2] = np.nan   # NaN query -> all +inf, ties broken by index
    return x, qx


def _qds(qx):
    return Dataset(qx, np.zeros(qx.shape[0], np.int32))


def _jqds(qx):
    return JDataset(qx, np.zeros(qx.shape[0], np.int32))


def _assert_bitwise(a, b, what=""):
    d1, i1 = a
    d2, i2 = b
    np.testing.assert_array_equal(np.asarray(i1, np.int64),
                                  np.asarray(i2, np.int64),
                                  err_msg=f"{what}: indices")
    assert (np.asarray(d1, np.float32).view(np.uint32)
            == np.asarray(d2, np.float32).view(np.uint32)).all(), \
        f"{what}: distances not bit-identical"


def _pair(cls, jcls, x, y, **kw):
    """The port's fitted model and JAX's, on the same rows."""
    return (cls(**kw, **CPU).fit(Dataset(x, y)),
            jcls(**kw).fit(JDataset(x, y)))


class TestShardPlan:
    @pytest.mark.parametrize("n,s", [(10, 3), (5, 1), (3, 500), (0, 4),
                                     (4096, 7)])
    def test_plan_rows_equals_jax(self, n, s):
        assert plan_mod.plan_rows(n, s) == jplan.plan_rows(n, s)
        with pytest.raises(ValueError):
            plan_mod.plan_rows(10, 0)

    def test_plan_rows_balanced_export(self):
        p = plan_mod.plan_rows(10, 3)
        assert p.row_starts == (0, 4, 7, 10)
        assert p.export()["rows_per_shard"] == [4, 3, 3]

    def test_plan_cells_equals_jax(self, rng):
        sizes = rng.integers(1, 40, 17)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        for s in (1, 5, 17, 64):
            assert plan_mod.plan_cells(offsets, s) == jplan.plan_cells(
                offsets, s)
        p = plan_mod.plan_cells(offsets, 5)
        for s in range(p.num_shards):
            c0, c1 = p.cells(s)
            assert c1 > c0
            assert p.rows(s) == (int(offsets[c0]), int(offsets[c1]))

    @pytest.mark.parametrize("count,s", [(7, 3), (2, 4), (0, 2), (9, 1)])
    def test_plan_delta_equals_jax(self, count, s):
        assert plan_mod.plan_delta(count, s) == jplan.plan_delta(count, s)

    def test_plan_rows_uniform_equals_jax(self):
        for n, stride, shards in [(403, 51, 8), (6, 51, 8), (0, 4, 3),
                                  (4096, 512, 8)]:
            assert plan_mod.plan_rows_uniform(n, shards, stride) == \
                jplan.plan_rows_uniform(n, shards, stride)
        with pytest.raises(ValueError):
            plan_mod.plan_rows_uniform(10, 0, 4)
        with pytest.raises(ValueError):
            plan_mod.plan_rows_uniform(10, 2, 0)

    def test_effective_shards_clamps(self):
        for args in ((8, 3), (2, 100), (4, 0)):
            assert plan_mod.effective_shards(*args) == \
                jplan.effective_shards(*args)
        with pytest.raises(ValueError):
            plan_mod.effective_shards(0, 5)


class TestLexicographicDeviceTwin:
    """The torch realization every cross-shard merge of the engines selects
    through, against the JAX one on adversarial tie plateaus."""

    def _plateau(self, rng, q=8, m=96):
        d = rng.choice(np.array([0.0, 1.0, np.inf], np.float32),
                       (q, m), p=[0.45, 0.45, 0.1])
        d[0] = 1.0
        idx = np.stack([rng.permutation(m) for _ in range(q)]).astype(
            np.int32)
        return d, idx

    def test_equals_jax_on_plateaus(self, rng):
        from knn_tpu.models.ordering import lexicographic_topk_jax

        d, idx = self._plateau(rng)
        for k in (1, 5, 64, 96):
            jd, ji = lexicographic_topk_jax(d, idx, k)
            td, ti = lexicographic_topk_torch(torch.from_numpy(d),
                                              torch.from_numpy(idx), k)
            _assert_bitwise((np.asarray(jd), np.asarray(ji)),
                            (td.numpy(), ti.numpy()), f"k={k}")

    def test_merge_candidates_vote_equals_jax(self, rng):
        import jax.numpy as jnp

        from knn_tpu.parallel.train_sharded import (
            merge_candidates_vote as jmerge,
        )
        from knn_tpu_torch.parallel.train_sharded import (
            merge_candidates_vote,
        )

        d, idx = self._plateau(rng, q=6, m=60)
        labels = (idx % 4).astype(np.int32)
        for perm_seed in range(3):
            order = np.random.default_rng(perm_seed).permutation(60)
            want = jmerge(jnp.asarray(d[:, order]),
                          jnp.asarray(idx[:, order]),
                          jnp.asarray(labels[:, order]), 7, 4)
            got = merge_candidates_vote(
                torch.from_numpy(d[:, order]),
                torch.from_numpy(idx[:, order]),
                torch.from_numpy(labels[:, order]), 7, 4)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestShardedExactBitIdentity:
    @pytest.mark.parametrize("engine", ["auto", "xla"])
    def test_classifier_matrix_vs_single_device(self, rng, engine):
        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model, jmodel = _pair(KNNClassifier, JKNNClassifier, x, y, k=5,
                              engine=engine if engine == "xla" else "auto")
        want = model.kneighbors(_qds(qx))
        want_pred = model.predict(_qds(qx))
        for s in (1, 2, 3, 7):
            sm = make_sharded(model, s)
            assert sm.shard_plan_.num_shards == s
            got = sm.kneighbors(_qds(qx))
            _assert_bitwise(want, got, f"shards={s}")
            _assert_bitwise(jmake_sharded(jmodel, s).kneighbors(_jqds(qx)),
                            got, f"jax shards={s}")
            np.testing.assert_array_equal(sm.predict(_qds(qx)), want_pred)

    def test_regressor_vs_single_device(self, rng):
        x, qx = _tie_problem(rng)
        y = rng.standard_normal(x.shape[0]).astype(np.float32)
        model, jmodel = _pair(KNNRegressor, JKNNRegressor, x, y, k=5,
                              engine="xla")
        sm = make_sharded(model, 3)
        _assert_bitwise(model.kneighbors(_qds(qx)), sm.kneighbors(_qds(qx)),
                        "regressor")
        _assert_bitwise(jmake_sharded(jmodel, 3).kneighbors(_jqds(qx)),
                        sm.kneighbors(_qds(qx)), "jax regressor")
        np.testing.assert_array_equal(sm.predict(_qds(qx)),
                                      model.predict(_qds(qx)))

    @pytest.mark.parametrize("engine", ["auto", "xla"])
    def test_shards_exceed_rows(self, rng, engine):
        x, qx = _tie_problem(rng, n=10, q=6)
        y = rng.integers(0, 2, 10).astype(np.int32)
        model, jmodel = _pair(KNNClassifier, JKNNClassifier, x, y, k=3,
                              engine=engine)
        sm = make_sharded(model, 500)  # clamps to one-row shards
        assert sm.shard_plan_.num_shards == 10
        _assert_bitwise(model.kneighbors(_qds(qx)), sm.kneighbors(_qds(qx)),
                        "shards>rows")
        _assert_bitwise(jmake_sharded(jmodel, 500).kneighbors(_jqds(qx)),
                        sm.kneighbors(_qds(qx)), "jax shards>rows")

    @pytest.mark.parametrize("engine", ["auto", "xla"])
    def test_k_exceeds_per_shard_candidates(self, rng, engine):
        x, qx = _tie_problem(rng, n=30, q=8)
        y = rng.integers(0, 2, 30).astype(np.int32)
        model, jmodel = _pair(KNNClassifier, JKNNClassifier, x, y, k=20,
                              engine=engine)
        sm = make_sharded(model, 7)  # ~4 rows/shard << k
        _assert_bitwise(model.kneighbors(_qds(qx)), sm.kneighbors(_qds(qx)),
                        "k>per-shard rows")
        _assert_bitwise(jmake_sharded(jmodel, 7).kneighbors(_jqds(qx)),
                        sm.kneighbors(_qds(qx)), "jax k>per-shard rows")

    def test_async_and_weighted_match(self, rng):
        x, qx = _tie_problem(rng, n=120, q=9)
        y = rng.integers(0, 3, 120).astype(np.int32)
        model = KNNClassifier(k=4, weights="distance", **CPU).fit(
            Dataset(x, y))
        sm = make_sharded(model, 4)
        _assert_bitwise(model.kneighbors(_qds(qx)),
                        sm.kneighbors_async(_qds(qx)).result(), "async")
        np.testing.assert_array_equal(sm.predict(_qds(qx)),
                                      model.predict(_qds(qx)))
        np.testing.assert_array_equal(
            sm.predict_async(_qds(qx)).result(), model.predict(_qds(qx)))

    def test_unfitted_model_raises(self):
        with pytest.raises(RuntimeError, match="fit"):
            make_sharded(KNNClassifier(k=3, **CPU), 2)

    def test_shard_metrics_registered(self, rng):
        x, qx = _tie_problem(rng, n=120, q=4)
        y = rng.integers(0, 2, 120).astype(np.int32)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(Dataset(x, y))
        obs.reset()
        obs.enable()
        try:
            make_sharded(model, 3).kneighbors(_qds(qx))
            names = set(obs.registry().to_json())
        finally:
            obs.disable()
            obs.reset()
        for want in ("knn_shard_dispatch_ms", "knn_shard_dispatch_ms_max",
                     "knn_shard_dispatch_ms_min", "knn_shard_dispatch_skew",
                     "knn_shard_candidates_total", "knn_shard_bytes_total"):
            assert want in names, (want, sorted(names))


def _ivf_pair(rng, cells, k=5):
    x, qx = _tie_problem(rng)
    y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
    model, jmodel = _pair(KNNClassifier, JKNNClassifier, x, y, k=k,
                          engine="xla")
    jpart = JIVFIndex.build(x, cells, seed=0)
    setattr(jmodel, J_IVF_ATTR, jpart)
    setattr(model, IVF_ATTR, IVFIndex(jpart.centroids, jpart.row_perm,
                                      jpart.cell_offsets, meta=jpart.meta))
    return x, qx, model, jmodel


class TestShardedIVFBitIdentity:
    def test_device_scorer_matrix(self, rng, monkeypatch):
        monkeypatch.setenv("KNN_TPU_IVF_SCORER", "device")
        x, qx, model, jmodel = _ivf_pair(rng, 16)
        for s in (1, 3, 50):  # 50 > 16 cells: clamps to one-cell shards
            sm = make_sharded(model, s)
            jsm = jmake_sharded(jmodel, s)
            if s > 16:
                assert sm.ivf_.shard_plan.num_shards == 16
            for k, nprobe in [(1, 1), (5, 4), (10, 16)]:
                want = model.ivf_.search(x, qx, k, nprobe, scorer="host",
                                         **CPU)
                got = sm.ivf_.search(x, qx, k, nprobe, scorer="device",
                                     **CPU)
                _assert_bitwise(want[:2], got[:2],
                                f"shards={s} k={k} nprobe={nprobe}")
                _assert_bitwise(jsm.ivf_.search(x, qx, k, nprobe,
                                                scorer="device")[:2],
                                got[:2], f"jax shards={s} k={k}")

    def test_serving_rung_through_sharded_model(self, rng, monkeypatch):
        monkeypatch.setenv("KNN_TPU_IVF_SCORER", "device")
        x, qx, model, jmodel = _ivf_pair(rng, 16)
        want = IVFServing(4, 16).kneighbors(model, qx)
        got = IVFServing(4, 16).kneighbors(make_sharded(model, 3), qx)
        _assert_bitwise(want, got, "ivf serving rung")
        _assert_bitwise(JIVFServing(4, 16).kneighbors(
            jmake_sharded(jmodel, 3), qx), got, "jax ivf serving rung")
        assert make_sharded(model, 3).shard_export()["ivf"]["num_shards"] \
            == 3


def _sharded_vs_plain_batchers(model, num_shards, tmp_path, **kw):
    """Two MicroBatchers over byte-identical artifacts: the sharded twin
    vs the plain model, each with its own device-tail mutable engine."""
    root_a = tmp_path / "idx-sharded"
    save_index(model, root_a, ivf=getattr(model, IVF_ATTR, None))
    root_b = tmp_path / "idx-plain"
    shutil.copytree(root_a, root_b)
    eng_a = MutableEngine(model, root_a, delta_cap=256,
                          device_tail="on", **kw)
    eng_b = MutableEngine(model, root_b, delta_cap=256,
                          device_tail="on", **kw)
    b_sh = MicroBatcher(make_sharded(model, num_shards), max_batch=64,
                        max_wait_ms=0.0, mutable=eng_a)
    b_pl = MicroBatcher(model, max_batch=64, max_wait_ms=0.0,
                        mutable=eng_b)
    return b_sh, b_pl


class TestShardedMutableBitIdentity:
    @pytest.mark.parametrize("engine", ["xla", "auto"])
    def test_merged_serving_matches_single_device(self, rng, tmp_path,
                                                  engine):
        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=5, engine=engine, **CPU).fit(Dataset(x, y))
        b_sh, b_pl = _sharded_vs_plain_batchers(model, 3, tmp_path)
        try:
            _assert_bitwise(b_pl.kneighbors(qx, timeout=60),
                            b_sh.kneighbors(qx, timeout=60), "no delta")
            rows = rng.standard_normal((30, x.shape[1])).astype(np.float32)
            vals = rng.integers(0, 3, 30).astype(np.float32)
            for b in (b_sh, b_pl):
                b.submit_mutation("insert",
                                  {"rows": rows, "values": vals}).result(
                    timeout=60)
            _assert_bitwise(b_pl.kneighbors(qx, timeout=60),
                            b_sh.kneighbors(qx, timeout=60), "insert")
            np.testing.assert_array_equal(b_sh.predict(qx, timeout=60),
                                          b_pl.predict(qx, timeout=60))
            for b in (b_sh, b_pl):
                b.submit_mutation("delete",
                                  {"ids": [x.shape[0] + 1]}).result(
                    timeout=60)
            d1, i1 = b_sh.kneighbors(qx, timeout=60)
            _assert_bitwise(b_pl.kneighbors(qx, timeout=60), (d1, i1),
                            "delta delete")
            assert not (np.asarray(i1) == x.shape[0] + 1).any()
            # base tombstone: the host merge, widening through the shards
            for b in (b_sh, b_pl):
                b.submit_mutation("delete", {"ids": [17]}).result(
                    timeout=60)
            d2, i2 = b_sh.kneighbors(qx, timeout=60)
            _assert_bitwise(b_pl.kneighbors(qx, timeout=60), (d2, i2),
                            "base tombstone")
            assert not (np.asarray(i2) == 17).any()
        finally:
            b_sh.close()
            b_pl.close()

    def test_merged_serving_matches_jax(self, rng, tmp_path):
        from knn_tpu.mutable.engine import MutableEngine as JMutableEngine
        from knn_tpu.serve.artifact import save_index as jsave_index
        from knn_tpu.serve.batcher import MicroBatcher as JMicroBatcher

        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model, jmodel = _pair(KNNClassifier, JKNNClassifier, x, y, k=5,
                              engine="xla")
        save_index(model, tmp_path / "p")
        jsave_index(jmodel, tmp_path / "j")
        b = MicroBatcher(make_sharded(model, 3), max_batch=64,
                         max_wait_ms=0.0, mutable=MutableEngine(
                             model, tmp_path / "p", delta_cap=256,
                             device_tail="on"))
        jb = JMicroBatcher(jmake_sharded(jmodel, 3), max_batch=64,
                           max_wait_ms=0.0, mutable=JMutableEngine(
                               jmodel, tmp_path / "j", delta_cap=256,
                               device_tail="on"))
        try:
            rows = rng.integers(0, 4, (30, x.shape[1])).astype(np.float32)
            vals = rng.integers(0, 3, 30).astype(np.float32)
            for bb in (b, jb):
                bb.submit_mutation("insert",
                                   {"rows": rows, "values": vals}).result(
                    timeout=60)
                bb.submit_mutation("delete",
                                   {"ids": [x.shape[0] + 2]}).result(
                    timeout=60)
            _assert_bitwise(jb.kneighbors(qx, timeout=60),
                            b.kneighbors(qx, timeout=60), "jax merged")
        finally:
            b.close()
            jb.close()

    def test_ivf_fused_delta_matches_single_device(self, rng, tmp_path,
                                                   monkeypatch):
        monkeypatch.setenv("KNN_TPU_IVF_SCORER", "device")
        x, qx, model, _ = _ivf_pair(rng, 12, k=4)
        sm = make_sharded(model, 4)
        root = tmp_path / "idx"
        save_index(model, root, ivf=model.ivf_)
        eng = MutableEngine(model, root, delta_cap=256, device_tail="on")
        rows = rng.standard_normal((30, x.shape[1])).astype(np.float32)
        eng.apply_insert(rows, rng.integers(0, 3, 30).astype(np.float32),
                         time.monotonic_ns())
        view = eng.snapshot()
        serving = IVFServing(4, 12)
        want = serving.kneighbors(model, qx, view=view)
        got = serving.kneighbors(sm, qx, view=view)
        _assert_bitwise(want, got, "sharded ivf fused delta")

    def test_slice_view_keeps_ids_global(self):
        from knn_tpu_torch.mutable import device_tail as dtail

        view = dtail.DeviceTailView(torch.arange(20.0).reshape(10, 2),
                                    torch.zeros(10, dtype=torch.bool), 7,
                                    100)
        s = dtail.slice_view(view, 3, 9)  # stops at the parent's count
        assert (s.count, s.base_n) == (4, 103)
        assert torch.equal(s.features, view.features[3:7])
        assert dtail.slice_view(view, 5, 2).count == 0


class TestServeAppSharding:
    def test_sharded_app_serves_bit_identical(self, rng):
        from knn_tpu_torch.serve.server import ServeApp

        x, qx = _tie_problem(rng, n=200, q=8)
        y = rng.integers(0, 3, 200).astype(np.int32)
        model = KNNClassifier(k=4, engine="xla", **CPU).fit(Dataset(x, y))
        plain = KNNClassifier(k=4, engine="xla", **CPU).fit(Dataset(x, y))
        app = ServeApp(model, max_batch=16, max_wait_ms=0.0, shards=2)
        ref = ServeApp(plain, max_batch=16, max_wait_ms=0.0)
        try:
            assert app.shards == 2
            np.testing.assert_array_equal(
                app.batcher.predict(qx, timeout=60),
                ref.batcher.predict(qx, timeout=60))
            block = app.health()["shard"]
            assert block["num_shards"] == 2
            assert sum(block["rows_per_shard"]) == 200
            assert block["dispatches"] >= 1
        finally:
            app.close()
            ref.close()

    def test_unsharded_app_constructs_nothing(self, rng):
        from knn_tpu_torch.serve.server import ServeApp

        x, _ = _tie_problem(rng, n=60, q=4)
        y = rng.integers(0, 2, 60).astype(np.int32)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(Dataset(x, y))
        app = ServeApp(model, max_batch=8, max_wait_ms=0.0)
        try:
            assert app.shards is None
            assert app.health()["shard"] is None
            assert not hasattr(app.model, "shard_plan_")
        finally:
            app.close()

    def test_shard_failure_degrades_to_unsharded_on_the_card(self, rng,
                                                           monkeypatch):
        from knn_tpu_torch.resilience.errors import DeviceError
        from knn_tpu_torch.serve.server import ServeApp
        from knn_tpu_torch.shard import dispatch

        x, qx = _tie_problem(rng, n=120, q=6)
        y = rng.integers(0, 3, 120).astype(np.int32)
        model = KNNClassifier(k=3, **CPU).fit(Dataset(x, y))
        want = model.kneighbors(_qds(qx))

        def broken(*a, **kw):
            raise DeviceError("shard dispatch failed", transient=False)

        monkeypatch.setattr(dispatch, "exact_sharded", broken)
        obs.reset()
        obs.enable()
        app = ServeApp(model, max_batch=16, max_wait_ms=0.0, shards=3)
        try:
            h = app.batcher.submit(qx, "kneighbors")
            _assert_bitwise(want, h.result(timeout=60), "unsharded rung")
            assert h.meta["rung"] == "unsharded"
            moves = obs.registry().to_json()["knn_serve_fallback_total"]
            assert moves[0]["labels"] == {
                "from_rung": "fast", "to": "unsharded",
                "reason": "DeviceError"}
        finally:
            app.close()
            obs.disable()
            obs.reset()

    def test_mutable_app_with_shards(self, rng, tmp_path):
        from knn_tpu_torch.serve.server import ServeApp

        x, qx = _tie_problem(rng, n=150, q=6)
        y = rng.integers(0, 3, 150).astype(np.int32)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(Dataset(x, y))
        save_index(model, tmp_path / "idx")
        app = ServeApp(model, max_wait_ms=0.0, index_path=str(
            tmp_path / "idx"), mutable=True, compact_interval_s=0.0,
            shards=3)
        try:
            app.batcher.submit_mutation("insert", {
                "rows": x[:4], "values": [0, 1, 2, 0]}).result(timeout=30)
            got = app.batcher.kneighbors(qx, timeout=30)
            assert app.compactor.run_once(force=True)["compacted"]
            assert app.model.shard_plan_.num_shards == 3
            _assert_bitwise(got, app.batcher.kneighbors(qx, timeout=30),
                            "after compaction")
        finally:
            app.close()


class TestFleetShardGroups:
    """The router's ``url1+url2`` shard groups (``fleet/health.py``): a
    group is usable only while every member is."""

    def _set(self, specs):
        from knn_tpu_torch.fleet.health import ReplicaSet

        return ReplicaSet(specs, interval_s=999, poll_timeout_s=1)

    def test_spec_parsing_heads_and_members(self):
        rs = self._set(["http://a:1+http://a:2", "http://b:1"])
        assert rs.urls == ["http://a:1", "http://b:1"]
        assert rs.groups == {"http://a:1": ("http://a:1", "http://a:2")}
        assert set(rs._states) == {"http://a:1", "http://a:2",
                                   "http://b:1"}

    def test_duplicate_member_across_specs_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            self._set(["http://x:1+http://x:2", "http://x:2"])

    def test_group_usable_only_when_every_member_healthy(self):
        rs = self._set(["http://a:1+http://a:2", "http://b:1"])
        for s in rs._states.values():
            s.healthy = True
        assert rs.usable_urls() == ["http://a:1", "http://b:1"]
        # kill the NON-head member: the head's own poll stays 200, but
        # the group must look down to routing (a partial shard group
        # cannot answer from its whole index)
        rs._states["http://a:2"].healthy = False
        assert not rs.is_healthy("http://a:1")
        assert rs.usable_urls() == ["http://b:1"]
        rs._states["http://a:2"].healthy = True
        assert rs.is_healthy("http://a:1")

    def test_group_gates_failover_queries_and_export(self):
        rs = self._set(["http://a:1+http://a:2", "http://b:1"])
        for s in rs._states.values():
            s.healthy = True
        rs._states["http://a:1"].role = "primary"
        rs._states["http://b:1"].role = "follower"
        assert rs.primary_url() == "http://a:1"
        rs._states["http://a:2"].healthy = False
        assert rs.primaries() == []
        assert rs.down_primary() == "http://a:1"  # failover trigger
        assert rs.most_caught_up() == "http://b:1"
        doc = rs.export()
        head = doc["replicas"]["http://a:1"]
        assert head["shard_group"]["members"] == ["http://a:1",
                                                  "http://a:2"]
        assert head["shard_group"]["unhealthy"] == ["http://a:2"]
        assert head["healthy"] is False  # the GROUP's usability
        assert doc["usable"] == 1
        assert "shard_group" not in doc["replicas"]["http://b:1"]
