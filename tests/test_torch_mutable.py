"""The mutable tier on the port (the twin of ``tests/test_mutable.py``):
delta tier, tombstones, the write-ahead epoch log, compaction and the HTTP
routes of ``knn_tpu_torch.mutable`` and ``knn_tpu_torch.serve``, on the
CPU (``device="cpu"``: the kernels' plain versions and the torch scan),
then held against the JAX package on the same seeded mutations.

Each class twins the JAX class of the same name; the cross-package
classes at the end require:

- equal merged indices and predictions through each package's serving
  batcher, distances bit-equal on integer grids and within
  ``rtol = d * 2^-24`` on float rows;
- byte-equal epoch files, and a WAL written by either package replaying
  in the other to the same view;
- a generation compacted by either package loading in both.

Every HTTP and compactor test bounds its waits (joined threads with
timeouts, result timeouts), so none can hang the suite.
"""

import json
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from knn_tpu.models.knn import KNNClassifier as JKNNClassifier  # noqa: E402
from knn_tpu.models.knn import KNNRegressor as JKNNRegressor  # noqa: E402
from knn_tpu.mutable import compact as jcompact  # noqa: E402
from knn_tpu.mutable import engine as jengine  # noqa: E402
from knn_tpu.mutable import state as jstate  # noqa: E402
from knn_tpu.serve import artifact as jartifact  # noqa: E402
from knn_tpu.serve.batcher import MicroBatcher as JMicroBatcher  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor  # noqa: E402
from knn_tpu_torch.models.ordering import lexicographic_topk  # noqa: E402
from knn_tpu_torch.mutable.compact import (  # noqa: E402
    CompactionInProgress,
    Compactor,
    fold,
)
from knn_tpu_torch.mutable.engine import MutableEngine  # noqa: E402
from knn_tpu_torch.mutable.state import (  # noqa: E402
    MutableView,
    MutationConflict,
    merged_oracle_kneighbors,
    validate_insert,
)
from knn_tpu_torch.resilience.errors import DataError, OverloadError  # noqa: E402
from knn_tpu_torch.serve import artifact  # noqa: E402
from knn_tpu_torch.serve.artifact import load_index, save_index  # noqa: E402
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401

CPU = {"device": "cpu"}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _problem(rng, n=200, q=24, d=5, c=4):
    train_x = rng.integers(0, 4, (n, d)).astype(np.float32)  # grid -> ties
    train_y = rng.integers(0, c, n).astype(np.int32)
    test_x = np.concatenate(
        [train_x[rng.choice(n, q // 2, replace=False)],
         rng.integers(0, 4, (q - q // 2, d)).astype(np.float32)]
    )
    return Dataset(train_x, train_y), test_x


def _root(model, tmp_path):
    """A mutable engine needs a real artifact directory (its WAL and
    generations live inside one); reuse it across engines in a test."""
    out = tmp_path / "idx"
    if not (out / "manifest.json").exists():
        save_index(model, out)
    return out


def _engine(model, root, **kw):
    kw.setdefault("delta_cap", 256)
    return MutableEngine(model, root, **kw)


def _brute_force_view(model, view, queries, k):
    """Independent re-derivation of the merge contract: full distance
    matrix over [base; delta], tombstoned positional ids masked, one
    lexicographic top-k."""
    from knn_tpu_torch.backends.oracle import _metric_dists

    train = model.train_
    full = np.concatenate(
        [train.features, np.asarray(view.features[:view.count])])
    d = np.asarray(_metric_dists(np.asarray(queries, np.float32), full,
                                 model.metric), np.float64)
    np.nan_to_num(d, copy=False, nan=np.inf)
    ids = np.broadcast_to(np.arange(full.shape[0], dtype=np.int64),
                          d.shape).copy()
    for p in view.tomb_pos:
        d[:, p] = np.inf
        ids[:, p] = view.sentinel
    return lexicographic_topk(d, ids, k)


class TestMergeContract:
    def test_merged_oracle_matches_brute_force(self, rng, tmp_path):
        train, test_x = _problem(rng)
        model = KNNClassifier(k=4, engine="xla", **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            for _ in range(4):
                eng.apply_insert(
                    rng.integers(0, 4, (6, 5)).astype(np.float32),
                    rng.integers(0, 4, 6), 0)
            _, base_i = model.kneighbors(
                Dataset(test_x, np.zeros(len(test_x), np.int32)))
            victims = sorted({int(base_i[0, 0]), int(base_i[3, 0]),
                              int(base_i[7, 1]), 200 + 2, 200 + 11})
            eng.apply_delete(victims, 0)
            view = eng.snapshot()
            got_d, got_i = merged_oracle_kneighbors(model, view, test_x)
            want_d, want_i = _brute_force_view(model, view, test_x, model.k)
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_array_equal(
                got_d.astype(np.float32), want_d.astype(np.float32))
            for v in victims:
                assert not (got_i == v).any()
        finally:
            eng.close()

    def test_tie_order_base_beats_delta(self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            dup = train.features[17].copy()
            eng.apply_insert(dup[None, :], [1], 0)
            got_d, got_i = merged_oracle_kneighbors(
                model, eng.snapshot(), dup[None, :])
            row = got_i[0].tolist()
            assert 17 in row and 200 in row
            assert row.index(17) < row.index(200)
            assert got_d[0][row.index(200)] == 0.0
        finally:
            eng.close()

    @pytest.mark.parametrize("engine", ["xla", "auto"])
    def test_widening_never_returns_short_or_dead(self, rng, tmp_path,
                                                  engine):
        """Delete a query's ENTIRE base top-k: the served answer (the
        rung's own retrieval on the device widens) still has k live rows,
        none of them dead, equal to the brute-force truth."""
        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, engine=engine, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0, mutable=eng)
        try:
            q = test_x[:1]
            _, base_i = model.kneighbors(Dataset(q, np.zeros(1, np.int32)))
            victims = [int(v) for v in base_i[0]]
            b.submit_mutation("delete", {"ids": victims}).result(timeout=30)
            view = eng.snapshot()
            got_d, got_i = merged_oracle_kneighbors(model, view, q)
            assert got_i.shape == (1, 3)
            assert np.isfinite(got_d).all()
            assert not np.isin(got_i, victims).any()
            want_d, want_i = _brute_force_view(model, view, q, model.k)
            np.testing.assert_array_equal(got_i, want_i)
            sd, si = b.kneighbors(q, timeout=30)
            np.testing.assert_array_equal(si, want_i)
            np.testing.assert_array_equal(sd, want_d.astype(np.float32))
        finally:
            b.close()
            eng.close()

    def test_nan_query_masked_slots_rank_last(self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            eng.apply_delete([0, 1], 0)
            q = np.full((1, 5), np.nan, np.float32)
            _, got_i = merged_oracle_kneighbors(model, eng.snapshot(), q)
            assert got_i[0].tolist() == [2, 3, 4]
        finally:
            eng.close()

    def test_regressor_merge_votes_with_delta_targets(self, rng, tmp_path):
        from knn_tpu_torch.mutable.state import predict_from_view

        train, _ = _problem(rng)
        reg_train = Dataset(
            train.features, train.labels,
            raw_targets=np.linspace(0, 1, 200).astype(np.float32))
        model = KNNRegressor(k=2, engine="xla", **CPU).fit(reg_train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            q = np.full((1, 5), 77.0, np.float32)  # far from the grid
            eng.apply_insert(np.full((2, 5), 77.0, np.float32),
                             [5.0, 7.0], 0)
            view = eng.snapshot()
            d, i = merged_oracle_kneighbors(model, view, q)
            assert sorted(i[0].tolist()) == [200, 201]
            pred = predict_from_view(model, view, d, i)
            np.testing.assert_allclose(pred, [6.0], atol=1e-6)
        finally:
            eng.close()

    def test_validate_insert_typed_errors(self, rng):
        train, _ = _problem(rng)
        clf = KNNClassifier(k=3, **CPU).fit(train)
        with pytest.raises(ValueError, match=r"\[m, 5\]"):
            validate_insert(clf, [[1.0, 2.0]], [1])
        with pytest.raises(ValueError, match="empty insert"):
            validate_insert(clf, np.empty((0, 5), np.float32), [])
        with pytest.raises(ValueError, match="one label per row"):
            validate_insert(clf, np.ones((2, 5), np.float32), [1])
        with pytest.raises(ValueError, match="integers"):
            validate_insert(clf, np.ones((1, 5), np.float32), [1.5])
        with pytest.raises(ValueError, match="rebuild the index"):
            validate_insert(clf, np.ones((1, 5), np.float32), [99])
        reg = KNNRegressor(k=3, **CPU).fit(
            Dataset(train.features, train.labels,
                    raw_targets=np.zeros(200, np.float32)))
        with pytest.raises(ValueError, match="finite"):
            validate_insert(reg, np.ones((1, 5), np.float32), [np.nan])


class TestEngine:
    def test_snapshot_is_immutable_under_growth(self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path), delta_cap=512)
        try:
            eng.apply_insert(np.full((2, 5), 1.0, np.float32), [0, 1], 0)
            view = eng.snapshot()
            frozen = view.features[:view.count].copy()
            eng.apply_insert(
                rng.integers(0, 4, (200, 5)).astype(np.float32),
                rng.integers(0, 4, 200), 0)  # forces 64 -> 256 growth
            assert view.count == 2
            np.testing.assert_array_equal(view.features[:2], frozen)
            assert eng.snapshot().count == 202
        finally:
            eng.close()

    def test_delta_cap_is_backpressure(self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path), delta_cap=3)
        try:
            eng.apply_insert(np.ones((3, 5), np.float32), [0, 1, 2], 0)
            with pytest.raises(OverloadError, match="delta tier full"):
                eng.apply_insert(np.ones((1, 5), np.float32), [0], 0)
            b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                             mutable=eng)
            try:
                with pytest.raises(OverloadError, match="delta tier full"):
                    b.submit_mutation(
                        "insert", {"rows": np.ones((1, 5), np.float32),
                                   "values": [0]})
                assert not b._mutations  # never enqueued
            finally:
                b.close()
            eng.close()
            eng2 = _engine(model, _root(model, tmp_path), delta_cap=3)
            assert eng2.snapshot().count == 3
            eng2.close()
        finally:
            eng.close()

    def test_delete_conflicts_are_typed(self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            with pytest.raises(MutationConflict, match="no such row"):
                eng.apply_delete([9999], 0)
            with pytest.raises(MutationConflict, match="duplicate id"):
                eng.apply_delete([5, 5], 0)
            eng.apply_delete([5], 0)
            with pytest.raises(MutationConflict, match="already deleted"):
                eng.apply_delete([5], 0)
            with pytest.raises(ValueError, match="empty delete"):
                eng.apply_delete([], 0)
        finally:
            eng.close()

    def test_k_floor_refusal_leaves_wal_untouched(self, rng, tmp_path):
        train = Dataset(np.eye(4, dtype=np.float32)[:, :3].copy(),
                        np.zeros(4, np.int32))
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            with pytest.raises(MutationConflict, match="below k"):
                eng.apply_delete([0, 1], 0)
            eng.apply_delete([0], 0)  # leaves exactly k=3
            eng.close()
            eng2 = _engine(model, _root(model, tmp_path))
            assert eng2.snapshot().tomb_pos == frozenset({0})
            eng2.close()
        finally:
            eng.close()

    def test_replay_rebuilds_identical_state(self, rng, tmp_path):
        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        rows = rng.integers(0, 4, (5, 5)).astype(np.float32)
        eng.apply_insert(rows, [0, 1, 2, 3, 0], 0)
        eng.apply_delete([201, 17], 0)
        before = eng.snapshot()
        d0, i0 = merged_oracle_kneighbors(model, before, test_x)
        eng.close()

        eng2 = _engine(model, _root(model, tmp_path))
        try:
            after = eng2.snapshot()
            assert after.seq == before.seq
            assert after.count == before.count
            assert after.tomb_pos == before.tomb_pos
            np.testing.assert_array_equal(
                after.features[:after.count], before.features[:before.count])
            d1, i1 = merged_oracle_kneighbors(model, after, test_x)
            np.testing.assert_array_equal(i0, i1)
            ack = eng2.apply_insert(rows[:1], [1], 0)
            assert ack["seq"] == before.seq + 1
            assert eng2.snapshot().stable[after.count] == 205
        finally:
            eng2.close()

    def test_torn_final_record_dropped_with_warning(self, rng, tmp_path,
                                                    capsys):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
        eng.close()
        log = artifact.epoch_path(tmp_path / "idx", 1)
        with open(log, "a") as f:
            f.write('{"seq": 2, "op": "insert", "ro')  # crash mid-append
        eng2 = _engine(model, _root(model, tmp_path))
        try:
            assert eng2.snapshot().seq == 1
            assert eng2.snapshot().count == 1
            assert "torn final record" in capsys.readouterr().out
        finally:
            eng2.close()
        assert '"seq": 2' not in log.read_text()
        assert artifact.read_epoch_records(log) == ([json.loads(
            log.read_text().splitlines()[0])], False)
        eng3 = _engine(model, _root(model, tmp_path))
        try:
            assert eng3.snapshot().seq == 1
            assert eng3.snapshot().count == 1
        finally:
            eng3.close()

    def test_corrupt_mid_log_is_typed(self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
        eng.close()
        log = artifact.epoch_path(tmp_path / "idx", 1)
        log.write_text("GARBAGE\n" + log.read_text())
        with pytest.raises(DataError, match="corrupt epoch-log record"):
            _engine(model, _root(model, tmp_path))

    def test_non_monotonic_seq_is_typed(self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
        eng.close()
        log = artifact.epoch_path(tmp_path / "idx", 1)
        log.write_text(log.read_text() * 2)  # seq 1 twice
        with pytest.raises(DataError, match="not seq-monotonic"):
            _engine(model, _root(model, tmp_path))

    def test_freshness_and_export_fields(self, rng, tmp_path, obs_on):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            eng.apply_insert(np.ones((2, 5), np.float32), [0, 1],
                             time.monotonic_ns())
            eng.apply_delete([0], time.monotonic_ns())
            doc = eng.export()
            assert doc["delta_rows"] == 2 and doc["delta_slots"] == 2
            assert doc["tombstones"] == 1 and doc["seq"] == 2
            assert doc["freshness"]["count"] == 2
            assert doc["freshness"]["p99_ms"] is not None
            names = {i.name for i in obs_on.instruments()}
            assert {"knn_mutable_delta_rows", "knn_mutable_tombstones",
                    "knn_mutable_freshness_ms",
                    "knn_mutable_mutations_total"} <= names
        finally:
            eng.close()


@pytest.fixture
def obs_on(global_state):  # noqa: F811
    obs.enable()
    obs.reset()
    yield obs.registry()
    obs.reset()


class TestCompaction:
    def _artifact_engine(self, rng, tmp_path, *, ivf_cells=None, k=3):
        train, test_x = _problem(rng)
        model = KNNClassifier(k=k, engine="xla", **CPU).fit(train)
        ivf = None
        if ivf_cells:
            from knn_tpu_torch.index.ivf import IVFIndex

            ivf = IVFIndex.build(train.features, ivf_cells, seed=0, **CPU)
            model.ivf_ = ivf
        root = save_index(model, tmp_path / "idx", ivf=ivf)
        model = load_index(root, **CPU)
        return model, test_x, root

    def _compactor(self, eng, holder, **kw):
        def swap(new_model, version, rebase_hook):
            prev = holder.get("version")
            rebase_hook()
            holder["model"], holder["version"] = new_model, version
            return prev

        kw.setdefault("threshold", 10_000)
        kw.setdefault("interval_s", 0.0)
        return Compactor(eng, swap=swap,
                         warm=lambda m: holder.setdefault("warmed", []).
                         append(m), **kw)

    def test_fold_keeps_survivor_order(self, rng):
        train, _ = _problem(rng, n=6, q=4)
        base_stable = np.arange(6, dtype=np.int64)
        fold_input = {
            "count": 3,
            "stable": np.array([6, 7, 8], np.int64),
            "features": rng.integers(0, 4, (3, 5)).astype(np.float32),
            "values": np.array([1, 2, 3], np.float32),
            "tomb_stable": frozenset({1, 4, 7}),
            "seq": 5, "generation": 0,
        }
        new_train, new_stable, stats = fold(train, fold_input, base_stable)
        assert new_stable.tolist() == [0, 2, 3, 5, 6, 8]
        np.testing.assert_array_equal(new_train.features[:4],
                                      train.features[[0, 2, 3, 5]])
        np.testing.assert_array_equal(
            new_train.features[4:], fold_input["features"][[0, 2]])
        assert stats == {"base_kept": 4, "base_dropped": 2,
                         "delta_folded": 2, "delta_dropped": 1, "rows": 6}

    def test_compaction_round_trip_preserves_answers(self, rng, tmp_path):
        model, test_x, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        holder = {"model": model, "version": "v0"}
        comp = self._compactor(eng, holder)
        rows = rng.integers(0, 4, (4, 5)).astype(np.float32)
        eng.apply_insert(rows, [0, 1, 2, 3], 0)
        eng.apply_delete([7, 203], 0)
        before_d, _ = merged_oracle_kneighbors(model, eng.snapshot(),
                                               test_x)
        res = comp.run_once(force=True)
        assert res["compacted"] and res["generation"] == 1
        assert res["rows"] == 200 + 3 - 1
        assert set(res["split_ms"]) == {"seal", "fold", "save", "warm",
                                        "swap", "commit"}
        new_model = holder["model"]
        after_d, after_i = merged_oracle_kneighbors(
            new_model, eng.snapshot(), test_x)
        np.testing.assert_array_equal(after_d, before_d)
        assert eng.snapshot().count == 0  # everything folded
        cur = artifact.read_current(root)
        assert cur["generation"] == 1
        assert artifact.list_epochs(root)[0][0] == 2  # epoch 1 cleaned
        eng.close()

        base_dir, cur = artifact.resolve_mutable_base(root)
        model2 = load_index(base_dir, **CPU)
        eng2 = _engine(model2, root, current=cur, base_dir=base_dir)
        try:
            d2, i2 = merged_oracle_kneighbors(model2, eng2.snapshot(),
                                              test_x)
            np.testing.assert_array_equal(d2, after_d)
            np.testing.assert_array_equal(i2, after_i)
        finally:
            eng2.close()

    def test_mid_compaction_writes_survive(self, rng, tmp_path):
        model, test_x, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        holder = {"model": model, "version": "v0"}
        late_row = np.full((1, 5), 9.0, np.float32)

        def swap(new_model, version, rebase_hook):
            eng.apply_insert(late_row, [2], 0)
            rebase_hook()
            holder["model"], holder["version"] = new_model, version
            return "v0"

        comp = Compactor(eng, swap=swap, warm=lambda m: None,
                         threshold=10_000, interval_s=0.0)
        eng.apply_insert(rng.integers(0, 4, (2, 5)).astype(np.float32),
                         [0, 1], 0)
        comp.run_once(force=True)
        try:
            view = eng.snapshot()
            assert view.count == 1
            np.testing.assert_array_equal(view.features[0], late_row[0])
            d, i = merged_oracle_kneighbors(
                holder["model"], view, np.full((1, 5), 9.0, np.float32))
            assert i[0, 0] == 202 and d[0, 0] == 0.0
            eng.close()
            base_dir, cur = artifact.resolve_mutable_base(root)
            model2 = load_index(base_dir, **CPU)
            eng2 = _engine(model2, root, current=cur, base_dir=base_dir)
            assert eng2.snapshot().count == 1
            eng2.close()
        finally:
            eng.close()

    def test_failed_compaction_rolls_back(self, rng, tmp_path, obs_on):
        model, test_x, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)

        def bad_swap(new_model, version, rebase_hook):
            raise RuntimeError("synthetic swap failure")

        comp = Compactor(eng, swap=bad_swap, warm=lambda m: None,
                         threshold=10_000, interval_s=0.0)
        eng.apply_insert(np.full((1, 5), 9.0, np.float32), [2], 0)
        before = merged_oracle_kneighbors(model, eng.snapshot(), test_x)
        with pytest.raises(RuntimeError, match="synthetic swap failure"):
            comp.run_once(force=True)
        try:
            assert artifact.read_current(root) is None
            after = merged_oracle_kneighbors(model, eng.snapshot(), test_x)
            np.testing.assert_array_equal(after[0], before[0])
            assert eng._last_compaction["outcome"] == "rolled_back"
            eng.close()
            eng2 = _engine(model, root, base_dir=root)
            assert eng2.snapshot().count == 1
            eng2.close()
        finally:
            eng.close()

    def test_injected_fault_rolls_back(self, rng, tmp_path, obs_on):
        """The ``mutable.compact`` fault point between warmup and swap:
        a rollback counted as such, the old generation answering."""
        from knn_tpu_torch.resilience import faults

        model, test_x, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        holder = {"model": model, "version": "v0"}
        comp = self._compactor(eng, holder)
        try:
            eng.apply_insert(np.full((1, 5), 9.0, np.float32), [2], 0)
            with faults.inject("mutable.compact=once"):
                with pytest.raises(Exception, match="mutable.compact"):
                    comp.run_once(force=True)
            assert holder["version"] == "v0"
            rolled = [i for i in obs_on.instruments()
                      if i.name == "knn_mutable_compactions_total"
                      and dict(i.labels).get("outcome") == "rolled_back"]
            assert len(rolled) == 1 and rolled[0].value == 1
            assert comp.run_once(force=True)["compacted"]
            assert holder["version"] != "v0"
        finally:
            eng.close()

    def test_ivf_partition_reassigned(self, rng, tmp_path):
        model, test_x, root = self._artifact_engine(rng, tmp_path,
                                                    ivf_cells=8)
        eng = _engine(model, root, base_dir=root)
        holder = {"model": model, "version": "v0"}
        comp = self._compactor(eng, holder)
        try:
            eng.apply_insert(rng.integers(0, 4, (5, 5)).astype(np.float32),
                             [0, 1, 2, 3, 0], 0)
            res = comp.run_once(force=True)
            new_ivf = getattr(holder["model"], "ivf_", None)
            assert new_ivf is not None and new_ivf.num_cells == 8
            gen_model = load_index(
                artifact.generation_path(root, res["generation"]), **CPU)
            assert getattr(gen_model, "ivf_", None) is not None
            assert gen_model.train_.num_instances == 205
        finally:
            eng.close()

    def test_one_compaction_at_a_time(self, rng, tmp_path):
        model, _, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        comp = self._compactor(eng, {"model": model})
        try:
            eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
            assert comp._lock.acquire(blocking=False)
            try:
                with pytest.raises(CompactionInProgress):
                    comp.run_once(force=True)
            finally:
                comp._lock.release()
        finally:
            eng.close()

    def test_nothing_to_fold_is_a_no_op(self, rng, tmp_path):
        model, _, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        comp = self._compactor(eng, {"model": model})
        try:
            res = comp.run_once(force=True)
            assert res == {"compacted": False, "reason": "nothing to fold"}
            assert artifact.read_current(root) is None
        finally:
            eng.close()

    def test_version_precondition_checked_at_apply_not_admission(
            self, rng, tmp_path):
        model, _, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root, version="v0")
        holder = {"model": model, "version": "v0"}
        comp = self._compactor(eng, holder)
        try:
            eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
            eng.apply_delete([3], 0, expect_version="v0")
            with pytest.raises(MutationConflict,
                               match="precondition failed"):
                eng.apply_delete([4], 0, expect_version="stale")
            res = comp.run_once(force=True)
            with pytest.raises(MutationConflict,
                               match="precondition failed"):
                eng.apply_delete([5], 0, expect_version="v0")
            eng.apply_delete([5], 0,
                             expect_version=res["index_version"])
        finally:
            eng.close()

    def test_failed_rebase_restores_old_model_and_engine(
            self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        root = _root(model, tmp_path)
        eng = _engine(model, root, version="v0")
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                         index_version="v0", mutable=eng)
        try:
            eng.apply_insert(np.ones((2, 5), np.float32), [1, 0], 0)
            before = eng.snapshot()
            fold_input = eng.seal()
            model2 = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
            bad_stable = np.array([5, 3, 1], np.int64)  # not ascending
            with pytest.raises(DataError, match="not strictly ascending"):
                b.swap_model(model2, "v1",
                             hook=lambda: eng.rebase(fold_input, model2,
                                                     bad_stable, 1,
                                                     version="v1"))
            assert b._model is model and b._index_version == "v0"
            after = eng.snapshot()
            assert after.count == before.count
            assert after.base_n == before.base_n
            assert after.generation == before.generation
            eng.apply_delete([0], 0, expect_version="v0")
        finally:
            b.close()
            eng.close()

    def test_ack_version_is_stamped_under_the_engine_lock(
            self, rng, tmp_path):
        model, _, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root, version="v0")
        holder = {"model": model, "version": "v0"}
        comp = self._compactor(eng, holder)
        try:
            ack = eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
            assert ack["index_version"] == "v0"
            res = comp.run_once(force=True)
            ack2 = eng.apply_delete([3], 0)
            assert ack2["index_version"] == res["index_version"] != "v0"
        finally:
            eng.close()

    def test_leftover_repair_tmp_file_does_not_brick_boot(
            self, rng, tmp_path):
        model, _, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
        eng.close()
        stale = artifact.epoch_path(root, 1).with_name(
            "epoch-00000001.jsonl.tmp")
        stale.write_text('{"seq": 1, "op": "ins')  # torn repair attempt
        assert [n for n, _ in artifact.list_epochs(root)] == [1]
        eng2 = _engine(model, root, base_dir=root)
        try:
            assert eng2.snapshot().count == 1
        finally:
            eng2.close()

    def test_post_swap_commit_failure_is_not_reported_as_rollback(
            self, rng, tmp_path, monkeypatch):
        from knn_tpu_torch.mutable.compact import CompactionCommitFailed

        model, _, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        holder = {"model": model, "version": "v0"}
        comp = self._compactor(eng, holder)
        monkeypatch.setattr(
            artifact, "write_current",
            lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
        try:
            eng.apply_insert(np.ones((1, 5), np.float32), [1], 0)
            with pytest.raises(CompactionCommitFailed,
                               match="pointer commit failed"):
                comp.run_once(force=True)
            assert eng._last_compaction["outcome"] == "commit_failed"
            assert holder["version"] != "v0"
            assert artifact.read_current(root) is None
            eng.close()
            eng2 = _engine(model, root, base_dir=root)
            assert eng2.snapshot().count == 1
            eng2.close()
        finally:
            eng.close()

    def test_fold_promotes_fractional_regression_targets(self, rng):
        train = Dataset(rng.integers(0, 4, (6, 5)).astype(np.float32),
                        rng.integers(0, 3, 6).astype(np.int32))
        assert train.raw_targets is None
        fold_input = {
            "count": 2,
            "stable": np.array([6, 7], np.int64),
            "features": rng.integers(0, 4, (2, 5)).astype(np.float32),
            "values": np.array([2.7, -3.25], np.float32),
            "tomb_stable": frozenset(),
            "seq": 2, "generation": 0,
        }
        new_train, _, _ = fold(train, fold_input,
                               np.arange(6, dtype=np.int64))
        np.testing.assert_array_equal(
            new_train.targets[6:], np.array([2.7, -3.25], np.float32))
        np.testing.assert_array_equal(new_train.targets[:6],
                                      train.targets)

    def test_threshold_kick_compacts_without_interval_thread(
            self, rng, tmp_path):
        model, _, root = self._artifact_engine(rng, tmp_path)
        eng = _engine(model, root, base_dir=root)
        holder = {"model": model, "version": "v0"}
        comp = self._compactor(eng, holder, threshold=2, interval_s=0.0)
        comp.start()  # no-op at interval 0: no thread to consume kicks
        assert comp._thread is None
        try:
            eng.apply_insert(np.ones((2, 5), np.float32), [1, 0], 0)
            deadline = time.monotonic() + 30
            while comp.compactions == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert comp.compactions == 1
            assert holder["version"] != "v0"
            assert eng.snapshot().count == 0  # folded
        finally:
            comp.stop()
            eng.close()


class TestEmptyViewBitIdentity:
    """Mutable-on serving with an empty delta/tombstone set is
    byte-identical to mutable-off on every rung."""

    def test_empty_view_skips_the_merge_wrapper(self, rng):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0)
        try:
            empty = MutableView(
                features=np.zeros((0, 5), np.float32),
                values=np.zeros(0, np.float32),
                stable=np.zeros(0, np.int64), count=0,
                tomb_pos=frozenset(), tomb_base=np.empty(0, np.int64),
                tomb_delta_slots=np.empty(0, np.int64), seq=0,
                base_n=200, generation=0)
            plain = b._rungs(model)
            viewed = b._rungs(model, empty)
            assert [n for n, _ in plain] == [n for n, _ in viewed]
            for name, fn in viewed:
                assert "_merged_rung" not in fn.__qualname__, name
        finally:
            b.close()

    def test_every_rung_bit_identical_with_empty_view(self, rng, tmp_path):
        from knn_tpu_torch.index.ivf import IVFIndex, IVFServing

        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        model.ivf_ = IVFIndex.build(train.features, 8, seed=0, **CPU)
        root = save_index(model, tmp_path / "idx", ivf=model.ivf_)
        model = load_index(root, **CPU)
        eng = _engine(model, root, base_dir=root)
        ivf_serving = IVFServing(4, 8)
        b_off = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                             ivf=ivf_serving)
        b_on = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                            ivf=ivf_serving, mutable=eng)
        try:
            view = eng.snapshot()
            assert view.empty
            rungs_off = b_off._rungs(model)
            rungs_on = b_on._rungs(model, view)
            assert [n for n, _ in rungs_off] == [n for n, _ in rungs_on]
            assert [n for n, _ in rungs_on] == ["ivf", "fast"]
            for (name, f_off), (_, f_on) in zip(rungs_off, rungs_on):
                d0, i0 = f_off(test_x)
                d1, i1 = f_on(test_x)
                assert np.asarray(d0).tobytes() == \
                    np.asarray(d1).tobytes(), name
                assert np.asarray(i0).tobytes() == \
                    np.asarray(i1).tobytes(), name
        finally:
            b_off.close()
            b_on.close()
            eng.close()

    @pytest.mark.parametrize("engine", ["xla", "auto"])
    def test_served_bytes_identical_end_to_end(self, rng, tmp_path, engine):
        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, engine=engine, **CPU).fit(train)
        root = save_index(model, tmp_path / "idx")
        model = load_index(root, **CPU)
        eng = _engine(model, root, base_dir=root)
        b_off = MicroBatcher(model, max_batch=8, max_wait_ms=0.0)
        b_on = MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                            mutable=eng)
        try:
            d0, i0 = b_off.submit(test_x, "kneighbors").result(60)
            h = b_on.submit(test_x, "kneighbors")
            d1, i1 = h.result(60)
            assert h.meta["mutation_seq"] == 0
            assert d0.tobytes() == d1.tobytes()
            assert i0.tobytes() == i1.tobytes()
            p0 = b_off.submit(test_x, "predict").result(60)
            p1 = b_on.submit(test_x, "predict").result(60)
            assert np.asarray(p0).tobytes() == np.asarray(p1).tobytes()
        finally:
            b_off.close()
            b_on.close()
            eng.close()


class TestBucketing:
    @pytest.mark.parametrize("engine", ["auto", "xla"])
    def test_mutable_view_bucketed_matches_unbucketed(self, rng, tmp_path,
                                                      engine):
        """The twin of tests/test_bucketing.py's case: two byte-identical
        artifact stacks, identical mutations; the bucketed (staged upload)
        and cached batcher answers bit-identically to the plain one at
        every sequence point, its second pass from the cache."""
        train, test = _problem(rng, n=80, q=6)
        model = KNNClassifier(k=3, engine=engine, **CPU).fit(train)
        save_index(model, tmp_path / "a")
        shutil.copytree(tmp_path / "a", tmp_path / "b")

        def build(d, bucketed):
            m = load_index(d, **CPU)
            assert m._retrieval_engine() == engine
            eng = MutableEngine(m, d, version="v1")
            kw = dict(max_batch=8, max_wait_ms=0.0, mutable=eng,
                      index_version="v1")
            if bucketed:
                kw.update(buckets=(2, 4, 8), result_cache_rows=64)
            return MicroBatcher(m, **kw), eng

        plain, eng_a = build(tmp_path / "a", False)
        bucketed, eng_b = build(tmp_path / "b", True)
        try:
            ins = rng.normal(0.0, 2.0, (2, test.shape[1])).astype(np.float32)
            for bat in (plain, bucketed):
                bat.submit_mutation(
                    "insert", {"rows": ins, "values": [1, 2]}
                ).result(timeout=60)
                bat.submit_mutation("delete", {"ids": [0]}).result(
                    timeout=60)
            for _ in range(2):  # pass 2 = cache hits on the bucketed side
                hk_p = plain.submit(test, "kneighbors")
                hk_b = bucketed.submit(test, "kneighbors")
                wk, gk = hk_p.result(timeout=60), hk_b.result(timeout=60)
                assert hk_p.meta["mutation_seq"] == hk_b.meta[
                    "mutation_seq"] == 2
                np.testing.assert_array_equal(gk[0], wk[0])
                np.testing.assert_array_equal(gk[1], wk[1])
                np.testing.assert_array_equal(
                    bucketed.predict(test, timeout=60),
                    plain.predict(test, timeout=60))
            assert bucketed.cache.stats()["hits"] > 0
        finally:
            plain.close()
            bucketed.close()
            eng_a.close()
            eng_b.close()


class TestShadowScoringLiveView:
    def test_stale_answer_burns_recall(self, rng, tmp_path):
        from knn_tpu_torch.obs.quality import ShadowScorer

        train, _ = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            q = np.full((2, 5), 50.0, np.float32)  # far from the grid
            eng.apply_insert(np.full((3, 5), 50.0, np.float32),
                             [1, 1, 1], 0)
            view = eng.snapshot()
            stale_d, stale_i = model.kneighbors(
                Dataset(q, np.zeros(2, np.int32)))  # base-only: stale
            fresh_d, fresh_i = merged_oracle_kneighbors(model, view, q)
            sc = ShadowScorer(1.0, queue_cap=8)
            for d, i in ((stale_d, stale_i), (fresh_d, fresh_i)):
                sc.offer(features=q, kind="kneighbors", dists=d, idx=i,
                         preds=None, rung="fast", model=model,
                         version="v", mview=view)
            assert sc.drain(30)
            sc.close()
            stats = sc.export()["rungs"]["fast"]
            assert stats["scored"] == 2
            assert 0.0 < stats["recall"] < 1.0
        finally:
            eng.close()

    def test_fresh_answer_scores_exactly_one(self, rng, tmp_path):
        from knn_tpu_torch.obs.quality import ShadowScorer

        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            eng.apply_insert(rng.integers(0, 4, (3, 5)).astype(np.float32),
                             [0, 1, 2], 0)
            eng.apply_delete([0], 0)
            view = eng.snapshot()
            d, i = merged_oracle_kneighbors(model, view, test_x)
            sc = ShadowScorer(1.0, queue_cap=8)
            sc.offer(features=test_x, kind="kneighbors", dists=d, idx=i,
                     preds=None, rung="oracle", model=model, version="v",
                     mview=view)
            assert sc.drain(30)
            sc.close()
            stats = sc.export()["rungs"]["oracle"]
            assert stats["recall"] == 1.0
            assert stats["divergence"] == {}
        finally:
            eng.close()

    def test_served_merged_answers_score_clean(self, rng, tmp_path):
        """The batcher's own merged answers (predict and kneighbors),
        shadow-scored at rate 1.0 against the live view: zero
        divergences."""
        from knn_tpu_torch.obs.quality import ShadowScorer

        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        sc = ShadowScorer(1.0, queue_cap=64)
        b = MicroBatcher(model, max_batch=8, max_wait_ms=0.0, mutable=eng,
                         quality=sc)
        try:
            b.submit_mutation("insert", {
                "rows": rng.integers(0, 4, (6, 5)).astype(np.float32),
                "values": [0, 1, 2, 3, 0, 1]}).result(timeout=30)
            b.submit_mutation("delete", {"ids": [0, 3, 201]}).result(
                timeout=30)
            for kind in ("kneighbors", "predict"):
                b.submit(test_x, kind).result(timeout=30)
            assert sc.drain(30)
        finally:
            b.close()
            sc.close()
            eng.close()
        stats = sc.export()["rungs"]["fast"]
        assert stats["scored"] >= 2 and stats["recall"] == 1.0
        assert stats["divergence"] == {}


class TestMutableHTTP:
    @pytest.fixture
    def served_mutable(self, rng, obs_on, tmp_path):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(train)
        root = save_index(model, tmp_path / "idx")
        model = load_index(root, **CPU)
        app = ServeApp(model, max_batch=16, max_wait_ms=1.0,
                       index_path=str(root), index_version="v0",
                       mutable=True, delta_cap=8,
                       compact_threshold=10_000, compact_interval_s=0.0)
        server = make_server(app)
        host, port = server.server_address[:2]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        app.warm((1, 4))
        try:
            yield f"http://{host}:{port}", model, test_x, app
        finally:
            server.shutdown()
            server.server_close()
            app.close()
            thread.join(timeout=10)

    def _post(self, base, path, payload=None):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            base + path,
            data=json.dumps(payload if payload is not None else {}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def _get(self, base, path):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def test_read_after_write_with_sequence_point(self, served_mutable):
        base, model, test_x, app = served_mutable
        rows = np.full((3, 5), 9.0, np.float32)  # k rows AT the query
        st, ack = self._post(base, "/insert",
                             {"rows": rows.tolist(), "labels": [2, 2, 2]})
        assert st == 200 and ack["ids"] == [200, 201, 202]
        assert ack["seq"] == 1
        st, body = self._post(base, "/kneighbors",
                              {"instances": rows[:1].tolist()})
        assert st == 200
        assert body["mutation_seq"] >= 1
        assert body["indices"][0] == [200, 201, 202]
        assert body["distances"][0] == [0.0, 0.0, 0.0]
        st, body = self._post(base, "/predict",
                              {"instances": rows[:1].tolist()})
        assert st == 200 and body["predictions"] == [2]

    def test_typed_status_matrix(self, served_mutable):
        base, model, test_x, app = served_mutable
        row = test_x[0].tolist()
        assert self._post(base, "/insert", {"rows": [[1.0]],
                                            "labels": [0]})[0] == 400
        assert self._post(base, "/insert", {"rows": [row]})[0] == 400
        assert self._post(base, "/insert", {"rows": [row],
                                            "labels": [99]})[0] == 400
        assert self._post(base, "/delete", {"ids": [99999]})[0] == 409
        assert self._post(base, "/delete", {})[0] == 400
        st, body = self._post(base, "/delete",
                              {"ids": [0], "index_version": "stale"})
        assert st == 409 and "precondition" in body["error"]
        for _ in range(8):  # fill the delta tier (cap 8)
            self._post(base, "/insert", {"rows": [row], "labels": [1]})
        st, body = self._post(base, "/insert",
                              {"rows": [row], "labels": [1]})
        assert st == 429 and "delta tier full" in body["error"]

    def test_compact_swaps_version_and_preserves_answers(
            self, served_mutable):
        base, model, test_x, app = served_mutable
        self._post(base, "/insert",
                   {"rows": np.full((2, 5), 9.0).tolist(),
                    "labels": [1, 2]})
        self._post(base, "/delete", {"ids": [5]})
        st, before = self._post(base, "/kneighbors",
                                {"instances": test_x[:4].tolist()})
        st, res = self._post(base, "/admin/compact")
        assert st == 200 and res["compacted"]
        assert res["index_version"] != "v0"
        assert res["previous_version"] == "v0"
        assert app.index_version == res["index_version"]
        st, after = self._post(base, "/kneighbors",
                               {"instances": test_x[:4].tolist()})
        assert st == 200
        assert after["distances"] == before["distances"]
        assert after["index_version"] == res["index_version"]
        st, res2 = self._post(base, "/admin/compact")
        assert st == 200 and res2["compacted"] is False

    def test_hot_reload_disabled_under_mutable(self, served_mutable):
        base, *_ = served_mutable
        st, body = self._post(base, "/admin/reload", {})
        assert st == 400
        assert "compact" in body["error"]

    def test_observability_surfaces(self, served_mutable):
        base, model, test_x, app = served_mutable
        self._post(base, "/insert",
                   {"rows": [test_x[0].tolist()], "labels": [1]})
        st, body = self._get(base, "/healthz")
        blk = json.loads(body)["mutable"]
        assert blk["delta_rows"] == 1 and blk["epoch"] == 1
        assert blk["freshness"]["count"] == 1
        st, text = self._get(base, "/metrics")
        for row in ("knn_mutable_delta_rows 1", "knn_mutable_tombstones 0",
                    "knn_mutable_freshness_ms", "knn_mutable_epoch"):
            assert row in text, row
        st, body = self._get(base, "/debug/capacity")
        assert json.loads(body)["mutable"]["delta_rows"] == 1

    def test_draining_refuses_mutations_503(self, served_mutable):
        base, model, test_x, app = served_mutable
        app.draining = True
        app.batcher.begin_drain()
        st, body = self._post(base, "/insert",
                              {"rows": [test_x[0].tolist()],
                               "labels": [1]})
        assert st == 503 and "draining" in body["error"]

    def test_routes_404_while_off(self, rng, tmp_path):
        """``--mutable off``: the mutation routes are 404 with the layer
        named, as JAX answers them."""
        from knn_tpu_torch.serve.server import ServeApp, make_server

        train, test_x = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        app = ServeApp(model, max_batch=8, max_wait_ms=0.0)
        server = make_server(app)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = server.server_address[:2]
            for path in ("/insert", "/delete", "/admin/compact"):
                st, body = self._post(f"http://{host}:{port}", path,
                                      {"ids": [0]})
                assert st == 404 and "--mutable on" in body["error"]
        finally:
            server.shutdown()
            server.server_close()
            app.close()
            thread.join(timeout=10)


class TestWALReplicationEdges:
    def test_boot_replay_seq_gap_is_typed_never_skipped(self, rng,
                                                        tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        for v in (0, 1, 2):
            eng.apply_insert(np.full((1, 5), float(v), np.float32),
                             [v], 0)
        eng.close()
        path = artifact.epoch_path(_root(model, tmp_path), 1)
        lines = [ln for ln in path.read_text().splitlines() if ln]
        assert len(lines) == 3
        path.write_text("\n".join([lines[0], lines[2]]) + "\n")
        with pytest.raises(DataError, match="seq gap"):
            _engine(model, _root(model, tmp_path))

    def test_reapply_already_applied_seq_is_idempotent_noop(
            self, rng, tmp_path):
        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            eng.apply_insert(np.ones((2, 5), np.float32), [0, 1], 0)
            eng.apply_delete([3], 0)
            records, seq = eng.records_since(0)
            assert [r["seq"] for r in records] == [1, 2]
            assert all("digest" in r for r in records)
            before = eng.snapshot()
            for rec in records:
                out = eng.apply_replicated(rec)
                assert out == {"applied": False, "seq": seq}
            after = eng.snapshot()
            assert after.seq == before.seq
            assert after.count == before.count
            assert after.tomb_pos == before.tomb_pos
        finally:
            eng.close()
        eng2 = _engine(model, _root(model, tmp_path))
        try:
            records2, seq2 = eng2.records_since(0)
            assert seq2 == seq
            assert [(r["seq"], r["op"]) for r in records2] == [
                (1, "insert"), (2, "delete")]
        finally:
            eng2.close()

    def test_reapply_with_divergent_content_is_typed(self, rng,
                                                     tmp_path):
        from knn_tpu_torch.mutable.state import WALDivergence

        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        eng = _engine(model, _root(model, tmp_path))
        try:
            eng.apply_insert(np.ones((1, 5), np.float32), [0], 0)
            records, _seq = eng.records_since(0)
            evil = dict(records[0])
            evil["rows"] = [[9.0, 9.0, 9.0, 9.0, 9.0]]
            with pytest.raises(WALDivergence, match="diverged"):
                eng.apply_replicated(evil)
        finally:
            eng.close()

    def test_replicated_next_record_applies_and_gap_is_typed(
            self, rng, tmp_path):
        """A record at ``applied + 1`` applies through the local
        validation and is logged; one past it is a typed gap carrying the
        applied seq (the engine state the fleet, A12, will drive)."""
        from knn_tpu_torch.mutable.state import ReplicationGap

        train, _ = _problem(rng)
        model = KNNClassifier(k=3, **CPU).fit(train)
        src = _engine(model, _root(model, tmp_path / "a"))
        dst = _engine(model, _root(model, tmp_path / "b"))
        try:
            src.apply_insert(np.ones((2, 5), np.float32), [0, 1], 0)
            src.apply_delete([3], 0)
            records, _ = src.records_since(0)
            with pytest.raises(ReplicationGap) as gap:
                dst.apply_replicated(records[1])
            assert gap.value.applied_seq == 0
            for rec in records:
                assert dst.apply_replicated(rec)["applied"]
            assert dst.snapshot().tomb_pos == src.snapshot().tomb_pos
            assert dst.seq == 2
        finally:
            src.close()
            dst.close()


# -- against the JAX package -------------------------------------------------


def _jax_engine(model, root, **kw):
    kw.setdefault("delta_cap", 256)
    return jengine.MutableEngine(model, root, **kw)


def _seeded_mutations(seed: int, n_base: int, d: int, grid: bool):
    """One seeded sequence of (op, payload): inserts of 1-4 rows, deletes
    of base and delta rows, never below the k floor."""
    rng = np.random.default_rng(seed)
    ops, delta, dead = [], 0, set()
    for step in range(14):
        if step % 3 == 2:
            ids = {int(rng.integers(0, n_base))}
            if delta:
                ids.add(n_base + int(rng.integers(0, delta)))
            ids -= dead
            dead |= ids
            if ids:
                ops.append(("delete", {"ids": sorted(ids)}))
        else:
            m = int(rng.integers(1, 5))
            rows = (rng.integers(0, 4, (m, d)) if grid
                    else rng.normal(0, 2, (m, d))).astype(np.float32)
            ops.append(("insert", {"rows": rows,
                                   "values": rng.integers(0, 3, m)
                                   .astype(np.float32)}))
            delta += m
    return ops


def _apply(batcher, ops):
    for op, payload in ops:
        batcher.submit_mutation(op, payload).result(timeout=30)


class TestAgainstJAX:
    @pytest.mark.parametrize("grid", [True, False])
    @pytest.mark.parametrize("engine", ["xla", "auto"])
    def test_same_mutations_same_answers(self, rng, tmp_path, grid,
                                         engine):
        """The same seeded inserts and deletes through each package's
        serving batcher: equal indices and predictions; distances
        bit-equal on integer grids, within rtol = d * 2^-24 on float
        rows."""
        d = 6
        x = (rng.integers(0, 4, (300, d)) if grid
             else rng.normal(0, 2, (300, d))).astype(np.float32)
        y = rng.integers(0, 3, 300).astype(np.int32)
        qx = np.concatenate([x[:8], (rng.integers(0, 4, (8, d)) if grid
                                     else rng.normal(0, 2, (8, d)))
                             .astype(np.float32)])
        model = KNNClassifier(k=5, engine=engine, **CPU).fit(Dataset(x, y))
        jmodel = JKNNClassifier(k=5, engine="xla").fit(JDataset(x, y))
        eng = _engine(model, _root(model, tmp_path / "p"))
        jeng = _jax_engine(jmodel, jartifact.save_index(
            jmodel, tmp_path / "j"))
        b = MicroBatcher(model, max_batch=16, max_wait_ms=0.0, mutable=eng)
        jb = JMicroBatcher(jmodel, max_batch=16, max_wait_ms=0.0,
                           mutable=jeng)
        try:
            ops = _seeded_mutations(5, 300, d, grid)
            _apply(b, ops)
            _apply(jb, ops)
            h, jh = b.submit(qx, "kneighbors"), jb.submit(qx, "kneighbors")
            (pd, pi), (jd, ji) = h.result(30), jh.result(30)
            assert h.meta["mutation_seq"] == jh.meta["mutation_seq"]
            np.testing.assert_array_equal(pi, ji)
            if grid:
                np.testing.assert_array_equal(pd, jd)
            else:
                np.testing.assert_allclose(pd, jd, rtol=d * 2.0 ** -24,
                                           atol=0)
            np.testing.assert_array_equal(
                b.submit(qx, "predict").result(30),
                jb.submit(qx, "predict").result(30))
        finally:
            b.close()
            jb.close()
            eng.close()
            jeng.close()

    def test_regressor_same_answers(self, rng, tmp_path):
        d = 5
        x = rng.integers(0, 4, (120, d)).astype(np.float32)
        t = rng.normal(0, 1, 120).astype(np.float32)
        y = np.zeros(120, np.int32)
        qx = rng.integers(0, 4, (10, d)).astype(np.float32)
        model = KNNRegressor(k=4, weights="distance", engine="xla",
                             **CPU).fit(Dataset(x, y, raw_targets=t))
        jmodel = JKNNRegressor(k=4, weights="distance", engine="xla").fit(
            JDataset(x, y, raw_targets=t))
        eng = _engine(model, _root(model, tmp_path / "p"))
        jeng = _jax_engine(jmodel, jartifact.save_index(
            jmodel, tmp_path / "j"))
        b = MicroBatcher(model, max_batch=16, max_wait_ms=0.0, mutable=eng)
        jb = JMicroBatcher(jmodel, max_batch=16, max_wait_ms=0.0,
                           mutable=jeng)
        try:
            ops = _seeded_mutations(9, 120, d, True)
            _apply(b, ops)
            _apply(jb, ops)
            np.testing.assert_array_equal(
                b.submit(qx, "predict").result(30),
                jb.submit(qx, "predict").result(30))
        finally:
            b.close()
            jb.close()
            eng.close()
            jeng.close()

    def test_epoch_files_byte_equal(self, rng, tmp_path):
        x = rng.normal(0, 2, (100, 7)).astype(np.float32)
        y = rng.integers(0, 3, 100).astype(np.int32)
        model = KNNClassifier(k=3, **CPU).fit(Dataset(x, y))
        jmodel = JKNNClassifier(k=3).fit(JDataset(x, y))
        root, jroot = _root(model, tmp_path / "p"), jartifact.save_index(
            jmodel, tmp_path / "j")
        eng, jeng = _engine(model, root), _jax_engine(jmodel, jroot)
        try:
            for op, payload in _seeded_mutations(3, 100, 7, False):
                for e in (eng, jeng):
                    if op == "insert":
                        e.apply_insert(payload["rows"], payload["values"], 0)
                    else:
                        e.apply_delete(payload["ids"], 0)
        finally:
            eng.close()
            jeng.close()
        got = artifact.epoch_path(root, 1).read_bytes()
        want = jartifact.epoch_path(jroot, 1).read_bytes()
        assert got == want and got.count(b"\n") >= 10
        assert [jengine.wal_record_digest(r) for r in
                jartifact.read_epoch_records(
                    jartifact.epoch_path(jroot, 1))[0]] == [
            __import__("knn_tpu_torch.mutable.engine", fromlist=["x"])
            .wal_record_digest(r)
            for r in artifact.read_epoch_records(
                artifact.epoch_path(root, 1))[0]]

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_wal_replays_in_the_other_package(self, rng, tmp_path, writer):
        x = rng.integers(0, 4, (150, 5)).astype(np.float32)
        y = rng.integers(0, 3, 150).astype(np.int32)
        model = KNNClassifier(k=3, **CPU).fit(Dataset(x, y))
        jmodel = JKNNClassifier(k=3).fit(JDataset(x, y))
        src, dst = tmp_path / "src", tmp_path / "dst"
        if writer == "jax":
            jartifact.save_index(jmodel, src)
            e = _jax_engine(jmodel, src)
        else:
            save_index(model, src)
            e = _engine(model, src)
        for op, payload in _seeded_mutations(4, 150, 5, True):
            if op == "insert":
                e.apply_insert(payload["rows"], payload["values"], 0)
            else:
                e.apply_delete(payload["ids"], 0)
        want = e.snapshot()
        e.close()
        shutil.copytree(src, dst)
        if writer == "jax":
            other = _engine(load_index(dst, **CPU), dst)
        else:
            other = _jax_engine(jartifact.load_index(dst), dst)
        try:
            got = other.snapshot()
            assert (got.seq, got.count, got.tomb_pos) == (
                want.seq, want.count, want.tomb_pos)
            np.testing.assert_array_equal(
                got.features[:got.count], want.features[:want.count])
            np.testing.assert_array_equal(
                got.stable[:got.count], want.stable[:want.count])
        finally:
            other.close()

    @pytest.mark.parametrize("compactor", ["jax", "port"])
    def test_generation_loads_in_both(self, rng, tmp_path, compactor):
        """A generation compacted by either package loads in both, with
        the same train, stable ids and answers; the other package's engine
        boots on it through ``CURRENT.json``."""
        x = rng.integers(0, 4, (120, 5)).astype(np.float32)
        y = rng.integers(0, 3, 120).astype(np.int32)
        qx = rng.integers(0, 4, (6, 5)).astype(np.float32)
        if compactor == "jax":
            m = JKNNClassifier(k=3).fit(JDataset(x, y))
            root = jartifact.save_index(m, tmp_path / "idx")
            m = jartifact.load_index(root)
            e = _jax_engine(m, root)
            comp_cls = jcompact.Compactor
        else:
            m = KNNClassifier(k=3, **CPU).fit(Dataset(x, y))
            root = save_index(m, tmp_path / "idx")
            m = load_index(root, **CPU)
            e = _engine(m, root)
            comp_cls = Compactor
        holder = {}

        def swap(new_model, version, hook):
            hook()
            holder["model"] = new_model
            return None

        comp = comp_cls(e, swap=swap, warm=lambda mm: None,
                        threshold=10_000, interval_s=0.0)
        for op, payload in _seeded_mutations(6, 120, 5, True):
            if op == "insert":
                e.apply_insert(payload["rows"], payload["values"], 0)
            else:
                e.apply_delete(payload["ids"], 0)
        res = comp.run_once(force=True)
        e.close()
        gen = artifact.generation_path(root, res["generation"])
        p = load_index(gen, **CPU)
        j = jartifact.load_index(gen)
        np.testing.assert_array_equal(p.train_.features, j.train_.features)
        np.testing.assert_array_equal(p.train_.labels, j.train_.labels)
        block, stable = artifact.read_mutable_block(gen)
        jblock, jstable = jartifact.read_mutable_block(gen)
        assert block == jblock
        np.testing.assert_array_equal(stable, jstable)
        assert stable.dtype == np.int64
        manifest = json.loads((gen / "manifest.json").read_text())
        assert manifest["backend"] == "tpu"
        np.testing.assert_array_equal(
            p.kneighbors(Dataset(qx, np.zeros(6, np.int32)))[1],
            j.kneighbors(JDataset(qx, np.zeros(6, np.int32)))[1])
        # Both engines boot on the committed pointer and agree.
        base_dir, cur = artifact.resolve_mutable_base(root)
        pe = _engine(load_index(base_dir, **CPU), root, current=cur,
                     base_dir=base_dir)
        pe_view = pe.snapshot()
        pe.close()
        jb_dir, jcur = jartifact.resolve_mutable_base(root)
        je = _jax_engine(jartifact.load_index(jb_dir), root, current=jcur,
                         base_dir=jb_dir)
        try:
            jv = je.snapshot()
            assert (pe_view.seq, pe_view.base_n, pe_view.count) == (
                jv.seq, jv.base_n, jv.count)
        finally:
            je.close()

    def test_shadow_scorer_stale_answer_matches_jax(self, rng, tmp_path):
        """Both packages' scorers count a stale answer as a divergence and
        the fresh one as clean, on the same view."""
        from knn_tpu.obs.quality import ShadowScorer as JShadowScorer
        from knn_tpu_torch.obs.quality import ShadowScorer

        x = rng.integers(0, 4, (100, 5)).astype(np.float32)
        y = rng.integers(0, 3, 100).astype(np.int32)
        model = KNNClassifier(k=3, **CPU).fit(Dataset(x, y))
        jmodel = JKNNClassifier(k=3).fit(JDataset(x, y))
        eng = _engine(model, _root(model, tmp_path / "p"))
        jeng = _jax_engine(jmodel, jartifact.save_index(
            jmodel, tmp_path / "j"))
        q = np.full((2, 5), 50.0, np.float32)
        out = []
        try:
            for e, m, cls, ds in ((eng, model, ShadowScorer, Dataset),
                                  (jeng, jmodel, JShadowScorer, JDataset)):
                e.apply_insert(np.full((3, 5), 50.0, np.float32),
                               [1, 1, 1], 0)
                view = e.snapshot()
                stale = m.kneighbors(ds(q, np.zeros(2, np.int32)))
                sc = cls(1.0, queue_cap=8, seed=0)
                sc.offer(features=q, kind="kneighbors", dists=stale[0],
                         idx=stale[1], preds=None, rung="fast", model=m,
                         version="v", mview=view)
                assert sc.drain(30)
                sc.close()
                out.append(sc.export()["rungs"]["fast"])
        finally:
            eng.close()
            jeng.close()
        assert out[0]["recall"] == out[1]["recall"] == 0.0
        assert out[0]["divergence"] == out[1]["divergence"] != {}
