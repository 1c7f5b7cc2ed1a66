"""The mutable tier's device programs on the port (ROADMAP B4; the twin of
``tests/test_device_path.py``'s ``TestDeviceDeltaTail``,
``TestIncrementalCompaction`` and the serving case of
``TestDeleteAwareProbeAccounting``), and ``ops/segment_score.py``'s
``delta_columns`` and fused delta scorer against
``knn_tpu/ops/segment_score.py``'s. On the CPU: the port's torch ops on CPU
tensors, JAX's jitted programs on XLA:CPU.

Tolerances: merged answers after the host re-rank are bit-identical to the
host merge's; the delta scores before any re-rank are bit-equal to JAX's on
integer grids and agree to ``SCORE_RTOL`` on float rows (each sums the
features in its own order); selections on integer grids are exact.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from knn_tpu.ops import segment_score as jseg  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.index.ivf import IVF_ATTR, IVFIndex, IVFServing  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor  # noqa: E402
from knn_tpu_torch.mutable import device_tail as dtail  # noqa: E402
from knn_tpu_torch.mutable.engine import MutableEngine  # noqa: E402
from knn_tpu_torch.mutable.state import merged_oracle_kneighbors  # noqa: E402
from knn_tpu_torch.ops import segment_score as seg  # noqa: E402
from knn_tpu_torch.serve.artifact import save_index  # noqa: E402
from knn_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402

CPU = {"device": "cpu"}

#: Subtraction-form delta distances before the re-rank: each package sums
#: D products in its own order (relative, per distance).
SCORE_RTOL = 11 * 2.0 ** -23


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _tie_problem(rng, n=400, d=6, q=24):
    """Grid-valued features -> plentiful exact distance ties, plus an
    exact-match query and a NaN query (the adversarial corners)."""
    x = rng.integers(0, 4, (n, d)).astype(np.float32)
    x[40:50] = x[0:10]
    qx = rng.integers(0, 4, (q, d)).astype(np.float32)
    qx[1] = x[17]
    qx[3, 2] = np.nan
    return x, qx


def _assert_bitwise(a, b, what=""):
    d1, i1 = a
    d2, i2 = b
    np.testing.assert_array_equal(i1, i2, err_msg=f"{what}: indices")
    assert (np.asarray(d1, np.float32).view(np.uint32)
            == np.asarray(d2, np.float32).view(np.uint32)).all(), \
        f"{what}: distances not bit-identical"


def _mutable_pair(model, tmp_path, **kw):
    """Two engines over byte-identical artifacts: device tail forced on
    vs off — the merged-serving bit-identity harness."""
    import shutil

    root_on = tmp_path / "idx-on"
    save_index(model, root_on, ivf=getattr(model, IVF_ATTR, None))
    root_off = tmp_path / "idx-off"
    shutil.copytree(root_on, root_off)
    on = MutableEngine(model, root_on, delta_cap=256, device_tail="on", **kw)
    off = MutableEngine(model, root_off, delta_cap=256, device_tail="off",
                        **kw)
    return on, off


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


class TestDeltaColumns:
    @pytest.mark.parametrize("grid", [True, False])
    def test_against_jax(self, rng, grid):
        cap, d, b = 40, 6, 9
        rows = (rng.integers(0, 4, (cap, d)) if grid
                else rng.normal(0, 2, (cap, d))).astype(np.float32)
        q = (rng.integers(0, 4, (b, d)) if grid
             else rng.normal(0, 2, (b, d))).astype(np.float32)
        q[2, 1] = np.nan
        dead = np.zeros(cap, bool)
        dead[[3, 17]] = True
        base_n, count = 1000, 31
        dd, di, sent = seg.delta_columns(_t(q), _t(rows), _t(dead),
                                         base_n, count)
        jd, ji, jsent = jseg.delta_columns(
            jnp.asarray(q), jnp.asarray(rows), jnp.asarray(dead),
            jnp.asarray(base_n, jnp.int32), jnp.asarray(count, jnp.int32))
        assert sent == int(jsent) == base_n + count
        np.testing.assert_array_equal(di.numpy(), np.asarray(ji))
        if grid:
            np.testing.assert_array_equal(dd.numpy(), np.asarray(jd))
        else:
            np.testing.assert_allclose(dd.numpy(), np.asarray(jd),
                                       rtol=SCORE_RTOL, atol=0)
        # The liveness rule: dead and pad slots at (+inf, sentinel).
        masked = dead | (np.arange(cap) >= count)
        assert np.isinf(dd.numpy()[:, masked]).all()
        assert (di.numpy()[:, masked] == sent).all()

    def test_chunking_does_not_change_answers(self, rng, monkeypatch):
        cap, d, b = 64, 5, 33
        rows = rng.normal(0, 2, (cap, d)).astype(np.float32)
        q = rng.normal(0, 2, (b, d)).astype(np.float32)
        dead = np.zeros(cap, bool)
        one = seg.delta_columns(_t(q), _t(rows), _t(dead), 10, 50)
        monkeypatch.setattr(seg, "SCORE_BYTES_CAP", 8 * cap * d * 3)
        many = seg.delta_columns(_t(q), _t(rows), _t(dead), 10, 50)
        assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])
        # ... and through the merge core and the fused scorer.
        base_d = torch.full((b, 4), 5.0)
        base_i = torch.arange(4, dtype=torch.int32).expand(b, 4)
        monkeypatch.setattr(seg, "SCORE_BYTES_CAP", 256 << 20)
        want = dtail._delta_merge_core(base_d, base_i, _t(q), _t(rows),
                                       _t(dead), 10, 50, 12)
        monkeypatch.setattr(seg, "SCORE_BYTES_CAP", 8 * cap * d)
        got = dtail._delta_merge_core(base_d, base_i, _t(q), _t(rows),
                                      _t(dead), 10, 50, 12)
        assert all(torch.equal(a, c) for a, c in zip(want, got))


class TestFusedDeltaScorer:
    def test_against_jax_on_integer_grid(self, rng):
        """The probed segments plus the delta tail in one selection: the
        port's survivors equal JAX's (integer grid: exact distances, the
        exact sort runs on every plateau)."""
        x, qx = _tie_problem(rng, n=300)
        qx = qx[np.isfinite(qx).all(axis=1)]
        ivf = IVFIndex.build(x, 8, seed=0, **CPU)
        perm_rows, perm_ids = seg.device_operands(x, ivf.row_perm, "cpu")
        sel = np.argsort(((qx[:, None] - ivf.centroids[None]) ** 2).sum(-1),
                         axis=1, kind="stable")[:, :3]
        starts = ivf.cell_offsets[:-1][sel].astype(np.int32)
        lens = ivf.cell_sizes[sel].astype(np.int32)
        m_pad = int(lens.sum(axis=1).max())
        cap, count = 16, 12
        rows = rng.integers(0, 4, (cap, x.shape[1])).astype(np.float32)
        dead = np.zeros(cap, bool)
        dead[5] = True
        kk = 9
        sd, si = seg.segment_topk_delta_core(
            perm_rows, perm_ids, _t(qx), _t(starts), _t(lens), None,
            _t(rows), _t(dead), x.shape[0], count, m_pad, kk)
        jd, ji = jseg._segment_topk_delta_core(
            jnp.asarray(perm_rows.numpy()), jnp.asarray(perm_ids.numpy()),
            jnp.asarray(qx), jnp.asarray(starts), jnp.asarray(lens),
            jnp.ones(qx.shape[0], bool), jnp.asarray(rows),
            jnp.asarray(dead), jnp.asarray(x.shape[0], jnp.int32),
            jnp.asarray(count, jnp.int32), m_pad=m_pad, kk=kk)
        # Each keeps a superset of the exact (distance, index) top-k: the
        # first k, after the exact order, agree.
        from knn_tpu_torch.models.ordering import lexicographic_topk

        k = 4
        pd, pi = lexicographic_topk(sd.numpy(), si.numpy().astype(np.int64),
                                    k)
        wd, wi = lexicographic_topk(np.asarray(jd),
                                    np.asarray(ji).astype(np.int64), k)
        np.testing.assert_array_equal(pi, wi)
        np.testing.assert_array_equal(pd, wd)
        # Id N == base_n is delta slot 0 only: a base pad slot carrying it
        # was remapped to the sentinel, so every survivor with that id has
        # slot 0's distance.
        d0 = ((qx - rows[0]) ** 2).sum(axis=1)
        hit = si.numpy() == x.shape[0]
        np.testing.assert_array_equal(sd.numpy()[hit],
                                      np.broadcast_to(d0[:, None],
                                                      hit.shape)[hit])

    def test_tie_plateau_base_beats_delta_masked_last(self):
        """Equal distances: the base row (lower id) ranks before the delta
        slot; a NaN query makes every distance +inf, and the masked dead
        and pad slots (the sentinel) rank after every real row."""
        d = 3
        rows = np.zeros((8, d), np.float32)
        rows[0] = [1, 0, 0]       # slot 0: distance 1 from the origin
        rows[1] = [0, 0, 0]       # slot 1: dead, distance 0
        dead = np.zeros(8, bool)
        dead[1] = True
        base_n, count = 50, 3     # slots 3..7 are pad
        q = np.zeros((2, d), np.float32)
        q[1] = np.nan
        base_d = torch.tensor([[1.0, 1.0], [np.inf, np.inf]])
        base_i = torch.tensor([[7, 9], [7, 9]], dtype=torch.int32)
        sd, si = dtail._delta_merge_core(base_d, base_i, _t(q), _t(rows),
                                         _t(dead), base_n, count, 10)
        # Row 0: slot 2 (zeros, distance 0) first, then the plateau at
        # 1.0: base 7, base 9, delta slot 0 (id 50); masked last.
        assert si[0, :4].tolist() == [52, 7, 9, 50]
        assert (si[0, 4:] == base_n + count).all()
        # Row 1 (NaN): every live candidate at +inf in id order, then the
        # sentinel for the dead and pad slots.
        assert si[1, :4].tolist() == [7, 9, 50, 52]
        assert (si[1, 4:] == base_n + count).all()
        assert torch.isinf(sd[1]).all()

    def test_held_snapshot_frozen_across_append_delete_growth(
            self, rng, tmp_path):
        """A view's tensors never change: appends write a new buffer
        (even into the quantum's live slots), deletes a new mask, growth a
        new tail — the held view's merge answers the same throughout."""
        x = rng.integers(0, 4, (60, 4)).astype(np.float32)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(
            Dataset(x, rng.integers(0, 2, 60).astype(np.int32)))
        save_index(model, tmp_path / "idx")
        eng = MutableEngine(model, tmp_path / "idx", delta_cap=512,
                            device_tail="on")
        try:
            eng.apply_insert(rng.integers(0, 4, (5, 4)).astype(np.float32),
                             [0, 1, 0, 1, 0], 0)
            view = eng.snapshot()
            q = rng.integers(0, 4, (6, 4)).astype(np.float32)
            base_d = torch.full((6, 3), 2.0)
            base_i = torch.arange(3, dtype=torch.int32).expand(6, 3)
            tail = dtail.make_merge_tail(view.device, 3)
            want = [t.clone() for t in tail(base_d, base_i, _t(q))]
            feats = view.device.features.clone()
            eng.apply_insert(rng.integers(0, 4, (2, 4)).astype(np.float32),
                             [1, 1], 0)           # same cap: quantum clone
            eng.apply_delete([61], 0)              # new dead mask
            eng.apply_insert(rng.integers(0, 4, (100, 4)).astype(
                np.float32), np.zeros(100), 0)     # growth: a new tail
            assert torch.equal(view.device.features, feats)
            assert not view.device.dead.any()
            got = tail(base_d, base_i, _t(q))
            assert all(torch.equal(a, b) for a, b in zip(want, got))
        finally:
            eng.close()


class TestDeviceDeltaTail:
    def test_lazy_activation_and_modes(self, rng, tmp_path):
        x, _ = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(Dataset(x, y))
        on, off = _mutable_pair(model, tmp_path)
        try:
            assert on.snapshot().device is None  # lazy: nothing inserted
            on.apply_insert(x[:2], y[:2].astype(np.float32),
                            time.monotonic_ns())
            tv = on.snapshot().device
            assert tv is not None and tv.count == 2
            assert tv.base_n == x.shape[0]
            assert tv.features.device.type == "cpu"
            off.apply_insert(x[:2], y[:2].astype(np.float32),
                             time.monotonic_ns())
            assert off.snapshot().device is None  # off: never constructs
            assert on.export()["device_tail"] == {"mode": "on",
                                                  "active": True}
        finally:
            on.close()
            off.close()

    def test_auto_threshold_activation(self, rng, tmp_path, monkeypatch):
        from knn_tpu_torch.mutable import engine as eng_mod

        monkeypatch.setattr(eng_mod, "DEVICE_TAIL_MIN_ROWS", 8)
        monkeypatch.delenv("KNN_TPU_DEVICE_TAIL", raising=False)
        x, _ = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(Dataset(x, y))
        root = tmp_path / "idx"
        save_index(model, root)
        eng = MutableEngine(model, root, delta_cap=256)
        try:
            eng.apply_insert(x[:4], y[:4].astype(np.float32),
                             time.monotonic_ns())
            assert eng.snapshot().device is None  # below the threshold
            eng.apply_insert(x[4:12], y[4:12].astype(np.float32),
                             time.monotonic_ns())
            assert eng.snapshot().device is not None
        finally:
            eng.close()

    def test_growth_keeps_snapshots_frozen(self, rng, tmp_path):
        x, _ = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=3, engine="xla", **CPU).fit(Dataset(x, y))
        on, off = _mutable_pair(model, tmp_path)
        try:
            rows = rng.standard_normal((20, x.shape[1])).astype(np.float32)
            on.apply_insert(rows, rng.integers(0, 3, 20).astype(np.float32),
                            time.monotonic_ns())
            tv = on.snapshot().device
            frozen = tv.features[:tv.count].clone()
            more = rng.standard_normal((200, x.shape[1])).astype(np.float32)
            on.apply_insert(more, rng.integers(0, 3, 200).astype(
                np.float32), time.monotonic_ns())
            assert torch.equal(tv.features[:tv.count], frozen)
            v2 = on.snapshot()
            np.testing.assert_array_equal(
                v2.device.features[:v2.count].numpy(),
                np.asarray(v2.features)[:v2.count])
        finally:
            on.close()
            off.close()

    def test_merged_serving_bit_identity_both_families(self, rng,
                                                       tmp_path):
        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        for family in ("classifier", "regressor"):
            if family == "classifier":
                model = KNNClassifier(k=5, engine="xla", **CPU).fit(
                    Dataset(x, y))
            else:
                model = KNNRegressor(k=5, engine="xla", **CPU).fit(
                    Dataset(x, y))
            on, off = _mutable_pair(model, tmp_path / family)
            rows = rng.standard_normal((30, x.shape[1])).astype(np.float32)
            vals = rng.integers(0, 3, 30).astype(np.float32)
            for e in (on, off):
                e.apply_insert(rows, vals, time.monotonic_ns())
            b_on = MicroBatcher(model, max_batch=64, max_wait_ms=0.0,
                                mutable=on)
            b_off = MicroBatcher(model, max_batch=64, max_wait_ms=0.0,
                                 mutable=off)
            try:
                launches = dtail._delta_merge_core.launches
                _assert_bitwise(b_off.kneighbors(qx, timeout=60),
                                b_on.kneighbors(qx, timeout=60),
                                f"{family} insert-only")
                assert dtail._delta_merge_core.launches == launches + 1
                np.testing.assert_array_equal(
                    b_on.predict(qx, timeout=60),
                    b_off.predict(qx, timeout=60))
                for b in (b_on, b_off):
                    b.submit_mutation(
                        "delete", {"ids": [x.shape[0] + 1]}).result(
                        timeout=60)
                d1, i1 = b_on.kneighbors(qx, timeout=60)
                _assert_bitwise(b_off.kneighbors(qx, timeout=60),
                                (d1, i1), f"{family} delta delete")
                assert not (i1 == x.shape[0] + 1).any()
                for b in (b_on, b_off):
                    b.submit_mutation("delete", {"ids": [17]}).result(
                        timeout=60)
                launches = dtail._delta_merge_core.launches
                d1, i1 = b_on.kneighbors(qx, timeout=60)
                # A base tombstone takes the host merge.
                assert dtail._delta_merge_core.launches == launches
                _assert_bitwise(b_off.kneighbors(qx, timeout=60),
                                (d1, i1), f"{family} base tombstone")
                assert not (i1 == 17).any()
                want = merged_oracle_kneighbors(model, on.snapshot(), qx)
                np.testing.assert_array_equal(i1, want[1])
            finally:
                b_on.close()
                b_off.close()
                on.close()
                off.close()

    def test_ivf_rung_fused_delta_bit_identity(self, rng, tmp_path):
        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=4, engine="xla", **CPU).fit(Dataset(x, y))
        setattr(model, IVF_ATTR, IVFIndex.build(x, 12, seed=0, **CPU))
        on, off = _mutable_pair(model, tmp_path)
        try:
            rows = rng.standard_normal((30, x.shape[1])).astype(np.float32)
            for e in (on, off):
                e.apply_insert(rows, rng.integers(0, 3, 30).astype(
                    np.float32), time.monotonic_ns())
            serving = IVFServing(4, 12)
            launches = seg.segment_topk_delta_core.launches
            got = serving.kneighbors(model, qx, view=on.snapshot())
            assert seg.segment_topk_delta_core.launches == launches + 1
            want = serving.kneighbors(model, qx, view=off.snapshot())
            _assert_bitwise(want, got, "ivf fused delta")
            st = model.ivf_.search_merged(x, qx, 4, 4, on.snapshot(),
                                          **CPU)[2]
            assert st.merged_delta and st.scorer == "device"
            # Full probe, fused: the merged oracle's bits.
            full = model.ivf_.search_merged(x, qx, 4, 12, on.snapshot(),
                                            **CPU)[:2]
            _assert_bitwise(merged_oracle_kneighbors(model, on.snapshot(),
                                                     qx), full, "full")
        finally:
            on.close()
            off.close()

    def test_concurrent_mutation_vs_reads(self, rng, tmp_path):
        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=4, engine="xla", **CPU).fit(Dataset(x, y))
        on, off = _mutable_pair(model, tmp_path)
        b = MicroBatcher(model, max_batch=64, max_wait_ms=0.0, mutable=on)
        stop = threading.Event()
        errors = []
        wrng = np.random.default_rng(11)

        def writer():
            i = 0
            while not stop.is_set() and i < 40:
                rows = wrng.standard_normal((3, x.shape[1])).astype(
                    np.float32)
                try:
                    b.submit_mutation("insert", {
                        "rows": rows,
                        "values": wrng.integers(0, 3, 3).astype(np.float32),
                    }).result(timeout=30)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                i += 1

        t = threading.Thread(target=writer)
        t.start()
        try:
            for _ in range(15):
                h = b.submit(qx, "kneighbors")
                d, i = h.result(timeout=60)
                assert d.shape == (qx.shape[0], 4)
                with np.errstate(invalid="ignore"):
                    steps = np.diff(d, axis=1)
                ok = np.isfinite(steps)
                assert (steps[ok] >= 0).all()
        finally:
            stop.set()
            t.join(30)
            b.close()
        assert not errors
        view = on.snapshot()
        want = merged_oracle_kneighbors(model, view, qx)
        b2 = MicroBatcher(model, max_batch=64, max_wait_ms=0.0, mutable=on)
        try:
            got = b2.kneighbors(qx, timeout=60)
        finally:
            b2.close()
            on.close()
            off.close()
        np.testing.assert_array_equal(got[1], want[1])


class TestIncrementalCompaction:
    def _compact_once(self, engine):
        from knn_tpu_torch.mutable.compact import Compactor

        def swap(m, v, hook):
            hook()
            return "prev"

        c = Compactor(engine, swap=swap, warm=lambda m: None,
                      threshold=10_000, interval_s=0)
        return c.run_once()

    def test_incremental_path_and_forced_rebuild(self, rng, tmp_path,
                                                 monkeypatch):
        x, _ = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=4, engine="xla", **CPU).fit(Dataset(x, y))
        setattr(model, IVF_ATTR, IVFIndex.build(x, 12, seed=0, **CPU))
        root = tmp_path / "idx"
        save_index(model, root, ivf=model.ivf_)
        eng = MutableEngine(model, root, delta_cap=256, device_tail="off")
        try:
            eng.apply_insert(x[:20] + 0.25, rng.integers(0, 3, 20).astype(
                np.float32), time.monotonic_ns())
            out = self._compact_once(eng)
            assert out["compacted"] and out["ivf_compaction"] == "incremental"
            assert out["ivf_cell_imbalance"] >= 1.0
            monkeypatch.setenv("KNN_TPU_IVF_REBUILD_IMBALANCE", "0")
            eng.apply_insert(x[:5] + 0.5, rng.integers(0, 3, 5).astype(
                np.float32), time.monotonic_ns())
            out2 = self._compact_once(eng)
            assert out2["compacted"] and out2["ivf_compaction"] == "rebuild"
        finally:
            eng.close()

    def test_serving_records_dead_candidate_counter(self, rng, tmp_path):
        from knn_tpu_torch import obs

        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=4, engine="xla", **CPU).fit(Dataset(x, y))
        setattr(model, IVF_ATTR, IVFIndex.build(x, 12, seed=0, **CPU))
        on, off = _mutable_pair(model, tmp_path)
        was = obs.enabled()
        try:
            on.apply_insert(x[:8] + 0.5, rng.integers(0, 3, 8).astype(
                np.float32), time.monotonic_ns())
            on.apply_delete([11, 23], time.monotonic_ns())
            serving = IVFServing(4, 12)
            obs.enable()
            obs.reset()
            d, i = serving.kneighbors(model, qx, view=on.snapshot())
            metrics = {m.name for m in obs.registry().instruments()}
            assert "knn_ivf_dead_candidate_rows_total" in metrics
            assert "knn_ivf_scorer_dispatch_total" in metrics
            assert not np.isin(i, [11, 23]).any()
        finally:
            obs.reset()
            (obs.enable if was else obs.disable)()
            on.close()
            off.close()
