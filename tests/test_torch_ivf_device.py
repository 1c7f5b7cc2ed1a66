"""The IVF device path on the port (the twin of
``tests/test_device_path.py``'s ``TestDeviceScorerBitIdentity``,
``TestApproxCentroidRanking`` without its recall-floor case, which needs
the shadow scorer of ROADMAP A8b, ``test_assign_to_is_deterministic_and_
keeps_centroids`` and ``TestDeleteAwareProbeAccounting``'s partition
cases), and the module that holds the device programs,
``ops/segment_score.py``, against ``knn_tpu/ops/segment_score.py`` and
``models/ordering.py::lexicographic_topk_jax``. On the CPU: the port's
torch ops on CPU tensors, JAX's jitted programs on XLA:CPU.

Tolerances: the device scorer's answers (after the host re-rank) are
bit-identical to the host scorer's and the oracle's; the selections are
exact (equal indices and equal distance bits); the segment scores, before
any re-rank, agree with JAX's to ``SCORE_RTOL`` (each sums the features in
its own order), and the matmul-form centroid distances to the same.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from knn_tpu.index import ivf as jivf  # noqa: E402
from knn_tpu.models.ordering import lexicographic_topk_jax  # noqa: E402
from knn_tpu.ops import segment_score as jseg  # noqa: E402
from knn_tpu_torch.backends.oracle import oracle_kneighbors  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.index.ivf import IVF_ATTR, IVFIndex, IVFServing  # noqa: E402
from knn_tpu_torch.models.knn import (  # noqa: E402
    DEFAULT_CANDIDATE_BUCKETS,
    KNNClassifier,
    candidate_padded_rows,
)
from knn_tpu_torch.models.ordering import lexicographic_topk_torch  # noqa: E402
from knn_tpu_torch.ops import segment_score as seg  # noqa: E402
from knn_tpu_torch.resilience.errors import (  # noqa: E402
    DeviceError,
    ResilienceError,
)

CPU = {"device": "cpu"}

#: Subtraction-form segment distances before the re-rank: each package
#: sums D products in its own order (relative, per distance).
SCORE_RTOL = 11 * 2.0 ** -23


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _tie_problem(rng, n=400, d=6, q=24):
    """tests/test_device_path.py's data: an integer grid (exact ties), a
    duplicated block, an exact-match query and a NaN query."""
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


class TestDeviceScorerBitIdentity:
    def test_matrix_vs_host_and_jax(self, rng):
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        jind = jivf.IVFIndex.build(x, 16, seed=0)
        for k, nprobe in [(1, 1), (5, 2), (5, 16), (10, 3), (64, 5)]:
            host = ivf.search(x, qx, k, nprobe, scorer="host", **CPU)
            dev = ivf.search(x, qx, k, nprobe, scorer="device", **CPU)
            jdev = jind.search(x, qx, k, nprobe, scorer="device")
            _assert_bitwise(host[:2], dev[:2], f"k={k} nprobe={nprobe}")
            _assert_bitwise(jdev[:2], dev[:2], f"jax k={k} nprobe={nprobe}")
            assert host[2].scorer == "host" and dev[2].scorer == "device"
            assert tuple(dev[2]) == tuple(jdev[2])
            assert dev[2].padded_candidate_rows >= 0

    def test_full_probe_device_bit_identical_to_oracle(self, rng):
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        for k in (1, 5, 17):
            od, oi = oracle_kneighbors(x, qx, k)
            dd, di, st = ivf.search(x, qx, k, 16, scorer="device", **CPU)
            _assert_bitwise((od, oi), (dd, di), f"oracle k={k}")
            assert st.scorer == "device"

    def test_wide_dtype_queries_coerce(self, rng):
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 8, seed=0, **CPU)
        host = ivf.search(x, qx.astype(np.float64), 5, 3, scorer="host",
                          **CPU)
        dev = ivf.search(x.astype(np.float64), qx, 5, 3, scorer="device",
                         **CPU)
        _assert_bitwise(host[:2], dev[:2], "dtype coercion")

    def test_k_exceeds_candidates_pads_with_sentinel(self, rng):
        x, qx = _tie_problem(rng, n=60)
        ivf = IVFIndex.build(x, 30, seed=0, **CPU)
        host = ivf.search(x, qx, 59, 1, scorer="host", **CPU)
        dev = ivf.search(x, qx, 59, 1, scorer="device", **CPU)
        _assert_bitwise(host[:2], dev[:2], "k-coverage saturation")

    def test_auto_routes_small_to_host_env_overrides(self, rng,
                                                     monkeypatch):
        x, qx = _tie_problem(rng, n=120, q=4)
        ivf = IVFIndex.build(x, 8, seed=0, **CPU)
        assert ivf.search(x, qx, 3, 2, **CPU)[2].scorer == "host"
        monkeypatch.setenv("KNN_TPU_IVF_SCORER", "device")
        assert ivf.search(x, qx, 3, 2, **CPU)[2].scorer == "device"
        monkeypatch.setenv("KNN_TPU_IVF_SCORER", "host")
        st = ivf.search(x, qx, 3, 2, scorer="device", **CPU)[2]
        assert st.scorer == "device"  # explicit arg beats the env

    def test_auto_threshold_routes_by_work(self, rng, monkeypatch):
        from knn_tpu_torch.index import ivf as pivf

        x, qx = _tie_problem(rng, n=120, q=4)
        ivf = IVFIndex.build(x, 8, seed=0, **CPU)
        _, _, st = ivf.search(x, qx, 3, 2, **CPU)
        work = qx.shape[0] * (st.candidate_rows // qx.shape[0] + 60) * 6
        monkeypatch.setattr(pivf, "DEVICE_SCORER_MIN_ELEMS", 1)
        assert ivf.search(x, qx, 3, 2, **CPU)[2].scorer == "device"
        monkeypatch.setattr(pivf, "DEVICE_SCORER_MIN_ELEMS", work)
        assert ivf.search(x, qx, 3, 2, **CPU)[2].scorer == "host"

    def test_serving_rung_device_scorer_bit_identity(self, rng):
        x, qx = _tie_problem(rng)
        y = rng.integers(0, 3, x.shape[0]).astype(np.int32)
        model = KNNClassifier(k=5, engine="xla", **CPU).fit(Dataset(x, y))
        setattr(model, IVF_ATTR, IVFIndex.build(x, 16, seed=0, **CPU))
        want = model.ivf_.search(x, qx, 5, 4, scorer="host", **CPU)[:2]
        got = IVFServing(4, 16, scorer="device").kneighbors(model, qx)
        _assert_bitwise(want, got, "serving rung")

    def test_candidate_bucket_one_definition(self):
        from knn_tpu_torch.obs import accounting as acct

        assert candidate_padded_rows(0) == 0
        assert candidate_padded_rows(1) == DEFAULT_CANDIDATE_BUCKETS[0]
        for b in DEFAULT_CANDIDATE_BUCKETS:
            assert candidate_padded_rows(b) == b
            assert candidate_padded_rows(b - 1) == b
        top = DEFAULT_CANDIDATE_BUCKETS[-1]
        assert candidate_padded_rows(top + 1) == 2 * top
        for m in (1, 300, 5000, top + 9):
            assert acct.padded_candidate_rows(m) == candidate_padded_rows(m)

    @pytest.mark.parametrize("cap_queries", [1, 3])
    def test_chunking_under_the_byte_cap_changes_nothing(self, rng,
                                                         monkeypatch,
                                                         cap_queries):
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        whole = ivf.search(x, qx, 7, 5, scorer="device", **CPU)
        counts = ivf._coverage(qx, 7, 5, None, "cpu")[1]
        m_pad = candidate_padded_rows(int(counts.max()))
        monkeypatch.setattr(seg, "SCORE_BYTES_CAP",
                            cap_queries * 8 * m_pad * x.shape[1])
        chunks = []
        core = seg.segment_topk_core

        def spy(perm_rows, perm_ids, queries, *rest):
            chunks.append(queries.shape[0])
            return core(perm_rows, perm_ids, queries, *rest)

        monkeypatch.setattr(seg, "segment_topk_core", spy)
        chunked = ivf.search(x, qx, 7, 5, scorer="device", **CPU)
        _assert_bitwise(whole[:2], chunked[:2], "chunked")
        assert max(chunks) == cap_queries and sum(chunks) == qx.shape[0]

    def test_buckets_key_the_signature_and_only_live_rows_score(
            self, rng, monkeypatch):
        """The query pad is JAX's executable key (the signature counted in
        obs/devprof.py); eager torch scores only the live rows."""
        from knn_tpu_torch import obs
        from knn_tpu_torch.obs import devprof

        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        seen, keys = [], []
        core = seg.segment_topk_core

        def spy(perm_rows, perm_ids, queries, *rest):
            seen.append(queries.shape[0])
            return core(perm_rows, perm_ids, queries, *rest)

        monkeypatch.setattr(seg, "segment_topk_core", spy)
        monkeypatch.setattr(devprof, "record_executable_lookup",
                            lambda backend, key: keys.append(key))
        monkeypatch.setattr(obs, "enabled", lambda: True)
        a = ivf.search(x, qx[:5], 3, 4, scorer="device", buckets=(8, 16),
                       **CPU)
        b = ivf.search(x, qx[:5], 3, 4, scorer="device", **CPU)
        assert seen == [5, 5]
        assert [key[:3] for key in keys] == [("ivf-segment", 8, 4),
                                             ("ivf-segment", 128, 4)]
        _assert_bitwise(a[:2], b[:2], "bucketed")


class TestNoQuietFallback:
    """JAX moves a failing device scorer (under ``auto``) and a failing
    approximate ranking to the host without a word; the port raises
    typed."""

    def test_device_scorer_failure_raises_typed(self, rng, monkeypatch):
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)

        def broken(*a, **kw):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(seg, "segment_topk", broken)
        monkeypatch.setattr(jseg, "segment_topk", broken)
        monkeypatch.setenv("KNN_TPU_IVF_SCORER", "device")
        with pytest.raises(DeviceError, match="illegal memory access"):
            ivf.search(x, qx, 5, 4, **CPU)
        monkeypatch.delenv("KNN_TPU_IVF_SCORER")
        monkeypatch.setattr(jivf, "DEVICE_SCORER_MIN_ELEMS", 1)
        jind = jivf.IVFIndex.build(x, 16, seed=0)
        # JAX under auto: the host scorer answers and nothing says so.
        assert jind.search(x, qx, 5, 4)[2].scorer == "host"

    def test_oom_in_the_scorer_is_an_oom_device_error(self, rng,
                                                      monkeypatch):
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)

        def oom(*a, **kw):
            raise MemoryError("out of memory")

        monkeypatch.setattr(seg, "segment_topk", oom)
        with pytest.raises(DeviceError) as e:
            ivf.search(x, qx, 5, 4, scorer="device", **CPU)
        assert e.value.oom

    def test_approx_ranking_failure_raises_typed(self, rng, monkeypatch):
        monkeypatch.setenv("KNN_TPU_IVF_APPROX_CELLS", "8")
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        jind = jivf.IVFIndex.build(x, 16, seed=0)

        def broken(*a, **kw):
            raise RuntimeError("ranking kernel failed")

        monkeypatch.setattr(seg, "rank_cells_approx", broken)
        monkeypatch.setattr(jseg, "rank_cells_approx", broken)
        with pytest.raises(ResilienceError, match="ranking kernel failed"):
            ivf.search(x, qx, 5, 4, **CPU)
        assert jind.search(x, qx, 5, 4)[2].ranking == "exact"

    def test_card_asked_for_without_one_raises_typed(self, rng):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        with pytest.raises(DeviceError, match="is_available"):
            ivf.search(x, qx, 5, 4, scorer="device")
        # The host scorer needs no card: routing by size, not recovery.
        assert ivf.search(x, qx, 5, 4, scorer="host")[2].scorer == "host"


class TestApproxCentroidRanking:
    def test_arms_past_threshold_only(self, rng, monkeypatch):
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        assert ivf.search(x, qx, 5, 4, **CPU)[2].ranking == "exact"
        monkeypatch.setenv("KNN_TPU_IVF_APPROX_CELLS", "8")
        assert ivf.search(x, qx, 5, 4, **CPU)[2].ranking == "approx"
        dd, di, st = ivf.search(x, qx, 5, 16, scorer="device", **CPU)
        assert st.ranking == "exact"
        _assert_bitwise(oracle_kneighbors(x, qx, 5), (dd, di),
                        "full probe under approx threshold")

    def test_approx_answers_carry_exact_distances(self, rng, monkeypatch):
        monkeypatch.setenv("KNN_TPU_IVF_APPROX_CELLS", "8")
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        d, i, st = ivf.search(x, qx, 5, 4, **CPU)
        assert st.ranking == "approx"
        finite = np.isfinite(d)
        diff = qx[:, None, :] - x[i]
        true_d = np.einsum("qkd,qkd->qk", diff, diff, dtype=np.float32)
        np.testing.assert_array_equal(d[finite], true_d[finite])

    def test_ranking_is_exact_selection_of_the_matmul_form(self, rng):
        """B6's rule: the device ranking selects exactly (recall 1.0 of
        the cells its distances rank first, ties to the lower cell)."""
        x, qx = _tie_problem(rng)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        cents = torch.from_numpy(ivf.centroids)
        q = np.nan_to_num(qx, nan=0.0)
        got = seg.rank_cells_approx(q, cents, 6)
        q2 = (q.astype(np.float64) ** 2).sum(1)[:, None]
        c2 = (ivf.centroids.astype(np.float64) ** 2).sum(1)[None, :]
        d = q2 + c2 - 2 * q.astype(np.float64) @ ivf.centroids.T
        want = np.argsort(d, axis=1, kind="stable")[:, :6]
        np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))
        # ties: equal centroids rank the lower cell first
        twins = torch.from_numpy(np.repeat(ivf.centroids[:1], 5, axis=0))
        np.testing.assert_array_equal(
            seg.rank_cells_approx(q[:2], twins, 3), [[0, 1, 2], [0, 1, 2]])

    def test_ranking_distances_match_jax_matmul_form(self, rng):
        x, qx = _tie_problem(rng)
        cents = rng.random((40, x.shape[1])).astype(np.float32)
        from knn_tpu.ops.distance import pairwise_sq_dists_dot as jdot
        from knn_tpu_torch.ops.distance import pairwise_sq_dists_dot

        q = np.nan_to_num(qx, nan=0.0)
        got = pairwise_sq_dists_dot(torch.from_numpy(q),
                                    torch.from_numpy(cents)).numpy()
        want = np.asarray(jdot(jnp.asarray(q), jnp.asarray(cents)))
        np.testing.assert_allclose(got, want, rtol=SCORE_RTOL,
                                   atol=SCORE_RTOL * 4 * 11)


class TestTieOrderSelection:
    """Every new selection on tie plateaus (ROADMAP Queue C's rule)."""

    @pytest.mark.parametrize("k", [1, 7, 40, 200])
    def test_lexicographic_topk_torch_equals_jax_with_payload(self, rng, k):
        d = rng.integers(0, 3, (30, 120)).astype(np.float32)
        d[:, ::9] = np.inf
        ids = np.stack([rng.permutation(120) for _ in range(30)]).astype(
            np.int32)
        pay = rng.integers(0, 9, (30, 120)).astype(np.int32)
        got = lexicographic_topk_torch(torch.from_numpy(d),
                                       torch.from_numpy(ids), k,
                                       torch.from_numpy(pay))
        want = lexicographic_topk_jax(jnp.asarray(d), jnp.asarray(ids), k,
                                      jnp.asarray(pay))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_nan_counts_as_inf(self):
        d = torch.tensor([[np.nan, np.inf, 1.0, np.nan]])
        i = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
        sd, si = lexicographic_topk_torch(d, i, 4)
        assert si.tolist() == [[2, 0, 1, 3]]
        assert sd.tolist() == [[1.0, np.inf, np.inf, np.inf]]

    def test_margin_select_keeps_a_superset_when_no_plateau(self, rng):
        d = torch.from_numpy(rng.permutation(200).astype(np.float32)[None])
        ids = torch.arange(200, dtype=torch.int32)[None]
        sd, si, crossed = seg.margin_select(d, ids, 10)
        assert not bool(crossed)
        assert sorted(si[0].tolist()) == sorted(
            np.argsort(d[0].numpy())[:10].tolist())

    def test_margin_select_detects_a_plateau_and_masks_pad_rows(self):
        d = torch.tensor([[0.0, 1.0, 1.0, 1.0, 2.0],
                          [np.inf] * 5])
        ids = torch.tensor([[4, 3, 2, 1, 0]] * 2, dtype=torch.int32)
        _, _, crossed = seg.margin_select(d, ids, 2)
        assert bool(crossed)  # row 0: three candidates at the boundary
        ok = torch.tensor([False, True])
        _, _, crossed = seg.margin_select(d, ids, 2, row_ok=ok)
        assert bool(crossed)  # row 1: all +inf, and it is live
        _, _, crossed = seg.margin_select(d[1:], ids[1:], 2,
                                          row_ok=torch.tensor([False]))
        assert not bool(crossed)  # a pad row never fires the detector
        sd, si = lexicographic_topk_torch(d, ids, 2)
        assert si.tolist() == [[4, 1], [0, 1]]

    def test_margin_select_covers_the_width_exactly(self):
        d = torch.tensor([[1.0, 1.0, 0.0]])
        ids = torch.tensor([[7, 5, 9]], dtype=torch.int32)
        sd, si, crossed = seg.margin_select(d, ids, 3)
        assert crossed is None and si.tolist() == [[9, 5, 7]]

    def test_plateau_crossing_takes_the_exact_branch_in_the_core(
            self, monkeypatch):
        """Adversarial ties across the boundary: the core reads the
        detector once and answers with the two-key order."""
        calls = []

        def spy(d, ids, kk):
            calls.append(kk)
            return lexicographic_topk_torch(d, ids, kk)

        monkeypatch.setattr(seg, "lexicographic_topk_torch", spy)
        n, m_pad = 64, 256
        rows = torch.zeros((n + 1, 2))  # every row at one distance
        ids = torch.arange(n + 1, dtype=torch.int32)
        ids[-1] = n
        q = torch.ones((2, 2))
        starts = torch.tensor([[0], [0]], dtype=torch.int32)
        lens = torch.tensor([[n], [n]], dtype=torch.int32)
        ok = torch.tensor([True, False])
        sd, si = seg.segment_topk_core(rows, ids, q, starts, lens, ok,
                                       m_pad, 5)
        assert calls == [5]
        assert si[0].tolist() == [0, 1, 2, 3, 4]
        calls.clear()
        rows[:n, 0] = torch.arange(n, dtype=torch.float32)  # distinct
        seg.segment_topk_core(rows, ids, q, starts, lens, ok, m_pad, 5)
        assert calls == []


class TestSegmentScores:
    @pytest.mark.parametrize("cells,probes", [(16, 4), (64, 40)])
    def test_scores_equal_jax(self, rng, cells, probes):
        """The flat (query, cell) mapping: compare-sum at P <= 32, the
        batched searchsorted above; the same ids, distances to
        SCORE_RTOL, pad slots (+inf, N)."""
        x, qx = _tie_problem(rng, n=900)
        ivf = IVFIndex.build(x, cells, seed=0, **CPU)
        sel, counts = ivf._coverage(qx, 5, probes, None, "cpu")[:2]
        starts = ivf.cell_offsets[:-1][sel].astype(np.int32)
        lens = ivf.cell_sizes[sel].astype(np.int32)
        m_pad = candidate_padded_rows(int(counts.max()))
        rows, ids = seg.device_operands(x, ivf.row_perm, "cpu")
        jrows, jids = jseg.device_operands(x, ivf.row_perm)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        d, i = seg._segment_scores(rows, ids, torch.from_numpy(qx),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(lens), m_pad)
        jd, ji = jseg._segment_scores(jrows, jids, jnp.asarray(qx),
                                      jnp.asarray(starts),
                                      jnp.asarray(lens), m_pad)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd),
                                   rtol=SCORE_RTOL)
        assert (i.numpy()[d.numpy() == np.inf] <= x.shape[0]).all()

    def test_survivors_equal_jax(self, rng):
        x, qx = _tie_problem(rng, n=900)
        ivf = IVFIndex.build(x, 16, seed=0, **CPU)
        sel, counts = ivf._coverage(qx, 5, 4, None, "cpu")[:2]
        starts = ivf.cell_offsets[:-1][sel].astype(np.int32)
        lens = ivf.cell_sizes[sel].astype(np.int32)
        m = int(counts.max())
        rows, ids = seg.device_operands(x, ivf.row_perm, "cpu")
        jrows, jids = jseg.device_operands(x, ivf.row_perm)
        got = seg.segment_topk(rows, ids, qx, starts, lens, m, 5)
        want = jseg.segment_topk(jrows, jids, qx, starts, lens, m, 5)
        # Integer grid: every distance exact, so the survivor sets agree;
        # their order inside a plateau is topk's, so compare as sets.
        for g, w in zip(got[1], want[1]):
            assert set(g.tolist()) == set(w.tolist())
        assert got[0].shape == want[0].shape

    def test_device_operands_refuse_int32_overflow(self):
        class Huge:
            shape = (2 ** 31 - 1, 3)

        with pytest.raises(ValueError, match="int32"):
            seg.device_operands(Huge(), np.zeros(1, np.int64), "cpu")


class TestPartitionUpkeep:
    def test_assign_to_is_deterministic_and_keeps_centroids(self, rng):
        x, _ = _tie_problem(rng)
        base = IVFIndex.build(x, 10, seed=3, **CPU)
        extra = np.concatenate([x, x[:13] + 0.125])
        a = IVFIndex.assign_to(extra, base, **CPU)
        b = IVFIndex.assign_to(extra, base, **CPU)
        np.testing.assert_array_equal(a.row_perm, b.row_perm)
        np.testing.assert_array_equal(a.centroids, base.centroids)
        assert a.meta["incremental"] and a.num_rows == extra.shape[0]
        jbase = jivf.IVFIndex.build(x, 10, seed=3)
        ja = jivf.IVFIndex.assign_to(extra, jbase)
        np.testing.assert_array_equal(a.row_perm, ja.row_perm)
        od, oi = oracle_kneighbors(extra, x[:8], 5)
        dd, di, _ = a.search(extra, x[:8], 5, 10, **CPU)
        _assert_bitwise((od, oi), (dd, di), "incremental full probe")

    def test_dead_rows_per_cell(self, rng):
        x, _ = _tie_problem(rng)
        ivf = IVFIndex.build(x, 8, seed=0, **CPU)
        inv = np.empty(x.shape[0], np.int64)
        inv[ivf.row_perm] = np.arange(x.shape[0])
        dead = np.array([0, 5, 9, 200], np.int64)
        got = ivf.dead_rows_per_cell(dead)
        want = np.zeros(8, np.int64)
        for r in dead:
            want[int(np.searchsorted(ivf.cell_offsets, inv[r],
                                     side="right") - 1)] += 1
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jivf.IVFIndex.build(x, 8, seed=0).dead_rows_per_cell(dead))
        assert got.sum() == dead.size
        assert ivf.dead_rows_per_cell(np.array([], np.int64)).sum() == 0

    def test_live_coverage_widens_past_dead_cells(self, rng):
        x, qx = _tie_problem(rng, n=120)
        ivf = IVFIndex.build(x, 6, seed=0, **CPU)
        jind = jivf.IVFIndex.build(x, 6, seed=0)
        cell = int(np.argmax(ivf.cell_sizes))
        lo, hi = ivf.cell_offsets[cell], ivf.cell_offsets[cell + 1]
        dead_per_cell = ivf.dead_rows_per_cell(ivf.row_perm[lo:hi])
        _, _, naive = ivf.search(x, qx, 5, 1, **CPU)
        d, i, st = ivf.search(x, qx, 5, 1, dead_per_cell=dead_per_cell,
                              **CPU)
        jd, ji, jst = jind.search(x, qx, 5, 1, dead_per_cell=dead_per_cell)
        assert st.forced_widenings >= naive.forced_widenings
        assert tuple(st) == tuple(jst)
        _assert_bitwise((jd, ji), (d, i), "live coverage")
