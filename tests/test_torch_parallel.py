"""The multi-device strategies on the port (``knn_tpu_torch/parallel/``)
against the JAX package's (``knn_tpu/parallel/``): the twins of
``tests/test_parallel.py`` for the three backends and every engine, the
seams of the multi-chip dry runs, and the classify CLI's ``--persona mpi``,
``--backend cuda-*`` and ``--devices``.

The port runs 8 logical shards of the host (a device named 8 times), the
JAX package its 8 virtual CPU devices (``tests/conftest.py``); the same
seeded numpy inputs go to both. The JAX reference is its ``xla`` engine
(the stripe kernel's interpreter would only slow the suite: every JAX
engine answers the same predictions, ``tests/test_parallel.py``), except
where a case names the engine. Tolerances: predictions exact.
"""

import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import cli as jcli  # noqa: E402
from knn_tpu.backends.oracle import knn_oracle  # noqa: E402
from knn_tpu.parallel.query_sharded import predict_query_sharded as jquery  # noqa: E402
from knn_tpu.parallel.ring import predict_ring as jring  # noqa: E402
from knn_tpu.parallel.train_sharded import predict_train_sharded as jtrain  # noqa: E402
from knn_tpu_torch import cli  # noqa: E402
from knn_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from knn_tpu_torch.parallel.query_sharded import predict_query_sharded  # noqa: E402
from knn_tpu_torch.parallel.ring import predict_ring  # noqa: E402
from knn_tpu_torch.parallel.train_sharded import predict_train_sharded  # noqa: E402
from knn_tpu_torch.resilience.errors import DeviceError  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401

CPU8 = {"num_devices": 8, "device": "cpu"}
_MS = re.compile(r"required \d+ ms")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    n, q, d, c = 1210, 133, 6, 5
    train_x = rng.integers(0, 4, (n, d)).astype(np.float32)  # int grid → ties
    train_y = rng.integers(0, c, n).astype(np.int32)
    test_x = np.concatenate(
        [train_x[rng.choice(n, 40, replace=False)],  # exact duplicates
         rng.integers(0, 4, (q - 40, d)).astype(np.float32)]
    )
    return train_x, train_y, test_x, c


@pytest.fixture(scope="module")
def jax_q(problem):
    """JAX's query-sharded predictions at k = 1, 3, 5, 20 (8 devices)."""
    tx, ty, qx, c = problem
    return {k: jquery(tx, ty, qx, k, c, query_tile=16, train_tile=256)
            for k in (1, 3, 5, 20)}


def _tie_rows(n, d, mod):
    return (np.ones((n, d), np.float32),
            (np.arange(n, dtype=np.int32) * (3 if mod == 9 else 1)) % mod)


class TestMesh:
    def test_eight_logical_shards(self):
        mesh = pmesh.make_mesh(8, "cpu")
        assert mesh == (torch.device("cpu"),) * 8
        assert pmesh.make_mesh(None, "cpu") == (torch.device("cpu"),)

    def test_default_mesh_shape(self):
        from knn_tpu.parallel.mesh import default_mesh_shape

        for n in (1, 4, 7, 8, 12, 16):
            assert pmesh.default_mesh_shape(n) == default_mesh_shape(n)
        assert pmesh.default_mesh_shape(8) == (4, 2)

    def test_make_mesh_too_many(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="requested 99 devices but only "
                           "1 available"):
            pmesh.make_mesh(99)
        assert pmesh.make_mesh(None) == (torch.device("cuda", 0),)

    def test_cuda_mesh_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceError, match="device='cpu'"):
            pmesh.make_mesh(2)

    def test_make_mesh_2d(self):
        grid = pmesh.make_mesh_2d(2, 4, pmesh.make_mesh(8, "cpu"))
        assert len(grid) == 2 and all(len(row) == 4 for row in grid)
        with pytest.raises(ValueError, match="needs 9 devices"):
            pmesh.make_mesh_2d(3, 3, pmesh.make_mesh(8, "cpu"))

    def test_resolve_mesh_keeps_repeats(self):
        assert pmesh.resolve_mesh(["cpu", "cpu", "cpu"]) == (
            torch.device("cpu"),) * 3
        with pytest.raises(ValueError):
            pmesh.resolve_mesh([])


class TestQuerySharded:
    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    @pytest.mark.parametrize("k", [1, 5])
    def test_matches_jax(self, problem, jax_q, k, engine):
        tx, ty, qx, c = problem
        got = predict_query_sharded(tx, ty, qx, k, c, query_tile=16,
                                    train_tile=256, engine=engine, **CPU8)
        np.testing.assert_array_equal(got, jax_q[k])

    def test_subset_of_devices(self, problem):
        tx, ty, qx, c = problem
        want = jquery(tx, ty, qx, 3, c, num_devices=4, query_tile=8,
                      train_tile=128)
        for engine in ("stripe", "xla"):
            got = predict_query_sharded(tx, ty, qx, 3, c, num_devices=4,
                                        device="cpu", query_tile=8,
                                        train_tile=128, engine=engine)
            np.testing.assert_array_equal(got, want)

    def test_single_device_mesh(self, problem, jax_q):
        tx, ty, qx, c = problem
        got = predict_query_sharded(tx, ty, qx, 5, c, num_devices=1,
                                    device="cpu", query_tile=32,
                                    train_tile=256)
        np.testing.assert_array_equal(got, jax_q[5])

    def test_collectives_are_the_scatter_and_the_gather(self, problem):
        from knn_tpu.parallel.comm_audit import model_query_sharded_bytes

        tx, ty, qx, c = problem
        log = []
        predict_query_sharded(tx, ty, qx, 5, c, log=log, **CPU8)
        assert {o.op for o in log} == {"scatter", "gather"}
        q_pad = -(-qx.shape[0] // 8) * 8
        assert sum(o.nbytes for o in log) == model_query_sharded_bytes(
            q_pad, qx.shape[1])


class TestTrainSharded:
    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    @pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
    def test_mesh_shapes_match_jax(self, problem, jax_q, mesh_shape,
                                   engine):
        tx, ty, qx, c = problem
        got = predict_train_sharded(tx, ty, qx, 5, c, mesh_shape=mesh_shape,
                                    query_tile=16, train_tile=64,
                                    engine=engine, **CPU8)
        np.testing.assert_array_equal(got, jax_q[5])
        np.testing.assert_array_equal(got, jtrain(
            tx, ty, qx, 5, c, mesh_shape=mesh_shape, query_tile=16,
            train_tile=64))

    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_tie_stability_across_shards(self, engine):
        # All train rows identical: predictions must come from the k lowest
        # *global* indices no matter the shard layout.
        train_x, train_y = _tie_rows(64, 3, 7)
        test_x = np.ones((8, 3), np.float32)
        want = jtrain(train_x, train_y, test_x, 5, 7, mesh_shape=(1, 8),
                      query_tile=8, train_tile=8)
        np.testing.assert_array_equal(want, knn_oracle(
            train_x, train_y, test_x, 5, 7))
        got = predict_train_sharded(train_x, train_y, test_x, 5, 7,
                                    mesh_shape=(1, 8), query_tile=8,
                                    train_tile=8, engine=engine, **CPU8)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_k_larger_than_shard(self, problem, jax_q, engine):
        # k=20 over 8 shards of ~151 rows; also k > train_tile.
        tx, ty, qx, c = problem
        got = predict_train_sharded(tx, ty, qx, 20, c, mesh_shape=(1, 8),
                                    query_tile=16, train_tile=16,
                                    engine=engine, **CPU8)
        np.testing.assert_array_equal(got, jax_q[20])


class TestRing:
    @pytest.mark.parametrize("engine", ["stripe", "full", "tiled"])
    @pytest.mark.parametrize("k", [1, 5])
    def test_matches_jax(self, problem, jax_q, k, engine):
        tx, ty, qx, c = problem
        got = predict_ring(tx, ty, qx, k, c, engine=engine, **CPU8)
        np.testing.assert_array_equal(got, jax_q[k])

    def test_jax_ring_itself_agrees(self, problem, jax_q):
        tx, ty, qx, c = problem
        np.testing.assert_array_equal(jring(tx, ty, qx, 5, c), jax_q[5])

    @pytest.mark.parametrize("engine", ["stripe", "full", "tiled"])
    def test_tie_stability_rotated_order(self, engine):
        # The ring visits shards in rotated order per device; the
        # (dist, global-index) merge must still pick lowest indices.
        train_x, train_y = _tie_rows(40, 2, 9)
        test_x = np.ones((16, 2), np.float32)
        want = jring(train_x, train_y, test_x, 7, 9)
        got = predict_ring(train_x, train_y, test_x, 7, 9, engine=engine,
                           **CPU8)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("engine", ["stripe", "full", "tiled"])
    def test_k_exceeds_shard_rows(self, engine):
        # 8 devices × 5 rows each; k=12 > shard size.
        rng = np.random.default_rng(3)
        train_x = rng.normal(size=(40, 4)).astype(np.float32)
        train_y = rng.integers(0, 3, 40).astype(np.int32)
        test_x = rng.normal(size=(24, 4)).astype(np.float32)
        want = jring(train_x, train_y, test_x, 12, 3)
        got = predict_ring(train_x, train_y, test_x, 12, 3, engine=engine,
                           **CPU8)
        np.testing.assert_array_equal(got, want)

    def test_engine_rule(self):
        from knn_tpu_torch.parallel.ring import _resolve_ring_engine

        assert _resolve_ring_engine("auto", "exact", 10, 10) == "stripe"
        assert _resolve_ring_engine("auto", "manhattan", 10, 10) == "full"
        assert _resolve_ring_engine("auto", "manhattan", 4096,
                                    8192) == "tiled"
        assert _resolve_ring_engine("xla", "exact", 1, 1) == "tiled"
        with pytest.raises(ValueError, match="euclidean only"):
            _resolve_ring_engine("stripe", "cosine", 1, 1)
        with pytest.raises(ValueError, match="unknown ring engine"):
            _resolve_ring_engine("warp", "exact", 1, 1)


class TestStripeEngine:
    """The per-shard kernels (their plain versions here) on every sharded
    path, against JAX's stripe engine where the JAX test runs it."""

    @pytest.mark.parametrize("k", [1, 5])
    def test_query_sharded_stripe(self, problem, k):
        tx, ty, qx, c = problem
        want = jquery(tx, ty, qx, k, c, engine="stripe")
        got = predict_query_sharded(tx, ty, qx, k, c, engine="stripe",
                                    **CPU8)
        np.testing.assert_array_equal(got, want)

    def test_train_sharded_stripe_cross_shard_ties(self):
        train_x, train_y = _tie_rows(64, 3, 7)
        test_x = np.ones((8, 3), np.float32)
        want = jtrain(train_x, train_y, test_x, 5, 7, mesh_shape=(1, 8),
                      engine="stripe")
        got = predict_train_sharded(train_x, train_y, test_x, 5, 7,
                                    mesh_shape=(1, 8), engine="stripe",
                                    **CPU8)
        np.testing.assert_array_equal(got, want)

    def test_ring_stripe(self, problem):
        tx, ty, qx, c = problem
        want = jring(tx, ty, qx, 5, c, engine="stripe")
        got = predict_ring(tx, ty, qx, 5, c, engine="stripe", **CPU8)
        np.testing.assert_array_equal(got, want)

    def test_ring_tiled(self, problem, jax_q):
        tx, ty, qx, c = problem
        got = predict_ring(tx, ty, qx, 5, c, engine="tiled", query_tile=16,
                           train_tile=64, **CPU8)
        np.testing.assert_array_equal(got, jax_q[5])

    @pytest.mark.parametrize("path", ["query", "train", "ring"])
    @pytest.mark.parametrize("precision", ["fast", "bf16"])
    def test_matmul_forms_on_an_integer_grid(self, problem, path,
                                             precision):
        # The tile kernel's forms per shard: on an integer grid every
        # product and sum is exact, so each form answers as JAX's exact.
        tx, ty, qx, c = problem
        fn = {"query": predict_query_sharded, "train": predict_train_sharded,
              "ring": predict_ring}[path]
        got = fn(tx, ty, qx, 5, c, precision=precision, engine="stripe",
                 **CPU8)
        np.testing.assert_array_equal(got, jquery(
            tx, ty, qx, 5, c, precision=precision, query_tile=16,
            train_tile=256))


class TestRingXl:
    def test_ring_tiled_xl_without_full_matrix(self):
        # An xl-shaped problem — >=1M train rows over 8 shards — through
        # the ring's tiled engine (per-step memory O(query_tile x
        # train_tile)), against the oracle as the JAX test holds its ring.
        rng = np.random.default_rng(11)
        n, q, d, c, k = 1_050_000, 48, 4, 6, 5
        train_x = rng.integers(0, 64, (n, d)).astype(np.float32)
        train_y = rng.integers(0, c, n).astype(np.int32)
        test_x = np.concatenate(
            [train_x[rng.choice(n, q // 2, replace=False)],
             rng.integers(0, 64, (q - q // 2, d)).astype(np.float32)]
        )
        want = knn_oracle(train_x, train_y, test_x, k, c)
        got = predict_ring(train_x, train_y, test_x, k, c, engine="tiled",
                           query_tile=8, train_tile=4096, **CPU8)
        np.testing.assert_array_equal(got, want)


class TestSeams:
    """The cases the multi-chip dry runs list: ragged shapes, shards
    smaller than k, degenerate meshes, more shards than rows, no
    queries."""

    @pytest.fixture(scope="class")
    def uneven(self):
        rng = np.random.default_rng(5)
        tx = rng.normal(size=(203, 37)).astype(np.float32)
        ty = rng.integers(0, 4, 203).astype(np.int32)
        qx = rng.normal(size=(29, 37)).astype(np.float32)
        return tx, ty, qx, jquery(tx, ty, qx, 7, 4)

    @pytest.mark.parametrize("path", ["query", "train", "ring"])
    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_uneven_203x37_k7(self, uneven, path, engine):
        tx, ty, qx, want = uneven
        fn = {"query": predict_query_sharded, "train": predict_train_sharded,
              "ring": predict_ring}[path]
        got = fn(tx, ty, qx, 7, 4, engine=engine, **CPU8)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("engine", ["stripe", "xla"])
    def test_degenerate_1x8_and_more_shards_than_rows(self, engine):
        rng = np.random.default_rng(9)
        tx = rng.integers(0, 3, (6, 3)).astype(np.float32)
        ty = rng.integers(0, 2, 6).astype(np.int32)
        qx = rng.integers(0, 3, (5, 3)).astype(np.float32)
        want = jtrain(tx, ty, qx, 3, 2, mesh_shape=(1, 8))
        np.testing.assert_array_equal(want, knn_oracle(tx, ty, qx, 3, 2))
        for mesh_shape in ((1, 8), (2, 4), (8, 1)):
            got = predict_train_sharded(tx, ty, qx, 3, 2,
                                        mesh_shape=mesh_shape,
                                        engine=engine, **CPU8)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(predict_ring(
            tx, ty, qx, 3, 2, engine="stripe" if engine == "stripe"
            else "tiled", **CPU8), want)

    @pytest.mark.parametrize("fn", [predict_query_sharded,
                                    predict_train_sharded, predict_ring])
    def test_zero_queries(self, problem, fn):
        tx, ty, _, c = problem
        out = fn(tx, ty, np.zeros((0, tx.shape[1]), np.float32), 5, c,
                 **CPU8)
        assert out.shape == (0,) and out.dtype == np.int32


class TestFixtureParity:
    """Small reference fixture through every distributed path."""

    @pytest.mark.parametrize("path", ["query", "train", "ring"])
    def test_small_k5(self, small, path):
        train, test = small
        args = (train.features, train.labels, test.features, 5,
                train.num_classes)
        want = jquery(*args, query_tile=8, train_tile=128)
        if path == "query":
            got = predict_query_sharded(*args, query_tile=8, train_tile=128,
                                        **CPU8)
        elif path == "train":
            got = predict_train_sharded(*args, mesh_shape=(2, 4),
                                        query_tile=8, train_tile=64, **CPU8)
        else:
            got = predict_ring(*args, **CPU8)
        np.testing.assert_array_equal(got, want)


def _paths():
    d = fixtures.datasets_dir()
    return str(d / "small-train.arff"), str(d / "small-test.arff")


def _line(runner, argv):
    out = io.StringIO()
    rc = runner(argv, stdout=out)
    return rc, _MS.sub("required <ms> ms", out.getvalue())


class TestCLI:
    @pytest.mark.parametrize("argv,jargv", [
        (["--persona", "mpi"], ["--persona", "mpi"]),
        (["--backend", "cuda-sharded", "--devices", "8"],
         ["--backend", "tpu-sharded"]),
        (["--backend", "cuda-train-sharded", "--devices", "8"],
         ["--backend", "tpu-train-sharded"]),
        (["--backend", "cuda-ring", "--devices", "8"],
         ["--backend", "tpu-ring"]),
        (["--backend", "cuda-ring", "--devices", "3", "--engine", "full"],
         ["--backend", "tpu-ring", "--devices", "3", "--engine", "full"]),
        (["--backend", "cuda-ring", "--devices", "4", "--engine", "tiled"],
         ["--backend", "tpu-ring", "--devices", "4", "--engine", "tiled"]),
        (["--backend", "cuda-train-sharded", "--devices", "4", "--engine",
          "xla"], ["--backend", "tpu-train-sharded", "--devices", "4",
                   "--engine", "xla"]),
    ])
    def test_result_line_equals_jax(self, argv, jargv):
        tr, te = _paths()
        rc, got = _line(cli.run, [tr, te, "5", *argv, "--device", "cpu",
                                  "--json"])
        jrc, want = _line(jcli.run, [tr, te, "5", *jargv, "--platform",
                                     "cpu"])
        assert rc == jrc == 0
        assert got.splitlines()[0] == want.splitlines()[0]
        backend = argv[1] if argv[0] == "--backend" else "cuda-sharded"
        assert f'"backend": "{backend}"' in got

    def test_devices_past_the_cards_is_a_runtime_error(self, monkeypatch,
                                                       capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        tr, te = _paths()
        assert cli.run([tr, te, "5", "--backend", "cuda-ring", "--devices",
                        "99"], stdout=io.StringIO()) == 1
        assert "requested 99 devices" in capsys.readouterr().err

    def test_ring_engine_on_another_backend_is_refused(self, capsys):
        tr, te = _paths()
        assert cli.run([tr, te, "5", "--engine", "full", "--device", "cpu"],
                       stdout=io.StringIO()) == 1
        assert "unknown engine 'full'" in capsys.readouterr().err

    def test_sweep_refuses_devices_and_ring_engines(self, capsys):
        tr, te = _paths()
        assert cli.run([tr, te, "1", "--sweep-k", "1,3", "--devices", "2",
                        "--engine", "tiled", "--device", "cpu"]) == 2
        err = capsys.readouterr().err
        assert "--devices" in err and "--engine full/tiled" in err

    def test_platform_is_not_an_alias(self, capsys):
        tr, te = _paths()
        assert cli.run([tr, te, "5", "--platform=cpu"]) == 2
        assert "unrecognized arguments" in capsys.readouterr().err

    def test_collective_fault_ends_typed_on_cuda(self, monkeypatch, capsys):
        from knn_tpu_torch.resilience import faults

        tr, te = _paths()
        with faults.inject("collective.step=always"):
            rc, got = _line(cli.run, [tr, te, "5", "--backend",
                                      "cuda-train-sharded", "--devices", "4",
                                      "--device", "cpu", "--json"])
        err = capsys.readouterr().err
        assert rc == 0
        assert ("backend 'cuda-train-sharded' failed (CollectiveError"
                in err and "falling back to 'cuda'" in err)
        assert '"backend": "cuda"' in got
        with faults.inject("collective.step=always"):
            rc = cli.run([tr, te, "5", "--backend", "cuda-ring", "--devices",
                          "2", "--device", "cpu", "--no-fallback"],
                         stdout=io.StringIO())
        assert rc == 1
        assert "error: CollectiveError" in capsys.readouterr().err
