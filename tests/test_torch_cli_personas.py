"""The port's classify command against the JAX package's, on the CPU: the
personas, the ``threads`` positional, ``--no-fallback`` and the static rung,
``--approx``/``--recall-target``, and the twin of
``tests/test_approx_guard.py``.

Result lines must equal the JAX CLI's for the same persona (the ms field
masked); error lines and exit codes likewise where both CLIs reject the
same input. The port's default persona ``cuda`` is the twin of JAX's
``tpu``, run with ``--device cpu`` (the kernels' plain versions).
Tolerances: predictions and result lines exact.
"""

import io
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import backends as jbackends  # noqa: E402
from knn_tpu import cli as jcli  # noqa: E402
from knn_tpu.backends import tpu as jtpu  # noqa: E402
from knn_tpu_torch import backends, cli  # noqa: E402
from knn_tpu_torch.backends import cuda as cuda_backend  # noqa: E402
from knn_tpu_torch.backends import native as native_backend  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_approx_guard import _tiled_problem  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401

_MS = re.compile(r"required \d+ ms")
CPU = ["--device", "cpu"]


def _paths(size="small"):
    d = fixtures.datasets_dir()
    return str(d / f"{size}-train.arff"), str(d / f"{size}-test.arff")


def _run(runner, argv):
    out = io.StringIO()
    rc = runner(argv, stdout=out)
    return rc, _MS.sub("required <ms> ms", out.getvalue())


def _jax(argv):
    return _run(jcli.run, [*argv, "--platform", "cpu"])


@pytest.fixture
def no_native(monkeypatch):
    """Both registries without the native rungs, as on a host with no C++
    compiler."""
    backends.available_backends()
    jbackends.available_backends()
    for mod in (backends, jbackends):
        monkeypatch.setattr(mod, "_REGISTRY", {
            k: v for k, v in mod._REGISTRY.items()
            if not k.startswith("native")})
        monkeypatch.setattr(mod, "_LOADED", True)
    monkeypatch.setattr(backends, "_NATIVE_TRIED", True)


class TestPersonas:
    @pytest.mark.parametrize("size", ["small", "medium"])
    @pytest.mark.parametrize("persona,extra", [
        ("main", []), ("multi-thread", ["4"]), ("multi-thread", ["1"]),
    ])
    def test_native_personas_match_jax(self, size, persona, extra):
        tr, te = _paths(size)
        argv = [tr, te, "5", *extra, "--persona", persona, "--json"]
        rc, got = _run(cli.run, argv)
        jrc, want = _jax(argv)
        assert rc == jrc == 0
        assert got.splitlines()[0] == want.splitlines()[0]
        backend = "native" if persona == "main" else "native-mt"
        assert f'"backend": "{backend}"' in got.splitlines()[1]

    @pytest.mark.parametrize("k", ["1", "5", "20"])
    def test_default_persona_is_the_twin_of_tpu(self, k):
        tr, te = _paths("medium")
        rc, got = _run(cli.run, [tr, te, k, *CPU])
        jrc, want = _jax([tr, te, k])
        assert rc == jrc == 0 and got == want
        rc, explicit = _run(cli.run, [tr, te, k, "--persona", "cuda", *CPU])
        assert explicit == got

    def test_threads_positional_reaches_the_kernel(self, monkeypatch):
        seen = []
        real = native_backend.knn_native

        def spy(*args, num_threads=1):
            seen.append(num_threads)
            return real(*args, num_threads=num_threads)

        monkeypatch.setattr(native_backend, "knn_native", spy)
        tr, te = _paths()
        assert cli.run([tr, te, "3", "6", "--persona", "multi-thread"],
                       stdout=io.StringIO()) == 0
        assert cli.run([tr, te, "3", "--persona", "multi-thread"],
                       stdout=io.StringIO()) == 0
        assert cli.run([tr, te, "3", "--persona", "main"],
                       stdout=io.StringIO()) == 0
        assert seen == [6, 0, 1]  # 0: the hardware's concurrency

    def test_mpi_persona_is_not_ported(self):
        """Ported since the multi-device slice (the name is kept from when
        the persona was refused): ``--persona mpi`` runs the query-sharded
        backend and prints the JAX CLI's mpi line."""
        tr, te = _paths()
        rc, got = _run(cli.run, [tr, te, "3", "--persona", "mpi", *CPU,
                                 "--json"])
        jrc, want = _jax([tr, te, "3", "--persona", "mpi"])
        assert rc == jrc == 0
        assert got.splitlines()[0] == want.splitlines()[0]
        assert '"backend": "cuda-sharded"' in got


class TestStaticRung:
    def test_unavailable_native_substitutes_oracle_as_jax(self, no_native,
                                                          capsys):
        tr, te = _paths()
        rc, got = _run(cli.run, [tr, te, "3", "--persona", "main", "--json"])
        err = capsys.readouterr().err
        jrc, want = _jax([tr, te, "3", "--persona", "main", "--json"])
        jerr = capsys.readouterr().err
        assert rc == jrc == 0
        assert got.splitlines()[0] == want.splitlines()[0]
        assert '"backend": "oracle"' in got
        for e in (err, jerr):
            assert e.startswith("warning: backend 'native' unavailable")
            assert e.rstrip().endswith("falling back to 'oracle'")

    @pytest.mark.parametrize("persona", ["main", "multi-thread"])
    def test_no_fallback_exits_2_with_jax_line(self, no_native, capsys,
                                               persona):
        tr, te = _paths()
        argv = [tr, te, "3", "--persona", persona, "--no-fallback"]
        rc, out = _run(cli.run, argv)
        err = capsys.readouterr().err
        jrc, _ = _jax(argv)
        assert rc == jrc == 2 and out == ""
        assert err == capsys.readouterr().err
        assert "--no-fallback forbids degrading to 'oracle'" in err

    @pytest.mark.parametrize("name", ["bogus", "tpu", "tpu-pallas"])
    def test_unknown_backend_exits_2(self, capsys, name):
        tr, te = _paths()
        assert cli.run([tr, te, "3", "--backend", name]) == 2
        assert capsys.readouterr().err == \
            f"error: backend '{name}' unavailable\n"

    def test_no_fallback_on_an_available_backend_runs(self):
        tr, te = _paths()
        rc, got = _run(cli.run, [tr, te, "3", "--no-fallback", *CPU])
        jrc, want = _jax([tr, te, "3", "--no-fallback"])
        assert rc == jrc == 0 and got == want


class TestApproxFlags:
    def test_recall_target_without_approx_exits_2(self, capsys):
        tr, te = _paths()
        argv = [tr, te, "3", "--recall-target", "0.9"]
        assert cli.run(argv) == 2
        err = capsys.readouterr().err
        assert _jax(argv)[0] == 2
        assert err == capsys.readouterr().err == \
            "error: --recall-target only applies with --approx\n"

    @pytest.mark.parametrize("target", ["0", "1.5", "-1"])
    def test_recall_target_out_of_range_exits_1(self, capsys, target):
        tr, te = _paths()
        argv = [tr, te, "3", "--approx", "--recall-target", target]
        assert cli.run([*argv, *CPU]) == 1
        err = capsys.readouterr().err
        assert _jax(argv)[0] == 1
        assert err == capsys.readouterr().err
        assert "recall_target must be in (0, 1]" in err

    @pytest.mark.parametrize("extra", [[], ["--recall-target", "0.99"],
                                       ["--metric", "manhattan"],
                                       ["--engine", "xla"]])
    def test_approx_line_matches_jax(self, extra):
        # medium has 370 queries: above the guard's 128, so JAX's guard
        # runs (the port selects exactly and has none).
        tr, te = _paths("medium")
        argv = [tr, te, "5", "--approx", *extra]
        rc, got = _run(cli.run, [*argv, *CPU])
        jrc, want = _jax(argv)
        assert rc == jrc == 0 and got == want
        # The same line as the exact run's.
        exact = [] if extra[:1] == ["--recall-target"] else extra
        assert got == _run(cli.run, [tr, te, "5", *exact, *CPU])[1]

    def test_approx_with_forced_stripe_is_refused(self, capsys):
        tr, te = _paths()
        argv = [tr, te, "3", "--approx", "--engine", "stripe"]
        assert cli.run([*argv, *CPU]) == 1
        assert _jax(argv)[0] == 1
        err = capsys.readouterr().err.splitlines()
        assert all("approx" in line for line in err)

    @pytest.mark.parametrize("extra,flag", [
        (["--approx"], "--approx"), (["4"], "--threads")])
    def test_sweep_rejects_approx_and_threads(self, capsys, extra, flag):
        tr, te = _paths()
        assert cli.run([tr, te, "1", *extra, "--sweep-k", "1,3"]) == 2
        err = capsys.readouterr().err
        assert "incompatible with" in err and flag in err


class TestApproxGuard:
    """The twin of ``tests/test_approx_guard.py``. JAX's guard scores a
    query sample to catch ``approx_max_k``'s misses and falls back to exact
    selection below the target; on the card approx selection is exact
    (recall 1.0 on every input), so the port answers what JAX's fallback
    answers, with no sample and no warning."""

    @staticmethod
    def _args(problem, **kw):
        train_x, train_y, test_x, c = problem
        return (train_x, train_y, test_x, 5, c), {"engine": "xla", **kw}

    @staticmethod
    def _no_approx_selection(monkeypatch):
        """Record every approximate selection the port makes."""
        calls = []
        monkeypatch.setattr(cuda_backend, "approx_smallest_indices",
                            lambda *a, **k: calls.append(1))
        return calls

    def test_guard_triggers_fallback_and_warns(self, rng, monkeypatch):
        problem = _tiled_problem(rng)
        args, kw = self._args(problem)
        monkeypatch.setattr(jtpu, "sampled_approx_recall",
                            lambda *a, **k: 0.002)
        calls = self._no_approx_selection(monkeypatch)
        want = jtpu.predict_arrays(*args, **kw)
        with pytest.warns(RuntimeWarning, match="sampled recall 0.002"):
            np.testing.assert_array_equal(
                jtpu.predict_arrays(*args, approx=True, **kw), want)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            got = cuda_backend.predict_arrays(*args, approx=True,
                                              device="cpu", **kw)
        np.testing.assert_array_equal(got, want)
        assert not calls

    def test_guard_silent_when_recall_meets_target(self, rng):
        problem = _tiled_problem(rng, reps=3)
        args, kw = self._args(problem)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            got = cuda_backend.predict_arrays(*args, approx=True,
                                              device="cpu", **kw)
            np.testing.assert_array_equal(
                got, jtpu.predict_arrays(*args, approx=True, **kw))
        np.testing.assert_array_equal(
            got, cuda_backend.predict_arrays(*args, device="cpu", **kw))

    def test_sampled_recall_math(self, rng):
        # JAX's guard arithmetic on its strided sample, and the port's
        # approx selection scored the same way: both 1.0.
        from knn_tpu_torch.ops.distance import DIST_FNS
        from knn_tpu_torch.ops.topk import (approx_smallest_indices,
                                            topk_smallest)

        train_x, _, test_x, _ = _tiled_problem(rng, reps=2)
        assert jtpu.sampled_approx_recall(train_x, test_x, 5, 0.95) == 1.0
        pick = np.linspace(0, len(test_x) - 1, 128).astype(int)
        d = DIST_FNS["fast"](torch.from_numpy(test_x[pick]),
                             torch.from_numpy(train_x))
        exact = topk_smallest(d, 5)[1].numpy()
        approx = approx_smallest_indices(d, 5, 0.95).numpy()
        hits = sum(len(set(e) & set(a)) for e, a in zip(exact, approx))
        assert hits / (len(pick) * 5) == 1.0

    def test_small_query_sets_run_exact_without_guard(self, rng, monkeypatch):
        calls = self._no_approx_selection(monkeypatch)
        problem = _tiled_problem(rng, reps=2, q=40)
        args, kw = self._args(problem)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            got = cuda_backend.predict_arrays(*args, approx=True,
                                              device="cpu", **kw)
        np.testing.assert_array_equal(
            got, cuda_backend.predict_arrays(*args, device="cpu", **kw))
        np.testing.assert_array_equal(
            got, jtpu.predict_arrays(*args, approx=True, **kw))
        assert not calls

    def test_guard_uses_resolved_metric(self, rng, monkeypatch):
        calls = self._no_approx_selection(monkeypatch)
        problem = _tiled_problem(rng, reps=2)
        args, kw = self._args(problem, metric="manhattan", precision="exact")
        got = cuda_backend.predict_arrays(*args, approx=True, device="cpu",
                                          **kw)
        np.testing.assert_array_equal(
            got, jtpu.predict_arrays(*args, approx=True, **kw))
        np.testing.assert_array_equal(
            got, cuda_backend.predict_arrays(*args, device="cpu", **kw))
        assert not calls

    def test_guard_not_run_without_approx(self, rng, monkeypatch):
        calls = self._no_approx_selection(monkeypatch)
        args, kw = self._args(_tiled_problem(rng, reps=2))
        np.testing.assert_array_equal(
            cuda_backend.predict_arrays(*args, device="cpu", **kw),
            jtpu.predict_arrays(*args, **kw))
        assert not calls

    @pytest.mark.parametrize("engine", ["auto", "xla"])
    def test_approx_takes_the_exact_calls_route(self, rng, monkeypatch,
                                                engine):
        # On the card approx runs where the exact call runs: the kernels
        # for euclidean with engine auto.
        routes = []
        real = cuda_backend.stripe_classify_arrays
        monkeypatch.setattr(cuda_backend, "stripe_classify_arrays",
                            lambda *a, **k: routes.append(1) or real(*a, **k))
        args, kw = self._args(_tiled_problem(rng, reps=2), engine=engine)
        got = cuda_backend.predict_arrays(*args, approx=True, device="cpu",
                                          **kw)
        assert len(routes) == (engine == "auto")
        np.testing.assert_array_equal(
            got, cuda_backend.predict_arrays(*args, device="cpu", **kw))
