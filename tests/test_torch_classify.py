"""The classify slice end to end on the host: the port against ``knn_tpu``.

The port's host entries and ``cuda`` backend, run with ``device="cpu"``
(the kernel's plain version), must predict exactly what ``knn_tpu``'s
stripe route (interpret mode) and the oracle predict, and the port's CLI
must print the JAX CLI's result line (the ms field masked).
"""

import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import cli as jcli  # noqa: E402
from knn_tpu.backends.oracle import knn_oracle  # noqa: E402
from knn_tpu.backends.tpu import predict_arrays as jax_predict_arrays  # noqa: E402
from knn_tpu_torch import cli  # noqa: E402
from knn_tpu_torch.backends import available_backends, get_backend  # noqa: E402
from knn_tpu_torch.backends import cuda as cuda_backend  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from knn_tpu_torch.ops import cuda_knn  # noqa: E402
from knn_tpu_torch.resilience.errors import DeviceError  # noqa: E402
from tests import fixtures  # noqa: E402


def _paths(size):
    d = fixtures.datasets_dir()
    return str(d / f"{size}-train.arff"), str(d / f"{size}-test.arff")


@pytest.fixture(scope="module")
def small_port():
    tr, te = _paths("small")
    return load_arff(tr), load_arff(te)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_small_fixture_predictions_match_jax_and_oracle(small_port, k):
    train, test = small_port
    want = jax_predict_arrays(train.features, train.labels, test.features, k,
                              train.num_classes, engine="stripe")
    np.testing.assert_array_equal(
        want, knn_oracle(train.features, train.labels, test.features, k,
                         train.num_classes))
    got = cuda_knn.stripe_classify_arrays(
        train.features, train.labels, test.features, k, train.num_classes,
        device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    got = cuda_backend.predict_arrays(
        train.features, train.labels, test.features, k, train.num_classes,
        device="cpu")
    np.testing.assert_array_equal(got, want)


def test_candidates_arrays_chunked_equal_unchunked(small_port):
    # Each query's answer depends on that query alone: slices of the
    # queries, run one call each, give the rows of one call on them all.
    train, test = small_port
    whole = cuda_knn.stripe_candidates_arrays(
        train.features, test.features, 5, device="cpu")
    parts = [cuda_knn.stripe_candidates_arrays(
        train.features, test.features[s : s + 9], 5, device="cpu")
        for s in range(0, test.num_instances, 9)]
    for j, a in enumerate(whole):
        assert a.tobytes() == np.concatenate([p[j] for p in parts]).tobytes()
    assert whole[0].shape == (test.num_instances, 5)


def test_backend_registry_and_device_cache(small_port):
    train, test = small_port
    # native/native-mt register when their library builds (g++).
    assert available_backends() == ["cuda", "cuda-ring", "cuda-sharded",
                                    "cuda-tile", "cuda-train-sharded",
                                    "native", "native-mt", "oracle"]
    cache_train = load_arff(_paths("small")[0])
    first = get_backend("cuda")(cache_train, test, 3, device="cpu")
    key = ("train_operand", "cpu")  # the kernels' route's one copy
    assert key in cache_train.device_cache
    cached = cache_train.device_cache[key]
    again = get_backend("cuda")(cache_train, test, 3, device="cpu")
    assert cache_train.device_cache[key] is cached
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(
        first, get_backend("oracle")(cache_train, test, 3))


@pytest.mark.parametrize("option,value", [
    ("precision", "bogus"), ("engine", "merge"), ("approx", True),
])
def test_unported_options_raise(small_port, option, value):
    # None of these is an option of tpu either; approx (B6) is, but not with
    # the forced stripe engine, which tpu rejects too.
    train, test = small_port
    extra = {"engine": "stripe"} if option == "approx" else {}
    with pytest.raises(ValueError,
                       match="approx" if option == "approx" else None):
        cuda_backend.predict_arrays(
            train.features, train.labels, test.features, 3,
            train.num_classes, device="cpu", **{option: value}, **extra)


@pytest.mark.parametrize("option,value", [
    ("precision", "fast"), ("metric", "manhattan"), ("metric", "chebyshev"),
    ("metric", "cosine"), ("engine", "xla"), ("query_batch", 7),
])
def test_xla_route_options_match_jax(small_port, option, value):
    # Options the tpu backend sends to the XLA scans (fast with 7 features,
    # every other metric, engine xla, query_batch streaming): the port runs
    # them as torch ops and predicts what the JAX package predicts.
    train, test = small_port
    args = (train.features, train.labels, test.features, 3, train.num_classes)
    want = jax_predict_arrays(*args, **{option: value})
    got = cuda_backend.predict_arrays(*args, device="cpu", **{option: value})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_bf16_on_the_stripe_route_matches_jax(small_port, k):
    # The tpu backend sends bf16 at any width to the stripe kernel; here it
    # runs the tile kernel's plain version with a float32 train (d = 7).
    train, test = small_port
    want = jax_predict_arrays(train.features, train.labels, test.features, k,
                              train.num_classes, engine="stripe",
                              precision="bf16")
    got = cuda_backend.predict_arrays(
        train.features, train.labels, test.features, k, train.num_classes,
        precision="bf16", device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,k", [(129, 3), (7, 17), (7, 257)])
def test_outside_the_stripe_envelope_matches_jax(d, k):
    # The exact form past 128 features and k > 16 take the XLA scans on
    # both backends.
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (300, d)).astype(np.float32)
    y = rng.integers(0, 3, 300).astype(np.int32)
    want = jax_predict_arrays(x, y, x[:25], k, 3)
    np.testing.assert_array_equal(want, knn_oracle(x, y, x[:25], k, 3))
    np.testing.assert_array_equal(
        cuda_backend.predict_arrays(x, y, x[:25], k, 3, device="cpu"), want)


def test_cuda_without_a_card_is_a_device_error(small_port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, test = small_port
    with pytest.raises(DeviceError, match="is_available"):
        cuda_backend.predict_arrays(train.features, train.labels,
                                    test.features, 3, train.num_classes)


_MS = re.compile(r"required \d+ ms")


def _line(runner, argv):
    out = io.StringIO()
    assert runner(argv, stdout=out) == 0
    return _MS.sub("required <ms> ms", out.getvalue())


@pytest.mark.parametrize("size", ["small", "medium"])
@pytest.mark.parametrize("k", [1, 5])
def test_cli_result_line_matches_jax_cli(size, k):
    tr, te = _paths(size)
    want = _line(jcli.run, [tr, te, str(k), "--platform", "cpu"])
    assert want.startswith(f"The {k}-NN classifier")
    assert _line(cli.run, ["classify", tr, te, str(k), "--device", "cpu"]) == want
    assert _line(cli.run, [tr, te, str(k), "--backend", "oracle"]) == want


def test_cli_json_and_warmup():
    tr, te = _paths("small")
    out = io.StringIO()
    assert cli.run([tr, te, "3", "--device", "cpu", "--warmup", "--json"],
                   stdout=out) == 0
    line, js = out.getvalue().splitlines()
    assert line.startswith("The 3-NN classifier for 80 test instances")
    assert '"backend": "cuda"' in js and '"k": 3' in js


def _one_line_error(capsys):
    err = capsys.readouterr().err
    assert err.startswith("error:") and len(err.strip().splitlines()) == 1
    return err


class TestExitCodes:
    def test_k_below_one_exits_2(self, capsys):
        tr, te = _paths("small")
        assert cli.run([tr, te, "0", "--device", "cpu"]) == 2
        assert "k must be >= 1" in _one_line_error(capsys)

    def test_k_over_n_train_exits_2(self, capsys):
        tr, te = _paths("small")
        assert cli.run([tr, te, "999999", "--device", "cpu"]) == 2
        _one_line_error(capsys)

    def test_missing_file_exits_2(self, capsys):
        assert cli.run(["/no/such/train.arff", _paths("small")[1], "1"]) == 2
        assert "Traceback" not in _one_line_error(capsys)

    def test_mismatched_dims_exits_2(self, capsys):
        # small has 7 features, medium 11
        assert cli.run([_paths("small")[0], _paths("medium")[1], "1",
                        "--device", "cpu"]) == 2
        assert "features" in _one_line_error(capsys)

    def test_unknown_flag_exits_2(self):
        tr, te = _paths("small")
        assert cli.run([tr, te, "1", "--bogus-flag"]) == 2

    def test_cuda_without_a_card_exits_1(self, capsys, monkeypatch):
        # An error, never a fallback to the host.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tr, te = _paths("small")
        out = io.StringIO()
        assert cli.run([tr, te, "1", "--device", "cuda"], stdout=out) == 1
        assert "DeviceError" in _one_line_error(capsys)
        assert out.getvalue() == ""


def test_forced_stripe_takes_k_above_16_as_jax_does(small_port):
    # engine="stripe" runs the stripe route at any k, as the tpu backend's
    # forced stripe engine does; engine="auto" takes the XLA scans there.
    train, test = small_port
    args = (train.features, train.labels, test.features, 20, train.num_classes)
    want = jax_predict_arrays(*args, engine="stripe")
    np.testing.assert_array_equal(want, knn_oracle(*args))
    got = cuda_backend.predict_arrays(*args, engine="stripe", device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        get_backend("cuda")(train, test, 20, device="cpu"),
        jax_predict_arrays(*args))
    args = (*args[:3], 257, train.num_classes)
    np.testing.assert_array_equal(
        cuda_backend.predict_arrays(*args, engine="stripe", device="cpu"),
        knn_oracle(*args))
