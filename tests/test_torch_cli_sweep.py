"""The port's ``--sweep-k`` and ``--dump-predictions`` against the JAX
package's CLI, on the CPU: twins of ``tests/test_cli.py``'s sweep and dump
cases. Each result line must equal ``python -m knn_tpu ... --platform cpu``'s
apart from the ms field, and each dumped prediction vector must equal the
JAX package's (exact).
"""

import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import cli as jcli  # noqa: E402
from knn_tpu_torch import cli  # noqa: E402
from knn_tpu_torch.backends.oracle import knn_oracle  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from tests import fixtures  # noqa: E402

LINE_RE = re.compile(
    r"^The (\d+)-NN classifier for (\d+) test instances on (\d+) train instances "
    r"required (\d+) ms CPU time\. Accuracy was (\d\.\d{4})$"
)
_MS = re.compile(r"required \d+ ms")


def _paths(size):
    d = fixtures.datasets_dir()
    return str(d / f"{size}-train.arff"), str(d / f"{size}-test.arff")


@pytest.fixture(scope="module")
def paths():
    return _paths("small")


@pytest.fixture(scope="module")
def noisy(tmp_path_factory):
    """An integer grid with random labels and tie plateaus, written as ARFF:
    its accuracy changes with k, unlike the fixtures'."""
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("noisy")
    x = rng.integers(0, 4, (500, 6))
    x[250:300] = x[:50]
    y = rng.integers(0, 5, 500)
    qx = np.concatenate([x[:40], rng.integers(0, 4, (60, 6))])
    qy = rng.integers(0, 5, 100)
    out = []
    for name, a, b in (("train", x, y), ("test", qx, qy)):
        rows = [",".join(map(str, r)) + f",{c}" for r, c in zip(a.tolist(), b)]
        head = ["@relation noisy", ""] + [f"@attribute a{i} NUMERIC"
                                          for i in range(6)]
        head += ["@attribute class NUMERIC", "", "@data"]
        path = d / f"{name}.arff"
        path.write_text("\n".join(head + rows) + "\n")
        out.append(str(path))
    return tuple(out)


def _lines(runner, argv):
    out = io.StringIO()
    assert runner(argv, stdout=out) == 0
    return _MS.sub("required <ms> ms", out.getvalue()).splitlines()


@pytest.mark.parametrize("size", ["small", "medium", "large", "noisy"])
def test_sweep_lines_equal_jax(size, noisy):
    tr, te = noisy if size == "noisy" else _paths(size)
    argv = [tr, te, "1", "--sweep-k", "1,5,10"]
    want = _lines(jcli.run, [*argv, "--platform", "cpu"])
    got = _lines(cli.run, [*argv, "--device", "cpu"])
    assert len(got) == 3 and got == want
    for line, k in zip(got, ("1", "5", "10")):
        assert LINE_RE.match(line.replace("<ms>", "0")).group(1) == k


@pytest.mark.parametrize("extra", [[], ["--engine", "xla"],
                                   ["--engine", "stripe"],
                                   ["--metric", "manhattan"], ["--warmup"]])
def test_sweep_options_equal_jax(noisy, extra):
    argv = [*noisy, "3", "--sweep-k", "7,2", *extra]
    want = _lines(jcli.run, [*argv, "--platform", "cpu"])
    got = _lines(cli.run, [*argv, "--device", "cpu"])
    assert got == want and len(got) == 2


def test_sweep_json_lines(noisy):
    import json

    got = _lines(cli.run, [*noisy, "1", "--sweep-k", "2,4", "--engine", "xla",
                           "--json", "--device", "cpu"])
    assert len(got) == 4
    recs = [json.loads(x) for x in got[1::2]]
    assert [r["k"] for r in recs] == [2, 4]
    assert {r["backend"] for r in recs} == {"sweep:xla"}


def test_sweep_prints_one_line_per_k(paths):
    out = io.StringIO()
    assert cli.run([paths[0], paths[1], "1", "--sweep-k", "5,1", "--engine",
                    "xla", "--device", "cpu"], stdout=out) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 2
    for line, k in zip(lines, ("1", "5")):
        m = LINE_RE.match(line)
        assert m and m.group(1) == k, line
    single = io.StringIO()
    assert cli.run([paths[0], paths[1], "5", "--backend", "oracle"],
                   stdout=single) == 0
    assert lines[1].split()[-1] == single.getvalue().strip().split()[-1]


def test_sweep_rejects_garbage(paths, capsys):
    for bad in ("a,b", "0,5", ",", "-1"):
        assert cli.run([paths[0], paths[1], "1", "--sweep-k", bad]) == 2
        assert "positive integers" in capsys.readouterr().err


def test_sweep_rejects_k_over_n(paths, capsys):
    assert cli.run([paths[0], paths[1], "1", "--sweep-k", "1,100000",
                    "--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    ["--precision", "fast"], ["--precision", "bf16"], ["--query-batch", "8"],
    ["--backend", "oracle"], ["--backend", "cuda"], ["--query-tile", "64"],
    ["--train-tile", "512"],
])
def test_sweep_rejects_incompatible_flags_before_loading(extra, capsys):
    # Missing files: the flag error comes first, so nothing is read.
    assert cli.run(["/no/train.arff", "/no/test.arff", "1", *extra,
                    "--sweep-k", "1,5"]) == 2
    err = capsys.readouterr().err
    assert "incompatible" in err and err.count("\n") == 1


def test_sweep_allows_the_device_switch_and_default_knobs(paths):
    out = io.StringIO()
    assert cli.run([paths[0], paths[1], "1", "--sweep-k", "1,3",
                    "--precision", "exact", "--query-tile", "256",
                    "--train-tile", "2048", "--device", "cpu"],
                   stdout=out) == 0
    assert len(out.getvalue().splitlines()) == 2


def test_sweep_on_the_card_without_one_is_a_device_error(paths, capsys,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    assert cli.run([paths[0], paths[1], "1", "--sweep-k", "1,3"],
                   stdout=out) == 1
    assert "DeviceError" in capsys.readouterr().err
    assert out.getvalue() == ""


def test_dump_predictions_writes_the_vector(paths, tmp_path):
    out = tmp_path / "preds.npy"
    assert cli.run([paths[0], paths[1], "3", "--backend", "oracle",
                    "--dump-predictions", str(out)], stdout=io.StringIO()) == 0
    train, test = load_arff(paths[0]), load_arff(paths[1])
    want = knn_oracle(train.features, train.labels, test.features, 3,
                      train.num_classes)
    np.testing.assert_array_equal(np.load(out), want)


def test_dump_predictions_equal_jax(noisy, tmp_path):
    mine, theirs = tmp_path / "p.npy", tmp_path / "j.npy"
    assert cli.run([*noisy, "4", "--device", "cpu", "--dump-predictions",
                    str(mine)], stdout=io.StringIO()) == 0
    assert jcli.run([*noisy, "4", "--platform", "cpu", "--dump-predictions",
                     str(theirs)], stdout=io.StringIO()) == 0
    got = np.load(mine)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.load(theirs))


def test_sweep_dumps_one_file_per_k(noisy, tmp_path):
    base = tmp_path / "p.npy"
    assert cli.run([*noisy, "1", "--sweep-k", "1,5", "--engine", "xla",
                    "--dump-predictions", str(base), "--device", "cpu"],
                   stdout=io.StringIO()) == 0
    jbase = tmp_path / "j.npy"
    assert jcli.run([*noisy, "1", "--sweep-k", "1,5", "--engine", "xla",
                     "--dump-predictions", str(jbase), "--platform", "cpu"],
                    stdout=io.StringIO()) == 0
    for k in (1, 5):
        single = tmp_path / f"single{k}.npy"
        assert cli.run([*noisy, str(k), "--backend", "oracle",
                        "--dump-predictions", str(single)],
                       stdout=io.StringIO()) == 0
        got = np.load(tmp_path / f"p.k{k}.npy")
        np.testing.assert_array_equal(got, np.load(single))
        np.testing.assert_array_equal(got, np.load(tmp_path / f"j.k{k}.npy"))


@pytest.mark.parametrize("sweep", [False, True])
def test_unwritable_dump_path_clean_error(paths, capsys, sweep):
    out = io.StringIO()
    argv = [paths[0], paths[1], "1", "--device", "cpu",
            "--dump-predictions", "/no/such/dir/p.npy"]
    if sweep:
        argv += ["--sweep-k", "1"]
    assert cli.run(argv, stdout=out) == 1
    assert "error:" in capsys.readouterr().err
    # The result line still printed: the computation is not discarded.
    assert LINE_RE.match(out.getvalue().strip())
