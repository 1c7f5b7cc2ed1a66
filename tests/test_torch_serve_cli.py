"""``save-index`` and ``serve`` on the port's CLI (the twin of the serve
cases of ``tests/test_cli.py`` and of ``scripts/serve_smoke.py`` steps
1-5), on the CPU.

- The validation tables and exit codes are the JAX CLI's: each bad value
  exits 2 before any compute in both CLIs, with one ``error:`` line.
- The flags of later slices (fleet, control, history) are not in the
  port's parser: argparse exits 2 on each, where the JAX CLI accepts it
  (ROADMAP A12). ``--shards`` (ROADMAP A11) is, with JAX's validation
  line. The mutable tier's flags (``--mutable``,
  ``--delta-cap``, ``--compact-threshold``, ``--compact-interval-s``,
  ROADMAP A10) are, with JAX's validation lines. The index family's flags
  (``save-index --ivf-cells/--ivf-seed/--ivf-iters``, ``serve
  --ivf-probes/--ivf-recall-floor``, ROADMAP A9) and the answer-quality
  and capture flags (``--shadow-rate`` ... ``--capture-burn-window-s``,
  ROADMAP A8b) are, with JAX's validation lines and exit codes; so is the
  ``replay`` subcommand.
- One subprocess lifecycle with ``--device cpu --port 0``: the ready
  banner, ``/healthz``, ``/predict`` (equal to the JAX package's answer),
  a re-save and SIGHUP (a new ``index_version``, the same predictions),
  SIGTERM (exit 0 after the drain line).
"""

import io
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.cli import run as jrun  # noqa: E402
from knn_tpu.data.arff import load_arff as jload_arff  # noqa: E402
from knn_tpu.models import knn as jknn  # noqa: E402
from knn_tpu.models.knn import KNNClassifier as JKNNClassifier  # noqa: E402
from knn_tpu.serve.artifact import load_index as jload_index  # noqa: E402
from knn_tpu_torch import cli  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from knn_tpu_torch.serve.artifact import load_index  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY_RE = re.compile(r"ready on (http://[\d.]+:\d+)")


@pytest.fixture(scope="module")
def paths():
    d = fixtures.datasets_dir()
    return str(d / "small-train.arff"), str(d / "small-test.arff")


def both(argv, capsys):
    """Exit codes of the port's CLI and the JAX CLI on ``argv``, and the
    port's stderr."""
    got = cli.run(argv, stdout=io.StringIO())
    err = capsys.readouterr().err
    want = jrun(argv, stdout=io.StringIO())
    capsys.readouterr()
    assert "Traceback" not in err
    return got, want, err


class TestSaveIndex:
    def test_save_index_serves_as_jax(self, paths, tmp_path):
        out = io.StringIO()
        index = tmp_path / "idx"
        assert cli.run(["save-index", paths[0], str(index), "--k", "3"],
                       stdout=out) == 0
        assert out.getvalue().startswith(f"wrote index {index}: ")
        test = load_arff(paths[1])
        want = JKNNClassifier(k=3).fit(jload_arff(paths[0])).predict(
            jload_arff(paths[1]))
        np.testing.assert_array_equal(
            load_index(index, device="cpu").predict(test), want)
        np.testing.assert_array_equal(
            jload_index(index).predict(jload_arff(paths[1])), want)

    @pytest.mark.parametrize("extra,needle", [
        (["--k", "0"], "k must be >= 1"),
        (["--k", "999999"], "exceeds"),
        (["--backend", "no-such"], "unavailable"),
    ])
    def test_bad_input_exits_2_as_jax(self, paths, tmp_path, capsys, extra,
                                      needle):
        got, want, err = both(["save-index", paths[0], str(tmp_path / "x"),
                               *extra], capsys)
        assert got == want == 2
        assert needle in err and err.startswith("error: ")

    def test_missing_train_and_foreign_dir_exit_2(self, paths, tmp_path,
                                                  capsys):
        got, want, _ = both(["save-index", "/no/such.arff",
                             str(tmp_path / "x")], capsys)
        assert got == want == 2
        victim = tmp_path / "home"
        victim.mkdir()
        (victim / "keep.txt").write_text("mine")
        got, want, err = both(["save-index", paths[0], str(victim)], capsys)
        assert got == want == 2 and "refusing" in err
        assert (victim / "keep.txt").exists()

    @pytest.mark.parametrize("flag", ["--ivf-cells", "--ivf-seed",
                                      "--ivf-iters"])
    def test_later_slice_flags_exit_2(self, paths, tmp_path, capsys, flag):
        """The index family's flags, ported (ROADMAP A9): a bad value of
        each exits 2 in both CLIs with JAX's one error line, before any
        build."""
        bad = {"--ivf-cells": ["--ivf-cells", "0"],
               "--ivf-seed": ["--ivf-cells", "99999", "--ivf-seed", "4"],
               "--ivf-iters": ["--ivf-cells", "4", "--ivf-iters", "0"]}[flag]
        got = cli.run(["save-index", paths[0], str(tmp_path / "x"), *bad,
                       "--device", "cpu"], stdout=io.StringIO())
        err = capsys.readouterr().err
        want = jrun(["save-index", paths[0], str(tmp_path / "j"), *bad],
                    stdout=io.StringIO())
        jerr = capsys.readouterr().err
        assert got == want == 2
        assert err.strip().splitlines() == jerr.strip().splitlines()[-1:]
        assert not (tmp_path / "x").exists()


class TestServeExitCodes:
    def test_missing_and_non_artifact_exit_2(self, tmp_path, capsys):
        got, want, err = both(["serve", "/no/such/index"], capsys)
        assert got == want == 2 and "not found" in err
        plain = tmp_path / "plain"
        plain.mkdir()
        (plain / "junk").write_text("x")
        got, want, err = both(["serve", str(plain)], capsys)
        assert got == want == 2 and "not an index artifact" in err

    @pytest.mark.parametrize("extra", [
        ["--max-batch", "0"], ["--max-wait-ms", "-1"],
        ["--deadline-ms", "0"], ["--port", "99999"],
        ["--max-batch", "64", "--max-queue-rows", "8"],
        ["--warmup-batches", "a,b"], ["--drain-timeout-s", "0"],
        ["--flight-recorder-size", "-1"], ["--slowest-k", "-1"],
        ["--slo-availability-target", "1.5"], ["--slo-latency-target", "0"],
        ["--slo-fast-rung-target", "-0.1"], ["--slo-latency-ms", "0"],
        ["--slo-windows", "5,x"], ["--slo-windows", "0"],
        ["--slo-quality-target", "1"], ["--capacity-window-s", "4"],
        ["--batch-buckets", "a,b"], ["--batch-buckets", "0"],
        ["--batch-buckets", "16,512"], ["--result-cache-rows", "-1"],
        ["--cost-accounting", "maybe"], ["--device", "tpu"],
        ["--ivf-probes", "0"], ["--ivf-recall-floor", "1.5"],
        ["--ivf-recall-floor", "0"],
    ])
    def test_bad_policy_exits_2_before_compute(self, capsys, extra):
        got = cli.run(["serve", "/irrelevant/index", *extra])
        err = capsys.readouterr().err
        assert got == 2 and "Traceback" not in err, extra
        if extra[0] != "--device":  # the port's own flag
            assert jrun(["serve", "/irrelevant/index", *extra]) == 2
            capsys.readouterr()

    def test_missing_positional_exits_2(self):
        assert cli.run(["serve"]) == 2

    @pytest.mark.parametrize("extra", [
        ["--replicate-ack-timeout-s", "5"],
        ["--bootstrap", "auto"],
        ["--follower-of", "http://127.0.0.1:1"],
        ["--replicate-to", "http://127.0.0.1:1"],
        ["--replicate-ack", "any"],
        ["--platform", "cpu"],
    ])
    def test_later_slice_flags_are_not_accepted(self, capsys, extra):
        """The port's parser does not know them: argparse exits 2 rather
        than accepting and ignoring a flag whose layer is not ported (the
        fleet's replication flags; the control and history flags are
        ported, ``tests/test_torch_control.py::TestCLIValidation``)."""
        assert cli.run(["serve", "/irrelevant/index", *extra]) == 2
        assert "unrecognized arguments" in capsys.readouterr().err

    @pytest.mark.parametrize("value,code,line", [
        ("0", 2, "--shards wants a positive integer or 'auto', got '0'"),
        ("two", 2, "--shards wants a positive integer or 'auto'"),
        ("2", 2, "not found"),
        ("auto", 2, "not found"),
    ])
    def test_shards_flag_as_jax(self, capsys, value, code, line):
        """``--shards N|auto`` (ROADMAP A11): a bad count exits 2 with JAX's
        line in both CLIs; a good one gets past the checks to the artifact
        load (missing here: exit 2 in both)."""
        argv = ["serve", "/irrelevant/index", "--shards", value]
        assert cli.run([*argv, "--device", "cpu"]) == code
        assert line in capsys.readouterr().err
        assert jrun([*argv, "--platform", "cpu"]) == code
        assert line in capsys.readouterr().err

    @pytest.mark.parametrize("flag,bad,good", [
        ("--shadow-rate", ["1.5"], ["0.5"]),
        ("--drift-rate", ["-0.1"], ["0.5"]),
        ("--quality-queue", ["0"], ["8"]),
        ("--quality-seed", ["x"], ["1"]),
        ("--capture-dir", ["/dev/null/x"], ["CAPTURE_DIR"]),
        ("--capture-rate", ["0"], ["1"]),
        ("--capture-max-requests", ["0"], ["8"]),
        ("--capture-queue", ["0"], ["8"]),
        ("--capture-burn-threshold", ["0", "--capture-dir", "CAPTURE_DIR"],
         ["2", "--capture-dir", "CAPTURE_DIR"]),
        ("--capture-burn-objective", ["nope"], ["quality"]),
        ("--capture-burn-window-s", ["0"], ["5"]),
    ])
    def test_quality_and_capture_flags_as_jax(self, paths, tmp_path, capsys,
                                              flag, bad, good):
        """The answer-quality and capture flags (ROADMAP A8b): a bad value
        exits 2 in both CLIs (JAX's own error line where it is a value
        check), a good one gets past argparse and the checks (the missing
        index then exits 2 with "not found"). A bad ``--capture-dir`` is
        an unwritable path, seen only once an index loads."""
        sub = lambda argv: [str(tmp_path / "caps") if a == "CAPTURE_DIR"
                            else a for a in argv]  # noqa: E731
        index = "/irrelevant/index"
        if flag == "--capture-dir":
            index = str(tmp_path / "idx")
            assert cli.run(["save-index", paths[0], index, "--k", "3"],
                           stdout=io.StringIO()) == 0
        argv = ["serve", index, flag, *sub(bad)]
        got = cli.run(argv + ["--device", "cpu"], stdout=io.StringIO())
        err = capsys.readouterr().err
        # JAX's CLI installs its process-wide bucket ladder before a boot
        # that then fails (ROADMAP Queue C): put it back, or the next JAX
        # test in this process pads by it.
        with jknn.query_bucket_ladder(jknn.query_buckets()):
            want = jrun(argv, stdout=io.StringIO())
        jerr = capsys.readouterr().err
        assert got == want == 2 and "Traceback" not in err
        last = jerr.strip().splitlines()[-1]
        if last.startswith(f"error: {flag}"):
            assert err.strip().splitlines()[-1] == last
        got = cli.run(["serve", "/irrelevant/index", flag, *sub(good),
                       "--device", "cpu"])
        err = capsys.readouterr().err
        assert got == 2 and "not found" in err, err

    def test_serve_bad_mutable_choice_exits_2(self, capsys):
        """The twin of tests/test_cli.py's case: argparse refuses a bad
        --mutable choice with exit 2, no traceback."""
        assert cli.run(["serve", "/irrelevant/index",
                        "--mutable", "maybe"]) == 2
        assert "Traceback" not in capsys.readouterr().err

    @pytest.mark.parametrize("flag,bad,good", [
        ("--delta-cap", ["0"], ["8"]),
        ("--compact-threshold", ["0"], ["8"]),
        ("--compact-interval-s", ["-1"], ["0"]),
        ("--mutable", ["maybe"], ["on"]),
    ])
    def test_mutable_flags_as_jax(self, capsys, flag, bad, good):
        """The mutable tier's flags (ROADMAP A10): a bad value exits 2 in
        both CLIs with JAX's error line where it is a value check; a good
        one gets past the checks (the missing index then exits 2 with
        "not found")."""
        argv = ["serve", "/irrelevant/index", flag, *bad]
        got = cli.run(argv + ["--device", "cpu"], stdout=io.StringIO())
        err = capsys.readouterr().err
        with jknn.query_bucket_ladder(jknn.query_buckets()):
            want = jrun(argv, stdout=io.StringIO())
        jerr = capsys.readouterr().err
        assert got == want == 2 and "Traceback" not in err
        last = jerr.strip().splitlines()[-1]
        if last.startswith(f"error: {flag}"):
            assert err.strip().splitlines()[-1] == last
        got = cli.run(["serve", "/irrelevant/index", flag, *good,
                       "--device", "cpu"])
        err = capsys.readouterr().err
        assert got == 2 and "not found" in err, err

    def test_other_subcommands_are_not_ported_yet(self, capsys):
        """``route`` waits for the fleet layer; ``history`` and ``report``
        are ported (``tests/test_torch_history_alerts.py``)."""
        assert cli.run(["route", "x"]) == 2
        capsys.readouterr()

    def test_replay_is_ported(self, capsys):
        """``replay`` is a subcommand of the port (ROADMAP A8b): without a
        target argparse exits 2; a missing workload exits 2 in both CLIs
        with one typed line. The in-process and HTTP replays are in
        ``tests/test_torch_workload.py``."""
        assert cli.run(["replay", "x"]) == 2
        assert "--url" in capsys.readouterr().err
        argv = ["replay", "/no/such/workload", "--index", "/no/such/index"]
        got = cli.run(argv)
        err = capsys.readouterr().err
        assert got == jrun(argv) == 2
        capsys.readouterr()
        assert err.startswith("error: ") and "not found" in err


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, json.loads(r.read())


class TestServeLifecycle:
    def test_boot_probe_reload_and_sigterm(self, paths, tmp_path):
        """``scripts/serve_smoke.py`` steps 1-5 on the port's CLI."""
        index = tmp_path / "index"
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        build = subprocess.run(
            [sys.executable, "-m", "knn_tpu_torch", "save-index", paths[0],
             str(index), "--k", "3"], env=env, capture_output=True,
            text=True, cwd=REPO, timeout=120)
        assert build.returncode == 0, build.stderr
        proc = subprocess.Popen(
            [sys.executable, "-m", "knn_tpu_torch", "serve", str(index),
             "--port", "0", "--device", "cpu", "--max-batch", "16",
             "--max-wait-ms", "1", "--drain-timeout-s", "5"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO)
        lines = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()
        try:
            banner = lines.get(timeout=120)
            m = READY_RE.search(banner)
            assert m, banner
            assert "device=cpu" in banner and "buckets=16" in banner
            base = m.group(1)
            st, h = _get(base, "/healthz")
            assert st == 200 and h["ready"] and not h["draining"]
            assert h["device"]["memory"][0]["device"] == "cpu:0"
            assert h["capacity"] is not None  # --cost-accounting on
            test = jload_arff(paths[1])
            want = JKNNClassifier(k=3).fit(jload_arff(paths[0])).predict(
                test)[:32].tolist()
            st, body = _post(base, "/predict",
                             {"instances": test.features[:32].tolist()})
            assert st == 200 and body["predictions"] == want
            v0 = body["index_version"]
            rebuild = subprocess.run(
                [sys.executable, "-m", "knn_tpu_torch", "save-index",
                 paths[0], str(index), "--k", "3"], env=env,
                capture_output=True, text=True, cwd=REPO, timeout=120)
            assert rebuild.returncode == 0
            proc.send_signal(signal.SIGHUP)
            import time

            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                h = _get(base, "/healthz")[1]
                if h["reloads"] == 1:
                    break
                time.sleep(0.05)
            assert h["reloads"] == 1 and h["index_version"] != v0
            st, body = _post(base, "/predict",
                             {"instances": test.features[:32].tolist()})
            assert body["predictions"] == want
            assert body["index_version"] == h["index_version"]
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
            assert "drained (clean=True" in proc.stderr.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
