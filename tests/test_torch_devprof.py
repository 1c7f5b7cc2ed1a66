"""The card's side of observability on the port (the twin of
``tests/test_devprof.py``), on the CPU: ``knn_tpu_torch/obs/devprof.py``.

- Device memory: ``torch.cuda.memory_stats``/``mem_get_info`` per card;
  with no initialized card (here) one ``cpu:0`` row of zeros, the JAX
  package's bare-device answer.
- Compile events: the port compiles nothing at dispatch; its builds are
  (``nvcc`` of ``csrc/*.cu``, the C++ compiler of ``native/``), and each
  one that runs is ``knn_compile_events_total``/``knn_compile_ms``.
- Executable-signature hit/miss with JAX's miss-then-hit semantics, keyed
  on the port's (route, form, swept rows, k, d), at the retrieval core.
- ``torch.profiler`` captures: host spans ride the trace as
  ``record_function`` ranges, with obs on or off; ``CaptureBusy`` for a second capture; the
  serve endpoints and the classify CLI's ``--profile-out``/``--trace-dir``.

What the card adds (the kernels' events in a capture, real memory
numbers) is held in ``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""

import json
import os
import stat
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.obs import devprof as jdevprof  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier  # noqa: E402
from knn_tpu_torch.obs import devprof  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401
from tests.test_torch_serve import (  # noqa: E402,F401
    CPU,
    Served,
    http_get,
    obs_on,
    problem,
)


def paths(size="small"):
    d = fixtures.datasets_dir()
    return str(d / f"{size}-train.arff"), str(d / f"{size}-test.arff")


class TestDeviceMemory:
    def test_no_card_reports_one_zero_row(self, obs_on):
        stats = devprof.record_device_memory()
        assert stats == [{"device": "cpu:0", "platform": "cpu", "in_use": 0,
                          "peak": 0, "reserved": 0, "free": 0, "total": 0,
                          "source": "none"}]
        gauges = {dict(i.labels)["kind"]: i.value
                  for i in obs_on.instruments()
                  if i.name == "knn_device_memory_bytes"}
        assert gauges == dict.fromkeys(
            ("in_use", "peak", "reserved", "free", "total"), 0)

    def test_zero_row_matches_jax_bare_device(self):
        class Bare:
            platform, id = "cpu", 0

            def memory_stats(self):
                return None

        jrow = jdevprof.device_memory_stats(devices=[Bare()])[0]
        row = devprof.device_memory_stats(devices=[torch.device("cpu")])[0]
        for key in ("device", "in_use", "peak"):
            assert row[key] == jrow[key], key

    def test_disabled_records_nothing(self):
        obs.disable()
        obs.reset()
        devprof.record_device_memory()
        assert obs.registry().instruments() == []


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes its ``-o`` file: the build hook is
    exercised without a CUDA toolkit."""
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                      '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
                      '  shift\ndone\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


class TestBuildEvents:
    def test_an_nvcc_build_is_a_compile_event(self, obs_on, tmp_path,
                                              monkeypatch):
        from knn_tpu_torch.ops import _build

        nvcc = _fake_nvcc(tmp_path)
        monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        _build._finish("stripe_knn", _build._start("stripe_knn"))
        assert _build.library_path("stripe_knn").exists()
        assert devprof.compile_summary()["nvcc"]["count"] == 1
        names = {i.name for i in obs_on.instruments()}
        assert {"knn_compile_events_total", "knn_compile_ms"} <= names
        assert _build._start("stripe_knn") is None  # built: no event
        assert devprof.compile_summary()["nvcc"]["count"] == 1

    def test_a_native_build_is_a_compile_event(self, obs_on, tmp_path,
                                               monkeypatch):
        from knn_tpu_torch import native

        if native.compiler() is None:
            pytest.skip("no C++ compiler on this host")
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
        native.build("knn_runtime")
        summary = devprof.compile_summary()
        assert summary["cxx"]["count"] == 1
        assert summary["cxx"]["wall_ms_total"] > 0
        native.build("knn_runtime")  # on disk: no second event
        assert devprof.compile_summary()["cxx"]["count"] == 1

    def test_off_records_nothing(self):
        obs.disable()
        obs.reset()
        devprof.record_build("nvcc", "x", 1.0)
        assert obs.registry().instruments() == []


class TestExecutableCache:
    def test_miss_then_hit_as_jax(self, obs_on):
        jobs.enable()
        jobs.reset()
        for m in (devprof, jdevprof):
            assert m.record_executable_lookup("b", ("sig", 1)) == "miss"
            assert m.record_executable_lookup("b", ("sig", 1)) == "hit"
            assert m.record_executable_lookup("b", ("sig", 2)) == "miss"
            assert m.executable_cache_summary() == {"hits": 1, "misses": 2}

    def test_reset_clears_signatures(self, obs_on):
        devprof.record_executable_lookup("b", ("sig",))
        obs.reset()
        assert devprof.record_executable_lookup("b", ("sig",)) == "miss"

    def test_off_records_nothing(self):
        obs.disable()
        obs.reset()
        assert devprof.record_executable_lookup("b", ("x",)) == "off"
        assert obs.registry().instruments() == []

    @pytest.mark.parametrize("engine,route", [("auto", "stripe"),
                                              ("xla", "xla")])
    def test_retrieval_keys_route_form_rows_k_d(self, obs_on, rng, engine,
                                                route):
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, engine=engine, **CPU).fit(train)
        model.kneighbors(test)
        model.kneighbors(test)
        assert devprof.executable_cache_summary() == {"hits": 1, "misses": 1}
        assert ("retrieval", (route, "exact", test.num_instances, 3,
                              test.num_features)) in devprof._exec_seen


    @pytest.mark.parametrize("backend,opts", [
        ("cuda", {}), ("cuda", {"engine": "xla"}),
        ("cuda", {"force_tiled": True}), ("cuda-tile", {})])
    def test_predict_path_records_lookup(self, obs_on, rng, backend, opts):
        """The backends' dispatch sites count too, as JAX's do: the second
        predict of one signature is a hit."""
        train, test, _, _ = problem(rng)
        model = KNNClassifier(k=3, backend=backend, **CPU, **opts).fit(train)
        model.predict(test)
        model.predict(test)
        assert devprof.executable_cache_summary() == {"hits": 1,
                                                      "misses": 1}


class TestCapture:
    def test_capture_holds_host_spans(self, obs_on):
        with devprof.capture() as cap:
            with obs.span("serve.dispatch", probe=1):
                torch.ones(64, 64) @ torch.ones(64, 64)
        trace = cap.trace
        assert cap.error is None and trace["traceEvents"]
        assert trace["otherData"]["source"] == "torch.profiler"
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert "serve.dispatch" in names
        # With obs off the capture holds the host ranges all the same (the
        # profiler rule), and the tracer records nothing.
        obs.disable()
        obs.reset()
        with devprof.capture() as cap:
            with obs.span("prepare", engine="stripe"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        assert cap.error is None
        assert "prepare" in {e.get("name", "")
                             for e in cap.trace["traceEvents"]}
        assert obs.tracer().spans() == []

    def test_concurrent_capture_raises_busy(self, obs_on):
        with devprof.capture():
            with pytest.raises(devprof.CaptureBusy):
                with devprof.capture():
                    pass

    def test_capture_counts_outcome(self, obs_on):
        with devprof.capture():
            pass
        assert obs_on.counter("knn_profile_captures_total",
                              outcome="ok").value == 1


@pytest.fixture
def server(rng, obs_on):
    from knn_tpu_torch.serve.server import ServeApp, make_server

    train, test, _, _ = problem(rng)
    s = Served(ServeApp, make_server, KNNClassifier(k=3, **CPU).fit(train),
               warm=(1, 8), max_batch=8, max_wait_ms=1.0)
    try:
        yield s.base, test
    finally:
        s.close()


class TestServeEndpoints:
    def test_metrics_and_healthz_device_block(self, server):
        base, _ = server
        st, body, _ = http_get(base, "/metrics")
        assert st == 200 and "knn_device_memory_bytes" in body
        dev = json.loads(http_get(base, "/healthz")[1])["device"]
        assert dev["memory"][0]["in_use"] == 0
        assert dev["executable_cache"]["misses"] >= 1
        assert isinstance(dev["compile"], dict)

    def test_debug_profile_under_load(self, server):
        base, test = server
        rows = json.dumps({"instances": test.features[:2].tolist()}).encode()
        stop = threading.Event()

        def load():
            req = urllib.request.Request(
                base + "/predict", data=rows,
                headers={"Content-Type": "application/json"})
            while not stop.is_set():
                urllib.request.urlopen(req, timeout=30).read()

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        try:
            st, body, _ = http_get(base, "/debug/profile?ms=150")
        finally:
            stop.set()
            loader.join(timeout=10)
        trace = json.loads(body)
        assert st == 200 and trace["traceEvents"]
        assert trace["otherData"]["source"] == "torch.profiler"
        assert trace["otherData"]["capture_wall_ms"] >= 150

    @pytest.mark.parametrize("ms", ["banana", "-1",
                                    str(devprof.MAX_CAPTURE_MS + 1)])
    def test_debug_profile_validation(self, server, ms):
        assert http_get(server[0], f"/debug/profile?ms={ms}")[0] == 400


class TestCliProfiles:
    def test_classify_profile_out_holds_the_classify_span(self, tmp_path):
        from knn_tpu_torch import cli

        tr, te = paths()
        out = tmp_path / "profile.json"
        assert cli.run([tr, te, "3", "--device", "cpu",
                        "--profile-out", str(out)]) == 0
        trace = json.loads(out.read_text())
        assert trace["otherData"]["source"] == "torch.profiler"
        assert "classify" in {e.get("name") for e in trace["traceEvents"]}

    def test_classify_trace_dir_writes_a_trace(self, tmp_path):
        from knn_tpu_torch import cli

        tr, te = paths()
        d = tmp_path / "traces" / "run1"
        assert cli.run([tr, te, "3", "--device", "cpu",
                        "--trace-dir", str(d)]) == 0
        files = os.listdir(d)
        assert len(files) == 1 and files[0].endswith(".pt.trace.json")
        assert json.loads((d / files[0]).read_text())["traceEvents"]

    def test_sweep_takes_the_profile_flags_too(self, tmp_path):
        from knn_tpu_torch import cli

        tr, te = paths()
        out = tmp_path / "p.json"
        assert cli.run([tr, te, "1", "--sweep-k", "1,3", "--device", "cpu",
                        "--profile-out", str(out)]) == 0
        assert json.loads(out.read_text())["traceEvents"]

    def test_unwritable_paths_exit_as_jax(self, tmp_path):
        """``--profile-out`` in a missing directory exits 2 before any
        parse; a ``--trace-dir`` that cannot be made fails the run (1),
        in both CLIs."""
        from knn_tpu.cli import run as jrun
        from knn_tpu_torch import cli

        tr, te = paths()
        blocker = tmp_path / "file"
        blocker.write_text("x")
        for argv in (["--profile-out", "/nonexistent-dir/p.json"],
                     ["--trace-dir", str(blocker / "sub")]):
            got = cli.run([tr, te, "3", "--device", "cpu", *argv])
            want = jrun([tr, te, "3", "--platform", "cpu", *argv])
            assert got == want, argv
        assert got == 1
