"""The port's obs core against the JAX package's (the twin of
``tests/test_obs.py`` and of ``tests/test_metrics.py``'s CLI and backend
cases), on the CPU.

The same recorded calls must give the same metrics JSON and the same
Prometheus text; the same spans the same trace structure (names, phases,
nesting, attributes — timestamps, thread ids and the category aside); and
``--metrics-out``/``--trace-out`` on the two CLIs, with the same inputs and
``--persona main`` on both, the same metric names and label sets.
Tolerances: exact, timestamps and wall times aside.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu import cli as jcli  # noqa: E402
from knn_tpu import obs as jobs  # noqa: E402
from knn_tpu.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from knn_tpu.obs.tracer import SpanTracer as JTracer  # noqa: E402
from knn_tpu_torch import cli, obs  # noqa: E402
from knn_tpu_torch.backends import get_backend  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from knn_tpu_torch.obs.export import metrics_document  # noqa: E402
from knn_tpu_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: E402
from knn_tpu_torch.obs.tracer import SpanTracer  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401


def _paths(size="small"):
    d = fixtures.datasets_dir()
    return str(d / f"{size}-train.arff"), str(d / f"{size}-test.arff")


def _record(reg):
    """One sequence of metric calls, fed to either package's registry."""
    reg.counter("knn_queries_total", help="rows classified",
                backend="cuda").add(42)
    reg.counter("knn_queries_total", help="rows classified",
                backend="oracle").add(7)
    reg.counter("knn_retry_total", site="device.put").inc()
    reg.gauge("knn_predict_qps", backend="cuda").set(1234.5)
    reg.gauge("knn_first_call_wall_ms").add(2.25)
    h = reg.histogram("knn_predict_wall_ms", buckets=(1.0, 2.5, 10.0),
                      help="predict call wall ms", backend="cuda")
    for v in (0.5, 1.0, 2.5, 3.0, 99.0, 1e-9):
        h.observe(v)
    reg.histogram("knn_kernel_ms", backend="native").observe(7.0)
    return reg


def _spans(tracer):
    with tracer.span("classify", backend="cuda"):
        with tracer.span("predict", backend="cuda", k=5):
            with tracer.span("prepare", engine="xla-full"):
                pass
            with tracer.span("dispatch", engine="xla-full", approx=False):
                pass
            with tracer.span("fetch", engine="xla-full"):
                pass
        with tracer.span("vote", weighted=True, obj=object):
            pass
    with tracer.span("ingest", file="a.arff"):
        pass
    return tracer


def _shape(events):
    return [(e["name"], e["ph"], e.get("args")) for e in events]


@contextlib.contextmanager
def _profiled():
    """A ``torch.profiler`` recording the block on this thread; yields a
    list that holds, after the block, the names of the ``record_function``
    ranges it recorded, in start order."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield names
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation()), key=lambda e: e.start_ns())
    names.extend(e.name() for e in ranges)


class TestRegistryTwin:
    def test_same_calls_same_json(self):
        mine, theirs = _record(MetricsRegistry()), _record(JRegistry())
        assert mine.to_json() == theirs.to_json()

    def test_same_calls_same_prometheus_text(self):
        mine, theirs = _record(MetricsRegistry()), _record(JRegistry())
        assert mine.to_prometheus() == theirs.to_prometheus()
        assert MetricsRegistry().to_prometheus() == JRegistry().to_prometheus()

    def test_prometheus_text_format(self):
        text = _record(MetricsRegistry()).to_prometheus()
        lines = text.strip().splitlines()
        assert "# HELP knn_queries_total rows classified" in lines
        assert "# TYPE knn_queries_total counter" in lines
        assert 'knn_queries_total{backend="cuda"} 42' in lines
        assert 'knn_predict_wall_ms_bucket{backend="cuda",le="1"} 3' in lines
        assert 'knn_predict_wall_ms_bucket{backend="cuda",le="+Inf"} 6' \
            in lines
        assert lines.index("# TYPE knn_queries_total counter") < lines.index(
            'knn_queries_total{backend="cuda"} 42')

    def test_bucket_edges_le_semantics(self):
        h = Histogram("h", (), buckets=(1.0, 2.0))
        for v in (1.0, 1.0000001, 2.0, 3.0, -1.0):
            h.observe(v)
        assert h.bucket_counts() == [2, 2, 1]
        assert h.cumulative()[-1] == (math.inf, 5)

    @pytest.mark.parametrize("buckets,match", [
        ((), None), ((1.0, 1.0), "duplicate"), ((1.0, math.inf), "implicit"),
    ])
    def test_rejects_bad_buckets(self, buckets, match):
        if not buckets:
            # An empty ladder falls back to the default one, as in JAX.
            assert Histogram("h", (), buckets=buckets).buckets == \
                tuple(sorted(float(b) for b in
                             __import__("knn_tpu_torch.obs.metrics",
                                        fromlist=["x"]).DEFAULT_BUCKETS))
            return
        with pytest.raises(ValueError, match=match):
            Histogram("h", (), buckets=buckets)

    def test_get_or_create_and_collisions(self):
        reg = MetricsRegistry()
        assert reg.counter("c_total", a="1") is reg.counter("c_total", a="1")
        assert reg.counter("c_total", a="1") is not reg.counter("c_total",
                                                                a="2")
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("c_total").add(-1)
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("c_total", a="1")
        reg.histogram("h_ms", buckets=(1.0,))
        with pytest.raises(ValueError, match="conflicting"):
            reg.histogram("h_ms", buckets=(2.0,))


class TestTracerTwin:
    def test_same_spans_same_trace_structure(self):
        mine = _spans(SpanTracer()).to_chrome_trace()
        theirs = _spans(JTracer()).to_chrome_trace()
        assert _shape(mine["traceEvents"]) == _shape(theirs["traceEvents"])
        assert mine["displayTimeUnit"] == theirs["displayTimeUnit"]

    def test_same_aggregates_and_phases(self):
        mine, theirs = _spans(SpanTracer()), _spans(JTracer())
        assert {n: a["count"] for n, a in mine.aggregate().items()} == \
            {n: a["count"] for n, a in theirs.aggregate().items()}
        assert set(mine.phase_totals(mine.find("classify"))) == \
            set(theirs.phase_totals(theirs.find("classify"))) == \
            {"predict", "vote"}

    def test_trace_is_matched_and_monotonic(self):
        events = _spans(SpanTracer()).to_chrome_trace()["traceEvents"]
        depth, last = 0, -math.inf
        for e in events:
            assert e["ts"] >= last
            last = e["ts"]
            depth += 1 if e["ph"] == "B" else -1
            assert depth >= 0
        assert depth == 0

    def test_threads_nest_independently(self):
        tr = SpanTracer()

        def work(i):
            with tr.span(f"outer{i}"):
                with tr.span(f"inner{i}"):
                    pass

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for i in range(4):
            inner = tr.find(f"inner{i}")
            assert inner.parent is tr.find(f"outer{i}")

    def test_buffer_cap_counts_drops(self):
        tr = SpanTracer(max_spans=3)
        for _ in range(5):
            with tr.span("s"):
                pass
        assert len(tr.spans()) == 3 and tr.dropped == 2
        doc = metrics_document(tr, MetricsRegistry())
        assert doc["spans_dropped"] == 2

    def test_annotations_use_record_function(self):
        """The profiler rule on a tracer: a span is a ``record_function``
        range of its name exactly while a profiler records on the thread;
        the tracer records every span either way."""
        tr = SpanTracer()
        with tr.span("before"):
            pass
        with _profiled() as names:
            with tr.span("classify", backend="cuda"):
                with tr.span("predict"):
                    pass
        with tr.span("after"):
            pass
        assert names == ["classify", "predict"]
        assert [s.name for s in tr.spans()] == ["before", "predict",
                                                "classify", "after"]


class TestProfilerRule:
    """``obs.span`` and the profiler, with obs off and on."""

    def test_off_with_a_profiler_is_a_range_and_records_nothing(self):
        obs.disable()
        obs.reset()
        with _profiled() as names:
            with obs.span("prepare", engine="stripe"):
                with obs.span("dispatch"):
                    pass
        assert names == ["prepare", "dispatch"]
        assert obs.tracer().spans() == []

    def test_off_without_a_profiler_is_the_shared_null(self):
        obs.disable()
        null = obs.span("anything")
        with _profiled():
            assert obs.span("inside") is not null
        assert obs.span("after", big="attr") is null
        assert obs.tracer().spans() == []

    def test_on_with_a_profiler_one_range_per_span(self):
        obs.enable()
        obs.reset()
        with _profiled() as names:
            for _ in range(3):
                with obs.span("fetch"):
                    with obs.span("vote"):
                        pass
        assert names == ["fetch", "vote"] * 3
        assert [s.name for s in obs.tracer().spans()] == ["vote", "fetch"] * 3

    def test_obs_imports_no_torch(self):
        code = ("import sys\n"
                "from knn_tpu_torch import obs\n"
                "with obs.span('a'):\n"
                "    pass\n"
                "obs.enable()\n"
                "with obs.span('b'):\n"
                "    pass\n"
                "assert obs.tracer().find('b') is not None\n"
                "assert 'torch' not in sys.modules, 'obs imported torch'\n")
        env = {k: v for k, v in os.environ.items() if k != "KNN_TPU_OBS"}
        done = subprocess.run([sys.executable, "-c", code], env=env,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))),
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr


class TestDisabledIsNoop:
    def test_span_is_shared_null(self):
        obs.disable()
        s1 = obs.span("anything", big="attr")
        s2 = obs.span("else")
        assert s1 is s2
        with s1:
            pass
        assert obs.tracer().spans() == []

    def test_metric_helpers_record_nothing(self):
        obs.disable()
        obs.reset()
        obs.counter_add("c_total", 5)
        obs.gauge_set("g", 1)
        obs.histogram_observe("h", 2)
        assert obs.registry().instruments() == []

    def test_backend_wrapper_passes_through_when_off(self):
        obs.disable()
        obs.reset()
        train, test = (load_arff(p) for p in _paths())
        get_backend("oracle")(train, test, 3)
        assert obs.registry().instruments() == [] and not obs.tracer().spans()


def _metric_keys(doc):
    return {(name, tuple(sorted(r["labels"].items())))
            for name, recs in doc["metrics"].items() for r in recs}


class TestCliRoundTrip:
    def test_persona_main_same_metric_names_and_labels_as_jax(self, tmp_path):
        tr, te = _paths()
        docs = {}
        for name, run, extra in (("port", cli.run, []),
                                 ("jax", jcli.run, ["--platform", "cpu"])):
            m, t = tmp_path / f"{name}.json", tmp_path / f"{name}.trace.json"
            out = io.StringIO()
            assert run([tr, te, "3", "--persona", "main", "--json",
                        "--metrics-out", str(m), "--trace-out", str(t),
                        *extra], stdout=out) == 0
            docs[name] = (json.loads(m.read_text()),
                          json.loads(t.read_text()),
                          json.loads(out.getvalue().splitlines()[1]))
        assert not obs.enabled()  # run() scoped the enablement to the call
        (m, t, js), (jm, jt, jjs) = docs["port"], docs["jax"]
        assert _metric_keys(m) == _metric_keys(jm)
        assert ("knn_predict_calls_total", (("backend", "native"),)) in \
            _metric_keys(m)
        assert set(m["phases"]) == set(jm["phases"]) == set(js["phases"])
        assert js["phases"] == m["phases"]
        assert js["backend"] == jjs["backend"] == "native"
        assert {e["name"] for e in t["traceEvents"]} == \
            {e["name"] for e in jt["traceEvents"]}

    def test_metrics_json_and_trace_on_the_cuda_rung(self, tmp_path):
        tr, te = _paths()
        m_path, t_path = tmp_path / "m.json", tmp_path / "t.json"
        out = io.StringIO()
        rc = cli.run([tr, te, "3", "--device", "cpu", "--engine", "xla",
                      "--metrics-out", str(m_path), "--trace-out",
                      str(t_path), "--json"], stdout=out)
        assert rc == 0 and not obs.enabled()
        m = json.loads(m_path.read_text())
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rec["phases"] == m["phases"] == {
            "predict": m["phases"]["predict"]}
        assert sum(m["phases"].values()) == pytest.approx(
            m["wall_ms"], rel=0.05, abs=0.5)
        keys = _metric_keys(m)
        for metric in ("knn_predict_calls_total", "knn_queries_total",
                       "knn_first_call_wall_ms", "knn_transfer_bytes_total"):
            assert any(n == metric and dict(lab).get("backend") == "cuda"
                       for n, lab in keys), metric
        names = [e["name"] for e in json.loads(t_path.read_text())[
            "traceEvents"]]
        assert {"ingest", "classify", "predict", "prepare", "dispatch",
                "fetch"} <= set(names)
        depth = max_depth = 0
        for e in json.loads(t_path.read_text())["traceEvents"]:
            depth += 1 if e["ph"] == "B" else -1
            max_depth = max(max_depth, depth)
        assert max_depth >= 3  # classify > predict > dispatch

    def test_prometheus_out(self, tmp_path):
        tr, te = _paths()
        m_path = tmp_path / "m.prom"
        assert cli.run([tr, te, "1", "--device", "cpu", "--metrics-out",
                        str(m_path)], stdout=io.StringIO()) == 0
        text = m_path.read_text()
        assert "# TYPE knn_queries_total counter" in text
        assert 'knn_queries_total{backend="cuda"} 80' in text

    @pytest.mark.parametrize("flag", ["--metrics-out", "--trace-out"])
    def test_unwritable_out_fails_fast(self, capsys, flag):
        tr, te = _paths()
        assert cli.run([tr, te, "1", "--device", "cpu", flag,
                        "/no/such/dir/m.json"]) == 2
        err = capsys.readouterr().err
        assert err.startswith("error:") and len(err.splitlines()) == 1
        assert not obs.enabled()

    def test_sweep_carries_phases(self, tmp_path):
        tr, te = _paths()
        m_path = tmp_path / "m.json"
        out = io.StringIO()
        assert cli.run([tr, te, "1", "--sweep-k", "1,5", "--engine", "xla",
                        "--device", "cpu", "--metrics-out", str(m_path),
                        "--json"], stdout=out) == 0
        m = json.loads(m_path.read_text())
        assert "sweep_k" in m["phases"]
        for line in out.getvalue().splitlines()[1::2]:
            assert json.loads(line)["phases"] == m["phases"]
        assert sum(m["phases"].values()) == pytest.approx(
            m["wall_ms"], rel=0.05, abs=0.5)

    def test_enabled_obs_stays_enabled_after_run(self):
        obs.enable()
        tr, te = _paths()
        assert cli.run([tr, te, "1", "--backend", "oracle"],
                       stdout=io.StringIO()) == 0
        assert obs.enabled()


class TestModelSpans:
    def test_model_calls_record_jax_span_names(self):
        from knn_tpu_torch import KNNClassifier, sweep_k

        obs.enable()
        obs.reset()
        train, test = (load_arff(p) for p in _paths())
        clf = KNNClassifier(k=3, device="cpu").fit(train)
        clf.kneighbors(test)
        clf.predict_async(test).result()
        KNNClassifier(k=3, engine="xla", device="cpu").fit(
            train).kneighbors_async(test).result()
        sweep_k(train, test, [1, 3], device="cpu")
        names = {s.name for s in obs.tracer().spans()}
        assert {"fit", "distance", "fetch", "vote", "sweep_k",
                "prepare"} <= names
        attrs = {s.name: s.attrs for s in obs.tracer().spans()
                 if s.name == "distance"}
        assert attrs["distance"]["note"] == "fused distance+top-k"


class TestMetricErrors:
    """The CLI and backend cases of ``tests/test_metrics.py``."""

    def test_native_backend_rejects_metric(self):
        train, test = (load_arff(p) for p in _paths())
        with pytest.raises(ValueError, match="euclidean only"):
            get_backend("native")(train, test, 1, metric="manhattan")

    def test_cli_metric_flag_matches_jax(self):
        tr, te = _paths()
        lines = []
        for run, extra in ((cli.run, []), (jcli.run, ["--platform", "cpu"])):
            out = io.StringIO()
            assert run([tr, te, "1", "--backend", "oracle", "--metric",
                        "manhattan", *extra], stdout=out) == 0
            lines.append(out.getvalue().split(" ms ")[1])
        assert lines[0] == lines[1]

    def test_cli_metric_rejected_for_native(self, capsys):
        tr, te = _paths()
        assert cli.run([tr, te, "1", "--backend", "native", "--metric",
                        "cosine"]) == 1
        assert jcli.run([tr, te, "1", "--backend", "native", "--metric",
                         "cosine", "--platform", "cpu"]) == 1
        err = capsys.readouterr().err.splitlines()
        assert err[0] == err[1] == \
            "error: the native runtime implements euclidean only"


def test_knn_queries_total_counts_rows():
    obs.enable()
    obs.reset()
    train, test = (load_arff(p) for p in _paths())
    for _ in range(2):
        get_backend("native-mt")(train, test, 3, num_threads=2)
    recs = obs.registry().to_json()
    assert recs["knn_queries_total"] == [{
        "labels": {"backend": "native-mt"}, "kind": "counter",
        "value": 2 * test.num_instances}]
    assert recs["knn_predict_wall_ms"][0]["count"] == 1  # after the first
    assert recs["knn_first_call_wall_ms"][0]["value"] > 0
    assert np.isfinite(recs["knn_predict_qps"][0]["value"])
