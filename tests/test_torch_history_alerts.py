"""Durable metrics history, declarative alerting and the incident report on
the port (``knn_tpu_torch/obs/{history,alerts,report}.py``), against the
JAX package's, on the CPU.

The twins of ``tests/test_history_alerts.py`` (every class, the
router's replica merge included), pointed at the port: the segment ring round-trips the registry exactly, a torn final line
is repaired and damage elsewhere refused typed, every rule type's
hysteresis emits one fire/resolve pair per incident, actions are audited,
``/debug/history`` and ``/debug/alerts`` answer, and ``history``/``report``
answer from a dead process's directory. Then, between the packages:

- the segment files are byte-equal for the same samples and clock, and
  each package's ``load_history`` reads the other's directory to the same
  samples;
- the same rules over the same samples give the same transitions (the
  audit files byte-equal);
- ``history --json`` and ``report``'s JSON and markdown are equal between
  the two CLIs on one directory, and their usage errors exit 2 with the
  same line.

One test pins the alert actions' order (ROADMAP Queue C): a ``fire``
command that outlives its ``resolve`` command is still audited first. JAX
starts a thread per event, so its audit follows the order the child
processes exit. Everything else runs on a fake clock with no sleeps.
"""

import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from knn_tpu import obs as jobs
from knn_tpu.cli import run as jrun
from knn_tpu.obs import alerts as jalerts
from knn_tpu.obs import history as jhistory
from knn_tpu.obs import report as jreport
from knn_tpu_torch import obs
from knn_tpu_torch.cli import run
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.models.knn import KNNClassifier
from knn_tpu_torch.obs.alerts import AlertEngine, load_rules, parse_rules
from knn_tpu_torch.obs.history import (
    SCHEMA_HASH,
    HistoryRecorder,
    load_history,
    parse_window,
    query_samples,
)
from knn_tpu_torch.obs.report import build_report, render_markdown
from knn_tpu_torch.resilience.errors import DataError


@pytest.fixture
def obs_on():
    """Both packages' observability enabled and isolated."""
    saved = (obs.enabled(), jobs.enabled())
    for pkg in (obs, jobs):
        pkg.enable()
        pkg.reset()
    yield obs.registry()
    for pkg, was in zip((obs, jobs), saved):
        pkg.reset()
        (pkg.enable if was else pkg.disable)()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def snap(counter=None, gauge=None, hist=None):
    """A fake ``aggregate.snapshot_registry()`` listing: one labelled
    counter, one gauge, one 3-bound histogram (4 counts, +Inf last)."""
    recs = []
    if counter is not None:
        recs.append({"name": "t_requests_total", "kind": "counter",
                     "labels": {"kind": "predict"}, "help": "",
                     "value": float(counter)})
    if gauge is not None:
        recs.append({"name": "t_depth", "kind": "gauge", "labels": {},
                     "help": "", "value": float(gauge)})
    if hist is not None:
        counts, s, c = hist
        recs.append({"name": "t_ms", "kind": "histogram", "labels": {},
                     "help": "", "buckets": [1.0, 5.0, 25.0],
                     "counts": list(counts), "sum": float(s),
                     "count": int(c)})
    return recs


def make_recorder(feed, clock, history_dir=None, cls=HistoryRecorder, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("retention_s", 60.0)
    return cls(history_dir, sample_fn=lambda: feed[0], clock=clock,
               autostart=False, **kw)


class TestParseWindow:
    def test_units(self):
        assert parse_window("300") == 300.0
        assert parse_window("300s") == 300.0
        assert parse_window("5m") == 300.0
        assert parse_window("1h") == 3600.0
        assert parse_window(45) == 45.0

    @pytest.mark.parametrize("raw", ["abc", "5x", "", "0", "-3", "0s"])
    def test_bad_values(self, raw):
        with pytest.raises(ValueError) as got:
            parse_window(raw)
        with pytest.raises(ValueError) as want:
            jhistory.parse_window(raw)
        assert str(got.value) == str(want.value)


class TestRoundTrip:
    def test_counter_gauge_histogram_reconstruct_exactly(self, tmp_path):
        clock = FakeClock()
        feed = [snap(counter=1, gauge=4, hist=([1, 0, 0, 0], 0.5, 1))]
        rec = make_recorder(feed, clock, str(tmp_path / "h"))
        rec.sample_once()
        clock.advance(1)
        feed[0] = snap(counter=3, gauge=2, hist=([1, 2, 0, 1], 40.5, 4))
        rec.sample_once()
        clock.advance(1)
        feed[0] = snap(counter=6, gauge=2, hist=([1, 2, 3, 1], 70.5, 7))
        rec.sample_once()

        hist = load_history(str(tmp_path / "h"))
        assert not hist.repaired
        assert len(hist.samples) == 3
        got = hist.query(metric="t_requests_total")["series"][0]
        assert got["kind"] == "counter"
        assert got["labels"] == {"kind": "predict"}
        assert [p[1] for p in got["points"]] == [1.0, 3.0, 6.0]
        got = hist.query(metric="t_depth")["series"][0]
        assert [p[1] for p in got["points"]] == [4.0, 2.0, 2.0]
        got = hist.query(metric="t_ms")["series"][0]
        assert got["kind"] == "histogram"
        assert [p[1] for p in got["points"]] == [1, 4, 7]
        assert got["points"][-1][2] == 70.5
        assert got["counts"] == [1, 2, 3, 1]
        assert got["buckets"] == [1.0, 5.0, 25.0]

    def test_wire_is_delta_encoded(self, tmp_path):
        clock = FakeClock()
        feed = [snap(counter=5, gauge=1)]
        rec = make_recorder(feed, clock, str(tmp_path / "h"))
        rec.sample_once()
        clock.advance(1)
        feed[0] = snap(counter=9, gauge=1)
        rec.sample_once()
        clock.advance(1)
        rec.sample_once()

        seg = tmp_path / "h" / "seg-1.jsonl"
        header, base, d1, d2 = [json.loads(ln)
                                for ln in seg.read_text().splitlines()]
        assert header["schema_hash"] == SCHEMA_HASH == jhistory.SCHEMA_HASH
        assert base["d"] == 0
        counter_base = next(e for e in base["m"]
                            if e["n"] == "t_requests_total")
        assert counter_base["v"] == 5.0
        assert d1["d"] == 1
        assert [e["n"] for e in d1["m"]] == ["t_requests_total"]
        assert d1["m"][0]["v"] == 4.0
        assert d2["m"] == []

    def test_segments_decode_independently(self, tmp_path):
        clock = FakeClock()
        feed = [snap(counter=0)]
        rec = make_recorder(feed, clock, str(tmp_path / "h"),
                            retention_s=16.0)
        for i in range(6):
            feed[0] = snap(counter=10 * (i + 1))
            rec.sample_once()
            clock.advance(1)
        segs = sorted(p.name for p in (tmp_path / "h").glob("seg-*.jsonl"))
        assert len(segs) >= 2
        (tmp_path / "h" / segs[0]).unlink()
        hist = load_history(str(tmp_path / "h"))
        pts = hist.query(metric="t_requests_total")["series"][0]["points"]
        assert pts[-1][1] == 60.0


class TestRotationRetention:
    def test_rotation_and_retention_prune_whole_segments(self, tmp_path):
        clock = FakeClock()
        feed = [snap(counter=0)]
        rec = make_recorder(feed, clock, str(tmp_path / "h"),
                            retention_s=8.0)
        for i in range(20):
            feed[0] = snap(counter=i)
            rec.sample_once()
            clock.advance(1)
        assert rec.status()["pruned_segments"] >= 1
        live = sorted(int(p.stem.split("-")[1])
                      for p in (tmp_path / "h").glob("seg-*.jsonl"))
        assert live[0] > 1
        hist = load_history(str(tmp_path / "h"))
        assert hist.samples[-1][0] - hist.samples[0][0] <= 8.0 + 1.0
        assert rec.query(metric="t_requests_total",
                         window_s=5)["series"][0]["points"]

    @pytest.mark.parametrize("kw", [{"interval_s": 0},
                                    {"interval_s": 5, "retention_s": 1}])
    def test_flag_validation(self, kw):
        with pytest.raises(ValueError):
            make_recorder([[]], FakeClock(), **kw)


class TestSamplingCadence:
    """The sampling thread keeps a fixed cadence (JAX's thread waits a
    whole interval after each sample): a run of T seconds holds T /
    interval samples, and a stall skips the ticks it let pass instead of
    making them up in a burst, so it shows as one wide gap."""

    class _Clock:
        def __init__(self):
            self.t = 0.0

        def monotonic(self):
            return self.t

    class _Stop:
        def __init__(self, clock, until):
            self.clock, self.until = clock, until

        def wait(self, dt):
            self.clock.t += dt
            return self.clock.t > self.until

    @pytest.mark.parametrize("stall_s,want,widest", [(0.0, 30, 1.0),
                                                     (3.5, 27, 4.0),
                                                     (12.0, 19, 12.0)])
    def test_missed_ticks_are_skipped_not_made_up(self, monkeypatch,
                                                  stall_s, want, widest):
        import types

        from knn_tpu_torch.obs import history as history_mod

        clock = self._Clock()
        monkeypatch.setattr(history_mod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic, time=lambda: clock.t))
        calls = []

        def sample():
            calls.append(clock.t)
            if len(calls) == 3:
                clock.t += stall_s  # the thread stalled mid-snapshot
            return []

        rec = HistoryRecorder(None, interval_s=1.0, retention_s=60.0,
                              sample_fn=sample, clock=clock.monotonic,
                              autostart=False)
        rec._stop = self._Stop(clock, 30.0)
        rec._loop()
        gaps = np.diff(calls)
        assert len(calls) == want
        assert gaps.min() >= 1.0 - 1e-9 and gaps.max() == pytest.approx(widest)


class TestTornTail:
    def _write_history(self, tmp_path, n=3):
        clock = FakeClock()
        feed = [snap(counter=0)]
        rec = make_recorder(feed, clock, str(tmp_path / "h"))
        for i in range(n):
            feed[0] = snap(counter=i + 1)
            rec.sample_once()
            clock.advance(1)
        return tmp_path / "h"

    def test_torn_final_line_tolerated_and_repaired(self, tmp_path):
        h = self._write_history(tmp_path)
        seg = h / "seg-1.jsonl"
        with open(seg, "a", encoding="utf-8") as f:
            f.write('{"t": 1003.0, "d": 1, "m"')
        hist = load_history(str(h))
        assert hist.repaired
        assert len(hist.samples) == 3
        assert all(json.loads(ln) for ln in seg.read_text().splitlines())
        assert not load_history(str(h)).repaired

    def test_mid_file_corruption_refused(self, tmp_path):
        h = self._write_history(tmp_path)
        seg = h / "seg-1.jsonl"
        lines = seg.read_text().splitlines()
        lines[2] = '{"t": broken'
        seg.write_text("\n".join(lines) + "\n")
        with pytest.raises(DataError):
            load_history(str(h))

    def test_torn_tail_of_non_last_segment_refused(self, tmp_path):
        clock = FakeClock()
        feed = [snap(counter=0)]
        rec = make_recorder(feed, clock, str(tmp_path / "h"),
                            retention_s=16.0)
        for i in range(5):
            feed[0] = snap(counter=i)
            rec.sample_once()
            clock.advance(1)
        segs = sorted((tmp_path / "h").glob("seg-*.jsonl"))
        assert len(segs) >= 2
        with open(segs[0], "a", encoding="utf-8") as f:
            f.write('{"torn')
        with pytest.raises(DataError):
            load_history(str(tmp_path / "h"))

    def test_schema_hash_pin_refuses_foreign_segments(self, tmp_path):
        h = self._write_history(tmp_path)
        seg = h / "seg-1.jsonl"
        lines = seg.read_text().splitlines()
        header = json.loads(lines[0])
        header["schema_hash"] = "0" * 32
        lines[0] = json.dumps(header)
        seg.write_text("\n".join(lines) + "\n")
        with pytest.raises(DataError, match="incompatible"):
            load_history(str(h))

    def test_boot_scan_repairs_and_opens_fresh_segment(self, tmp_path):
        h = self._write_history(tmp_path)
        with open(h / "seg-1.jsonl", "a", encoding="utf-8") as f:
            f.write('{"t": 99')
        clock = FakeClock(1010.0)
        feed = [snap(counter=100)]
        rec = make_recorder(feed, clock, str(h))
        rec.sample_once()
        assert rec.status()["segment"] == 2
        hist = load_history(str(h))
        assert not hist.repaired
        assert [int(n) for n in hist.segments] == [1, 2]
        assert hist.samples[-1][0] == 1010.0


class TestQuerySamples:
    def test_window_and_label_filters(self):
        def state(v, extra=None):
            return {("m", (("az", "a"),)): ("c", "m", {"az": "a"}, v),
                    **(extra or {})}

        samples = [(1000.0, state(1.0)), (1001.0, state(2.0)),
                   (1002.0, state(3.0, {("m", (("az", "b"),)):
                                        ("c", "m", {"az": "b"}, 9.0)}))]
        doc = query_samples(samples, metric="m", labels={"az": "a"},
                            window_s=1.0)
        assert doc["window"] == {"from": 1001.0, "to": 1002.0}
        assert len(doc["series"]) == 1
        assert [p[1] for p in doc["series"][0]["points"]] == [2.0, 3.0]
        assert len(query_samples(samples)["series"]) == 2
        assert doc == jhistory.query_samples(
            samples, metric="m", labels={"az": "a"}, window_s=1.0)


BAD_RULES = [
    {},
    [],
    [{"type": "threshold"}],
    [{"name": "x", "type": "nope"}],
    [{"name": "x", "type": "threshold", "metric": "m", "value": 1},
     {"name": "x", "type": "threshold", "metric": "m", "value": 1}],
    [{"name": "x", "type": "threshold", "metric": "m", "value": 1,
      "op": "!="}],
    [{"name": "x", "type": "threshold", "value": 1}],
    [{"name": "x", "type": "threshold", "metric": "m", "value": "high"}],
    [{"name": "x", "type": "burn_rate", "threshold": 0}],
    [{"name": "x", "type": "burn_rate", "threshold": 1, "windows": []}],
    [{"name": "x", "type": "derivative", "metric": "m", "value": 1}],
    [{"name": "x", "type": "absence"}],
    [{"name": "x", "type": "threshold", "metric": "m", "value": 1,
      "for_s": -1}],
    [{"name": "x", "type": "threshold", "metric": "m", "value": 1,
      "actions": [{"do": "explode"}]}],
    [{"name": "x", "type": "threshold", "metric": "m", "value": 1,
      "actions": [{"do": "command", "cmd": "  "}]}],
    [{"name": "x", "type": "threshold", "metric": "m", "value": 1,
      "actions": [{"do": "capture", "max_requests": 0}]}],
]


class TestRuleParsing:
    def test_normalization_defaults(self):
        doc = {"rules": [
            {"name": "a", "type": "threshold", "metric": "m", "value": 3,
             "for_s": 2},
            {"name": "b", "type": "burn_rate", "threshold": 1.5,
             "actions": [{"do": "capture"}]},
        ]}
        rules = parse_rules(doc)
        assert rules[0]["op"] == ">"
        assert rules[0]["resolve_for_s"] == 2.0
        assert rules[1]["objective"] == "availability"
        assert rules[1]["windows"] is None
        assert rules[1]["actions"] == [{"do": "capture", "window_s": 10.0}]
        assert rules == jalerts.parse_rules(doc)

    @pytest.mark.parametrize("case", range(len(BAD_RULES)))
    def test_shape_errors_are_typed_with_jax_text(self, case):
        with pytest.raises(DataError) as got:
            parse_rules(BAD_RULES[case])
        with pytest.raises(jalerts.DataError) as want:
            jalerts.parse_rules(BAD_RULES[case])
        assert str(got.value) == str(want.value)

    def test_load_rules_file_errors(self, tmp_path):
        with pytest.raises(DataError):
            load_rules(str(tmp_path / "missing.json"))
        p = tmp_path / "rules.json"
        p.write_text("{not json")
        with pytest.raises(DataError) as got:
            load_rules(str(p))
        with pytest.raises(jalerts.DataError) as want:
            jalerts.load_rules(str(p))
        assert str(got.value) == str(want.value)


class _StubSLO:
    def __init__(self):
        self.burns = {"availability": {"5s": 0.0, "1m": 0.0}}

    def burn_rates(self):
        return {k: dict(v) for k, v in self.burns.items()}


def _engine(rules, clock, **kw):
    return AlertEngine(parse_rules(rules), clock=clock, **kw)


def _step(feed, rec, engine, clock, dt=1.0, **snap_kw):
    if snap_kw:
        feed[0] = snap(**snap_kw)
    ts = rec.sample_once()
    engine.evaluate(ts, rec)
    clock.advance(dt)
    return ts


def _events(engine, kind):
    return [e for e in engine.export()["recent"] if e.get("event") == kind]


class TestAlertHysteresis:
    def test_threshold_for_flap_resolve_single_pair(self, obs_on):
        clock = FakeClock()
        feed = [snap(gauge=10)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "op": ">", "value": 5,
                        "for_s": 2, "resolve_for_s": 2}], clock)
        _step(feed, rec, eng, clock)
        assert eng.export()["rules"][0]["state"] == "pending"
        assert not _events(eng, "fire")
        _step(feed, rec, eng, clock)
        _step(feed, rec, eng, clock)
        assert len(_events(eng, "fire")) == 1
        assert eng.export()["firing"] == ["hot"]
        assert obs_on.gauge("knn_alerts_firing", alert="hot").value == 1
        _step(feed, rec, eng, clock, gauge=1)
        assert eng.export()["rules"][0]["state"] == "resolving"
        assert "hot" in eng.export()["firing"]
        _step(feed, rec, eng, clock, gauge=10)
        assert eng.export()["rules"][0]["state"] == "firing"
        assert len(_events(eng, "fire")) == 1
        _step(feed, rec, eng, clock, gauge=1)
        _step(feed, rec, eng, clock)
        assert not _events(eng, "resolve")
        _step(feed, rec, eng, clock)
        assert len(_events(eng, "resolve")) == 1
        assert eng.export()["rules"][0]["state"] == "ok"
        assert eng.export()["rules"][0]["fires"] == 1
        assert obs_on.gauge("knn_alerts_firing", alert="hot").value == 0
        fire, = _events(eng, "fire")
        assert fire["alert"] == "hot" and fire["value"] == 10.0
        assert fire["severity"] == "page" and fire["type"] == "threshold"

    def test_condition_blip_shorter_than_for_never_fires(self, obs_on):
        clock = FakeClock()
        feed = [snap(gauge=10)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5, "for_s": 2}], clock)
        _step(feed, rec, eng, clock)
        _step(feed, rec, eng, clock, gauge=1)
        _step(feed, rec, eng, clock, gauge=10)
        _step(feed, rec, eng, clock, gauge=1)
        assert not _events(eng, "fire")

    def test_for_zero_fires_immediately(self, obs_on):
        clock = FakeClock()
        feed = [snap(gauge=10)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5}], clock)
        _step(feed, rec, eng, clock)
        assert len(_events(eng, "fire")) == 1

    def test_absence_rule(self, obs_on):
        clock = FakeClock()
        feed = [snap(gauge=1)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "silent", "type": "absence",
                        "metric": "t_requests_total"}], clock)
        _step(feed, rec, eng, clock)
        assert len(_events(eng, "fire")) == 1
        _step(feed, rec, eng, clock, counter=1, gauge=1)
        assert len(_events(eng, "resolve")) == 1

    def test_derivative_rule(self, obs_on):
        clock = FakeClock()
        feed = [snap(counter=0)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "spike", "type": "derivative",
                        "metric": "t_requests_total", "op": ">",
                        "value": 2.0, "window_s": 2.0}], clock)
        _step(feed, rec, eng, clock)
        _step(feed, rec, eng, clock, counter=5)
        assert not _events(eng, "fire")
        _step(feed, rec, eng, clock, counter=10)
        assert len(_events(eng, "fire")) == 1
        assert _events(eng, "fire")[0]["value"] == 5.0
        _step(feed, rec, eng, clock, counter=10)
        _step(feed, rec, eng, clock, counter=10)
        assert len(_events(eng, "resolve")) == 1

    def test_burn_rate_multi_window_and(self, obs_on):
        clock = FakeClock()
        slo = _StubSLO()
        feed = [snap(counter=1)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "burn", "type": "burn_rate",
                        "objective": "availability",
                        "windows": ["5s", "1m"], "threshold": 1.0}],
                      clock, slo=slo)
        slo.burns["availability"] = {"5s": 3.0, "1m": 0.5}
        _step(feed, rec, eng, clock)
        assert not _events(eng, "fire")
        slo.burns["availability"] = {"5s": 3.0, "1m": 2.0}
        _step(feed, rec, eng, clock)
        fire, = _events(eng, "fire")
        assert fire["value"] == 3.0
        slo.burns["availability"] = {"5s": 0.0, "1m": 0.0}
        _step(feed, rec, eng, clock)
        assert len(_events(eng, "resolve")) == 1

    def test_burn_rate_needs_slo_at_boot(self):
        with pytest.raises(DataError, match="burn_rate"):
            _engine([{"name": "b", "type": "burn_rate", "threshold": 1}],
                    FakeClock())

    def test_unknown_window_audited_not_raised(self, obs_on):
        clock = FakeClock()
        slo = _StubSLO()
        feed = [snap(counter=1)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "b", "type": "burn_rate",
                        "windows": ["7d"], "threshold": 1}], clock, slo=slo)
        _step(feed, rec, eng, clock)
        errs = _events(eng, "eval-error")
        assert errs and errs[0]["alert"] == "b"
        assert eng.export()["rules"][0]["state"] == "ok"


class _StubWorkload:
    def __init__(self, raise_on_start=False):
        self.started = []
        self.raise_on_start = raise_on_start

    def start(self, reason="manual", max_requests=None, window_s=None):
        if self.raise_on_start:
            raise RuntimeError("capture already armed")
        self.started.append((reason, window_s, max_requests))


class _StubRecorder:
    def slowest(self):
        return [{"request_id": "r-1", "request_ms": 99.0}]


class TestAlertActions:
    def _fire(self, eng, clock, feed=None, rec=None):
        feed = feed if feed is not None else [snap(gauge=10)]
        rec = rec or make_recorder(feed, clock)
        _step(feed, rec, eng, clock)
        assert eng.drain_actions()
        return feed, rec

    def test_capture_action_arms_workload(self, obs_on):
        clock = FakeClock()
        wl = _StubWorkload()
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5,
                        "actions": [{"do": "capture", "window_s": 8}]}],
                      clock, workload=wl)
        self._fire(eng, clock)
        assert wl.started == [("alert:hot", 8.0, None)]
        acts = [e for e in _events(eng, "action")
                if e["action"] == "capture"]
        assert acts and acts[0]["outcome"] == "ok" and acts[0]["on"] == "fire"

    def test_capture_requires_workload_at_boot(self):
        with pytest.raises(DataError, match="capture"):
            _engine([{"name": "h", "type": "threshold", "metric": "m",
                      "value": 1, "actions": [{"do": "capture"}]}],
                    FakeClock())

    def test_profile_requires_history_dir_at_boot(self):
        with pytest.raises(DataError, match="profile"):
            _engine([{"name": "h", "type": "threshold", "metric": "m",
                      "value": 1, "actions": [{"do": "profile"}]}],
                    FakeClock())

    def test_profile_action_writes_trace(self, obs_on, tmp_path,
                                         monkeypatch):
        from knn_tpu_torch.obs import devprof

        monkeypatch.setattr(devprof, "capture_for",
                            lambda ms, **kw: {"traceEvents": [],
                                              "otherData": {"ms": ms}})
        clock = FakeClock()
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5,
                        "actions": [{"do": "profile", "ms": 50}]}],
                      clock, history_dir=str(tmp_path / "h"))
        self._fire(eng, clock)
        profiles = list((tmp_path / "h" / "profiles")
                        .glob("profile-hot-*.json"))
        assert len(profiles) == 1
        assert json.loads(profiles[0].read_text())["otherData"]["ms"] == 50

    def test_command_action_runs_on_fire_and_resolve(self, obs_on):
        clock = FakeClock()
        feed = [snap(gauge=10)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5,
                        "actions": [{"do": "command",
                                     "cmd": f"{sys.executable} -c pass"}]}],
                      clock)
        _step(feed, rec, eng, clock)
        _step(feed, rec, eng, clock, gauge=1)
        assert eng.drain_actions(timeout_s=60)
        acts = [e for e in _events(eng, "action")
                if e["action"] == "command"]
        assert [a["on"] for a in acts] == ["fire", "resolve"]
        assert all(a["outcome"] == "ok" for a in acts)
        assert acts[0]["detail"].endswith("fire hot")

    def test_fire_outliving_resolve_is_still_audited_first(self, obs_on,
                                                           tmp_path):
        """ROADMAP Queue C: the fire command sleeps 0.3 s, the resolve
        command exits at once. One queue per rule runs them in event
        order, so the audit reads fire, resolve; a thread per event (JAX's
        ``_dispatch``) would audit resolve first."""
        script = tmp_path / "hook.py"
        script.write_text("import sys, time\n"
                          "time.sleep(0.3 if sys.argv[1] == 'fire' else 0)\n")
        clock = FakeClock()
        feed = [snap(gauge=10)]
        rec = make_recorder(feed, clock)
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5,
                        "actions": [{"do": "command",
                                     "cmd": f"{sys.executable} {script}"}]}],
                      clock, history_dir=str(tmp_path / "h"))
        _step(feed, rec, eng, clock)
        _step(feed, rec, eng, clock, gauge=1)
        assert eng.drain_actions(timeout_s=60)
        eng.close()
        entries = [json.loads(ln) for ln in
                   (tmp_path / "h" / "alerts.jsonl").read_text().splitlines()]
        assert [(e["event"], e.get("on")) for e in entries] == [
            ("fire", None), ("resolve", None), ("action", "fire"),
            ("action", "resolve")]
        assert all(e["outcome"] == "ok" for e in entries[2:])

    def test_failing_command_audited_as_error(self, obs_on):
        clock = FakeClock()
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5,
                        "actions": [{"do": "command", "cmd": "false"}]}],
                      clock)
        self._fire(eng, clock)
        acts = [e for e in _events(eng, "action")
                if e["action"] == "command"]
        assert acts and acts[0]["outcome"].startswith("error")

    def test_raising_action_audited_engine_survives(self, obs_on):
        clock = FakeClock()
        wl = _StubWorkload(raise_on_start=True)
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5,
                        "actions": [{"do": "capture"}]}],
                      clock, workload=wl)
        feed, rec = self._fire(eng, clock)
        acts = [e for e in _events(eng, "action")
                if e["action"] == "capture"]
        assert acts and acts[0]["outcome"].startswith("error")
        _step(feed, rec, eng, clock, gauge=1)
        assert len(_events(eng, "resolve")) == 1

    def test_forensics_frozen_at_fire_time(self, obs_on, tmp_path):
        clock = FakeClock()
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5}],
                      clock, recorder=_StubRecorder(),
                      history_dir=str(tmp_path / "h"))
        self._fire(eng, clock)
        dumps = list((tmp_path / "h" / "forensics")
                     .glob("slowest-hot-*.json"))
        assert len(dumps) == 1
        doc = json.loads(dumps[0].read_text())
        assert doc["alert"] == "hot"
        assert doc["slowest"][0]["request_id"] == "r-1"

    def test_audit_file_written_line_buffered(self, obs_on, tmp_path):
        clock = FakeClock()
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5}],
                      clock, history_dir=str(tmp_path / "h"))
        feed, rec = self._fire(eng, clock)
        _step(feed, rec, eng, clock, gauge=1)
        assert eng.drain_actions()
        entries = [json.loads(ln) for ln in
                   (tmp_path / "h" / "alerts.jsonl")
                   .read_text().splitlines()]
        events = [e["event"] for e in entries]
        assert "fire" in events and "resolve" in events
        eng.close()

    def test_no_action_thread_outlives_its_queue(self, obs_on):
        clock = FakeClock()
        eng = _engine([{"name": "hot", "type": "threshold",
                        "metric": "t_depth", "value": 5,
                        "actions": [{"do": "command",
                                     "cmd": f"{sys.executable} -c pass"}]}],
                      clock)
        self._fire(eng, clock)
        for t in threading.enumerate():
            if t.name == "knn-alert-action-hot":
                t.join(timeout=10)
                assert not t.is_alive()


class TestRouterReplicaMerge:
    def test_scrape_tags_replica_label_and_merges(self, obs_on, tmp_path,
                                                  monkeypatch):
        from knn_tpu_torch.fleet.router import RouterApp

        app = RouterApp(["http://127.0.0.1:9/"], health_interval_s=30.0,
                        history_dir=str(tmp_path / "rh"),
                        history_interval_s=5.0)
        try:
            monkeypatch.setattr(app.set, "usable_urls",
                                lambda: ["http://r1", "http://r2"])

            def fake_admin(method, url, payload, timeout=None):
                if url.startswith("http://r2"):
                    return None, None, "connection refused"
                assert url == "http://r1/metrics?format=json"
                return 200, {"snapshot": [
                    {"name": "knn_serve_requests_total", "kind": "counter",
                     "labels": {"kind": "predict"}, "help": "",
                     "value": 7.0}]}, None

            monkeypatch.setattr(app, "_admin_call", fake_admin)
            app.history.sample_once()
            app.history.sample_once()
            doc = app.history.query(metric="knn_serve_requests_total")
            series = doc["series"]
            # The member's scraped record carries its {replica} label —
            # raw per-replica values, never a pre-sum.
            assert len(series) == 1
            assert series[0]["labels"] == {"kind": "predict",
                                           "replica": "http://r1"}
            assert series[0]["points"][-1][1] == 7.0
            # The failed member is simply absent from this snapshot.
            assert not [s for s in series
                        if s["labels"].get("replica") == "http://r2"]
            # The router's OWN instruments land unlabelled-by-replica.
            own = app.history.query(metric="knn_history_snapshots_total")
            assert own["series"] and "replica" not in own["series"][0]["labels"]
        finally:
            app.close()


def _mini_problem():
    rng = np.random.default_rng(3)
    train_x = rng.integers(0, 4, (60, 4)).astype(np.float32)
    train_y = rng.integers(0, 3, 60).astype(np.int32)
    return Dataset(train_x, train_y)


def _http_get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestServeEndpoints:
    def test_debug_history_and_alerts_contracts(self, tmp_path, obs_on):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        model = KNNClassifier(k=3, device="cpu").fit(_mini_problem())
        rules = parse_rules([{"name": "hot", "type": "threshold",
                              "metric": "t_depth", "value": 5}])
        app = ServeApp(model, max_batch=8, max_wait_ms=0.5,
                       history_dir=str(tmp_path / "h"),
                       history_interval_s=60.0, alert_rules=rules,
                       device="cpu")
        server = make_server(app)
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://{host}:{port}"
        try:
            app.history.sample_once()
            app.history.sample_once()
            st, doc = _http_get(base, "/debug/history"
                                      "?metric=knn_history_snapshots_total")
            assert st == 200 and doc["enabled"] is True
            assert doc["status"]["snapshots"] >= 1
            assert doc["series"][0]["name"] == "knn_history_snapshots_total"
            assert "index_version" in doc
            st, doc = _http_get(base, "/debug/history?label=kind")
            assert st == 400 and "label" in doc["error"]
            st, doc = _http_get(base, "/debug/history?window=xyz")
            assert st == 400
            st, doc = _http_get(base, "/debug/history?window=5m")
            assert st == 200
            st, doc = _http_get(base, "/debug/alerts")
            assert st == 200 and doc["enabled"] is True
            assert doc["firing"] == []
            assert doc["rules"][0]["name"] == "hot"
            assert doc["rules"][0]["state"] == "ok"
            st, h = _http_get(base, "/healthz")
            assert h["history"]["snapshots"] >= 1
            assert h["alerts"] == {"firing": [], "rules": 1}
        finally:
            server.shutdown()
            server.server_close()
            app.close()
        assert load_history(str(tmp_path / "h")).samples

    def test_disabled_is_absent_not_an_error(self, obs_on):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        model = KNNClassifier(k=3, device="cpu").fit(_mini_problem())
        app = ServeApp(model, max_batch=8, max_wait_ms=0.5, device="cpu")
        assert app.history is None and app.alerts is None
        server = make_server(app)
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://{host}:{port}"
        try:
            st, doc = _http_get(base, "/debug/history")
            assert st == 200 and doc["enabled"] is False
            assert doc["series"] == []
            st, doc = _http_get(base, "/debug/alerts")
            assert st == 200 and doc["enabled"] is False
            assert doc["rules"] == [] and doc["firing"] == []
            st, h = _http_get(base, "/healthz")
            assert h["history"] is None and h["alerts"] is None
        finally:
            server.shutdown()
            server.server_close()
            app.close()


def _crashed_dir(tmp_path, cls=HistoryRecorder):
    """A history dir as a SIGKILLed process leaves it: segments plus a torn
    half-written final line."""
    clock = FakeClock()
    feed = [snap(counter=0, gauge=1)]
    rec = make_recorder(feed, clock, str(tmp_path / "h"), cls=cls)
    for i in range(4):
        feed[0] = snap(counter=2 * i, gauge=1)
        rec.sample_once()
        clock.advance(1)
    with open(tmp_path / "h" / "seg-1.jsonl", "a", encoding="utf-8") as f:
        f.write('{"t": 1004.0, "d": 1,')
    return str(tmp_path / "h")


def _incident_inputs(tmp_path):
    """alerts.jsonl, a capture manifest and an access log beside a crashed
    history dir; returns ``(history_dir, access_log, captures_dir)``."""
    h = _crashed_dir(tmp_path)
    (tmp_path / "h" / "alerts.jsonl").write_text(
        json.dumps({"ts": 1001.5, "alert": "hot", "event": "fire",
                    "severity": "page", "type": "threshold",
                    "value": 9.0, "actions": ["capture"]}) + "\n" +
        json.dumps({"ts": 1001.6, "alert": "hot", "event": "action",
                    "on": "fire", "action": "capture",
                    "outcome": "ok", "detail": "armed"}) + "\n" +
        json.dumps({"ts": 1003.0, "alert": "hot", "event": "resolve",
                    "severity": "page", "type": "threshold",
                    "value": 1.0}) + "\n")
    cap = tmp_path / "captures" / "workload-1001700"
    cap.mkdir(parents=True)
    (cap / "manifest.json").write_text(json.dumps(
        {"reason": "alert:hot", "t0_unix": 1001.7, "records": 5,
         "stop_reason": "window"}))
    access = tmp_path / "access.jsonl"
    access.write_text(
        json.dumps({"ts": 1001.2, "request_id": "r-9",
                    "kind": "predict", "status": 503,
                    "outcome": "overload", "ms": 1.0,
                    "rung": "fast"}) + "\n")
    return h, str(access), str(tmp_path / "captures")


class TestPostMortemCLI:
    def test_history_cli_answers_from_crashed_dir(self, tmp_path, capsys):
        h = _crashed_dir(tmp_path)
        assert run(["history", h, "--metric", "t_requests_total"]) == 0
        out = capsys.readouterr().out
        assert "torn tail repaired" in out
        assert "t_requests_total" in out
        assert run(["history", h, "--metric", "t_requests_total",
                    "--window", "2s", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["samples"] == 4
        assert doc["repaired_torn_tail"] is False
        assert doc["series"][0]["points"][-1][1] == 6.0

    def test_history_cli_usage_errors_exit_2(self, tmp_path, capsys):
        h = _crashed_dir(tmp_path)
        assert run(["history", str(tmp_path / "nope")]) == 2
        assert run(["history", h, "--window", "xyz"]) == 2
        assert run(["history", h, "--label", "novalue"]) == 2
        seg = tmp_path / "h" / "seg-1.jsonl"
        lines = seg.read_text().splitlines()
        lines[2] = "garbage"
        seg.write_text("\n".join(lines) + "\n")
        assert run(["history", h]) == 2
        assert "Traceback" not in capsys.readouterr().err

    def test_report_cli_and_determinism(self, tmp_path, capsys):
        h, access, captures = _incident_inputs(tmp_path)
        load_history(h)
        doc1 = build_report(h, access_log=access, captures=captures)
        doc2 = build_report(h, access_log=access, captures=captures)
        assert json.dumps(doc1, sort_keys=True) == \
            json.dumps(doc2, sort_keys=True)
        assert render_markdown(doc1) == render_markdown(doc2)
        kinds = [e["kind"] for e in doc1["timeline"]]
        assert {"alert-fire", "alert-resolve", "alert-action", "capture",
                "request-error"} <= set(kinds)
        ts = [e["ts"] for e in doc1["timeline"]]
        assert ts == sorted(ts)
        assert doc1["alerts"] == {"fires": 1, "resolves": 1, "entries": 3}
        assert doc1["access_log"]["errors"] == 1
        counter_row = next(r for r in doc1["metrics"]
                           if r["name"] == "t_requests_total")
        assert counter_row["delta"] == 6.0
        out_md, out_json = tmp_path / "incident.md", tmp_path / "incident.json"
        assert run(["report", "--history", h, "--access-log", access,
                    "--captures", captures, "--out", str(out_md),
                    "--json-out", str(out_json)]) == 0
        md = out_md.read_text()
        assert "# Incident report" in md and "alert hot FIRED" in md
        assert json.loads(out_json.read_text())["alerts"]["fires"] == 1
        assert build_report(h, window=0.5)["window"]["seconds"] == 0.5

    def test_report_cli_usage_errors_exit_2(self, tmp_path, capsys):
        assert run(["report", "--history", str(tmp_path / "nope")]) == 2
        h = _crashed_dir(tmp_path)
        assert run(["report", "--history", h, "--window", "junk"]) == 2
        assert "Traceback" not in capsys.readouterr().err


def _rich_feed(step: int) -> list:
    """A registry listing whose values move at each step: floats with long
    expansions, several label keys in no order, a histogram that appears,
    changes bounds and vanishes, a counter that resets, a gauge that
    drops out."""
    rng = np.random.default_rng(step)
    recs = [
        {"name": "knn_serve_requests_total", "kind": "counter",
         "labels": {"kind": "predict", "class": "bulk"}, "help": "h",
         "value": float(step * 3 + (step % 4 == 3) * 0.1 + 0.2)},
        {"name": "knn_serve_requests_total", "kind": "counter",
         "labels": {"kind": "kneighbors", "class": "interactive"},
         "help": "h", "value": float(7 if step < 5 else 1)},
        {"name": "knn_capacity_headroom_ratio", "kind": "gauge",
         "labels": {}, "help": "", "value": float(rng.random() / 3.0)},
        {"name": "knn_serve_request_ms", "kind": "histogram",
         "labels": {"kind": "predict"}, "help": "",
         "buckets": [0.5, 1.0, 2.5] if step < 6 else [1.0, 10.0],
         "counts": ([int(x) for x in rng.integers(0, 9, 4)] if step < 6
                    else [1, 2, 3]),
         "sum": float(rng.random() * 100), "count": 9 * step},
    ]
    if step % 3:
        recs.append({"name": "knn_slo_burn_rate", "kind": "gauge",
                     "labels": {"window": "5m", "objective": "latency"},
                     "help": "", "value": float(step) / 7.0})
    if 2 <= step <= 8:
        recs.append({"name": "knn_x_ms", "kind": "histogram",
                     "labels": {"b": "2", "a": "1"}, "help": "",
                     "buckets": [1.0], "counts": [step, 1],
                     "sum": step * 1.1, "count": step + 1})
    recs.append({"name": "not_an_instrument", "kind": "summary",
                 "labels": {}, "value": 1.0})
    return recs


def _write_both(tmp_path, steps=14, retention_s=6.0):
    """The same feed and clock through both packages' recorders (rotation
    every sample pair, retention pruning included); returns the two dirs."""
    out = []
    for name, cls in (("port", HistoryRecorder),
                      ("jax", jhistory.HistoryRecorder)):
        clock = FakeClock(1700000000.123456)
        feed = [_rich_feed(0)]
        d = tmp_path / name
        rec = cls(str(d), sample_fn=lambda f=feed: f[0], clock=clock,
                  autostart=False, interval_s=0.75, retention_s=retention_s,
                  source="serve")
        for i in range(steps):
            feed[0] = _rich_feed(i)
            rec.sample_once()
            clock.advance(0.75 + (i % 3) * 0.0001)
        rec.close()
        out.append(d)
    return out


class TestAgainstJAX:
    def test_segment_files_byte_equal(self, tmp_path, obs_on):
        port_dir, jax_dir = _write_both(tmp_path)
        names = sorted(p.name for p in port_dir.iterdir())
        assert names == sorted(p.name for p in jax_dir.iterdir())
        assert len(names) >= 3
        for name in names:
            assert ((port_dir / name).read_bytes()
                    == (jax_dir / name).read_bytes()), name

    @pytest.mark.parametrize("reader", ["port", "jax"])
    def test_each_package_loads_the_others_directory(self, tmp_path, obs_on,
                                                     reader):
        port_dir, jax_dir = _write_both(tmp_path, retention_s=60.0)
        # The other package's directory, torn mid-append.
        other = jax_dir if reader == "port" else port_dir
        with open(sorted(other.glob("seg-*.jsonl"))[-1], "a",
                  encoding="utf-8") as f:
            f.write('{"t": 1700000099.0, "d": 1, "m": [')
        load = load_history if reader == "port" else jhistory.load_history
        jload = jhistory.load_history if reader == "port" else load_history
        got = load(str(other))
        assert got.repaired
        want = jload(str(other))
        assert len(got.samples) == len(want.samples) == 15  # + close()
        for (gt, gs), (wt, ws) in zip(got.samples, want.samples):
            assert gt == wt and gs == ws
        for metric in (None, "knn_serve_requests_total", "knn_x_ms"):
            assert (json.dumps(got.query(metric=metric), sort_keys=True)
                    == json.dumps(want.query(metric=metric), sort_keys=True))

    def test_capture_action_refused_while_a_window_is_armed(self, tmp_path,
                                                            obs_on):
        # ROADMAP Queue C: the alert's capture action refused while the
        # autotuner's window was armed. Both packages keep one workload
        # recorder and the first to arm it wins
        # (knn_tpu/obs/workload.py:352-357, the same in the port); the
        # autotuner's docstring states the other direction. Armed first
        # as the autotuner arms it, the alert's capture is refused in both
        # packages with the same error and the same audit outcome, and the
        # armed window keeps its owner.
        from knn_tpu.obs import workload as jworkload
        from knn_tpu_torch.obs import workload

        audits = []
        for name, wl_mod, eng_cls, rec_cls, parse in (
                ("port", workload, AlertEngine, HistoryRecorder, parse_rules),
                ("jax", jworkload, jalerts.AlertEngine,
                 jhistory.HistoryRecorder, jalerts.parse_rules)):
            clock = FakeClock()
            wl = wl_mod.WorkloadCapture(str(tmp_path / name), num_features=3,
                                        autostart=False)
            wl.start(reason="autotune", window_s=5.0)
            eng = eng_cls(parse([{
                "name": "hot", "type": "threshold", "metric": "t_depth",
                "value": 5, "actions": [{"do": "capture", "window_s": 8}]}]),
                clock=clock, workload=wl)
            feed = [snap(gauge=10)]
            rec = make_recorder(feed, clock, cls=rec_cls)
            _step(feed, rec, eng, clock)
            eng.drain_actions()
            acts = [{k: v for k, v in e.items() if k != "ts"}
                    for e in _events(eng, "action")]
            owner = wl.export()
            audits.append((acts, owner["capturing"], owner["reason"]))
            eng.close()
        assert audits[0] == audits[1]
        acts, capturing, reason = audits[0]
        assert capturing and reason == "autotune"
        assert acts == [{
            "alert": "hot", "event": "action", "on": "fire",
            "action": "capture",
            "outcome": "error: CaptureStateError('a capture window is "
                       "already armed; stop it first (POST /admin/capture "
                       "{\"action\": \"stop\"})')",
            "detail": "CaptureStateError('a capture window is already "
                      "armed; stop it first (POST /admin/capture "
                      "{\"action\": \"stop\"})')"}]

    RULES = [
        {"name": "low_headroom", "type": "threshold",
         "metric": "knn_capacity_headroom_ratio", "op": "<", "value": 0.15,
         "for_s": 1.0, "resolve_for_s": 1.5},
        {"name": "burn", "type": "threshold", "metric": "knn_slo_burn_rate",
         "labels": {"objective": "latency"}, "value": 0.5},
        {"name": "gone", "type": "absence", "metric": "knn_x_ms"},
        {"name": "surge", "type": "derivative",
         "metric": "knn_serve_requests_total", "op": ">=", "value": 3.0,
         "window_s": 1.4, "severity": "ticket"},
        {"name": "req_count", "type": "threshold",
         "metric": "knn_serve_request_ms", "op": ">=", "value": 50},
    ]

    def test_same_rules_same_transitions(self, tmp_path, obs_on):
        audits = []
        for name, rec_cls, eng_cls in (
                ("port", HistoryRecorder, AlertEngine),
                ("jax", jhistory.HistoryRecorder, jalerts.AlertEngine)):
            clock = FakeClock(1700000000.5)
            feed = [_rich_feed(0)]
            d = str(tmp_path / name)
            parse = parse_rules if name == "port" else jalerts.parse_rules
            eng = eng_cls(parse(self.RULES), clock=clock, history_dir=d)
            rec = rec_cls(None, sample_fn=lambda f=feed: f[0], clock=clock,
                          autostart=False, interval_s=0.5, retention_s=30.0,
                          on_sample=eng.evaluate)
            for i in range(24):
                feed[0] = _rich_feed(i % 12)
                rec.sample_once()
                clock.advance(0.5)
            eng.close()
            audits.append((tmp_path / name / "alerts.jsonl").read_bytes())
            states = [(r["name"], r["state"], r["fires"], r["last_fire"],
                       r["last_resolve"]) for r in eng.export()["rules"]]
            audits.append(states)
        assert audits[0] == audits[2]
        assert audits[1] == audits[3]
        events = [json.loads(ln)["event"] for ln in
                  audits[0].decode().splitlines()]
        assert events.count("fire") >= 3 and events.count("resolve") >= 2

    @pytest.mark.parametrize("argv", [
        [], ["--metric", "knn_serve_requests_total"],
        ["--label", "kind=predict"], ["--window", "3s"],
        ["--metric", "knn_x_ms", "--window", "5"],
    ])
    def test_history_json_equal_between_the_clis(self, tmp_path, capsys,
                                                 obs_on, argv):
        _, jax_dir = _write_both(tmp_path, retention_s=60.0)
        cmd = ["history", str(jax_dir), *argv, "--json"]
        assert run(cmd) == 0
        got = capsys.readouterr().out
        assert jrun(cmd) == 0
        assert got == capsys.readouterr().out
        assert json.loads(got)["samples"] > 0

    @pytest.mark.parametrize("window", [None, "2"])
    def test_report_json_equal_between_the_clis(self, tmp_path, capsys,
                                                window):
        h, access, captures = _incident_inputs(tmp_path)
        load_history(h)  # settle the torn tail so both see one state
        outs = []
        for fn, tag in ((run, "port"), (jrun, "jax")):
            argv = ["report", "--history", h, "--access-log", access,
                    "--captures", captures,
                    "--out", str(tmp_path / f"{tag}.md"),
                    "--json-out", str(tmp_path / f"{tag}.json")]
            if window is not None:
                argv += ["--window", window]
            assert fn(argv, stdout=io.StringIO()) == 0
            outs.append(((tmp_path / f"{tag}.json").read_text(),
                         (tmp_path / f"{tag}.md").read_text()))
        assert outs[0] == outs[1]
        assert build_report(h) == jreport.build_report(h)

    @pytest.mark.parametrize("argv", [
        ["history", "{missing}"], ["history", "{h}", "--window", "xyz"],
        ["history", "{h}", "--label", "novalue"],
        ["history", "{h}", "--label", "=v"],
        ["report", "--history", "{missing}"],
        ["report", "--history", "{h}", "--window", "junk"],
        ["report", "--history", "{h}", "--window", "0s"],
        ["history", "{corrupt}"],
        ["report", "--history", "{corrupt}"],
    ])
    def test_usage_errors_equal_between_the_clis(self, tmp_path, capsys,
                                                 argv):
        h = _crashed_dir(tmp_path)
        load_history(h)  # settle the torn tail so both see one state
        bad = tmp_path / "bad"
        bad.mkdir()
        (bad / "seg-1.jsonl").write_text("garbage\n{}\n")
        argv = [a.format(missing=str(tmp_path / "nope"), h=h,
                         corrupt=str(bad)) for a in argv]
        got = run(argv)
        err = capsys.readouterr().err.strip().splitlines()[-1]
        want = jrun(argv)
        jerr = capsys.readouterr().err.strip().splitlines()[-1]
        assert got == want == 2
        assert err == jerr and err.startswith("error: ")
