"""The split of the calls' idle by the program's stage, and its readers,
on made-up events."""

from __future__ import annotations

import dataclasses

import pytest

from knnbench import manifest, stages, trace
from knnbench.tests.test_trace import MS, events, reading, readers
from knnbench.trace import Event

STAGE_READERS = ("prepare_idle_ms_per_call", "dispatch_idle_ms_per_call",
                 "fetch_idle_ms_per_call", "entry_idle_ms_per_call")
US = MS // 10  # a tenth of a millisecond


def events_with_spans():
    """:func:`events` with the program's ranges inside each call, on the
    window's thread: ``kneighbors`` > ``distance`` > ``prepare``,
    ``dispatch``, ``fetch`` (a range of its own below ``fetch``), and on
    another thread a ``prepare`` that is not the window's. Of each call's
    1.5 ms of idle: 0.2 ms under no span, 0.4 entry, 0.4 prepare, 0.1
    dispatch, 0.4 fetch."""
    ev = events()
    for c0 in (1 * MS, 6 * MS):
        ev += [Event("user_annotation", "kneighbors", c0 + US, c0 + 39 * US, 1),
               Event("user_annotation", "distance", c0 + 3 * US,
                     c0 + 39 * US, 1),
               Event("user_annotation", "prepare", c0 + 5 * US, c0 + 9 * US, 1),
               Event("user_annotation", "dispatch", c0 + 9 * US,
                     c0 + 12 * US, 1),
               Event("user_annotation", "fetch", c0 + 29 * US, c0 + 39 * US, 1),
               Event("user_annotation", "fetch.join", c0 + 36 * US,
                     c0 + 38 * US, 1),
               Event("user_annotation", "prepare", c0, c0 + 4 * MS, 2)]
    return ev


@pytest.fixture
def stage_readers(monkeypatch):
    """The four readers, loaded as the harness loads them; ``summarize`` is
    put back after the test."""
    monkeypatch.setattr(trace, "summarize", trace.summarize)
    return {m: manifest._reader(manifest.HERE, m) for m in STAGE_READERS}


def test_the_stage_split_of_a_known_timeline():
    got = stages.split(events_with_spans())
    assert got == {
        "prepare": pytest.approx(0.0008), "dispatch": pytest.approx(0.0002),
        "fetch": pytest.approx(0.0008), stages.ENTRY: pytest.approx(0.0008),
        stages.NO_SPAN: pytest.approx(0.0004)}
    s = trace.summarize(events_with_spans())
    assert sum(got.values()) == pytest.approx(s.call_wall_s - s.call_device_s)
    idle = dict((k, v) for k, v in s.idle_gaps)
    assert idle["knnbench.call/fetch.join"] == pytest.approx(0.0004)
    assert idle["knnbench.call/prepare"] == pytest.approx(0.0008)
    assert idle["knnbench.call"] == pytest.approx(0.0002)


def test_the_stage_readers_split_host_ms_per_call(stage_readers):
    """The four readers sum to ``host_ms_per_call`` less the idle under no
    program span (the harness's own, in the calls)."""
    s = trace.summarize(events_with_spans())
    got = {name: read(reading(s)) for name, read in stage_readers.items()}
    assert got == {"prepare_idle_ms_per_call": pytest.approx(0.4),
                   "dispatch_idle_ms_per_call": pytest.approx(0.1),
                   "fetch_idle_ms_per_call": pytest.approx(0.4),
                   "entry_idle_ms_per_call": pytest.approx(0.4)}
    host_ms = readers()["host_ms_per_call"](reading(s))
    assert sum(got.values()) == pytest.approx(
        host_ms - s.stage_idle[stages.NO_SPAN] / s.calls * 1e3)


def test_install_wraps_summarize_once(stage_readers):
    wrapped = trace.summarize
    assert wrapped.splits_stages
    stages.install()
    assert trace.summarize is wrapped
    assert wrapped([Event("kernel", "k", 0, 5, 1)]) is None


def test_program_ranges_change_no_other_field(stage_readers):
    """Every field of the summary but ``idle_gaps``' names reads the same
    with and without the program's ranges."""
    plain = trace.summarize(events())
    spans = trace.summarize(events_with_spans())
    for f in dataclasses.fields(trace.Summary):
        if f.name != "idle_gaps":
            assert getattr(spans, f.name) == getattr(plain, f.name), f.name
    assert sum(v for _, v in spans.idle_gaps) == pytest.approx(
        sum(v for _, v in plain.idle_gaps))
    assert plain.stage_idle == {}


@pytest.mark.parametrize("name", STAGE_READERS)
def test_stage_readers_give_nothing_without_an_entry_span(stage_readers, name):
    read = stage_readers[name]
    no_entry = [e for e in events_with_spans()
                if e.name not in stages.ENTRY_SPANS]
    cpu_only = [e for e in events_with_spans()
                if e.kind not in trace.DEVICE_KINDS]
    assert stages.split(no_entry) == {}
    for events_ in (events(), no_entry, cpu_only):
        assert read(reading(trace.summarize(events_))) is None
    assert read(reading(None)) is None
    assert read(reading(trace.summarize(events_with_spans()))) is not None
