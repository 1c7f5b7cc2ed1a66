"""The overload control plane on the port (``knn_tpu_torch/control/``),
against the JAX package's, on the CPU.

The twins of ``tests/test_control.py``, pointed at the port: priority
admission sheds the LOWEST-priority class first and never the protected
top tier, each shed a typed ``ShedByPolicy`` with a bounded
``Retry-After``; a policy shed spends no availability budget; the brownout
ladder applies in order and reverts LIFO on a fake clock; the autotuner
refuses any candidate its replay cannot prove; the autoscale policy is a
pure hysteresis; ``ServeApp`` wires it all (``device="cpu"``). Then:

- the same capacity and SLO sequence gives the same admission cutoffs and
  brownout steps in both packages (JAX's admission is started past its
  cooldown, to step round its clock fault), and the same autoscale
  decisions;
- ROADMAP Queue C: an admission whose monotonic clock reads 630 s moves on
  its first pressured evaluation (JAX's clock starts at 0 and freezes it);
- with every new flag off a serve boot imports none of ``control``,
  ``obs.history``, ``obs.alerts`` and starts none of their threads;
- the shed's HTTP contract, the batcher's priority-ordered pickup, the
  brownout hooks of the sample queues, an autotune cycle replayed on the
  live batcher, and the CLI's validation rows with JAX's exit and line.
"""

import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from knn_tpu.cli import run as jrun
from knn_tpu.control import admission as jadmission
from knn_tpu.control import autoscale as jautoscale
from knn_tpu.control import brownout as jbrownout
from knn_tpu_torch import obs
from knn_tpu_torch.cli import run
from knn_tpu_torch.control import admission as admission_mod
from knn_tpu_torch.control.admission import (
    RETRY_AFTER_MAX_S,
    RETRY_AFTER_MIN_S,
    PriorityAdmission,
    parse_priority_map,
)
from knn_tpu_torch.control.autoscale import AutoscalePolicy, run_scale_cmd
from knn_tpu_torch.control.autotune import BatchAutotuner
from knn_tpu_torch.control.brownout import BrownoutController, BrownoutStep
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.models.knn import KNNClassifier
from knn_tpu_torch.obs.slo import SLOTracker
from knn_tpu_torch.resilience.degrade import DEGRADATION_ORDER
from knn_tpu_torch.resilience.errors import DataError, ShedByPolicy
from knn_tpu_torch.serve.batcher import MicroBatcher
from tests.test_torch_resilience import global_state  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CPU = {"device": "cpu"}


class FakeCapacity:
    """The fields the control plane reads, with a settable headroom."""

    def __init__(self, headroom=None, dispatch_model=None):
        self.headroom = headroom
        self.dispatch_model = dispatch_model

    def export(self):
        return {"headroom_ratio": self.headroom,
                "dispatch_model": self.dispatch_model}


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.enable()
    obs.reset()
    yield obs.registry()
    obs.reset()
    if not was:
        obs.disable()


def fresh_admission(priority_map, capacity, **kw):
    """Lazy-evaluation caches off: every admit() re-reads the signal and
    may move at once."""
    kw.setdefault("eval_ms", 0.0)
    kw.setdefault("cooldown_ms", 0.0)
    return PriorityAdmission(priority_map, capacity=capacity, **kw)


class TestParsePriorityMap:
    def test_parses_classes_and_levels(self):
        assert parse_priority_map("interactive=0,bulk=2") == {
            "interactive": 0, "bulk": 2}

    def test_whitespace_and_trailing_comma_tolerated(self):
        assert parse_priority_map(" a=1 , b=0 ,") == {"a": 1, "b": 0}

    @pytest.mark.parametrize("spec", [
        "", "interactive", "interactive=fast", "interactive=-1", "a=1,a=2",
        "BAD CLASS=1",
    ])
    def test_bad_specs_raise_with_jax_text(self, spec):
        with pytest.raises(ValueError) as got:
            parse_priority_map(spec)
        with pytest.raises(ValueError) as want:
            jadmission.parse_priority_map(spec)
        assert str(got.value) == str(want.value)


class TestPriorityShedOrdering:
    def test_no_pressure_admits_everything(self):
        adm = fresh_admission({"interactive": 0, "bulk": 2},
                              FakeCapacity(headroom=3.0))
        assert adm.admit("bulk") is None
        assert adm.admit("interactive") is None
        assert adm.export()["shed_tiers"] == 0

    def test_negative_headroom_sheds_lowest_tier_first(self):
        adm = fresh_admission(
            {"interactive": 0, "batch": 1, "bulk": 2},
            FakeCapacity(headroom=0.4), cooldown_ms=3600_000.0)
        shed = adm.admit("bulk")
        assert isinstance(shed, ShedByPolicy)
        assert shed.request_class == "bulk"
        assert adm.admit("batch") is None
        assert adm.admit("interactive") is None
        assert adm.export()["shed_tiers"] == 1

    def test_sustained_pressure_walks_to_the_protected_cap(self):
        adm = fresh_admission({"interactive": 0, "batch": 1, "bulk": 2},
                              FakeCapacity(headroom=0.4))
        assert isinstance(adm.admit("bulk"), ShedByPolicy)
        assert isinstance(adm.admit("batch"), ShedByPolicy)
        for _ in range(8):
            assert adm.admit("interactive") is None
        assert adm.export()["shed_tiers"] == 2

    def test_unmapped_class_defaults_to_protected(self):
        adm = fresh_admission({"interactive": 0, "bulk": 2},
                              FakeCapacity(headroom=0.2))
        assert isinstance(adm.admit("bulk"), ShedByPolicy)
        assert adm.admit("web") is None
        assert adm.admit(None) is None
        assert adm.protected("web") and not adm.protected("bulk")

    def test_single_tier_map_never_sheds(self):
        adm = fresh_admission({"bulk": 2}, FakeCapacity(headroom=0.1))
        for _ in range(4):
            assert adm.admit("bulk") is None

    def test_recovery_restores_tiers(self):
        cap = FakeCapacity(headroom=0.4)
        adm = fresh_admission({"interactive": 0, "bulk": 2}, cap)
        assert isinstance(adm.admit("bulk"), ShedByPolicy)
        cap.headroom = 2.0
        assert adm.admit("bulk") is None
        assert adm.export()["moves"] == {"shed": 1, "restore": 1}

    def test_cooldown_freezes_the_cutoff(self):
        adm = fresh_admission({"interactive": 0, "batch": 1, "bulk": 2},
                              FakeCapacity(headroom=0.1),
                              cooldown_ms=3600_000.0)
        assert isinstance(adm.admit("bulk"), ShedByPolicy)
        assert adm.admit("batch") is None

    def test_audit_and_export_describe_the_cutoff(self):
        adm = fresh_admission({"interactive": 0, "bulk": 2},
                              FakeCapacity(headroom=0.5))
        adm.admit("bulk")
        ex = adm.export()
        assert ex["cutoff_priority"] == 2
        assert ex["protected_priority"] == 0
        assert ex["audit"][-1]["action"] == "shed"
        assert ex["audit"][-1]["headroom_ratio"] == 0.5

    def test_retry_after_is_bounded_and_headroom_priced(self):
        adm = fresh_admission({"interactive": 0, "bulk": 2},
                              FakeCapacity(headroom=0.1))
        adm.admit("bulk")
        for _ in range(32):
            assert (RETRY_AFTER_MIN_S <= adm.retry_after_s()
                    <= RETRY_AFTER_MAX_S)
        shed = adm.admit("bulk")
        assert RETRY_AFTER_MIN_S <= shed.retry_after_s <= RETRY_AFTER_MAX_S

    def test_no_signals_means_fully_open_forever(self):
        adm = fresh_admission({"interactive": 0, "bulk": 2}, None)
        for _ in range(4):
            assert adm.admit("bulk") is None


class _FakeMonotonic:
    """A stand-in for an admission module's ``time``: ``monotonic_ns``
    reads a settable clock, ``time`` stays the wall clock."""

    def __init__(self, ns: int):
        self.ns = int(ns)
        self.time = time.time

    def monotonic_ns(self) -> int:
        return self.ns


class TestCooldownClockStartsAtNever:
    """ROADMAP Queue C: JAX starts ``_last_move_ns`` at 0, so on a host
    whose monotonic clock reads less than one cooldown (a host up for
    630 s, say) the first move is frozen. The port starts it at
    "never"."""

    def test_first_pressured_evaluation_moves_at_630_s(self, monkeypatch):
        clock = _FakeMonotonic(630 * 10**9)
        monkeypatch.setattr(admission_mod, "time", clock)
        adm = PriorityAdmission({"interactive": 0, "bulk": 2},
                                capacity=FakeCapacity(headroom=0.4),
                                cooldown_ms=3600_000.0, eval_ms=250.0)
        assert isinstance(adm.admit("bulk"), ShedByPolicy)
        assert adm.export()["moves"]["shed"] == 1
        # The cooldown now runs from that first move.
        clock.ns += 10**9
        assert adm.admit("interactive") is None
        assert adm.export()["shed_tiers"] == 1

    def test_first_evaluation_is_not_skipped_at_clock_zero(self,
                                                           monkeypatch):
        monkeypatch.setattr(admission_mod, "time", _FakeMonotonic(0))
        adm = PriorityAdmission({"interactive": 0, "bulk": 2},
                                capacity=FakeCapacity(headroom=0.4),
                                cooldown_ms=2000.0, eval_ms=250.0)
        assert isinstance(adm.admit("bulk"), ShedByPolicy)


class TestQueueShareByTier:
    """ROADMAP Queue C: JAX lets every class fill the one queue bound, so a
    sheddable class that the cutoff restores mid-overload takes the plain
    queue-full 429. The port divides the bound by tier: below the top tier
    a class past its share is shed by policy."""

    @pytest.mark.parametrize("pmap, want", [
        ({"interactive": 0, "batch": 1},
         {"interactive": 1.0, "batch": 0.5, "unmapped": 1.0}),
        ({"interactive": 0, "batch": 1, "bulk": 4},
         {"interactive": 1.0, "batch": 2 / 3, "bulk": 1 / 3}),
        ({"bulk": 2}, {"bulk": 1.0, "unmapped": 1.0}),
    ])
    def test_shares(self, pmap, want):
        adm = PriorityAdmission(pmap)
        assert {c: adm.queue_share(c) for c in want} == pytest.approx(want)

    def test_past_its_share_a_tier_is_shed_whatever_the_cutoff(self,
                                                                obs_on):
        adm = PriorityAdmission({"interactive": 0, "batch": 1})
        assert adm.admit_queued("batch", 2047, 4096) is None
        shed = adm.admit_queued("batch", 2048, 4096)
        assert isinstance(shed, ShedByPolicy)
        assert shed.request_class == "batch"
        assert RETRY_AFTER_MIN_S <= shed.retry_after_s <= RETRY_AFTER_MAX_S
        assert "share of the queue bound 4096 is 2048" in str(shed)
        for queued in (0, 2048, 4095, 4096):
            assert adm.admit_queued("interactive", queued, 4096) is None
        assert adm.export()["shed_tiers"] == 0
        assert obs_on.counter("knn_control_shed_total",
                              request_class="batch").value == 1


class TestBatcherShedIntegration:
    @pytest.fixture
    def model(self):
        rng = np.random.default_rng(7)
        x = rng.normal(0, 1, (64, 4)).astype(np.float32)
        y = rng.integers(0, 3, 64).astype(np.int32)
        return KNNClassifier(k=3, **CPU).fit(Dataset(x, y))

    def test_shed_is_typed_and_ordered(self, model):
        cap = FakeCapacity(headroom=0.3)
        adm = fresh_admission({"interactive": 0, "bulk": 2}, cap)
        with MicroBatcher(model, max_batch=8, max_wait_ms=0.0,
                          admission=adm) as b:
            q = np.zeros(4, np.float32)
            with pytest.raises(ShedByPolicy) as ei:
                b.submit(q, "predict", request_class="bulk")
            assert ei.value.retry_after_s >= RETRY_AFTER_MIN_S
            r = b.submit(q, "predict", request_class="interactive")
            assert r.result(timeout=30) is not None
            cap.headroom = 2.0
            r = b.submit(q, "predict", request_class="bulk")
            assert r.result(timeout=30) is not None

    @pytest.mark.parametrize("with_policy", [True, False])
    def test_pickup_fills_highest_priority_first(self, model, with_policy):
        """Three one-row requests inside one coalescing window at
        max_batch 2: with a policy the first batch is the interactive one
        plus the OLDER bulk one (FIFO within a class); without, FIFO."""
        adm = (fresh_admission({"interactive": 0, "bulk": 2},
                               FakeCapacity(headroom=5.0))
               if with_policy else None)
        b = MicroBatcher(model, max_batch=2, max_wait_ms=300.0,
                         admission=adm)
        seen = []
        dispatch = b._dispatch

        def record(batch):
            seen.append([(r.request_class, float(r.features[0, 0]))
                         for r in batch])
            return dispatch(batch)

        b._dispatch = record
        try:
            handles = [b.submit(np.full(4, i, np.float32), "predict",
                                request_class=c)
                       for i, c in enumerate(("bulk", "bulk",
                                              "interactive"))]
            for h in handles:
                h.result(timeout=30)
        finally:
            b.close()
        if with_policy:
            assert seen == [[("interactive", 2.0), ("bulk", 0.0)],
                            [("bulk", 1.0)]]
        else:
            assert seen == [[("bulk", 0.0), ("bulk", 1.0)],
                            [("interactive", 2.0)]]

    def test_queue_share_sheds_by_policy_before_the_bound(self, model,
                                                          obs_on):
        """A 16-row bound, `bulk` half of it: with 10 rows queued inside
        one coalescing window, `bulk` is shed by policy (where JAX would
        queue a row and refuse 7 with the plain 429) and `interactive`
        still queues to the bound."""
        adm = PriorityAdmission({"interactive": 0, "bulk": 2})
        b = MicroBatcher(model, max_batch=16, max_queue_rows=16,
                         max_wait_ms=2000.0, admission=adm)

        def rows(n):
            return np.zeros((n, 4), np.float32)

        try:
            handles = [b.submit(rows(6), "predict", request_class="bulk"),
                       b.submit(rows(4), "predict", request_class="bulk")]
            for n in (1, 7):
                with pytest.raises(ShedByPolicy, match="share of the "
                                   "queue bound 16 is 8"):
                    b.submit(rows(n), "predict", request_class="bulk")
            handles.append(b.submit(rows(6), "predict",
                                    request_class="interactive"))
            for h in handles:
                assert h.result(timeout=30) is not None
        finally:
            b.close()
        assert obs_on.counter("knn_serve_rejected_total",
                              reason="queue_share").value == 2
        assert obs_on.counter("knn_serve_rejected_total",
                              reason="queue_full").value == 0


class TestBrownoutLadder:
    def make(self, cap, clock, **kw):
        calls = []
        steps = [
            BrownoutStep("shadow_rate", lambda: calls.append("shadow-"),
                         lambda: calls.append("shadow+")),
            BrownoutStep("probes", lambda: calls.append("probes-"),
                         lambda: calls.append("probes+")),
        ]
        kw.setdefault("cooldown_ms", 1000.0)
        ctl = BrownoutController(steps, capacity=cap, autostart=False,
                                 clock=lambda: clock[0], **kw)
        return ctl, calls

    def test_applies_in_order_and_reverts_lifo(self):
        cap = FakeCapacity(headroom=0.5)
        clock = [0.0]
        ctl, calls = self.make(cap, clock)
        ctl.tick()
        assert calls == ["shadow-"] and ctl.level == 1
        clock[0] += 2.0
        ctl.tick()
        assert calls == ["shadow-", "probes-"] and ctl.level == 2
        cap.headroom = 2.0
        clock[0] += 2.0
        ctl.tick()
        assert calls[-1] == "probes+" and ctl.level == 1
        clock[0] += 2.0
        ctl.tick()
        assert calls[-1] == "shadow+" and ctl.level == 0
        assert ctl.moves == {"apply": 2, "revert": 2}
        assert ctl.export()["applied"] == []

    def test_cooldown_bounds_walk_rate(self):
        clock = [0.0]
        ctl, calls = self.make(FakeCapacity(headroom=0.5), clock)
        ctl.tick()
        ctl.tick()
        clock[0] += 0.5
        ctl.tick()
        assert calls == ["shadow-"] and ctl.level == 1

    def test_failed_knob_is_audited_and_does_not_kill_the_walk(self):
        clock = [0.0]
        boom = BrownoutStep("boom",
                            lambda: (_ for _ in ()).throw(RuntimeError("x")),
                            lambda: None)
        ok_calls = []
        ctl = BrownoutController(
            [boom, BrownoutStep("ok", lambda: ok_calls.append("-"),
                                lambda: ok_calls.append("+"))],
            capacity=FakeCapacity(headroom=0.5), autostart=False,
            cooldown_ms=1000.0, clock=lambda: clock[0])
        ctl.tick()
        assert ctl.export()["audit"][-1]["action"] == "apply-failed"
        clock[0] += 2.0
        ctl.tick()
        assert ok_calls == ["-"] and ctl.level == 2

    def test_defer_background_tracks_negative_headroom(self):
        cap = FakeCapacity(headroom=0.8)
        clock = [0.0]
        ctl, _calls = self.make(cap, clock)
        assert not ctl.defer_background()
        ctl.tick()
        assert ctl.defer_background()
        cap.headroom = 1.5
        clock[0] += 2.0
        ctl.tick()
        assert not ctl.defer_background()

    def test_no_signal_rests_fully_healthy(self):
        clock = [0.0]
        ctl, calls = self.make(None, clock)
        for _ in range(3):
            ctl.tick()
            clock[0] += 2.0
        assert calls == [] and ctl.level == 0


class TestSampleQueueBrownoutHooks:
    """``set_rate``/``set_defer`` on the shadow scorer and the drift
    monitor: the brownout's knobs and headroom gate."""

    @pytest.mark.parametrize("layer", ["quality", "drift"])
    def test_set_rate_and_defer(self, layer):
        if layer == "quality":
            from knn_tpu_torch.obs.quality import ShadowScorer

            q = ShadowScorer(0.5, queue_cap=8, autostart=False)
        else:
            from knn_tpu_torch.obs.drift import DriftMonitor

            q = DriftMonitor(None, rate=0.5, num_features=3, queue_cap=8,
                             autostart=False)
        try:
            q.set_rate(0.0)
            assert q.rate == 0.0 and q._sq.rate == 0.0
            q.set_rate(1.0)
            with pytest.raises(ValueError):
                q.set_rate(1.5)
            deferring = [True]
            q.set_defer(lambda: deferring[0])
            assert not q._sq.offer(lambda: "sample")
            assert q.shed == 1 and q._sq.depth() == 0
            deferring[0] = False
            assert q._sq.offer(lambda: "sample")
            q.set_defer(None)
            assert q._sq.defer is None
        finally:
            q.close()

    def test_deferred_offer_consumes_its_draw_as_jax_does(self):
        from knn_tpu.obs.shedqueue import ShedQueue as JShedQueue
        from knn_tpu_torch.obs.shedqueue import ShedQueue

        outs = []
        for cls in (ShedQueue, JShedQueue):
            sq = cls(rate=0.5, queue_cap=1000, consume=lambda s: None,
                     thread_name="t", seed=3, autostart=False)
            got = []
            for i in range(200):
                sq.defer = (lambda: True) if i % 3 == 0 else None
                got.append(sq.offer(lambda: i))
            outs.append((got, sq.shed))
            sq.close()
        assert outs[0] == outs[1]


class FakeWorkloadCapture:
    def start(self, reason=None, window_s=None):
        pass

    def stop(self):
        return {"path": "fake-window"}


class FakeWorkload:
    def __init__(self, n=64, spacing_ms=4.0):
        self._arrivals = [(i * spacing_ms, 1) for i in range(n)]

    def arrivals(self):
        return list(self._arrivals)


class FakeTunableBatcher:
    max_batch = 8
    buckets = None

    def __init__(self, max_wait_ms=4.0):
        self.max_wait_ms = max_wait_ms


@pytest.fixture
def tuner_parts(monkeypatch):
    import knn_tpu_torch.obs.workload as workload_mod

    monkeypatch.setattr(workload_mod, "load_workload",
                        lambda path: FakeWorkload())
    batcher = FakeTunableBatcher(max_wait_ms=4.0)
    cap = FakeCapacity(dispatch_model={"a_ms": 1.0, "b_ms_per_row": 0.05})

    def make(replay_fn):
        t = BatchAutotuner(batcher, cap, FakeWorkloadCapture(),
                           interval_s=30.0, replay_fn=replay_fn,
                           autostart=False)
        t._stop.set()  # the capture window returns at once in tests
        return t

    return batcher, make


class FailingCapacity:
    """A capacity layer whose export raises, as a broken signal would."""

    def export(self):
        raise RuntimeError("capacity export fell over")


class TestControlLoopFailures:
    """A failure inside a control thread is counted and audited, and the
    loop goes on (JAX's loops pass over it silently)."""

    def test_autotune_cycle_that_raises_is_counted_and_audited(
            self, tuner_parts, obs_on):
        batcher, _make = tuner_parts
        t = BatchAutotuner(batcher, FailingCapacity(), FakeWorkloadCapture(),
                           interval_s=30.0, autostart=False)
        t._stop.set()
        entry = t.run_cycle()
        assert entry["outcome"] == "error"
        assert "capacity export fell over" in entry["error"]
        assert t.export()["audit"][-1] == entry
        assert t.export()["outcomes"]["error"] == t.cycles == 1
        assert obs_on.counter("knn_control_autotune_total",
                              outcome="error").value == 1
        assert batcher.max_wait_ms == 4.0

    def test_autotune_loop_survives_a_failing_cycle(self, tuner_parts):
        batcher, _make = tuner_parts
        t = BatchAutotuner(batcher, FailingCapacity(), FakeWorkloadCapture(),
                           interval_s=0.01, autostart=True)
        deadline = time.monotonic() + 30
        while t.export()["outcomes"].get("error", 0) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        t.close()
        assert t._thread is not None and not t._thread.is_alive()

    def test_brownout_signal_failure_is_counted_and_audited_once(
            self, obs_on):
        clock = [0.0]
        ctl = BrownoutController(
            [BrownoutStep("s", lambda: None, lambda: None)],
            capacity=FailingCapacity(), autostart=False,
            cooldown_ms=1000.0, clock=lambda: clock[0])
        for _ in range(3):
            ctl.tick()
            clock[0] += 2.0
        audit = ctl.export()["audit"]
        assert [e["action"] for e in audit] == ["error"]
        assert audit[0]["where"] == "headroom"
        assert "capacity export fell over" in audit[0]["error"]
        assert ctl.export()["errors"] == 3
        assert obs_on.counter("knn_control_brownout_errors_total",
                              where="headroom").value == 3

    def test_brownout_tick_that_raises_is_counted_and_audited(
            self, obs_on, monkeypatch):
        ctl = BrownoutController(
            [BrownoutStep("s", lambda: None, lambda: None)],
            capacity=FakeCapacity(headroom=2.0), autostart=False,
            eval_ms=1.0)

        class StopAfter:
            def __init__(self, n):
                self.n = n

            def wait(self, _dt):
                self.n -= 1
                return self.n < 0

        def boom():
            raise ValueError("tick fell over")

        monkeypatch.setattr(ctl, "tick", boom)
        ctl._stop = StopAfter(2)
        ctl._run()
        audit = ctl.export()["audit"]
        assert [(e["action"], e["where"]) for e in audit] == [
            ("error", "tick")]
        assert "tick fell over" in audit[0]["error"]
        assert ctl.errors == 2
        assert obs_on.counter("knn_control_brownout_errors_total",
                              where="tick").value == 2


class TestAutotuneReplayGate:
    def test_refuses_divergent_replay_and_restores(self, tuner_parts):
        batcher, make = tuner_parts
        applied = []

        def replay(wl, batcher=None, speed=None, replay_mutations=None):
            applied.append(batcher.max_wait_ms)
            return {"verify": {"divergences": 3, "verified": 61}}

        entry = make(replay).run_cycle()
        assert entry["outcome"] == "refused"
        assert entry["replay_divergences"] == 3
        assert applied and applied[0] != 4.0
        assert batcher.max_wait_ms == 4.0

    def test_refuses_unverifiable_replay_and_restores(self, tuner_parts):
        batcher, make = tuner_parts

        def replay(wl, **kw):
            raise RuntimeError("replay harness fell over")

        entry = make(replay).run_cycle()
        assert entry["outcome"] == "refused"
        assert "replay harness" in entry["error"]
        assert batcher.max_wait_ms == 4.0

    def test_applies_only_a_proven_candidate(self, tuner_parts):
        batcher, make = tuner_parts

        def replay(wl, **kw):
            assert kw == {"batcher": batcher, "speed": 8.0,
                          "replay_mutations": False}
            return {"verify": {"divergences": 0, "verified": 64}}

        t = make(replay)
        entry = t.run_cycle()
        assert entry["outcome"] == "applied"
        assert batcher.max_wait_ms == entry["candidate_max_wait_ms"] != 4.0
        assert t.export()["outcomes"]["applied"] == 1

    @pytest.mark.parametrize("deadline,outcome,wait", [
        (2.0, "skipped", 4.0),   # every candidate's p99 is past it
        (50.0, "applied", 1.0),  # a loose deadline: the pick without one
    ])
    def test_a_candidate_must_fit_the_live_deadline(self, tuner_parts,
                                                    deadline, outcome, wait):
        """The port's one change to JAX's tuner: under a request deadline
        a window whose predicted p99 is past it is not eligible (a lone
        request would wait out the window and expire)."""
        batcher, _make = tuner_parts
        cap = FakeCapacity(dispatch_model={"a_ms": 1.0, "b_ms_per_row": 0.05})
        t = BatchAutotuner(
            batcher, cap, FakeWorkloadCapture(), interval_s=30.0,
            replay_fn=lambda wl, **kw: {"verify": {"divergences": 0,
                                                   "verified": 64}},
            deadline_fn=lambda: deadline, autostart=False)
        t._stop.set()
        entry = t.run_cycle()
        assert entry["outcome"] == outcome
        assert entry["deadline_ms"] == deadline
        assert batcher.max_wait_ms == wait
        if outcome == "applied":
            assert entry["predicted_p99_ms"] <= deadline

    def test_the_app_hands_the_tuner_its_live_deadline(self, tmp_path):
        from knn_tpu_torch.serve.server import ServeApp

        app = ServeApp(_model(), max_batch=8, max_wait_ms=2.0,
                       cost_accounting=True, capture_dir=str(tmp_path),
                       autotune_interval_s=30.0, deadline_ms=40.0, **CPU)
        try:
            assert app.autotune._deadline_fn() == 40.0
            app.deadline_ms = 20.0  # as the brownout's deadline step does
            assert app.autotune._deadline_fn() == 20.0
        finally:
            app.close()

    def test_skips_thin_captures(self, tuner_parts, monkeypatch):
        import knn_tpu_torch.obs.workload as workload_mod

        monkeypatch.setattr(workload_mod, "load_workload",
                            lambda path: FakeWorkload(n=5))
        batcher, make = tuner_parts
        entry = make(lambda wl, **kw: None).run_cycle()
        assert entry["outcome"] == "skipped"
        assert entry["reason"] == "too_few_requests"
        assert batcher.max_wait_ms == 4.0

    def test_a_cycle_replays_on_the_live_batcher(self, tmp_path):
        """The real loop on the CPU: capture a window of live traffic,
        price the candidates, and (if one wins) replay the window through
        the serving batcher with zero divergences."""
        from knn_tpu_torch.serve.server import ServeApp

        rng = np.random.default_rng(5)
        x = rng.integers(0, 6, (300, 5)).astype(np.float32)
        y = rng.integers(0, 3, 300).astype(np.int32)
        model = KNNClassifier(k=3, **CPU).fit(Dataset(x, y))
        app = ServeApp(model, max_batch=16, max_wait_ms=2.0,
                       cost_accounting=True, capture_dir=str(tmp_path),
                       batch_buckets=(4, 8, 16), **CPU)
        app.warm()
        tuner = BatchAutotuner(app.batcher, app.capacity, app.workload,
                               interval_s=3.0, min_requests=16,
                               autostart=False)
        stop = threading.Event()

        def traffic():
            q = rng.integers(0, 6, (400, 5)).astype(np.float32)
            i = 0
            while not stop.is_set():
                app.batcher.submit(q[i % 400], "predict").result(timeout=30)
                i += 1
                time.sleep(0.004)

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        try:
            entry = tuner.run_cycle()
        finally:
            stop.set()
            th.join(timeout=30)
            tuner.close()
            app.close()
        assert not th.is_alive()
        assert entry["outcome"] in ("applied", "held"), entry
        assert entry["captured_requests"] >= 16
        if entry["outcome"] == "applied":
            assert entry["replay_divergences"] == 0
            assert entry["replay_verified"] > 0


class TestAutoscalePolicy:
    def make(self, clock, **kw):
        kw.setdefault("cooldown_s", 10.0)
        return AutoscalePolicy(1, 4, clock=lambda: clock[0], **kw)

    def test_no_model_no_action(self):
        pol = self.make([100.0])
        assert pol.decide(1000.0, None, 2) is None
        assert pol.decide(1000.0, 0.0, 2) is None

    def test_up_past_the_up_fraction(self):
        pol = self.make([100.0])
        assert pol.decide(79.0, 100.0, 2) is None
        assert pol.decide(81.0, 100.0, 2) == "up"

    def test_never_up_past_scale_max(self):
        assert self.make([100.0]).decide(999.0, 100.0, 4) is None

    def test_down_only_when_remaining_fleet_fits_it(self):
        clock = [100.0]
        pol = self.make(clock)
        assert pol.decide(10.0, 100.0, 3) == "down"
        clock[0] += 20.0
        assert pol.decide(30.0, 100.0, 3) is None

    def test_never_down_below_scale_min(self):
        assert self.make([100.0]).decide(0.0, 50.0, 1) is None

    def test_cooldown_separates_any_two_actions(self):
        clock = [100.0]
        pol = self.make(clock)
        assert pol.decide(81.0, 100.0, 2) == "up"
        assert pol.decide(81.0, 100.0, 2) is None
        clock[0] += 11.0
        assert pol.decide(81.0, 100.0, 2) == "up"
        assert pol.decisions == {"up": 2, "down": 0}

    @pytest.mark.parametrize("args,kw", [
        ((0, 2), {}), ((3, 2), {}),
        ((1, 2), {"up_fraction": 0.3, "down_fraction": 0.5}),
    ])
    def test_bounds_validated(self, args, kw):
        with pytest.raises(ValueError):
            AutoscalePolicy(*args, **kw)

    def test_run_scale_cmd_passes_direction_and_url(self, tmp_path):
        out = tmp_path / "scale.log"
        script = tmp_path / "scale.sh"
        script.write_text(f"#!/bin/sh\necho \"$1 $2\" >> {out}\n")
        script.chmod(0o755)
        run_scale_cmd(str(script), "up", "http://r3:8000", timeout_s=30)
        assert out.read_text().strip() == "up http://r3:8000"

    def test_run_scale_cmd_raises_on_failure(self):
        with pytest.raises(subprocess.CalledProcessError):
            run_scale_cmd("false", "down", "http://r1:8000", timeout_s=30)


class TestShedSLOExclusion:
    def test_policy_sheds_spend_no_availability_budget(self):
        slo = SLOTracker(windows_s=(60,))
        for _ in range(20):
            slo.record(ok=True, latency_ms=1.0)
        for _ in range(50):
            slo.record_shed()
        assert slo.burn_rates()["availability"]["1m"] == 0.0
        assert slo.export()["policy_sheds"]["1m"] == 50

    def test_protected_429s_still_burn(self):
        slo = SLOTracker(windows_s=(60,))
        for _ in range(10):
            slo.record(ok=False, latency_ms=1.0)
        assert slo.burn_rates()["availability"]["1m"] > 0.0


class TestDegradationOrderContract:
    def test_order_is_scale_shed_brownout_availability(self):
        assert DEGRADATION_ORDER == (
            "scale", "shed_low_priority", "brownout_quality",
            "availability")


class _StubSLO:
    """Burn rates set by the test; one 5 s window."""

    windows_s = (5,)

    def __init__(self):
        self.burn = 0.0

    def burn_rates(self):
        return {"availability": {"5s": self.burn},
                "latency": {"5s": self.burn / 2}}


def _pressure_sequence(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    heads = rng.choice([None, 0.2, 0.6, 0.95, 1.1, 1.5, 3.0], n,
                       p=[0.05, 0.15, 0.15, 0.15, 0.15, 0.15, 0.2])
    burns = rng.choice([0.0, 0.3, 1.0, 1.8, 2.5, 6.0], n)
    steps_ms = rng.choice([50, 150, 400, 900, 2500], n)
    return list(zip(heads, burns, steps_ms))


class TestAgainstJAX:
    @pytest.mark.parametrize("seed", range(5))
    def test_same_signals_same_admission_cutoffs(self, seed, monkeypatch):
        """JAX's clock starts 1 h in (past its cooldown, whose clock starts
        at 0); the port's at 0 (its clocks start at "never")."""
        port_clock, jax_clock = _FakeMonotonic(0), _FakeMonotonic(3600e9)
        monkeypatch.setattr(admission_mod, "time", port_clock)
        monkeypatch.setattr(jadmission, "time", jax_clock)
        pmap = {"interactive": 0, "batch": 1, "bulk": 2, "scavenger": 5}
        sides = []
        for mod in (admission_mod, jadmission):
            cap, slo = FakeCapacity(), _StubSLO()
            sides.append((mod.PriorityAdmission(
                pmap, slo=slo, capacity=cap, cooldown_ms=1000.0,
                eval_ms=250.0), cap, slo))
        trail = [[], []]
        for head, burn, dt in _pressure_sequence(seed):
            for clock in (port_clock, jax_clock):
                clock.ns += int(dt * 1e6)
            for side, (adm, cap, slo) in enumerate(sides):
                cap.headroom = None if head is None else float(head)
                slo.burn = float(burn)
                for cls in ("scavenger", "bulk", "batch", "interactive",
                            "unmapped"):
                    shed = adm.admit(cls)
                    trail[side].append(
                        None if shed is None
                        else (type(shed).__name__, shed.request_class))
                ex = adm.export()
                trail[side].append((ex["shed_tiers"], ex["cutoff_priority"],
                                    ex["last_headroom_ratio"],
                                    ex["last_burn"]))
        assert trail[0] == trail[1]
        moves = sides[0][0].export()["moves"]
        assert moves == sides[1][0].export()["moves"]
        assert moves["shed"] >= 2 and moves["restore"] >= 1
        audit = [{k: v for k, v in e.items() if k != "ts"}
                 for e in sides[0][0].export()["audit"]]
        jaudit = [{k: v for k, v in e.items() if k != "ts"}
                  for e in sides[1][0].export()["audit"]]
        assert audit == jaudit

    @pytest.mark.parametrize("seed", range(5))
    def test_same_signals_same_brownout_steps(self, seed):
        runs = []
        for mod in (BrownoutController, jbrownout.BrownoutController):
            step_cls = (BrownoutStep if mod is BrownoutController
                        else jbrownout.BrownoutStep)
            calls = []
            steps = [step_cls(n, lambda n=n: calls.append(n + "-"),
                              lambda n=n: calls.append(n + "+"))
                     for n in ("shadow_rate", "drift_rate",
                               "ivf_probes_to_base", "deadline_tighten")]
            cap, slo, clock = FakeCapacity(), _StubSLO(), [0.0]
            ctl = mod(steps, slo=slo, capacity=cap, autostart=False,
                      cooldown_ms=1000.0, clock=lambda c=clock: c[0])
            levels = []
            for head, burn, dt in _pressure_sequence(100 + seed):
                clock[0] += dt / 1e3
                cap.headroom = None if head is None else float(head)
                slo.burn = float(burn)
                ctl.tick()
                levels.append((ctl.level, ctl.defer_background()))
            audit = [{k: v for k, v in e.items() if k != "ts"}
                     for e in ctl.export()["audit"]]
            runs.append((calls, levels, audit, dict(ctl.moves)))
        assert runs[0] == runs[1]
        assert runs[0][3]["apply"] >= 2 and runs[0][3]["revert"] >= 1

    def test_same_signals_same_autoscale_decisions(self):
        rng = np.random.default_rng(9)
        pols = [AutoscalePolicy(1, 5, cooldown_s=5.0,
                                clock=lambda: clock[0]),
                jautoscale.AutoscalePolicy(1, 5, cooldown_s=5.0,
                                           clock=lambda: clock[0])]
        clock = [0.0]
        out = [[], []]
        for _ in range(200):
            clock[0] += float(rng.choice([0.5, 2.0, 6.0]))
            args = (float(rng.uniform(0, 500)),
                    float(rng.choice([0.0, 100.0, 300.0, 600.0])),
                    int(rng.integers(0, 6)))
            for i, pol in enumerate(pols):
                out[i].append(pol.decide(*args))
        assert out[0] == out[1]
        assert pols[0].export() == pols[1].export()


def _model(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (64, 4)).astype(np.float32)
    y = rng.integers(0, 3, 64).astype(np.int32)
    return KNNClassifier(k=3, **CPU).fit(Dataset(x, y))


class TestServeAppWiring:
    def test_priority_requires_cost_accounting(self):
        from knn_tpu_torch.serve.server import ServeApp

        with pytest.raises(DataError, match="cost-accounting"):
            ServeApp(_model(), max_batch=8, max_wait_ms=0.0,
                     priority_map={"bulk": 2}, **CPU)

    def test_brownout_requires_a_knob(self):
        from knn_tpu_torch.serve.server import ServeApp

        with pytest.raises(DataError, match="reversible knob"):
            ServeApp(_model(), max_batch=8, max_wait_ms=0.0, brownout=True,
                     **CPU)

    def test_autotune_requires_capture_and_accounting(self):
        from knn_tpu_torch.serve.server import ServeApp

        with pytest.raises(DataError):
            ServeApp(_model(), max_batch=8, max_wait_ms=0.0,
                     autotune_interval_s=30.0, **CPU)

    @pytest.mark.parametrize("kw,argv", [
        ({"priority_map": {"a": 0}}, ["--priority", "a=0",
                                      "--cost-accounting", "off"]),
        ({"autotune_interval_s": 0.0}, ["--autotune-interval-s", "0"]),
        ({"autotune_interval_s": 5.0}, ["--autotune-interval-s", "5"]),
        ({"history_interval_s": 0.0}, ["--history-interval-s", "0"]),
        ({"history_interval_s": 5.0, "history_retention_s": 1.0},
         ["--history-interval-s", "5", "--history-retention-s", "1"]),
    ])
    def test_app_and_cli_hold_one_rule(self, capsys, kw, argv):
        """The CLI (before the index loads) and ServeApp (before any
        thread starts) refuse a flag on the same rule, in the same words."""
        from knn_tpu_torch.serve.server import ServeApp

        with pytest.raises(DataError) as got:
            ServeApp(_model(), max_batch=8, max_wait_ms=0.0, **kw, **CPU)
        assert run(["serve", "/irrelevant/index", *argv,
                    "--device", "cpu"]) == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert err[-1] == f"error: {got.value}"

    def test_control_block_and_threads_wired_when_flagged(self, tmp_path):
        from knn_tpu_torch.serve.server import ServeApp

        app = ServeApp(_model(), max_batch=8, max_wait_ms=0.0,
                       cost_accounting=True, shadow_rate=0.1,
                       capture_dir=str(tmp_path),
                       priority_map={"interactive": 0, "bulk": 2},
                       brownout=True, autotune_interval_s=3600.0, **CPU)
        try:
            block = app.control_block()
            assert block["admission"]["priority_map"] == {
                "interactive": 0, "bulk": 2}
            assert "shadow_rate" in block["brownout"]["steps"]
            assert block["autotune"]["interval_s"] == 3600.0
            names = {t.name for t in threading.enumerate()}
            assert "knn-control-brownout" in names
            assert "knn-control-autotune" in names
            assert app.batcher.admission is app.admission
            assert app.quality._sq.defer == app.brownout.defer_background
        finally:
            app.close()
        alive = {t.name for t in threading.enumerate()
                 if t.is_alive() and t.name.startswith("knn-control")}
        assert not alive

    def test_ladder_follows_the_knobs_and_reverts_them(self, tmp_path):
        from knn_tpu_torch.serve.server import ServeApp

        app = ServeApp(_model(), max_batch=8, max_wait_ms=0.0,
                       cost_accounting=True, shadow_rate=0.5,
                       drift_rate=0.2, deadline_ms=40.0, brownout=True,
                       **CPU)
        try:
            steps = app.brownout.steps
            assert [s.name for s in steps] == [
                "shadow_rate", "drift_rate", "deadline_tighten"]
            for s in steps:
                s.apply()
            assert (app.quality.rate, app.drift.rate, app.deadline_ms) == (
                pytest.approx(0.05), pytest.approx(0.02), 20.0)
            for s in reversed(steps):
                s.revert()
            assert (app.quality.rate, app.drift.rate, app.deadline_ms) == (
                0.5, 0.2, 40.0)
        finally:
            app.close()

    def test_policy_shed_is_a_429_that_spends_no_budget(self, obs_on):
        from knn_tpu_torch.serve.server import ServeApp, make_server

        app = ServeApp(_model(), max_batch=8, max_wait_ms=0.0,
                       cost_accounting=True,
                       priority_map={"interactive": 0, "bulk": 2}, **CPU)
        app.admission.capacity = FakeCapacity(headroom=0.2)
        app.admission.eval_ms = app.admission.cooldown_ms = 0.0
        app.warm((1,))
        server = make_server(app)
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://{host}:{port}"

        def post(cls):
            req = urllib.request.Request(
                base + "/predict",
                data=json.dumps({"instances": [[0, 0, 0, 0]],
                                 "class": cls}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read()), dict(r.headers)
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read()), dict(e.headers)

        try:
            st, doc, hdrs = post("bulk")
            assert st == 429 and "shed by admission policy" in doc["error"]
            assert 1 <= int(hdrs["Retry-After"]) <= 30
            st, doc, _ = post("interactive")
            assert st == 200
            burns = app.slo.burn_rates()["availability"]
            assert all(v == 0.0 for v in burns.values())
            assert sum(app.slo.export()["policy_sheds"].values()) >= 1
            with urllib.request.urlopen(base + "/debug/control",
                                        timeout=30) as r:
                ctl = json.loads(r.read())
            assert ctl["enabled"] == {"admission": True, "brownout": False,
                                      "autotune": False}
            assert ctl["admission"]["shed_tiers"] == 1
            assert ctl["degradation_order"] == list(DEGRADATION_ORDER)
        finally:
            server.shutdown()
            server.server_close()
            app.close()


def test_flagless_serve_constructs_nothing_of_the_slice(tmp_path):
    """Every new flag off: no import of control, obs.history or
    obs.alerts, and none of their threads, through a boot with the
    earlier layers on and one served request (a fresh process: this one
    imported them all)."""
    code = (
        "import sys, threading, numpy as np\n"
        "import knn_tpu_torch.cli, knn_tpu_torch.serve.server as srv\n"
        "from knn_tpu_torch.data.dataset import Dataset\n"
        "from knn_tpu_torch.models.knn import KNNClassifier\n"
        "rng = np.random.default_rng(0)\n"
        "m = KNNClassifier(k=3, device='cpu').fit(Dataset(\n"
        "    rng.normal(0, 1, (40, 3)).astype(np.float32),\n"
        "    rng.integers(0, 2, 40).astype(np.int32)))\n"
        "app = srv.ServeApp(m, max_batch=8, cost_accounting=True,\n"
        "                   shadow_rate=0.5, drift_rate=0.5,\n"
        "                   capture_dir=sys.argv[1], device='cpu')\n"
        "app.warm((1,))\n"
        "app.batcher.submit(np.zeros(3, np.float32)).result(timeout=30)\n"
        "h = app.health()\n"
        "assert h['control'] is None and h['history'] is None\n"
        "assert h['alerts'] is None and app.batcher.admission is None\n"
        "names = sorted(t.name for t in threading.enumerate())\n"
        "app.close()\n"
        "mods = sorted(n for n in sys.modules if n.startswith((\n"
        "    'knn_tpu_torch.control', 'knn_tpu_torch.obs.history',\n"
        "    'knn_tpu_torch.obs.alerts', 'knn_tpu_torch.obs.whatif')))\n"
        "print(mods, [n for n in names if n.startswith(('knn-control',\n"
        "    'knn-history', 'knn-alert'))])\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


def _rules_file(tmp_path, actions):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps([{"name": "r", "type": "threshold",
                              "metric": "m", "value": 1,
                              "actions": actions}]))
    return str(p)


class TestCLIValidation:
    @pytest.mark.parametrize("extra", [
        ["--priority", "a=0", "--cost-accounting", "off"],
        ["--priority", "bad", "--cost-accounting", "on"],
        ["--priority", "A=0", "--cost-accounting", "on"],
        ["--priority", "a=x", "--cost-accounting", "on"],
        ["--autotune-interval-s", "0"],
        ["--autotune-interval-s", "5"],
        ["--autotune-interval-s", "5", "--capture-dir", "/tmp/c",
         "--cost-accounting", "off"],
        ["--history-interval-s", "0"],
        ["--history-retention-s", "1", "--history-interval-s", "5"],
        ["--alert-rules", "{missing}"],
        ["--alert-rules", "{notjson}"],
        ["--alert-rules", "{badrule}"],
        ["--alert-rules", "{profile}"],
        ["--alert-rules", "{capture}", "--history-dir", "/tmp/h"],
    ])
    def test_rows_exit_2_with_jax_line(self, tmp_path, capsys, extra):
        (tmp_path / "bad.json").write_text("{not json")
        (tmp_path / "badrule.json").write_text('[{"name": "x"}]')
        files = {
            "missing": str(tmp_path / "nope.json"),
            "notjson": str(tmp_path / "bad.json"),
            "badrule": str(tmp_path / "badrule.json"),
            "profile": _rules_file(tmp_path, [{"do": "profile"}]),
        }
        (tmp_path / "c").mkdir()
        files["capture"] = _rules_file(tmp_path / "c", [{"do": "capture"}])
        extra = [a.format(**files) for a in extra]
        argv = ["serve", "/irrelevant/index", *extra]
        got = run([*argv, "--device", "cpu"], stdout=io.StringIO())
        err = capsys.readouterr().err.strip().splitlines()
        want = jrun([*argv, "--platform=cpu"], stdout=io.StringIO())
        jerr = capsys.readouterr().err.strip().splitlines()
        assert got == want == 2
        assert err[-1] == jerr[-1] and err[-1].startswith("error: ")

    def test_good_values_get_past_the_checks(self, tmp_path, capsys):
        rules = _rules_file(tmp_path, [{"do": "command", "cmd": "true"},
                                       {"do": "capture"}])
        argv = ["serve", "/irrelevant/index", "--cost-accounting", "on",
                "--priority", "interactive=0,batch=1", "--brownout", "on",
                "--shadow-rate", "0.1", "--capture-dir", str(tmp_path),
                "--autotune-interval-s", "3", "--history-dir",
                str(tmp_path / "h"), "--history-interval-s", "1",
                "--history-retention-s", "60", "--alert-rules", rules]
        assert run([*argv, "--device", "cpu"]) == 2
        assert "not found" in capsys.readouterr().err
        assert jrun([*argv, "--platform=cpu"]) == 2
        assert "not found" in capsys.readouterr().err

    def test_brownout_choice_is_refused_by_argparse(self, capsys):
        assert run(["serve", "/irrelevant/index", "--brownout", "maybe"]) == 2
        assert "invalid choice" in capsys.readouterr().err

    def test_banner_names_the_control_plane(self, tmp_path):
        """A boot through the CLI with the slice on prints the priority
        and brownout parts of the banner."""
        from knn_tpu_torch.serve.artifact import save_index

        idx = tmp_path / "idx"
        save_index(_model(), str(idx))
        proc = subprocess.Popen(
            [sys.executable, "-m", "knn_tpu_torch", "serve", str(idx),
             "--port", "0", "--device", "cpu", "--cost-accounting", "on",
             "--priority", "interactive=0,batch=1", "--brownout", "on",
             "--deadline-ms", "50", "--history-dir", str(tmp_path / "h"),
             "--history-interval-s", "1"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        watchdog = threading.Timer(120, proc.kill)  # a hung boot fails
        watchdog.start()
        try:
            line = proc.stdout.readline()
        finally:
            watchdog.cancel()
            proc.terminate()
            proc.wait(timeout=60)
        assert "priority=batch:1/interactive:0" in line, line
        assert "brownout=deadline_tighten" in line, line


def test_slice_leaves_jax_and_knn_tpu_out(tmp_path):
    """The slice's modules, a serve with every new flag on, and the
    ``history``/``report`` subcommands over its directory, in a fresh
    process: neither ``jax`` nor ``knn_tpu`` is imported."""
    code = (
        "import io, os, sys, numpy as np\n"
        "import knn_tpu_torch.control, knn_tpu_torch.control.admission\n"
        "import knn_tpu_torch.control.brownout, knn_tpu_torch.control.autotune\n"
        "import knn_tpu_torch.control.autoscale, knn_tpu_torch.obs.regress\n"
        "import knn_tpu_torch.obs.whatif, knn_tpu_torch.obs.history\n"
        "import knn_tpu_torch.obs.alerts, knn_tpu_torch.obs.report\n"
        "from knn_tpu_torch import cli\n"
        "from knn_tpu_torch.data.dataset import Dataset\n"
        "from knn_tpu_torch.models.knn import KNNClassifier\n"
        "from knn_tpu_torch.obs.alerts import parse_rules\n"
        "from knn_tpu_torch.serve.server import ServeApp\n"
        "d = sys.argv[1]\n"
        "rng = np.random.default_rng(0)\n"
        "m = KNNClassifier(k=3, device='cpu').fit(Dataset(\n"
        "    rng.normal(0, 1, (40, 3)).astype(np.float32),\n"
        "    rng.integers(0, 2, 40).astype(np.int32)))\n"
        "rules = parse_rules([{'name': 'r', 'type': 'absence',\n"
        "                      'metric': 'nothing', 'actions': [\n"
        "                          {'do': 'command', 'cmd': 'true'}]}])\n"
        "app = ServeApp(m, max_batch=8, cost_accounting=True,\n"
        "               shadow_rate=0.5, capture_dir=os.path.join(d, 'c'),\n"
        "               priority_map={'interactive': 0, 'bulk': 1},\n"
        "               brownout=True, autotune_interval_s=3600.0,\n"
        "               history_dir=os.path.join(d, 'h'),\n"
        "               history_interval_s=60.0, alert_rules=rules,\n"
        "               device='cpu')\n"
        "app.warm((1,))\n"
        "app.batcher.submit(np.zeros(3, np.float32)).result(timeout=30)\n"
        "app.history.sample_once()\n"
        "app.alerts.drain_actions()\n"
        "app.close()\n"
        "out = io.StringIO()\n"
        "assert cli.run(['history', os.path.join(d, 'h'), '--json'],\n"
        "               stdout=out) == 0\n"
        "assert cli.run(['report', '--history', os.path.join(d, 'h')],\n"
        "               stdout=out) == 0\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
