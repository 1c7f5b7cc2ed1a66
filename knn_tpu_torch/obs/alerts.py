"""Declarative alert rules evaluated on the history-snapshot cadence (the
port's copy of ``knn_tpu/obs/alerts.py``).

``--alert-rules rules.json`` loads a list of rules; each is a small
state machine with hysteresis::

    ok --cond--> pending --held for `for_s`--> FIRING
    firing --!cond--> resolving --held for `resolve_for_s`--> ok

A condition flap while resolving snaps back to firing without emitting a
second fire event — the fire/resolve audit pair is the unit operators
reason about, so it must not chatter.

Rule types:

* ``threshold`` — instantaneous comparison against a metric (counters
  and gauges compare their value; histograms compare their observation
  count). When several series match the metric+label selector the most
  alarming one decides (max for ``>``/``>=``, min for ``<``/``<=``).
* ``burn_rate`` — multi-window SLO burn (obs/slo.py): fires when the
  burn exceeds ``threshold`` in EVERY listed window simultaneously (the
  SRE-workbook multi-window guard against blips).
* ``absence`` — the selector matches nothing: the signal you depend on
  stopped being exported at all.
* ``derivative`` — rate of change per second over a trailing
  ``window_s``, computed from the recorder's ring.

Fires and resolves are **typed events**: a bounded in-memory audit ring,
a line-buffered ``alerts.jsonl`` under the history dir, optional fleet
event-log entries, and ``knn_alerts_*`` instruments. Optional per-rule
``actions`` close the forensics loop with machinery that already exists:

* ``capture``  — arm a workload-capture window (obs/workload.py),
* ``profile``  — grab a blocking device-profile capture (obs/devprof.py),
* ``command``  — run an operator hook, same audited off-thread contract
  as the autoscaler's ``--scale-cmd`` (argv + event + alert name,
  checked exit, hard timeout, output discarded).

Actions run off the evaluating thread so evaluation (and the history
sampling thread driving it) never blocks on a capture, a profile sleep,
or a slow subprocess. Each rule's actions go through ONE queue, run in
event order by one thread at a time (started when work arrives, gone
when the queue is empty), so a rule's ``fire`` actions are audited
before its ``resolve`` actions whatever the host's load. (JAX starts a
thread per event, so its audit order is the order the child processes
exit.) Every action outcome is audited, including raises — a broken
action must never take down serving.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from knn_tpu_torch import obs
from knn_tpu_torch.obs import history as history_mod
from knn_tpu_torch.resilience.errors import DataError

RULE_TYPES = ("threshold", "burn_rate", "absence", "derivative")
ACTION_KINDS = ("capture", "profile", "command")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_AUDIT_RING = 256


def _req(rule: dict, field: str, where: str):
    if field not in rule:
        raise DataError(f"alert rule {where}: missing required field {field!r}")
    return rule[field]


def _num(value, field: str, where: str, *, positive=False) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise DataError(f"alert rule {where}: {field} must be a number")
    v = float(value)
    if positive and not v > 0:
        raise DataError(f"alert rule {where}: {field} must be > 0")
    return v


def parse_rules(doc) -> List[dict]:
    """Validate and normalize a rules document (either ``[rule, ...]`` or
    ``{"rules": [rule, ...]}``). Raises typed ``DataError`` on any shape
    problem so the CLI can map it to exit 2 before anything boots."""
    if isinstance(doc, dict):
        doc = doc.get("rules")
    if not isinstance(doc, list) or not doc:
        raise DataError("alert rules: want a non-empty list of rule objects")
    out: List[dict] = []
    seen = set()
    for i, raw in enumerate(doc):
        where = f"#{i}"
        if not isinstance(raw, dict):
            raise DataError(f"alert rule {where}: not an object")
        name = _req(raw, "name", where)
        if not isinstance(name, str) or not name.strip():
            raise DataError(f"alert rule {where}: name must be a non-empty string")
        name = name.strip()
        where = name
        if name in seen:
            raise DataError(f"alert rule {name!r}: duplicate name")
        seen.add(name)
        rtype = _req(raw, "type", where)
        if rtype not in RULE_TYPES:
            raise DataError(
                f"alert rule {name!r}: unknown type {rtype!r} "
                f"(want one of {', '.join(RULE_TYPES)})")
        rule = {"name": name, "type": rtype,
                "severity": str(raw.get("severity", "page")),
                "for_s": 0.0, "resolve_for_s": 0.0}
        if "for_s" in raw:
            rule["for_s"] = _num(raw["for_s"], "for_s", where)
            if rule["for_s"] < 0:
                raise DataError(f"alert rule {name!r}: for_s must be >= 0")
        rule["resolve_for_s"] = rule["for_s"]
        if "resolve_for_s" in raw:
            rule["resolve_for_s"] = _num(raw["resolve_for_s"],
                                         "resolve_for_s", where)
            if rule["resolve_for_s"] < 0:
                raise DataError(
                    f"alert rule {name!r}: resolve_for_s must be >= 0")
        labels = raw.get("labels", {})
        if not isinstance(labels, dict):
            raise DataError(f"alert rule {name!r}: labels must be an object")
        rule["labels"] = {str(k): str(v) for k, v in labels.items()}

        if rtype == "threshold" or rtype == "derivative":
            metric = _req(raw, "metric", where)
            if not isinstance(metric, str) or not metric:
                raise DataError(f"alert rule {name!r}: metric must be a string")
            rule["metric"] = metric
            op = raw.get("op", ">")
            if op not in _OPS:
                raise DataError(
                    f"alert rule {name!r}: op {op!r} not in {sorted(_OPS)}")
            rule["op"] = op
            rule["value"] = _num(_req(raw, "value", where), "value", where)
            if rtype == "derivative":
                rule["window_s"] = _num(_req(raw, "window_s", where),
                                        "window_s", where, positive=True)
        elif rtype == "burn_rate":
            rule["objective"] = str(raw.get("objective", "availability"))
            rule["threshold"] = _num(_req(raw, "threshold", where),
                                     "threshold", where, positive=True)
            windows = raw.get("windows")
            if windows is not None:
                if (not isinstance(windows, list) or not windows
                        or not all(isinstance(w, str) for w in windows)):
                    raise DataError(
                        f"alert rule {name!r}: windows must be a non-empty "
                        "list of window labels (e.g. [\"5m\", \"1h\"])")
            rule["windows"] = windows
        elif rtype == "absence":
            metric = _req(raw, "metric", where)
            if not isinstance(metric, str) or not metric:
                raise DataError(f"alert rule {name!r}: metric must be a string")
            rule["metric"] = metric

        actions_raw = raw.get("actions", [])
        if not isinstance(actions_raw, list):
            raise DataError(f"alert rule {name!r}: actions must be a list")
        actions = []
        for j, act in enumerate(actions_raw):
            if not isinstance(act, dict):
                raise DataError(f"alert rule {name!r}: action #{j} not an object")
            do = act.get("do")
            if do not in ACTION_KINDS:
                raise DataError(
                    f"alert rule {name!r}: action #{j} do={do!r} "
                    f"(want one of {', '.join(ACTION_KINDS)})")
            norm = {"do": do}
            if do == "capture":
                if "window_s" in act:
                    norm["window_s"] = _num(act["window_s"], "window_s",
                                            where, positive=True)
                if "max_requests" in act:
                    mr = act["max_requests"]
                    if isinstance(mr, bool) or not isinstance(mr, int) or mr <= 0:
                        raise DataError(
                            f"alert rule {name!r}: max_requests must be "
                            "a positive integer")
                    norm["max_requests"] = mr
                if "window_s" not in norm and "max_requests" not in norm:
                    norm["window_s"] = 10.0
            elif do == "profile":
                norm["ms"] = _num(act.get("ms", 200), "ms", where, positive=True)
            elif do == "command":
                cmd = act.get("cmd")
                if not isinstance(cmd, str) or not cmd.strip():
                    raise DataError(
                        f"alert rule {name!r}: command action needs a "
                        "non-empty cmd string")
                norm["cmd"] = cmd.strip()
            actions.append(norm)
        rule["actions"] = actions
        out.append(rule)
    return out


def load_rules(path: str) -> List[dict]:
    """Read + parse a rules file; all failures are ``DataError`` (exit 2)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as exc:
        raise DataError(f"--alert-rules {path}: {exc}")
    except ValueError as exc:
        raise DataError(f"--alert-rules {path}: not valid JSON: {exc}")
    return parse_rules(doc)


class AlertEngine:
    """Evaluates rules against recorder samples; owns the audit trail."""

    def __init__(self, rules: List[dict], *,
                 slo=None, workload=None, recorder=None, events=None,
                 history_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 command_timeout_s: float = 10.0):
        # Environment validation up front: a rule that can never run its
        # action (or never evaluate) is a boot-time config error, not a
        # 3am surprise.
        for rule in rules:
            if rule["type"] == "burn_rate" and slo is None:
                raise DataError(
                    f"alert rule {rule['name']!r}: burn_rate rules need the "
                    "SLO tracker (serve only; routers have no request SLOs)")
            for act in rule["actions"]:
                if act["do"] == "capture" and workload is None:
                    raise DataError(
                        f"alert rule {rule['name']!r}: capture action "
                        "requires --capture-dir")
                if act["do"] == "profile" and history_dir is None:
                    raise DataError(
                        f"alert rule {rule['name']!r}: profile action "
                        "requires --history-dir (profiles land there)")
        self.rules = rules
        self.slo = slo
        self.workload = workload
        self.recorder = recorder
        self.events = events
        self.history_dir = history_dir
        self.clock = clock
        self.command_timeout_s = float(command_timeout_s)

        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=_AUDIT_RING)
        # One action queue per rule, created at its first dispatch.
        self._queues: Dict[str, _ActionQueue] = {}
        self._state: Dict[str, dict] = {
            r["name"]: {"phase": "ok", "since": None, "value": None,
                        "last_fire": None, "last_resolve": None, "fires": 0}
            for r in rules}
        self.audit_path = None
        self._audit_file = None
        if history_dir is not None:
            os.makedirs(history_dir, exist_ok=True)
            self.audit_path = os.path.join(history_dir, "alerts.jsonl")
            self._audit_file = open(self.audit_path, "a", buffering=1,
                                    encoding="utf-8")
        for rule in rules:
            obs.gauge_set("knn_alerts_firing", 0, alert=rule["name"],
                          help="1 while the named alert is firing.")

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, ts: float, view) -> None:
        """One evaluation pass at time ``ts`` against ``view`` (a
        HistoryRecorder — or anything with ``latest()``/``samples()``).
        Called from the recorder's ``on_sample`` hook; an injectable
        clock plus a manual ``sample_once`` makes this fully
        deterministic in tests."""
        latest = view.latest()
        state = latest[1] if latest is not None else {}
        for rule in self.rules:
            try:
                cond, value = self._eval_rule(rule, ts, state, view)
            except Exception as exc:
                self._audit({"ts": round(ts, 3), "alert": rule["name"],
                             "event": "eval-error", "error": repr(exc)})
                continue
            self._transition(rule, ts, cond, value)

    def _eval_rule(self, rule, ts, state, view):
        rtype = rule["type"]
        if rtype == "burn_rate":
            burns = self.slo.burn_rates()
            per_window = burns.get(rule["objective"], {})
            windows = rule["windows"] or sorted(per_window)
            if not windows:
                return False, None
            vals = [per_window.get(w) for w in windows]
            if any(v is None for v in vals):
                raise ValueError(
                    f"objective {rule['objective']!r} has no window(s) "
                    f"{[w for w, v in zip(windows, vals) if v is None]}")
            # Multi-window AND: every window must burn past the threshold.
            return min(vals) > rule["threshold"], max(vals)
        matches = [e for e in state.values()
                   if e[1] == rule["metric"]
                   and all(e[2].get(k) == v for k, v in rule["labels"].items())]
        if rtype == "absence":
            return not matches, float(len(matches))
        if not matches:
            return False, None  # no data: threshold/derivative rules stay ok
        values = [history_mod._value_of(e) for e in matches]
        agg = max(values) if rule["op"] in (">", ">=") else min(values)
        if rtype == "threshold":
            return _OPS[rule["op"]](agg, rule["value"]), agg
        # derivative: rate vs the newest sample at least window_s old.
        past = None
        for s_ts, s_state in reversed(view.samples()):
            if s_ts <= ts - rule["window_s"]:
                past = (s_ts, s_state)
                break
        if past is None:
            return False, None  # not enough history yet
        old = [history_mod._value_of(e) for e in past[1].values()
               if e[1] == rule["metric"]
               and all(e[2].get(k) == v for k, v in rule["labels"].items())]
        if not old:
            return False, None
        old_agg = max(old) if rule["op"] in (">", ">=") else min(old)
        rate = (agg - old_agg) / max(ts - past[0], 1e-9)
        return _OPS[rule["op"]](rate, rule["value"]), rate

    def _transition(self, rule, ts, cond, value) -> None:
        st = self._state[rule["name"]]
        st["value"] = value
        phase = st["phase"]
        if phase in ("ok", "pending"):
            if cond:
                if phase == "ok":
                    st["phase"], st["since"] = "pending", ts
                if ts - st["since"] >= rule["for_s"]:
                    self._fire(rule, ts, value)
            else:
                st["phase"], st["since"] = "ok", None
        else:  # firing | resolving
            if cond:
                # Flap while resolving: back to firing, NO second event.
                st["phase"], st["since"] = "firing", None
            else:
                if phase == "firing":
                    st["phase"], st["since"] = "resolving", ts
                if ts - st["since"] >= rule["resolve_for_s"]:
                    self._resolve(rule, ts, value)

    def _fire(self, rule, ts, value) -> None:
        st = self._state[rule["name"]]
        st.update(phase="firing", since=None, last_fire=ts)
        st["fires"] += 1
        self._emit(rule, "fire", ts, value)
        obs.gauge_set("knn_alerts_firing", 1, alert=rule["name"],
                      help="1 while the named alert is firing.")
        self._dispatch(rule, "fire", ts)

    def _resolve(self, rule, ts, value) -> None:
        st = self._state[rule["name"]]
        st.update(phase="ok", since=None, last_resolve=ts)
        self._emit(rule, "resolve", ts, value)
        obs.gauge_set("knn_alerts_firing", 0, alert=rule["name"],
                      help="1 while the named alert is firing.")
        self._dispatch(rule, "resolve", ts)

    def _emit(self, rule, event, ts, value) -> None:
        obs.counter_add("knn_alerts_transitions_total", alert=rule["name"],
                        event=event, help="Alert fire/resolve transitions.")
        entry = {"ts": round(ts, 3), "alert": rule["name"], "event": event,
                 "severity": rule["severity"], "type": rule["type"],
                 "value": None if value is None else round(float(value), 6)}
        if event == "fire" and rule["actions"]:
            entry["actions"] = [a["do"] for a in rule["actions"]]
        self._audit(entry)
        if self.events is not None:
            try:
                self.events.emit(f"alert-{event}", alert=rule["name"],
                                 severity=rule["severity"],
                                 value=entry["value"])
            except Exception:
                pass

    # -- actions -------------------------------------------------------------

    def _dispatch(self, rule, event, ts) -> None:
        todo = [a for a in rule["actions"]
                if event == "fire" or a["do"] == "command"]
        dump_forensics = (event == "fire" and self.recorder is not None
                          and self.history_dir is not None)
        if not todo and not dump_forensics:
            return
        with self._lock:
            q = self._queues.get(rule["name"])
            if q is None:
                q = self._queues[rule["name"]] = _ActionQueue(
                    f"knn-alert-action-{rule['name']}", self._run_actions)
        q.put((rule, event, ts, todo, dump_forensics))

    def _run_actions(self, rule, event, ts, todo, dump_forensics) -> None:
        if dump_forensics:
            try:
                self._dump_forensics(rule, ts)
            except Exception as exc:
                self._audit_action(rule, event, ts, "forensics",
                                   f"error: {exc!r}")
        for act in todo:
            try:
                detail = self._run_action(rule, event, ts, act)
                outcome = "ok"
            except Exception as exc:
                detail, outcome = f"{exc!r}", "error"
            obs.counter_add("knn_alerts_actions_total", action=act["do"],
                            outcome=outcome,
                            help="Alert action dispatches by outcome.")
            self._audit_action(rule, event, ts, act["do"],
                               outcome if outcome == "ok" else
                               f"{outcome}: {detail}", detail=detail)

    def _run_action(self, rule, event, ts, act) -> str:
        if act["do"] == "capture":
            self.workload.start(reason=f"alert:{rule['name']}",
                                window_s=act.get("window_s"),
                                max_requests=act.get("max_requests"))
            return "armed"
        if act["do"] == "profile":
            from knn_tpu_torch.obs import devprof
            trace = devprof.capture_for(act["ms"])
            pdir = os.path.join(self.history_dir, "profiles")
            os.makedirs(pdir, exist_ok=True)
            path = os.path.join(
                pdir, f"profile-{rule['name']}-{int(ts * 1000)}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(trace, f)
            return path
        # command: same audited contract as the autoscaler's --scale-cmd —
        # argv-split hook + event + alert name, checked exit, hard
        # timeout, output discarded (the hook owns its own logging).
        argv = [*act["cmd"].split(), event, rule["name"]]
        subprocess.run(argv, check=True, timeout=self.command_timeout_s,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return " ".join(argv)

    def _dump_forensics(self, rule, ts) -> None:
        """Freeze the flight recorder's slowest-K at fire time — by the
        time a human looks, the reservoir has moved on."""
        fdir = os.path.join(self.history_dir, "forensics")
        os.makedirs(fdir, exist_ok=True)
        path = os.path.join(
            fdir, f"slowest-{rule['name']}-{int(ts * 1000)}.json")
        doc = {"alert": rule["name"], "ts": round(ts, 3),
               "slowest": self.recorder.slowest()}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        self._audit_action(rule, "fire", ts, "forensics", "ok", detail=path)

    def _audit_action(self, rule, event, ts, action, outcome,
                      detail=None) -> None:
        entry = {"ts": round(ts, 3), "alert": rule["name"], "event": "action",
                 "on": event, "action": action, "outcome": outcome}
        if detail is not None:
            entry["detail"] = str(detail)[:500]
        self._audit(entry)

    def _audit(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)
            if self._audit_file is not None:
                try:
                    self._audit_file.write(
                        json.dumps(entry, separators=(",", ":")) + "\n")
                except (OSError, ValueError):
                    pass

    # -- introspection -------------------------------------------------------

    def export(self) -> dict:
        with self._lock:
            recent = list(self._ring)[-50:]
        rules = []
        for rule in self.rules:
            st = self._state[rule["name"]]
            rules.append({
                "name": rule["name"], "type": rule["type"],
                "severity": rule["severity"], "state": st["phase"],
                "for_s": rule["for_s"], "resolve_for_s": rule["resolve_for_s"],
                "value": st["value"], "fires": st["fires"],
                "last_fire": st["last_fire"],
                "last_resolve": st["last_resolve"],
                "actions": [a["do"] for a in rule["actions"]],
            })
        return {"rules": rules,
                "firing": [r["name"] for r in rules
                           if r["state"] in ("firing", "resolving")],
                "recent": recent, "audit_path": self.audit_path}

    def drain_actions(self, timeout_s: float = 5.0) -> bool:
        """Wait until every dispatched action has run (tests + orderly
        shutdown). Returns whether they all did within ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            queues = list(self._queues.values())
        return all([q.drain(deadline) for q in queues])

    def close(self) -> None:
        self.drain_actions()
        with self._lock:
            if self._audit_file is not None:
                try:
                    self._audit_file.close()
                except OSError:
                    pass
                self._audit_file = None


class _ActionQueue:
    """One rule's pending action batches, run in the order they were put
    by at most one thread at a time. The thread starts when an item
    arrives at an idle queue and ends when the queue is empty, so an
    engine whose rules never fire holds no thread."""

    def __init__(self, thread_name: str,
                 run: Callable[..., None]):
        self._thread_name = thread_name
        self._run = run
        self._cond = threading.Condition()
        self._items: deque = deque()
        self._pending = 0  # queued + running
        self._worker: Optional[threading.Thread] = None

    def put(self, item: Tuple) -> None:
        with self._cond:
            self._items.append(item)
            self._pending += 1
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._loop, name=self._thread_name, daemon=True)
                self._worker.start()

    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._items:
                    self._worker = None
                    return
                item = self._items.popleft()
            try:
                self._run(*item)
            except Exception:  # noqa: BLE001 — _run audits per action;
                pass           # the queue must outlive any one batch
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def drain(self, deadline: float) -> bool:
        with self._cond:
            while self._pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True
