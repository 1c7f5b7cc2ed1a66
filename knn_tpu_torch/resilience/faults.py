"""Deterministic, seeded fault injection (the port's copy of
``knn_tpu/resilience/faults.py``: the same points, plan syntax, environment
variables and seeded replay, so a chaos command line works on either CLI).

Named *fault points* sit at the production call sites; a *fault plan* arms
them from a test or from the environment. With no plan armed,
:func:`fault_point` is one module-global ``None`` check.

Fault points (the registry is closed — a plan naming an unknown point is an
error, so typos fail loudly). The port's classify path reaches these:

==================  =========================================================
``arff.parse``      dataset load/parse (``knn_tpu_torch/data/arff.py``)
``device.put``      host->device transfer and the copy back (backends,
                    model retrieval core)
``backend.compile`` kernel build and launch (the same call sites)
``native.load``     native C++ library load/call (arff + runtime kernels)
==================  =========================================================

The others keep the JAX package's names: ``collective.step`` and
``multihost.init`` (multi-device), ``serve.dispatch`` (serving),
``mutable.compact`` (the mutable tier), and ``fleet.forward``,
``fleet.wal_ship`` and ``fleet.snapshot_ship`` (the fleet: one router
forward, one WAL shipment, the snapshot install before its commit).

Fault-plan syntax (``KNN_TPU_FAULTS`` env var or :func:`inject`):

    point=mode[:kind][,point=mode[:kind]...]

``mode``: ``once`` (fail the first activation, then succeed), ``always``,
an integer ``N`` (fail the first N activations), or ``pF`` (e.g. ``p0.3``
— fail each activation with probability F, drawn from a ``random.Random``
seeded by ``KNN_TPU_FAULT_SEED``/the ``seed`` argument, so a given plan +
seed replays the identical fault sequence).

``kind`` overrides the raised error class: ``oom`` (DeviceError with
``oom=True``), ``data``, ``compile``, ``device``, ``collective``,
``worker``, ``io`` (OSError — exercises the raw-exception classification
path). Default is the point's natural class.

Example::

    KNN_TPU_FAULTS="device.put=once" python -m knn_tpu_torch train.arff test.arff 5
    with faults.inject("backend.compile=always"): ...

Every triggered fault increments ``knn_fault_injected_total{point,kind}``
through :mod:`knn_tpu_torch.obs` (when enabled) and is marked with
``fault_point=<name>`` on the raised error.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
from typing import Dict, Optional

from knn_tpu_torch.resilience.errors import (
    CollectiveError,
    CompileError,
    DataError,
    DeviceError,
    WorkerLostError,
)

FAULT_ENV = "KNN_TPU_FAULTS"
SEED_ENV = "KNN_TPU_FAULT_SEED"

#: point name -> default error kind
FAULT_POINTS: Dict[str, str] = {
    "arff.parse": "data",
    "device.put": "device",
    "backend.compile": "compile",
    "collective.step": "collective",
    "multihost.init": "worker",
    "native.load": "io",
    "serve.dispatch": "device",
    # The mutable tier's compaction, between its warmup and its swap.
    "mutable.compact": "device",
    # One router->replica HTTP forward.
    "fleet.forward": "io",
    # One primary->follower WAL shipment.
    "fleet.wal_ship": "io",
    # The snapshot bootstrap install path, before its commit.
    "fleet.snapshot_ship": "io",
}

_KINDS = ("data", "compile", "device", "collective", "worker", "io", "oom")


def _make_error(point: str, kind: str):
    msg = f"injected fault at {point} ({kind})"
    if kind == "data":
        return DataError(msg, fault_point=point)
    if kind == "compile":
        return CompileError(msg, fault_point=point)
    if kind == "device":
        return DeviceError(msg, transient=True, fault_point=point)
    if kind == "oom":
        return DeviceError(msg, oom=True, fault_point=point)
    if kind == "collective":
        return CollectiveError(msg, fault_point=point)
    if kind == "worker":
        return WorkerLostError(msg, reason="injected", fault_point=point)
    if kind == "io":
        # Raw OSError on purpose: exercises classify_exception / the
        # pre-existing ``except OSError`` degradation paths.
        return OSError(msg)
    raise ValueError(f"unknown fault kind {kind!r}")


class _Rule:
    """One armed fault point: mode state + error kind. ``fire()`` is
    called under the plan lock, so the countdown is race-free."""

    __slots__ = ("point", "kind", "remaining", "prob", "fired", "activations")

    def __init__(self, point: str, mode: str, kind: Optional[str]):
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: "
                f"{sorted(FAULT_POINTS)}"
            )
        kind = kind or FAULT_POINTS[point]
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; known: {sorted(_KINDS)}"
            )
        self.point = point
        self.kind = kind
        self.remaining: Optional[int] = None  # None = unbounded (always/p)
        self.prob: Optional[float] = None
        self.fired = 0
        self.activations = 0
        if mode == "once":
            self.remaining = 1
        elif mode == "always":
            pass
        elif mode.startswith("p"):
            try:
                self.prob = float(mode[1:])
            except ValueError:
                raise ValueError(f"bad probabilistic mode {mode!r}") from None
            if not (0.0 <= self.prob <= 1.0):
                raise ValueError(f"fault probability {self.prob} not in [0, 1]")
        else:
            try:
                self.remaining = int(mode)
            except ValueError:
                raise ValueError(
                    f"bad fault mode {mode!r}; want once|always|<int>|p<float>"
                ) from None
            if self.remaining < 0:
                raise ValueError(f"fault count must be >= 0, got {self.remaining}")

    def fire(self, rng: random.Random) -> bool:
        self.activations += 1
        if self.prob is not None:
            hit = rng.random() < self.prob
        elif self.remaining is None:
            hit = True
        elif self.remaining > 0:
            self.remaining -= 1
            hit = True
        else:
            hit = False
        if hit:
            self.fired += 1
        return hit


class FaultPlan:
    """A parsed fault plan. Construct from a spec string; arm with
    :func:`install` / :func:`inject` (or the env var at import)."""

    def __init__(self, spec: str, seed: Optional[int] = None):
        self.spec = spec
        self.from_env = False  # set by install_from_env; gates auto-disarm
        if seed is None:
            seed = int(os.environ.get(SEED_ENV, "0") or "0")
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: Dict[str, _Rule] = {}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad fault rule {part!r}; want point=mode[:kind]"
                )
            point, _, rhs = part.partition("=")
            mode, _, kind = rhs.partition(":")
            self._rules[point.strip()] = _Rule(
                point.strip(), mode.strip(), kind.strip() or None
            )

    def check(self, point: str):
        """Return the error to raise at ``point``, or None. Mutates rule
        state; callers hold the plan lock."""
        rule = self._rules.get(point)
        if rule is None or not rule.fire(self._rng):
            return None
        return rule.kind, _make_error(point, rule.kind)

    def stats(self) -> Dict[str, Dict[str, int]]:
        """{point: {fired, activations}} — for tests and post-run reports."""
        return {
            p: {"fired": r.fired, "activations": r.activations}
            for p, r in self._rules.items()
        }


_lock = threading.Lock()
_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def install(plan: Optional[FaultPlan]) -> None:
    """Arm ``plan`` globally (None disarms)."""
    global _ACTIVE
    with _lock:
        _ACTIVE = plan


def install_from_env(strict: bool = True) -> Optional[FaultPlan]:
    """(Re-)read ``KNN_TPU_FAULTS`` and arm the described plan. Called at
    import and again by the CLI entry, so env-driven chaos runs work both
    as subprocesses and in-process.

    When the var is unset/empty, only a plan that *itself came from the
    env* is disarmed — a plan armed programmatically via :func:`inject` /
    :func:`install` stays, so ``cli.run()`` inside an ``inject`` block
    still sees the context-managed faults.

    ``strict=False`` downgrades a malformed spec to a ``RuntimeWarning``
    (and disarms): at import time a typo'd env var must not make the whole
    library unimportable. Strict callers (the CLI) turn the ValueError
    into their one-line usage error instead.
    """
    global _ACTIVE
    spec = os.environ.get(FAULT_ENV, "")
    if not spec:
        with _lock:
            if _ACTIVE is not None and _ACTIVE.from_env:
                _ACTIVE = None
        return _ACTIVE
    try:
        plan = FaultPlan(spec)
    except ValueError:
        if strict:
            raise
        import warnings

        warnings.warn(
            f"ignoring malformed {FAULT_ENV}={spec!r} (fault injection "
            f"disarmed)", RuntimeWarning, stacklevel=2,
        )
        install(None)
        return None
    plan.from_env = True
    install(plan)
    return plan


@contextlib.contextmanager
def inject(spec: str, seed: Optional[int] = None):
    """Context manager arming a fault plan for the enclosed block::

        with faults.inject("device.put=once"):
            model.predict(test)  # first transfer fails, retry recovers

    Yields the :class:`FaultPlan` (read ``plan.stats()`` afterwards to
    assert the fault actually fired). Restores the previously armed plan
    on exit."""
    plan = FaultPlan(spec, seed=seed)
    with _lock:
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = plan
    try:
        yield plan
    finally:
        with _lock:
            _ACTIVE = prev


def fault_point(name: str) -> None:
    """Production-side marker: raise the armed fault for ``name``, if any.

    The disarmed path is one global ``None`` check. Unknown names raise
    even when disarmed-at-call-time plans exist — but only under an armed
    plan (checking the registry unconditionally would put a dict lookup on
    the hot path); tests cover every marker, so typos surface in tier-1.
    """
    plan = _ACTIVE
    if plan is None:
        return
    with _lock:
        if name not in FAULT_POINTS:
            raise ValueError(f"fault_point({name!r}) is not a registered point")
        hit = plan.check(name)
    if hit is None:
        return
    kind, err = hit
    from knn_tpu_torch import obs

    obs.counter_add(
        "knn_fault_injected_total",
        help="faults triggered by the injection harness",
        point=name, kind=kind,
    )
    raise err


# Arm from the environment at import: `KNN_TPU_FAULTS=... python -m
# knn_tpu_torch ...` works with no code cooperation beyond the markers.
# Non-strict: a typo'd env var warns and disarms rather than making the
# import raise.
install_from_env(strict=False)
