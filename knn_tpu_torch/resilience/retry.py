"""Retry with exponential backoff and deadlines (the port's copy of
``knn_tpu/resilience/retry.py``, with the same environment knobs).

The transfer/compile/collective call sites wrap their device work in
:func:`guarded_call`, which composes the three resilience primitives in
the right order:

1. :func:`knn_tpu_torch.resilience.faults.fault_point` — the injection marker
   (first, so a planned fault replaces the real call);
2. the real call, with raw exceptions classified into the typed taxonomy
   (:func:`knn_tpu_torch.resilience.errors.classify_exception`);
3. retry: transient failures re-attempt with exponential backoff
   (``base * 2**attempt``, capped) until the attempt budget or the
   deadline runs out. Non-transient failures (malformed data, OOM)
   propagate immediately — the degradation ladder, not the retry loop,
   owns those.

Every re-attempt increments ``knn_retry_total{site=...}`` and opens a
``retry`` span through :mod:`knn_tpu_torch.obs` (no-ops while obs is off).

Backoff timing is env-tunable so the chaos suite runs at full speed:
``KNN_TPU_RETRY_BASE_MS`` (default 25), ``KNN_TPU_RETRY_MAX_MS`` (default
2000), ``KNN_TPU_RETRY_ATTEMPTS`` (default 3 total attempts),
``KNN_TPU_RETRY_DEADLINE_MS`` (default none). Tests set the base to 0.

``KNN_TPU_RETRY_JITTER`` (default **off**) multiplies each backoff sleep
by a uniform draw from ``[0.5, 1.0]`` — enough spread to de-synchronize
the serving process's concurrent handler threads (a fault that fails N
threads at once would otherwise have all N re-attempt in lockstep, an
in-process retry storm), while staying below the deterministic schedule so
the ``max_ms`` cap and deadline arithmetic keep holding. It defaults off
because the chaos suite replays fault plans deterministically and jittered
sleeps would vary the interleaving; when on, the draw sequence comes from
a PRNG seeded by ``KNN_TPU_FAULT_SEED`` (the fault harness's seed), so a
single-threaded replay is still reproducible.
"""

from __future__ import annotations

import errno
import os
import random
import threading
import time
from typing import Callable, Optional, TypeVar

from knn_tpu_torch import obs
from knn_tpu_torch.resilience import faults
from knn_tpu_torch.resilience.errors import ResilienceError, classify_exception

T = TypeVar("T")

_BASE_ENV = "KNN_TPU_RETRY_BASE_MS"
_MAX_ENV = "KNN_TPU_RETRY_MAX_MS"
_ATTEMPTS_ENV = "KNN_TPU_RETRY_ATTEMPTS"
_DEADLINE_ENV = "KNN_TPU_RETRY_DEADLINE_MS"
_JITTER_ENV = "KNN_TPU_RETRY_JITTER"

# Jitter PRNG: one shared, lock-protected stream so concurrent handler
# threads draw DIFFERENT values (that difference is the whole point —
# per-call reseeding would hand every thread the identical first draw and
# re-synchronize the storm). Seeded lazily from KNN_TPU_FAULT_SEED.
_jitter_lock = threading.Lock()
_jitter_rng: Optional[random.Random] = None


def jitter_enabled() -> bool:
    return os.environ.get(_JITTER_ENV, "") not in ("", "0", "off", "false")


def _seed_from_env() -> int:
    return int(os.environ.get(faults.SEED_ENV, "0") or "0")


def reset_jitter(seed: Optional[int] = None) -> None:
    """(Re-)seed the jitter stream — tests use this to pin replay
    determinism; ``None`` re-reads ``KNN_TPU_FAULT_SEED``."""
    global _jitter_rng
    with _jitter_lock:
        _jitter_rng = random.Random(
            seed if seed is not None else _seed_from_env()
        )


def apply_jitter(sleep_ms: float) -> float:
    """One seeded draw: ``sleep_ms * U[0.5, 1.0]``. Bounded below at half
    the deterministic sleep (backoff must keep backing off) and above at
    the deterministic value (the ``max_ms`` cap and the caller's deadline
    check stay valid)."""
    global _jitter_rng
    with _jitter_lock:
        if _jitter_rng is None:
            _jitter_rng = random.Random(_seed_from_env())
        u = _jitter_rng.random()
    return sleep_ms * (0.5 + 0.5 * u)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def retry_schedule() -> "list[float]":
    """The environment's retry budget as :func:`guarded_call` reads it: the
    sleep (ms) before each re-attempt, one entry fewer than the attempts.
    For a caller that runs its own attempt loop (the serving batcher, which
    checks deadlines between attempts)."""
    attempts = max(1, int(_env_float(_ATTEMPTS_ENV, 3)))
    return backoff_schedule(attempts, _env_float(_BASE_ENV, 25.0),
                            _env_float(_MAX_ENV, 2000.0))


def backoff_schedule(
    attempts: int, base_ms: float, max_ms: float,
) -> "list[float]":
    """Sleep (ms) before re-attempt i (i = 1..attempts-1): capped binary
    exponential. Deterministic — no jitter — so chaos tests replay
    identically; the single-process CLI has no thundering-herd peer to
    de-synchronize from."""
    return [min(base_ms * (2.0 ** i), max_ms) for i in range(attempts - 1)]


# errno values that are deterministic facts about the filesystem, not
# blips: retrying a missing path re-stats the same absence.
_DETERMINISTIC_ERRNOS = frozenset(
    getattr(errno, name)
    for name in ("ENOENT", "EISDIR", "ENOTDIR", "EACCES", "EPERM", "ENAMETOOLONG")
    if hasattr(errno, name)
)


def is_transient(exc: BaseException) -> bool:
    """Whether ``exc`` is worth another attempt (the rule
    :func:`guarded_call` retries by, and the serving batcher's)."""
    if getattr(exc, "_retry_exhausted", False):
        # A nested guarded_call already spent its attempt budget on this
        # failure; re-retrying it at the outer guard would multiply the
        # attempts (3x3) and double-count knn_retry_total.
        return False
    if isinstance(exc, ResilienceError):
        return exc.transient
    # Raw OSError (e.g. an injected or real IO blip) is worth one more try —
    # unless its errno says the failure is deterministic.
    return isinstance(exc, OSError) and exc.errno not in _DETERMINISTIC_ERRNOS


def guarded_call(
    site: str,
    fn: Callable[[], T],
    *,
    attempts: Optional[int] = None,
    base_ms: Optional[float] = None,
    max_ms: Optional[float] = None,
    deadline_ms: Optional[float] = None,
    classify: bool = True,
) -> T:
    """Run ``fn()`` under fault point ``site`` with transient-failure retry.

    Raises the *typed* error (original as ``__cause__``) when attempts or
    the deadline are exhausted, or immediately for non-transient failures.
    ``classify=False`` propagates non-``ResilienceError`` exceptions
    unchanged (for sites whose callers already handle raw errors).
    """
    if attempts is None:
        attempts = max(1, int(_env_float(_ATTEMPTS_ENV, 3)))
    if base_ms is None:
        base_ms = _env_float(_BASE_ENV, 25.0)
    if max_ms is None:
        max_ms = _env_float(_MAX_ENV, 2000.0)
    if deadline_ms is None:
        raw = _env_float(_DEADLINE_ENV, 0.0)
        deadline_ms = raw if raw > 0 else None
    sleeps = backoff_schedule(attempts, base_ms, max_ms)
    t0 = time.monotonic()

    last: BaseException = RuntimeError(f"guarded_call({site!r}): no attempts")
    for attempt in range(attempts):
        try:
            faults.fault_point(site)
            return fn()
        except Exception as e:  # noqa: BLE001 — classified and re-raised below
            last = e
            if not is_transient(e):
                break
            obs.counter_add(
                "knn_retry_total",
                help="transient-failure re-attempts at guarded call sites",
                site=site,
            )
            if attempt + 1 >= attempts:
                break
            sleep_ms = sleeps[attempt]
            if sleep_ms > 0 and jitter_enabled():
                sleep_ms = apply_jitter(sleep_ms)
            elapsed_ms = (time.monotonic() - t0) * 1e3
            if deadline_ms is not None and elapsed_ms + sleep_ms >= deadline_ms:
                break
            with obs.span("retry", site=site, attempt=attempt + 1):
                if sleep_ms > 0:
                    time.sleep(sleep_ms / 1e3)
    try:
        # Mark so an enclosing guarded_call (the nested transfer+compile
        # guards) propagates instead of re-running this whole attempt loop.
        last._retry_exhausted = True
    except AttributeError:
        pass  # exceptions with __slots__: worst case the outer guard retries
    if classify and not isinstance(last, ResilienceError):
        err = classify_exception(last, site)
        err._retry_exhausted = True
        raise err from last
    raise last
