"""Typed error taxonomy (the port's copy of ``knn_tpu/resilience/errors.py``).

Callers branch on type, not text:

- :class:`DataError`       — input data is unusable (parse failures with
  file:line context, missing files surfaced at load, invalid shapes).
- :class:`CompileError`    — building a kernel failed (``nvcc`` missing or
  refusing a source).
- :class:`DeviceError`     — a CUDA device that was asked for is absent, a
  transfer or a kernel launch on it failed; ``oom=True`` marks resource
  exhaustion (the ladder answers OOM by halving ``query_batch``).
- :class:`CollectiveError` — a multi-device step failed.
- :class:`WorkerLostError` — a worker process or the cluster is gone.
- :class:`DeadlineExceededError` — a wait ran out of time before the work
  finished (``AsyncResult.result(timeout=...)``).
- :class:`OverloadError`   — a bounded queue refused new work;
  :class:`ShedByPolicy`, its subclass, is the priority admission's
  deliberate shed of a low-priority class.

``DataError`` subclasses ``ValueError`` and every class subclasses
``ResilienceError`` (itself an ``Exception``), so ``except ValueError``
handling keeps working while new code catches the taxonomy.

``transient`` marks errors worth retrying (:mod:`.retry` re-attempts only
those): an interrupted transfer is transient; a malformed file, an OOM and
a CUDA error that poisons the context are not — a retry on a dead context
only fails again.
"""

from __future__ import annotations


class ResilienceError(Exception):
    """Base of the taxonomy. ``transient`` gates retry; ``fault_point``
    records which named injection point raised it (None for real errors)."""

    #: class default; instances may override via the constructor
    transient = False

    def __init__(self, message: str, *, transient: "bool | None" = None,
                 fault_point: "str | None" = None):
        super().__init__(message)
        if transient is not None:
            self.transient = transient
        self.fault_point = fault_point


class DataError(ResilienceError, ValueError):
    """Unusable input data: parse failures (with file:line context where
    the parser has it), missing or unreadable files, unknown nominal or
    class labels, shape mismatches. Never transient."""


class CompileError(ResilienceError):
    """Building a kernel failed. Transient by default, as in the JAX
    package: one retry is cheap next to abandoning the rung."""

    transient = True


class DeviceError(ResilienceError):
    """A CUDA device was asked for and is absent, or a transfer or a kernel
    launch on it failed. ``oom=True`` marks resource exhaustion, which is
    NOT transient (the same inputs exhaust the same memory)."""

    def __init__(self, message: str, *, oom: bool = False,
                 transient: "bool | None" = None,
                 fault_point: "str | None" = None):
        if transient is None:
            transient = not oom
        super().__init__(message, transient=transient, fault_point=fault_point)
        self.oom = oom


class CollectiveError(ResilienceError):
    """A multi-device collective step failed. Transient by default."""

    transient = True


class WorkerLostError(CollectiveError):
    """A worker process or the cluster itself is unavailable. ``reason``
    carries the original failure class name for logs and metrics."""

    def __init__(self, message: str, *, reason: str = "unknown",
                 transient: "bool | None" = None,
                 fault_point: "str | None" = None):
        super().__init__(message, transient=transient, fault_point=fault_point)
        self.reason = reason


class DeadlineExceededError(ResilienceError):
    """A deadline elapsed before the work finished: ``AsyncResult.result(
    timeout=...)`` ran out of time waiting for an in-flight computation.
    The work usually keeps running, and a later ``result()`` collects it."""


class OverloadError(ResilienceError):
    """A bounded queue refused new work. Not transient for the internal
    retry loop: an immediate re-attempt meets the same full queue."""


class ShedByPolicy(OverloadError):
    """Admission DELIBERATELY refused this request because its priority
    class is below the control plane's current admission cutoff
    (:mod:`knn_tpu_torch.control.admission`) — overload pressure, not a
    full queue. Distinct from the base :class:`OverloadError` so the
    serving layer can label the outcome ``shed`` (not ``rejected``) and the
    SLO availability SLI can exclude policy sheds of non-protected classes.
    ``retry_after_s`` is the headroom-derived client backoff the 429's
    ``Retry-After`` header carries; ``request_class`` names the shed
    class."""

    def __init__(self, message: str, *, request_class: str,
                 retry_after_s: float,
                 fault_point: "str | None" = None):
        super().__init__(message, fault_point=fault_point)
        self.request_class = request_class
        self.retry_after_s = float(retry_after_s)


# cudaErrorMemoryAllocation: what a C launch entry returns when the card's
# memory is exhausted.
CUDA_ERROR_MEMORY_ALLOCATION = 2
# CUDA errors that poison the context: every later call in the process
# fails too, so retrying is pointless (cudaErrorECCUncorrectable 214,
# IllegalAddress 700, LaunchTimeout 702, ContextIsDestroyed 709, Assert
# 710, HardwareStackError 714, IllegalInstruction 715, MisalignedAddress
# 716, InvalidAddressSpace 717, InvalidPc 718, LaunchFailure 719, Unknown
# 999).
STICKY_CUDA_ERRORS = frozenset(
    (214, 700, 702, 709, 710, 714, 715, 716, 717, 718, 719, 999))

# Substrings that mark a failure as resource exhaustion (torch's CUDA
# caching allocator says "CUDA out of memory").
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
# Substrings of the CUDA runtime's messages for the sticky errors above.
_STICKY_MARKERS = (
    "illegal memory access", "unspecified launch failure",
    "device-side assert", "misaligned address", "illegal instruction",
    "launch timed out", "uncorrectable ECC", "hardware stack error",
    "invalid program counter", "context is destroyed",
)


def launch_error(entry: str, rc: int) -> DeviceError:
    """The typed error for a C launch entry that returned CUDA error ``rc``:
    ``oom`` for ``cudaErrorMemoryAllocation``, not transient for an error
    that poisons the context."""
    return DeviceError(
        f"{entry} launch failed: CUDA error {rc}",
        oom=rc == CUDA_ERROR_MEMORY_ALLOCATION,
        transient=False if rc in STICKY_CUDA_ERRORS else None,
    )


def _is_torch_oom(exc: BaseException) -> bool:
    import sys

    torch = sys.modules.get("torch")
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def classify_exception(exc: BaseException, site: str) -> ResilienceError:
    """Map a raw exception from a guarded call site to the taxonomy.

    ``site`` is the fault-point name of the call site (``device.put``,
    ``backend.compile``, ...): it decides the class for generic runtime
    errors. Resource exhaustion (``MemoryError``,
    ``torch.cuda.OutOfMemoryError``, the OOM markers) is an OOM
    :class:`DeviceError`; a CUDA error that poisons the context (its code
    in ``error_code`` or its message) is a :class:`DeviceError` that is
    not transient, at any site. Already-typed errors pass through
    unchanged. The raising caller keeps the original as ``__cause__``
    (``raise classify_exception(e, site) from e``).
    """
    if isinstance(exc, ResilienceError):
        return exc
    text = f"{type(exc).__name__}: {exc}"
    if (isinstance(exc, MemoryError) or _is_torch_oom(exc)
            or any(m in str(exc) for m in _OOM_MARKERS)):
        return DeviceError(f"[{site}] {text}", oom=True)
    if (getattr(exc, "error_code", None) in STICKY_CUDA_ERRORS
            or any(m in str(exc) for m in _STICKY_MARKERS)):
        return DeviceError(f"[{site}] {text}", transient=False)
    if site == "backend.compile":
        return CompileError(f"[{site}] {text}")
    if site == "multihost.init":
        return WorkerLostError(f"[{site}] {text}", reason=type(exc).__name__)
    if site == "collective.step":
        return CollectiveError(f"[{site}] {text}")
    if site == "arff.parse":
        return DataError(f"[{site}] {text}")
    # device.put, native.load, and any future execution-flavored site.
    return DeviceError(f"[{site}] {text}", transient=isinstance(exc, OSError))
