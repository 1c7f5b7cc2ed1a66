"""Typed error taxonomy (the port's copy of ``knn_tpu/resilience/errors.py``).

Callers branch on type, not text:

- :class:`DataError`    — input data is unusable (parse failures with
  file:line context, missing files surfaced at load, invalid shapes).
- :class:`CompileError` — building a kernel failed (``nvcc`` missing or
  refusing a source).
- :class:`DeviceError`  — a CUDA device that was asked for is absent, or a
  kernel launch on it was refused.
- :class:`DeadlineExceededError` — a wait ran out of time before the work
  finished (``AsyncResult.result(timeout=...)``).

``DataError`` subclasses ``ValueError`` and every class subclasses
``ResilienceError`` (itself an ``Exception``), so ``except ValueError``
handling keeps working while new code catches the taxonomy. The JAX
package's ``transient``/``oom`` flags serve its retry loop and degradation
ladder, which are still to port (ROADMAP A4, A7).
"""

from __future__ import annotations


class ResilienceError(Exception):
    """Base of the taxonomy."""


class DataError(ResilienceError, ValueError):
    """Unusable input data: parse failures (with file:line context where
    the parser has it), missing or unreadable files, unknown nominal or
    class labels, shape mismatches."""


class CompileError(ResilienceError):
    """Building a kernel failed."""


class DeviceError(ResilienceError):
    """A CUDA device was asked for and is absent, or a kernel launch on it
    was refused."""


class DeadlineExceededError(ResilienceError):
    """A deadline elapsed before the work finished: ``AsyncResult.result(
    timeout=...)`` ran out of time waiting for an in-flight computation.
    The work usually keeps running, and a later ``result()`` collects it."""
