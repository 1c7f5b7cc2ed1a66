"""Canonical output line — byte-compatible with the reference's printf
(main.cpp:146, multi-thread.cpp:203, mpi.cpp:198):

  "The %i-NN classifier for %lu test instances on %lu train instances
   required %llu ms CPU time. Accuracy was %.4f\\n"

plus an opt-in structured JSON form (SURVEY.md §5.5).
"""

from __future__ import annotations

import json


def result_line(k: int, num_test: int, num_train: int, ms: int, acc: float) -> str:
    return (
        f"The {k}-NN classifier for {num_test} test instances on {num_train} "
        f"train instances required {ms} ms CPU time. Accuracy was {acc:.4f}"
    )


def result_json(k: int, num_test: int, num_train: int, ms: int, acc: float,
                backend: str, phases: "dict | None" = None) -> str:
    """``phases`` (present when the obs tracer is on) carries the per-phase
    span totals of the timed region in milliseconds — the same numbers
    ``--metrics-out`` writes under ``"phases"``, so the two artifacts can
    be cross-checked (tests/test_obs.py)."""
    rec = {
        "k": k,
        "num_test": num_test,
        "num_train": num_train,
        "ms": ms,
        "accuracy": round(acc, 6),
        "backend": backend,
    }
    if phases is not None:
        rec["phases"] = phases
    return json.dumps(rec)
