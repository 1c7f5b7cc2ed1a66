"""A run on the CPU with the timed path broken underneath: the check has to
come out false for each fault a cell can have, and true without one."""

from __future__ import annotations

import numpy as np
import pytest

from knn_tpu_torch.models.knn import KNNClassifier
from knnbench import manifest, run

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def alter_one_answer(out, _last):
    """One answer in eight altered where it is produced."""
    if isinstance(out, tuple):
        d, i = (a.copy() for a in out)
        i[::8, 0] = (i[::8, 0] + 1) % 7
        return d, i
    out = out.copy()
    out[::8] = (out[::8] + 1) % 10
    return out


def drop_half(out, _last):
    """Half of the call's queries left out, their slots filled from the
    other half."""
    def half(a):
        a = a.copy()
        h = a.shape[0] // 2
        a[h:2 * h] = a[:h]
        return a
    return tuple(half(a) for a in out) if isinstance(out, tuple) else half(out)


def stale(out, last):
    """The call before's answers returned again."""
    return last[0] if last else out


def fail(out, last):
    """Every call after the warm-up raises."""
    if last:
        raise RuntimeError("injected")
    return out


@pytest.fixture
def break_program(monkeypatch):
    def install(fault):
        for entry in ("kneighbors", "predict"):
            real = getattr(KNNClassifier, entry)
            last = []

            def broken(self, test, real=real, last=last):
                out = fault(real(self, test), last)
                last[:] = [out]
                return out
            monkeypatch.setattr(KNNClassifier, entry, broken)
    return install


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(tiny_cell, name):
    result = run.run_cell(tiny_cell(name), 2**31 + 3, 0.3, False, device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert all(c["value"] <= c["limit"] or n == "compared"
               for n, c in result["checks"].items())


@pytest.mark.parametrize("fault", [alter_one_answer, drop_half, stale, fail])
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_fails_the_check(tiny_cell, break_program, name, fault):
    break_program(fault)
    result = run.run_cell(tiny_cell(name), 2**31 + 3, 0.3, False,
                          device="cpu")
    assert result["correct"] is False
    if fault is fail:
        assert result["failed"] == result["attempted"] > 0
        assert result["checks"]["unanswered"]["value"] > 0
    assert np.isfinite(result["metrics"]["setup_s"]["value"])
