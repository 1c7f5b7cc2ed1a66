"""The frozen bound arithmetic against the figures the cells were sized by."""

from __future__ import annotations

import pytest

from knnbench import bounds


@pytest.mark.parametrize("q, n, d, k, ms, kind", [
    (10_000, 1_000_000, 128, 10, 114.9, "operations"),
    (10_000, 1_000_000, 128, 100, 114.9, "operations"),
    (10_000, 60_000, 784, 10, 42.1, "operations"),
    (64, 1_000_000, 128, 10, 0.736, "operations"),
])
def test_bound_of_each_cell(q, n, d, k, ms, kind):
    s, which = bounds.retrieval_bound_s(q, n, d, k)
    assert which == kind
    assert round(s * 1e3, 1 if ms > 1 else 3) == ms


def test_bytes_bound_when_there_is_little_arithmetic():
    s, which = bounds.retrieval_bound_s(1, 1_000_000, 1, 1)
    assert which == "bytes"
    assert s == pytest.approx((1_000_000 + 1) * 4 / 3.35e12 + 8 / 3.35e12)
    assert bounds.retrieval_bytes(10_000, 1_000_000, 128, 10) / 3.35e12 \
        == pytest.approx(0.154e-3, rel=0.01)
