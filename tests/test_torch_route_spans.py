"""The host entry's stage spans on the kernels' route, on the CPU: the
``record_function`` ranges that ``kneighbors``, ``kneighbors_async``,
``predict`` and ``ops/cuda_knn.py::stripe_candidates_arrays`` leave on a
``torch.profiler`` timeline, by name, order and nesting, with obs off (the
ranges alone) and on (the same ranges, one per recorded span).

The benchmark's traced run names the card's idle time by these ranges
(``knnbench/trace.py``), so their placement is part of what it measures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier  # noqa: E402
from knn_tpu_torch.ops.cuda_knn import stripe_candidates_arrays  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401


def ranges(fn):
    """``fn()`` under a profiler: ``(its result, [(name, depth), ...])``,
    the ``record_function`` ranges in start order, each with the number of
    ranges that contain it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation()),
                    key=lambda t: (t[0], -t[1]))
    open_ends, got = [], []
    for start, end, name in events:
        while open_ends and open_ends[-1] <= start:
            open_ends.pop()
        got.append((name, len(open_ends)))
        open_ends.append(end)
    return out, got


def problem(q=40):
    rng = np.random.default_rng(7)
    train = Dataset(rng.random((300, 8), dtype=np.float32),
                    rng.integers(0, 4, 300).astype(np.int32))
    test = Dataset(rng.random((q, 8), dtype=np.float32),
                   np.zeros(q, np.int32))
    return train, test


@pytest.fixture(params=["obs off", "obs on"])
def obs_state(request):
    if request.param == "obs on":
        obs.enable()
    else:
        obs.disable()
    obs.reset()
    return request.param


def recorded():
    """The tracer's span names, in completion order (none with obs off)."""
    return [s.name for s in obs.tracer().spans()]


def test_kneighbors_nests_its_stages(obs_state):
    train, test = problem()
    model = KNNClassifier(k=3, backend="cuda", device="cpu").fit(train)
    want = model.kneighbors(test)
    obs.reset()
    got, names = ranges(lambda: model.kneighbors(test))
    assert names == [("kneighbors", 0), ("distance", 1), ("prepare", 2),
                     ("dispatch", 2), ("fetch", 2)]
    np.testing.assert_array_equal(got[1], want[1])
    assert recorded() == (
        ["prepare", "dispatch", "fetch", "distance", "kneighbors"]
        if obs_state == "obs on" else [])


def test_predict_nests_its_stages(obs_state):
    train, test = problem()
    model = KNNClassifier(k=3, backend="cuda", device="cpu").fit(train)
    want = model.predict(test)
    obs.reset()
    got, names = ranges(lambda: model.predict(test))
    assert names == [("predict", 0), ("prepare", 1), ("dispatch", 1),
                     ("fetch", 1)]
    np.testing.assert_array_equal(got, want)
    assert recorded() == (
        ["prepare", "dispatch", "fetch", "predict"]
        if obs_state == "obs on" else [])


def test_two_chunks_dispatch_twice_and_fetch_once():
    train, test = problem()
    whole = stripe_candidates_arrays(train.features, test.features, 3,
                                     device="cpu")
    got, names = ranges(lambda: stripe_candidates_arrays(
        train.features, test.features, 3, device="cpu", chunk_rows=20))
    # No cache: the train is built in the call, one upload in prepare.
    assert names == [("prepare", 0), ("upload", 1), ("dispatch", 0),
                     ("dispatch", 0), ("fetch", 0)]
    for a, b in zip(got, whole):
        np.testing.assert_array_equal(a, b)


def test_chunks_past_the_window_fetch_as_they_leave_it():
    """Seven chunks, a window of four: the first three leave the window
    while later chunks dispatch, each under a ``fetch`` of its own; the
    rest under ``resolve()``'s one ``fetch``. No ``fetch`` nests in
    another."""
    train, test = problem(q=70)
    whole = stripe_candidates_arrays(train.features, test.features, 3,
                                     device="cpu")
    got, names = ranges(lambda: stripe_candidates_arrays(
        train.features, test.features, 3, device="cpu", chunk_rows=10))
    d, f = ("dispatch", 0), ("fetch", 0)
    assert names == [("prepare", 0), ("upload", 1), d, d, d, d, d, f, d, f,
                     d, f, f]
    for a, b in zip(got, whole):
        np.testing.assert_array_equal(a, b)


def test_kneighbors_async_opens_fetch_at_result(obs_state):
    train, test = problem()
    model = KNNClassifier(k=3, backend="cuda", device="cpu").fit(train)
    want = model.kneighbors(test)
    handle, names = ranges(lambda: model.kneighbors_async(test))
    assert names == [("kneighbors", 0), ("distance", 1), ("prepare", 2),
                     ("dispatch", 2)]
    got, names = ranges(handle.result)
    assert names == [("fetch", 0)]
    np.testing.assert_array_equal(got[1], want[1])
    _, names = ranges(handle.result)  # memoized: nothing fetched again
    assert names == []
