"""The port's timing primitives against the JAX package's.

``knn_tpu_torch.obs.bench_timing`` is a copy of ``knn_tpu.obs.bench_timing``
with the card's peaks and drain: its reducers and the super-roofline filter
must give the JAX package's answers on the same inputs, and the slope must
recover a known per-step cost.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from knn_tpu.obs import bench_timing as jbt  # noqa: E402
from knn_tpu_torch.obs import bench_timing as bt  # noqa: E402

TRIALS = [
    [0.004],
    [0.003, 0.001],
    [0.0031, 0.0029, 0.0042, 0.0011, 0.0035],
    [1e-4, 2e-4, 3e-4, 4e-4],
]


@pytest.mark.parametrize("trials", TRIALS)
def test_median_and_spread_match_jax(trials):
    assert bt.median(trials) == jbt.median(trials)
    assert bt.spread(trials) == jbt.spread(trials)
    assert bt.spread(trials, scale=1e6, digits=1) == \
        jbt.spread(trials, scale=1e6, digits=1)


@pytest.mark.parametrize("trials", TRIALS)
@pytest.mark.parametrize("flops,peak", [(1e9, 207.0), (2e11, 989.0),
                                        (4e9, 67.0), (1e12, 1.0)])
def test_drop_superroofline_matches_jax(trials, flops, peak):
    assert bt.drop_superroofline(trials, flops, peak) == \
        jbt.drop_superroofline(trials, flops, peak)


def test_peaks_are_the_h100s():
    # 2*2048*65536*784 flops at 0.2 ms is 1,052 TFLOP/s: past the dense
    # bf16 peak, dropped; at 0.25 ms (842 TFLOP/s) kept.
    flops = 2 * 2048 * 65536 * 784
    assert bt.drop_superroofline([0.2e-3, 0.25e-3], flops) == [0.25e-3]
    assert (bt.PEAK_TF_BF16, bt.PEAK_TF_F32) == (989.0, 67.0)


def test_pipelined_slope_recovers_a_known_step_cost(monkeypatch):
    # Each step costs 2 ms; the drain a fixed 20 ms. The slope sees the
    # step, the intercept the drain. The costs advance a scripted clock, so
    # the host's load cannot move the answer.
    clock = [0.0]
    monkeypatch.setattr(bt, "time", SimpleNamespace(monotonic=lambda: clock[0]))

    def step(_):
        clock[0] += 0.002
        return torch.zeros(1)

    def drain(_):
        clock[0] += 0.02

    per_step, fixed = bt.pipelined_slope(step, [None] * 3, 5, 25, block_fn=drain)
    assert per_step == pytest.approx(0.002)
    assert fixed == pytest.approx(0.02)


def test_timed_batch_cycles_the_distinct_buffers():
    seen = []
    bt.timed_batch(seen.append, ["a", "b", "c"], 7)
    assert seen == ["a", "b", "c", "a", "b", "c", "a"]


def test_interleaved_trials_drop_nonpositive_and_raise_without_signal(
        monkeypatch):
    # Scripted batch times: a trial whose r_lo batch stalled reads as a
    # negative slope and is dropped; with every trial so, there is no signal.
    times = {"lo": [0.05, 0.05, 0.001, 0.001], "hi": [0.01, 0.01, 0.013, 0.013]}

    def scripted(step, bufs, reps, block_fn=None):
        return times["lo" if reps == 1 else "hi"].pop(0)

    monkeypatch.setattr(bt, "timed_batch", scripted)
    out = bt.interleaved_slope_trials({"c": (None, [None])}, 1, 4, trials=2,
                                      rounds=2)
    assert out == {"c": [pytest.approx(0.004)]}
    times.update(lo=[0.05, 0.05], hi=[0.01, 0.01])
    with pytest.raises(RuntimeError, match="non-positive"):
        bt.slope_trials(None, [None], 1, 4, trials=2, inner=1)
