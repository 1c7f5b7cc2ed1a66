"""Timing primitives for the port's probes and ``chip_smoke.py``.

The port's copy of ``knn_tpu/obs/bench_timing.py``, the JAX package's one
timing methodology, with the card in place of the TPU:

- :func:`timed_batch`              — one pipelined batch, one drain.
- :func:`pipelined_slope`          — marginal seconds/dispatch from two
  batch sizes (best-of-3 each).
- :func:`interleaved_slope_trials` — R independent slope trials with the
  compared cases interleaved inside each trial (load drift hits all cases
  alike) and non-positive trials dropped loudly.
- :func:`slope_trials`             — the one-case wrapper.
- :func:`drop_superroofline`       — discard trials whose implied TFLOP/s
  beats the card's peak (host-stall artifacts by definition).
- :func:`median` / :func:`spread`  — the summary reducers.
- :func:`cuda_ms`                  — the median CUDA-event time of a call.

A drain is ``torch.cuda.synchronize()`` when the step's output lies on the
card, and nothing on the host, where every op has finished when it returns.
Each dispatch takes the next of a pool of distinct input buffers, so no
layer of the stack can serve a repeat from a cache.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _first_tensor(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def drain(out) -> None:
    """Wait for the device work behind ``out`` (its first tensor)."""
    t = _first_tensor(out)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def timed_batch(step, bufs, reps, block_fn=None):
    """One pipelined batch: ``reps`` dispatches cycling the distinct buffer
    pool, one drain (``block_fn(out)``, default :func:`drain`), wall
    seconds."""
    block_fn = block_fn or drain
    t0 = time.monotonic()
    out = None
    for i in range(reps):
        out = step(bufs[i % len(bufs)])
    block_fn(out)
    return time.monotonic() - t0


def pipelined_slope(mkstep, bufs, r_lo, r_hi, block_fn=None):
    """Marginal per-dispatch seconds: time r_lo and r_hi pipelined dispatches
    (one drain each, best of 3) and take the slope, which subtracts the
    fixed cost of the drain. Returns ``(per_step_seconds,
    fixed_overhead_seconds)``."""
    def timed(reps):
        return min(
            timed_batch(mkstep, bufs, reps, block_fn) for _ in range(3)
        )

    t_lo, t_hi = timed(r_lo), timed(r_hi)
    per_step = (t_hi - t_lo) / (r_hi - r_lo)
    return per_step, t_lo - r_lo * per_step


def interleaved_slope_trials(cases, r_lo, r_hi, trials=5, rounds=2):
    """Per-case slope trials with the cases interleaved inside each trial:
    every round times each case once at r_lo and r_hi dispatches before the
    next round starts, so load drift hits all cases alike. Within a trial
    the slope is taken between the per-batch-size minima over ``rounds``
    rounds, and the batch order alternates (lo, hi) / (hi, lo) by round so
    a stall tied to a position cannot bias one batch size. ``cases`` maps
    name -> (step_fn, bufs); returns name -> list of per-step seconds, one
    per trial, in run order. Read the median; check a minimum against the
    roofline (:func:`drop_superroofline`)."""
    out = {name: [] for name in cases}
    for _ in range(trials):
        lo = {name: float("inf") for name in cases}
        hi = {name: float("inf") for name in cases}
        for r in range(rounds):
            for name, (step, bufs) in cases.items():
                if r % 2 == 0:
                    lo[name] = min(lo[name], timed_batch(step, bufs, r_lo))
                    hi[name] = min(hi[name], timed_batch(step, bufs, r_hi))
                else:
                    hi[name] = min(hi[name], timed_batch(step, bufs, r_hi))
                    lo[name] = min(lo[name], timed_batch(step, bufs, r_lo))
        for name in cases:
            out[name].append((hi[name] - lo[name]) / (r_hi - r_lo))
    # A stall spanning every r_lo batch of a trial can push its slope to
    # <= 0: drop such trials loudly; if every trial is, there is no signal.
    for name, vals in out.items():
        good = [v for v in vals if v > 0]
        if not good:
            raise RuntimeError(
                f"all {len(vals)} slope trials for {name!r} are non-positive "
                f"({vals}); load noise swamped the measurement"
            )
        if len(good) < len(vals):
            _log(f"dropped {len(vals) - len(good)} non-positive slope "
                 f"trial(s) for {name!r}: {vals}")
        out[name] = good
    return out


def slope_trials(step, bufs, r_lo, r_hi, trials=5, inner=2):
    """R independent slope estimates for one case: a thin wrapper over
    :func:`interleaved_slope_trials`."""
    return interleaved_slope_trials(
        {"case": (step, bufs)}, r_lo, r_hi, trials=trials, rounds=inner,
    )["case"]


# The H100 SXM's dense peaks (NVIDIA data sheet): bf16 on the tensor cores,
# and float32 on the CUDA cores (fused multiply-adds counted as two). Pass
# the peak of the case's operand type.
PEAK_TF_BF16 = 989.0
PEAK_TF_F32 = 67.0


def drop_superroofline(trials_s, flops, peak_tf=PEAK_TF_BF16):
    """Drop slope trials whose implied TFLOP/s exceeds ``peak_tf``: nothing
    computes faster than the hardware, so such a trial is a measurement
    artifact. Returns the surviving trials; if none survive, the raw list
    (its min and median then stay visibly absurd)."""
    good = [s for s in trials_s if flops / s / 1e12 <= peak_tf]
    if good and len(good) < len(trials_s):
        _log(f"dropped {len(trials_s) - len(good)} super-roofline slope "
             f"trial(s): {[round(flops / s / 1e12) for s in trials_s]} "
             f"TFLOP/s")
    return good or trials_s


def median(trials):
    srt = sorted(trials)
    m = len(srt)
    return srt[m // 2] if m % 2 else (srt[m // 2 - 1] + srt[m // 2]) / 2


def spread(trials_s, scale=1e3, digits=3):
    """Summary fields for a list of per-trial per-step seconds: best (min),
    median (the central estimate), and the full list in run order, in
    milliseconds."""
    ms = [s * scale for s in trials_s]
    return {
        "step_ms": round(min(ms), digits),
        "step_ms_median": round(median(ms), digits),
        "step_ms_trials": [round(v, digits) for v in ms],
    }


def cuda_ms(fn, args_list, reps: int) -> float:
    """Median CUDA-event time in ms of ``fn(*args)`` over ``reps`` runs,
    cycling through ``args_list`` (distinct buffers per run), after one warm
    run. Needs the card."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    times = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args_list[r % len(args_list)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
