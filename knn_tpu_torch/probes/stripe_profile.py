"""Profile the stripe scan on the card: where its device time goes.

At the xl shape (the large fixture's train rows tiled 33 times with 1e-3
noise, 1,016,499 x 11, and its 1,718 queries; k = 10) and at the large
shape (30,803 x 11, k = 5) it runs ``cuda_knn.knn_stripe_candidates``
``--calls`` times under ``torch.profiler`` and reports:

- each device kernel's total time and launches, from the profiler's
  ``key_averages`` (the device events only);
- the device's busy share of the window: the kernels' summed time over the
  window's host-clock time, the window ending in a synchronize;
- the scan's time beside P2's selection variants at one layout, the
  checkout's own plan (``cuda_knn.stripe_split_plan``, or ``split_plan``'s
  default where a checkout has no ``stripe_split_plan``;
  ``cuda_knn.knn_stripe_scan_variant``; ``nosel`` keeps no list, so the
  scan's time above it is the selection's), CUDA-event medians;
- whether ``ncu`` and ``nsys`` are on the PATH.

Then one ``classify --warmup`` of the large shape through the CLI
(``knn_tpu_torch.cli.run``, ARFF under ``build/probe-fixtures/``), its timed
run under the profiler: kernels, copies and the busy share of the call.

One JSON line at the end. It uses only entry points that earlier versions
of the port have too, so copy it (with ``probes/data.py``) into another
checkout to profile that version's kernels. Needs the card.

Usage: ``python -m knn_tpu_torch.probes.stripe_profile [--calls C]``.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import sys
import time

import numpy as np
import torch

from knn_tpu_torch.obs.bench_timing import cuda_ms
from knn_tpu_torch.ops import cuda_knn
from knn_tpu_torch.probes.data import (
    FIXTURE_DIR,
    large_fixture,
    load_large,
    tiled_large,
)


def device_events(prof) -> dict:
    """name -> [device ms, launches] of the device-side events (kernels and
    copies) in a finished profiler."""
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[e.key] = [total / 1e3, e.count]
    return out


def profiled(fn, calls: int) -> dict:
    """``fn()`` ``calls`` times under the profiler: its device events, and
    their summed time over the window's host-clock time."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy = sum(ms for ms, _ in events.values())
    return {"window_ms": wall, "device_ms": busy,
            "busy_share": busy / wall if wall else None, "events": events}


def main(argv=None, stdout=None) -> int:
    stdout = stdout or sys.stdout
    p = argparse.ArgumentParser(prog="stripe_profile",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=10,
                   help="profiled calls per shape (default 10)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("stripe_profile: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    lx, ly, lq, _ = large_fixture(seed=0)
    xx, _ = tiled_large(lx, ly)
    report = {"device": torch.cuda.get_device_name(dev),
              "ncu": shutil.which("ncu"), "nsys": shutil.which("nsys"),
              "shapes": {}}
    for shape, x, k in (("xl", xx, 10), ("large", lx, 5)):
        n, d = x.shape
        q = lq.shape[0]
        tx = torch.from_numpy(x).to(dev)
        bufs = [torch.from_numpy(lq + np.float32(i) * np.float32(1e-6)).to(dev)
                for i in range(4)]
        cuda_knn.knn_stripe_candidates(tx, bufs[0], n, k)  # builds, warms
        turn = [0]

        def call():
            turn[0] += 1
            return cuda_knn.knn_stripe_candidates(
                tx, bufs[turn[0] % len(bufs)], n, k)

        prof = profiled(call, args.calls)
        plan = (cuda_knn.stripe_split_plan(n, q, dev, d, k)
                if hasattr(cuda_knn, "stripe_split_plan")
                else cuda_knn.split_plan(n, q, sm_count))
        times = {"insert": cuda_ms(cuda_knn.knn_stripe_scan,
                                   [(tx, qb, n, k, *plan) for qb in bufs], 12)}
        for mode in cuda_knn.SELECT_MODES:
            times[mode] = cuda_ms(cuda_knn.knn_stripe_scan_variant,
                                  [(tx, qb, n, k, mode, *plan) for qb in bufs],
                                  12)
        report["shapes"][shape] = {"shape": f"q={q} n={n} d={d} k={k}",
                                   "plan": list(plan), "profile": prof,
                                   "scan_ms_by_selection": times}
        print(f"{shape} q={q} n={n} d={d} k={k}: {args.calls} calls of "
              f"knn_stripe_candidates (its own split plan) in "
              f"{prof['window_ms']} ms, device busy {prof['device_ms']} ms "
              f"({prof['busy_share']}); device events {prof['events']}; scan "
              f"by selection at the scan's own plan, {plan[0]} splits of "
              f"{plan[1]} rows (CUDA-event medians of 12): {times} ms",
              file=stdout, flush=True)
        del tx, bufs

    from knn_tpu_torch import cli

    load_large()  # writes the ARFF files at first use
    paths = [str(FIXTURE_DIR / f"large-{part}.arff") for part in ("train", "test")]
    out = io.StringIO()

    def classify():
        return cli.run([*paths, "5", "--warmup"], stdout=out)

    # cli.run parses, warms up and times; profile a second whole call, after
    # the first has built and cached what it needs.
    classify()
    prof = profiled(classify, 1)
    report["classify_large"] = {"line": out.getvalue().splitlines()[-1],
                                "profile": prof}
    print(f"classify large k=5 (cli.run, parse + --warmup run + timed run): "
          f"window {prof['window_ms']} ms, device busy {prof['device_ms']} ms "
          f"({prof['busy_share']}); device events {prof['events']}; "
          f"{report['classify_large']['line']}", file=stdout, flush=True)
    print(json.dumps(report), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
