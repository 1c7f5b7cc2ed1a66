"""Time the tile scan's k > 16 selection on the large shape or the sift
shape.

``--shape large`` (the default): the large fixture (30,803 train x 1,718
queries, 11 features). ``--shape sift128``: ANN-Benchmarks'
sift-128-euclidean at its published scale (1,000,000 train x 10,000
queries, 128 features), integers drawn from ``--seed`` in [0, 255] and
divided by 255. For each k it times the exact form of the tile scan
(``tile_knn.knn_tile_scan``) at the shipped split plan
(``tile_knn.tile_split_plan``); then the scan and the merge
(``cuda_knn.knn_stripe_merge``) together at splits of at least m*k rows,
for each rows-per-k factor m (the shipped factor is
``tile_knn._ROWS_PER_K``). Each layout's merged neighbors are held against
the shipped plan's: indices equal, distances bit-equal, since the function
does not depend on the layout. The shipped plan's keys of the first 128
queries (one query block) are held bit-equal to
``tile_knn.knn_tile_scan_reference``'s (``ref_parity``). At k <= 16 the
scan runs the register lists, so on one shape ``--ks 100,16`` times the
k > 16 selection against the same mainloop with the register selection.

One JSON line per k: ``{"k", "plan": [splits, rows], "scan_ms",
"ref_parity", "selection", "factors": {m: [splits, ms, parity]}}``;
``selection`` holds the k > 16 selection's counters over one scan at the
shipped plan (``tile_knn.selection_counters``: candidates, folds, overflow
rounds), or null where the kernel keeps none. To compare two versions of
the kernel, run the probe from the root of each checkout in one chip call,
in turn. On the card the times are CUDA-event medians over distinct query
buffers; with ``--device cpu`` the plain versions run on the host and the
times are the host's. Exit status 1 when a parity check fails.

Usage: ``python -m knn_tpu_torch.probes.tile_bigk [--device cuda|cpu]
[--shape large|sift128] [--seed S] [--rows N] [--queries Q]
[--ks 17,24,...] [--factors 1,2,4,8] [--reps R]``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.obs.bench_timing import cuda_ms
from knn_tpu_torch.ops import cuda_knn, tile_knn
from knn_tpu_torch.probes.data import load_large
from knn_tpu_torch.probes.tune_stripe_selection import H100_SMS

KS = "17,24,32,64,100,128,256,1000"
FACTORS = "1,2,4,8"
#: sift-128-euclidean at its published scale: train rows, queries, features.
SIFT128 = (1_000_000, 10_000, 128)
#: Queries of the shipped plan held to the plain version (one query block).
REF_QUERIES = 128


def host_ms(fn, args_list, reps: int) -> float:
    """Median host-clock time in ms of ``fn(*args)`` over ``reps`` runs,
    cycling through ``args_list``."""
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        fn(*args_list[r % len(args_list)])
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sift128(seed: int, rows=None, queries=None):
    """``(train, queries)`` float32 of the sift shape, cut to ``rows`` and
    ``queries``: integers drawn from ``seed`` in [0, 255], divided by 255."""
    n, q, d = SIFT128
    rng = np.random.default_rng(seed)

    def draw(r):
        return rng.integers(0, 256, (r, d), dtype=np.uint8).astype(
            np.float32) / np.float32(255)

    return draw(n if rows is None else rows), draw(q if queries is None
                                                   else queries)


def selection_counts(run):
    """The k > 16 selection's counters over ``run()``, or None where the
    kernel keeps none (an older checkout)."""
    read = getattr(tile_knn, "selection_counters", None)
    if read is None:
        return None
    was = obs.enabled()
    obs.enable()
    try:
        before = read()
        run()
        after = read()
    finally:
        if not was:
            obs.disable()
    return {name: after[name] - before[name] for name in after}


def main(argv=None, stdout=None) -> int:
    stdout = stdout or sys.stdout
    p = argparse.ArgumentParser(prog="tile_bigk",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--shape", choices=["large", "sift128"], default="large")
    p.add_argument("--seed", type=int, default=0,
                   help="the sift shape's seed (default 0)")
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--queries", type=int, default=None)
    p.add_argument("--ks", default=KS, help=f"the k timed (default {KS})")
    p.add_argument("--factors", default=FACTORS,
                   help=f"the rows-per-k factors m (default {FACTORS})")
    p.add_argument("--reps", type=int, default=12,
                   help="timed runs per figure (default 12)")
    args = p.parse_args(argv)
    ks = [int(v) for v in args.ks.split(",")]
    factors = [int(v) for v in args.factors.split(",")]
    dev = cuda_knn.resolve_device(args.device)

    if args.shape == "sift128":
        x, qx = sift128(args.seed, args.rows, args.queries)
    else:
        train, test = load_large()
        x = train.features[: args.rows].copy()
        qx = test.features[: args.queries].copy()
    (n, d), q = x.shape, qx.shape[0]
    if dev.type == "cuda":
        sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
        where, timer = torch.cuda.get_device_name(dev), cuda_ms
    else:
        sm_count, where, timer = H100_SMS, "cpu (plain versions)", host_ms
    print(f"device: {where}; {q} queries x {n} train x {d} feats, exact form",
          file=stdout, flush=True)

    tx = torch.from_numpy(x).to(dev)
    bufs = [torch.from_numpy(qx + np.float32(i) * np.float32(1e-7)).to(dev)
            for i in range(min(args.reps, 12))]
    failed = False
    for k in ks:
        plan = tile_knn.tile_split_plan(n, q, sm_count, k)
        scan_ms = timer(lambda qb: tile_knn.knn_tile_scan(
            tx, qb, n, k, "exact", *plan), [(qb,) for qb in bufs], args.reps)
        partial = tile_knn.knn_tile_scan(tx, bufs[0], n, k, "exact", *plan)
        ref_d, ref_i = cuda_knn.knn_stripe_merge(partial)
        head = bufs[0][:REF_QUERIES]
        ref_ok = bool(torch.equal(partial[:REF_QUERIES], tile_knn.
                                  knn_tile_scan_reference(tx, head, n, k,
                                                          "exact", *plan)))
        failed |= not ref_ok
        del partial
        selection = selection_counts(lambda: tile_knn.knn_tile_scan(
            tx, bufs[0], n, k, "exact", *plan))
        per_factor = {}
        for m in factors:
            mplan = cuda_knn.split_plan(n, q, sm_count, tile_knn._TILE_ROWS,
                                        tile_knn._BLOCKS_PER_SM,
                                        min_rows=m * k)

            def step(qb, mplan=mplan):
                return cuda_knn.knn_stripe_merge(tile_knn.knn_tile_scan(
                    tx, qb, n, k, "exact", *mplan))

            got_d, got_i = step(bufs[0])
            ok = bool(torch.equal(got_i, ref_i) and torch.equal(
                got_d.view(torch.int32), ref_d.view(torch.int32)))
            failed |= not ok
            per_factor[m] = [mplan[0], timer(step, [(qb,) for qb in bufs],
                                             args.reps), ok]
        print(json.dumps({"k": k, "plan": list(plan), "scan_ms": scan_ms,
                          "ref_parity": ref_ok, "selection": selection,
                          "factors": per_factor}), file=stdout, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
