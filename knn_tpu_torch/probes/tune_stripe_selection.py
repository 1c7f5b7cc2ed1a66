"""Sweep the stripe scan's selection variants on the large shape.

The port of ``scripts/tune_stripe_selection.py``. On the large fixture
(30,803 train x 1,718 queries, 11 features, k = 5) it times, for each launch
shape, the shipped scan (``insert``: ``cuda_knn.knn_stripe_scan``, the
sorted insertion list) beside its three selection variants
(``cuda_knn.knn_stripe_scan_variant``): ``nosel``, the floor a free
selection would give; ``rounds``, the k rounds of min-extraction of the JAX
package's stripe kernel; ``lite``, the rounds without index retirement.
The shapes are the port's own: the train splits that ``split_plan`` makes
for 4, 8, 16 and 32 blocks per SM (16 is the shipped plan), in place of the
TPU's block sizes. Each variant's keys are merged (``knn_stripe_merge``)
and held against the shipped ``knn_stripe_candidates`` on the same queries:
indices equal and distances bit-equal (``nosel`` has nothing to compare).

One line per (shape, mode): ms per scan, from ``pipelined_slope`` over
distinct query buffers, and the parity. Exit status 1 when a parity check
fails.

Usage: ``python -m knn_tpu_torch.probes.tune_stripe_selection [--device
cuda|cpu] [--rows N] [--queries Q] [--reps LO,HI]``. ``--device cpu`` runs
the plain versions on the host (its times are the host's); ``--rows`` and
``--queries`` keep the first rows of the fixture.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from knn_tpu_torch.obs.bench_timing import pipelined_slope
from knn_tpu_torch.ops import cuda_knn
from knn_tpu_torch.probes.data import load_large

K = 5
MODES = ("insert",) + cuda_knn.SELECT_MODES
BLOCKS_PER_SM = (4, 8, 16, 32)
# The H100's SM count: on the host the sweep plans the card's shapes.
H100_SMS = 132


def sweep_shapes(n: int, q: int, sm_count: int):
    """The distinct ``(n_splits, rows_per_split)`` plans of ``split_plan``
    over :data:`BLOCKS_PER_SM`."""
    shapes = []
    for b in BLOCKS_PER_SM:
        plan = cuda_knn.split_plan(n, q, sm_count, blocks_per_sm=b)
        if plan not in shapes:
            shapes.append(plan)
    return shapes


def scan_step(tx, n, mode, n_splits, rows_per_split):
    """One scan of ``mode`` over the queries it is given."""
    if mode == "insert":
        return lambda qb: cuda_knn.knn_stripe_scan(tx, qb, n, K, n_splits,
                                                   rows_per_split)
    return lambda qb: cuda_knn.knn_stripe_scan_variant(
        tx, qb, n, K, mode, n_splits, rows_per_split)


def parity(partial, ref_d, ref_i) -> bool:
    d, i = cuda_knn.knn_stripe_merge(partial)
    return bool(torch.equal(i, ref_i) and torch.equal(d.view(torch.int32),
                                                      ref_d.view(torch.int32)))


def main(argv=None, stdout=None) -> int:
    stdout = stdout or sys.stdout
    p = argparse.ArgumentParser(prog="tune_stripe_selection",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--queries", type=int, default=None)
    p.add_argument("--reps", default="50,200",
                   help="the two batch sizes of the slope (default 50,200)")
    args = p.parse_args(argv)
    r_lo, r_hi = (int(v) for v in args.reps.split(","))
    dev = cuda_knn.resolve_device(args.device)

    train, test = load_large()
    x = train.features[: args.rows].copy()
    qx = test.features[: args.queries].copy()
    (n, d), q = x.shape, qx.shape[0]
    if dev.type == "cuda":
        sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
        where = torch.cuda.get_device_name(dev)
    else:
        sm_count, where = H100_SMS, "cpu (plain versions)"
    print(f"device: {where}; {q} queries x {n} train x {d} feats, k={K}",
          file=stdout, flush=True)

    tx = torch.from_numpy(x).to(dev)
    bufs = [torch.from_numpy(qx + np.float32(i) * np.float32(1e-7)).to(dev)
            for i in range(8)]
    ref_d, ref_i = cuda_knn.knn_stripe_candidates(tx, bufs[0], n, K)
    lite_ok = cuda_knn.stripe_inputs_finite(x, qx) and K <= n
    failed = False
    for n_splits, rows in sweep_shapes(n, q, sm_count):
        for mode in MODES:
            step = scan_step(tx, n, mode, n_splits, rows)
            partial = step(bufs[0])
            if mode == "nosel":
                ok = "-"
            elif mode == "lite" and not lite_ok:
                ok = "skipped (inputs not finite or k > rows)"
            else:
                ok = parity(partial, ref_d, ref_i)
                failed |= not ok
            per_step, _ = pipelined_slope(step, bufs, r_lo, r_hi)
            print(f"splits={n_splits} rows={rows} {mode:6s} "
                  f"{per_step * 1e3:.4f} ms/step  parity={ok}", file=stdout,
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
