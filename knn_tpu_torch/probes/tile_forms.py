"""Time the tile kernels' distance forms, P1 and the stripe scan at
``chip_smoke.py``'s shapes.

Each figure is the median time of one entry point, with a distinct query
buffer per run: ``tile_knn.knn_tile_candidates`` (scan and merge at the
checkout's own split plan), ``cuda_knn.knn_stripe_candidates`` (the stripe
scan and merge at its plan) or ``probe_matmul.pure_matmul``.

- wide (P1's probe data: 65,536 x 784 uniform train, seed 0; 2,048
  queries, seed 1): the exact and fast forms at k = 5 (float32 store); the
  bf16 form at k = 5, 32 and 256 with the train stored as bfloat16 (the
  merge route's store, and the stripe route's past 128 features), and at
  k = 5 stored as float32; P1 at block_n 1,024.
- large (the large fixture: 30,803 x 11, 1,718 queries): the bf16 form at
  k = 5 (float32 store, the stripe route's), k = 32 and 256 (bfloat16
  store, the merge route's); the exact form at k = 32 and 256; the stripe
  scan at k = 5.
- xl (the large fixture's train rows tiled 33 times with 1e-3 noise,
  1,016,499 x 11, and its 1,718 queries): the stripe scan at k = 10.

One JSON line, ``{"device", "tag", "ms": {case: ms}, "kernel_ms": {case:
ms}, "device_ms": {case: ms}, "digest": {case: n}}``. ``ms`` is the whole
call as a caller sees it, host work before the first launch included.
On the card, ``kernel_ms`` and ``device_ms`` come from ``--reps`` more calls
under ``torch.profiler``, per call: the device time of the case's
hand-written scan kernel alone (``tile_scan``, ``stripe_scan`` or
``matmul_fold`` in its name), and of every device event of the call (the
scan, the merge, the norms and the operand copies).
A case's digest is the sum, as int64, of its first run's output read as
integers: the packed ``(distance bits << 32) | index`` keys of the neighbor
lists, or P1's float32 sums bit for bit. Two versions of a kernel that give
the same digests gave the same answers. The probe uses only entry points
that earlier versions of the port have too, so to compare two versions of
the kernels, copy this file and ``probes/data.py`` into the other
checkout's ``knn_tpu_torch/probes/`` and run it from each checkout's root
in turn, in one chip call. On the card the times are CUDA-event medians;
with ``--device cpu`` the plain versions run on the host at a cut size
(``--rows``, ``--queries``) and the times are the host's.

Usage: ``python -m knn_tpu_torch.probes.tile_forms [--device cuda|cpu]
[--rows N] [--queries Q] [--reps R] [--tag T]``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from knn_tpu_torch.obs.bench_timing import cuda_ms
from knn_tpu_torch.ops import cuda_knn, probe_matmul, tile_knn
from knn_tpu_torch.probes.data import large_fixture, tiled_large
from knn_tpu_torch.probes.probe_mnist_r3 import make_data
from knn_tpu_torch.probes.stripe_profile import profiled
from knn_tpu_torch.probes.tile_bigk import host_ms

BUFFERS = 12
# The hand-written scan kernels, by a part of their names.
SCAN_KERNELS = ("tile_scan", "stripe_scan", "matmul_fold")


def profiled_ms(fn, args_list, reps: int):
    """``(scan kernel ms, device ms)`` per call of ``fn``, over ``reps``
    calls under the profiler, cycling through ``args_list``."""
    turn = iter(range(reps))
    prof = profiled(lambda: fn(*args_list[next(turn) % len(args_list)]), reps)
    scan = sum(ms for name, (ms, _) in prof["events"].items()
               if any(part in name for part in SCAN_KERNELS))
    return scan / reps, prof["device_ms"] / reps


def cases(wide, large, xl, dev):
    """name -> (fn, args list): each case's entry point over its distinct
    query buffers."""
    out = {}
    for shape, (x, qx), runs in (
            ("wide", wide, (("exact", 5, "f32"), ("fast", 5, "f32"),
                            ("bf16", 5, "bf16"), ("bf16", 32, "bf16"),
                            ("bf16", 256, "bf16"), ("bf16", 5, "f32"))),
            ("large", large, (("bf16", 5, "f32"), ("bf16", 32, "bf16"),
                              ("bf16", 256, "bf16"), ("exact", 32, "f32"),
                              ("exact", 256, "f32"), ("stripe", 5, "f32"))),
            ("xl", xl, (("stripe", 10, "f32"),))):
        n = x.shape[0]
        t32 = torch.from_numpy(x).to(dev)
        stores = {"f32": t32}
        if shape != "xl":
            stores["bf16"] = t32.to(torch.bfloat16)
        bufs = [torch.from_numpy(qx + np.float32(i) * np.float32(1e-6)).to(dev)
                for i in range(BUFFERS)]
        for form, k, store in runs:
            if form == "stripe":
                out[f"{shape} stripe k={k}"] = (
                    cuda_knn.knn_stripe_candidates,
                    [(t32, qb, n, k) for qb in bufs])
                continue
            out[f"{shape} {form} k={k} {store} store"] = (
                tile_knn.knn_tile_candidates,
                [(stores[store], qb, n, k, form) for qb in bufs])
        if shape == "wide":
            out["wide P1 block_n=1024"] = (
                probe_matmul.pure_matmul,
                [(stores["bf16"], qb.to(torch.bfloat16), 1024) for qb in bufs])
    return out


def digest(out) -> int:
    """The sum, as int64, of an output read as integers: the packed keys of
    ``(distances, indices)``, or a float32 tensor's bits."""
    if isinstance(out, tuple):
        dist, idx = out
        keys = ((dist.contiguous().view(torch.int32).to(torch.int64) << 32)
                | idx.to(torch.int64))
    else:
        keys = out.contiguous().view(torch.int32).to(torch.int64)
    return int(keys.sum().item())


def main(argv=None, stdout=None) -> int:
    stdout = stdout or sys.stdout
    p = argparse.ArgumentParser(prog="tile_forms",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--rows", type=int, default=None,
                   help="cut the train sets to this many rows")
    p.add_argument("--queries", type=int, default=None,
                   help="cut the query sets to this many rows")
    p.add_argument("--reps", type=int, default=12,
                   help="timed runs per case (default 12)")
    p.add_argument("--tag", default="", help="a label for the output line")
    args = p.parse_args(argv)
    dev = cuda_knn.resolve_device(args.device)
    wx, wq = make_data(args.rows or 65536, args.queries or 2048)
    lx, ly, lq, _ = large_fixture(seed=0)
    xx, _ = tiled_large(lx, ly)
    large = (lx[: args.rows], lq[: args.queries])
    xl = (xx[: args.rows], lq[: args.queries])
    timer = cuda_ms if dev.type == "cuda" else host_ms
    ms, kernel_ms, device_ms, digests = {}, {}, {}, {}
    for name, (fn, args_list) in cases((wx, wq), large, xl, dev).items():
        digests[name] = digest(fn(*args_list[0]))
        ms[name] = timer(fn, args_list, args.reps)
        if dev.type == "cuda":
            kernel_ms[name], device_ms[name] = profiled_ms(fn, args_list,
                                                           args.reps)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions)")
    print(json.dumps({"device": where, "tag": args.tag, "ms": ms,
                      "kernel_ms": kernel_ms, "device_ms": device_ms,
                      "digest": digests}), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
