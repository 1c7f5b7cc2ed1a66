"""Time the tile kernels' distance forms and P1 at ``chip_smoke.py``'s shapes.

Each figure is the median time of one entry point, with a distinct query
buffer per run: ``tile_knn.knn_tile_candidates`` (scan and merge at the
checkout's own split plan) or ``probe_matmul.pure_matmul``.

- wide (P1's probe data: 65,536 x 784 uniform train, seed 0; 2,048
  queries, seed 1): the exact and fast forms at k = 5 (float32 store); the
  bf16 form at k = 5, 32 and 256 with the train stored as bfloat16 (the
  merge route's store, and the stripe route's past 128 features), and at
  k = 5 stored as float32; P1 at block_n 1,024.
- large (the large fixture: 30,803 x 11, 1,718 queries): the bf16 form at
  k = 5 (float32 store, the stripe route's), k = 32 and 256 (bfloat16
  store, the merge route's); the exact form at k = 32 and 256.

One JSON line, ``{"device", "tag", "ms": {case: ms}}``. It uses only entry
points that earlier versions of the port have too, so to compare two
versions of the kernels, copy this file into the other checkout's
``knn_tpu_torch/probes/`` and run it from each checkout's root in turn, in
one chip call. On the card the times are CUDA-event medians; with
``--device cpu`` the plain versions run on the host at a cut size
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
from knn_tpu_torch.probes.data import large_fixture
from knn_tpu_torch.probes.probe_mnist_r3 import make_data
from knn_tpu_torch.probes.tile_bigk import host_ms

BUFFERS = 12


def cases(wide, large, dev):
    """name -> (fn, args list): each case's entry point over its distinct
    query buffers."""
    out = {}
    for shape, (x, qx), runs in (
            ("wide", wide, (("exact", 5, "f32"), ("fast", 5, "f32"),
                            ("bf16", 5, "bf16"), ("bf16", 32, "bf16"),
                            ("bf16", 256, "bf16"), ("bf16", 5, "f32"))),
            ("large", large, (("bf16", 5, "f32"), ("bf16", 32, "bf16"),
                              ("bf16", 256, "bf16"), ("exact", 32, "f32"),
                              ("exact", 256, "f32")))):
        n = x.shape[0]
        t32 = torch.from_numpy(x).to(dev)
        stores = {"f32": t32, "bf16": t32.to(torch.bfloat16)}
        bufs = [torch.from_numpy(qx + np.float32(i) * np.float32(1e-6)).to(dev)
                for i in range(BUFFERS)]
        for form, k, store in runs:
            out[f"{shape} {form} k={k} {store} store"] = (
                tile_knn.knn_tile_candidates,
                [(stores[store], qb, n, k, form) for qb in bufs])
        if shape == "wide":
            out["wide P1 block_n=1024"] = (
                probe_matmul.pure_matmul,
                [(stores["bf16"], qb.to(torch.bfloat16), 1024) for qb in bufs])
    return out


def main(argv=None, stdout=None) -> int:
    stdout = stdout or sys.stdout
    p = argparse.ArgumentParser(prog="tile_forms",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--rows", type=int, default=None,
                   help="cut both train sets to this many rows")
    p.add_argument("--queries", type=int, default=None,
                   help="cut both query sets to this many rows")
    p.add_argument("--reps", type=int, default=12,
                   help="timed runs per case (default 12)")
    p.add_argument("--tag", default="", help="a label for the output line")
    args = p.parse_args(argv)
    dev = cuda_knn.resolve_device(args.device)
    wx, wq = make_data(args.rows or 65536, args.queries or 2048)
    lx, _, lq, _ = large_fixture(seed=0)
    large = (lx[: args.rows], lq[: args.queries])
    timer = cuda_ms if dev.type == "cuda" else host_ms
    ms = {name: timer(fn, args_list, args.reps)
          for name, (fn, args_list) in cases((wx, wq), large, dev).items()}
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions)")
    print(json.dumps({"device": where, "tag": args.tag, "ms": ms}),
          file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
