"""Where does the wide-feature (MNIST-784-shaped) step time go?

The port of ``scripts/probe_mnist_r3.py``. At its shape (65,536 train x
2,048 queries x 784 features, uniform [0, 1) from seeds 0 and 1, k = 5) it
times, with distinct query buffers per dispatch:

- A:  ``ops/probe_matmul.py::pure_matmul``, the bare bf16 cross term on the
      tensor cores, folded into 8 slots (block_n = 1,024): the floor.
- B:  the tile kernel's bf16 form with the train stored as bfloat16
      (``tile_knn.knn_tile_candidates``: ``predict_tile``'s merge route).
- B2: the tile kernel's fast form (float32 train).
- C:  the tile kernel's bf16 form with the train stored as float32.

The TPU probe's C2 is B here (one kernel serves both JAX routes), and its
C3-C5 and D vary only the TPU's block sizes, which the port does not have.

One line per case: ms per step (``pipelined_slope``), queries per second,
and the effective TFLOP/s of the 2*Q*N*D cross-term flops.

Usage: ``python -m knn_tpu_torch.probes.probe_mnist_r3 [--device cuda|cpu]
[--n N] [--q Q] [--reps LO,HI]``. ``--device cpu`` runs the plain versions
on the host (its times are the host's); ``--n`` and ``--q`` cut the shape.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from knn_tpu_torch.obs.bench_timing import pipelined_slope
from knn_tpu_torch.ops import tile_knn
from knn_tpu_torch.ops.cuda_knn import resolve_device
from knn_tpu_torch.ops.probe_matmul import pure_matmul

N, Q, D, K = 65536, 2048, 784, 5
BLOCK_N = 1024
BUFFERS = 12


def make_data(n: int, q: int):
    """The probe's train rows (seed 0) and queries (seed 1), float32."""
    train = np.random.default_rng(0).random((n, D), np.float32)
    test = np.random.default_rng(1).random((q, D), np.float32)
    return train, test


def query_buffers(test: np.ndarray, dev, dtype=torch.float32):
    """:data:`BUFFERS` distinct copies of the queries, each shifted by
    1e-6 more than the last."""
    return [torch.from_numpy(test + np.float32(i) * np.float32(1e-6))
            .to(dev, dtype) for i in range(BUFFERS)]


def cases(train: np.ndarray, test: np.ndarray, dev):
    """name -> (step, buffers) for the cases the port runs."""
    n = train.shape[0]
    txf = torch.from_numpy(train).to(dev)
    txb = txf.to(torch.bfloat16)
    bufs = query_buffers(test, dev)
    bufs_b = [b.to(torch.bfloat16) for b in bufs]

    def tile(t, form):
        return lambda qb: tile_knn.knn_tile_candidates(t, qb, n, K, form)

    return {
        f"A  pure matmul bf16 block_n={BLOCK_N}":
            (lambda qb: pure_matmul(txb, qb, BLOCK_N), bufs_b),
        "B  tile bf16, bf16 store": (tile(txb, "bf16"), bufs),
        "B2 tile fast, f32 store": (tile(txf, "fast"), bufs),
        "C  tile bf16, f32 store": (tile(txf, "bf16"), bufs),
    }


def main(argv=None, stdout=None) -> int:
    stdout = stdout or sys.stdout
    p = argparse.ArgumentParser(prog="probe_mnist_r3",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--q", type=int, default=Q)
    p.add_argument("--reps", default="10,40",
                   help="the two batch sizes of the slope (default 10,40)")
    args = p.parse_args(argv)
    r_lo, r_hi = (int(v) for v in args.reps.split(","))
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions)")
    print(f"device: {where}; {args.q} queries x {args.n} train x {D} feats, "
          f"k={K}", file=stdout, flush=True)
    train, test = make_data(args.n, args.q)
    flops = 2 * args.q * args.n * D
    for name, (step, bufs) in cases(train, test, dev).items():
        per_step, _ = pipelined_slope(step, bufs, r_lo, r_hi)
        print(f"{name}: {per_step * 1e3:.3f} ms/step  ({args.q / per_step:,.0f}"
              f" q/s, {flops / per_step / 1e12:.1f} TF eff)", file=stdout,
              flush=True)
    print("C2 tile bf16, bf16 store: the same kernel and store as B in the "
          "port (not run twice)", file=stdout)
    print("C3-C5, D: vary only the TPU's block sizes (block_q, block_n); the "
          "port has no such knob (not run)", file=stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
