"""The inputs and the reference at a configuration's full size, on the card.

``python3 -m knnbench.scale --config sift-128-euclidean --rows 100000000
--queries 4096 --k 10,100 --seed 2147483693 [--gen-runs 2] [--whole]``

Draws the configuration's inputs from the seed with ``--rows`` train rows
(``gen.make_inputs``, ``--gen-runs`` times, each hashed), then ranks the
first ``--queries`` of the pool with ``reference.neighbors`` at each
``--k``, and with ``--whole`` once more with the whole train in one block,
to compare the two bit for bit. One JSON line for each step: its wall
time, the device memory it left reserved or its peak, and hashes. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import sys
import time

import numpy as np
import torch

from knnbench import gen, manifest, reference

CHUNK = 256 << 20


def digest(a: np.ndarray) -> str:
    """sha256 over the sha256 of each 256 MB of ``a``'s bytes."""
    view = memoryview(np.ascontiguousarray(a)).cast("B")
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        parts = pool.map(lambda s: hashlib.sha256(view[s:s + CHUNK]).digest(),
                         range(0, len(view), CHUNK))
        return hashlib.sha256(b"".join(parts)).hexdigest()[:16]


def mem_total_kib() -> int:
    with open("/proc/meminfo", encoding="ascii") as f:
        return int(next(line for line in f if line.startswith("MemTotal"))
                   .split()[1])


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def rank(inputs: dict, queries: int, k: int):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = reference.neighbors(inputs["train_x"], inputs["pool"][:queries], k,
                              "cuda")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="knnbench.scale",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="sift-128-euclidean")
    p.add_argument("--rows", type=int, required=True)
    p.add_argument("--queries", type=int, default=4096)
    p.add_argument("--k", default="10")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--gen-runs", type=int, default=1)
    p.add_argument("--whole", action="store_true",
                   help="also rank with the whole train in one block")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("knnbench.scale: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load()
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    with open(manifest.ROOT / entry["file"], encoding="utf-8") as f:
        config = {**json.load(f), "train_rows": args.rows}
    traffic = {"queries_per_call": args.queries, "pool_queries": args.queries}
    emit(step="host", mem_total_kib=mem_total_kib(),
         card=torch.cuda.get_device_name(0), torch=torch.__version__,
         rows=args.rows, dim=config["dim"],
         train_bytes=args.rows * config["dim"] * 4,
         train_block_rows=reference.train_block_rows(args.rows, config["dim"]),
         device_budget_bytes=reference.DEVICE_BUDGET_BYTES)
    for run in range(args.gen_runs):
        inputs = None
        t0 = time.perf_counter()
        inputs = gen.make_inputs(config, traffic, args.seed, "cuda")
        wall = time.perf_counter() - t0
        # Past 2**31 elements the draw is split: do the later parts repeat
        # the first?
        r = (1 << 31) // config["dim"]
        emit(step="gen", run=run, seconds=wall,
             repeats=bool(np.array_equal(inputs["train_x"][:r],
                                         inputs["train_x"][r:2 * r])),
             reserved_bytes=torch.cuda.memory_reserved(),
             allocated_bytes=torch.cuda.memory_allocated(),
             train_x=digest(inputs["train_x"]),
             train_y=digest(inputs["train_y"]), pool=digest(inputs["pool"]),
             hash_seconds=time.perf_counter() - t0 - wall)
    for k in (int(v) for v in args.k.split(",")):
        (d, i), wall, peak = rank(inputs, args.queries, k)
        emit(step="reference", k=k, seconds=wall, peak_bytes=peak,
             dist=digest(d), idx=digest(i))
        if args.whole:
            block = reference.TRAIN_BLOCK_ELEMENTS
            reference.TRAIN_BLOCK_ELEMENTS = args.rows * config["dim"]
            try:
                (wd, wi), wall, peak = rank(inputs, args.queries, k)
            finally:
                reference.TRAIN_BLOCK_ELEMENTS = block
            emit(step="reference_one_block", k=k, seconds=wall,
                 peak_bytes=peak, dist=digest(wd), idx=digest(wi),
                 equal=bool(np.array_equal(d, wd) and np.array_equal(i, wi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
