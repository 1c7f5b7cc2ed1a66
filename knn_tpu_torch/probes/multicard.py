"""Time the mesh engines and the launcher across cards.

``chip_smoke.py``'s ``sharded`` phase runs the engines on logical shards
of one card; this probe runs them across real cards (one shard per card,
the copies between them over the cards' links) and the launcher with one
rank per card on NCCL:

- xl (the large fixture's train rows tiled 33 times with 1e-3 noise,
  1,016,499 x 11, and its 1,718 queries), k = 10: the single-card
  ``cuda`` backend, then ``cuda-sharded``, ``cuda-train-sharded`` (a
  1 x P mesh) and ``cuda-ring`` on the stripe engine across 2 and P
  cards (P the visible cards, at most 4); each held equal to the
  single-card predictions, its stripe-scan launches counted, its
  collectives held to the byte model (``parallel/comm_audit.py``), its
  call timed (host clock, answers on the host, median of ``--reps``);
- large (the large fixture), k = 5: ``python -m
  knn_tpu_torch.parallel.launch -np R`` for R = 2 and P, both strategies,
  each line equal to the single-process CLI's (ms aside) and its dumped
  predictions to the single-card backend's, with the backend it chose.

One JSON line, ``{"device", "cards", "single_ms", "engines": {name:
{"ms", "all_ms", "scan_launches", "bytes"}}, "launch": {name: {...}}}``,
after the card's name and power limit. ``--device cpu`` runs it at a cut
size (``--rows``, ``--queries``) on ``--shards`` logical shards of the
host, the launcher's ranks on gloo; on ``cuda`` fewer than two visible
cards is an error.

Usage: ``python -m knn_tpu_torch.probes.multicard [--device cuda|cpu]
[--rows N] [--queries Q] [--shards P] [--reps R]``.
"""

from __future__ import annotations

import argparse
import io
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from knn_tpu_torch.probes.data import FIXTURE_DIR, large_fixture, tiled_large, write_arff

REPO = FIXTURE_DIR.parents[1]


def _wall_ms(fn, reps: int):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def main(argv=None) -> int:
    from knn_tpu_torch import cli
    from knn_tpu_torch.backends import get_backend
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.ops import _build, cuda_knn
    from knn_tpu_torch.parallel import comm_audit
    from knn_tpu_torch.parallel.mesh import make_mesh
    from knn_tpu_torch.parallel.query_sharded import predict_query_sharded
    from knn_tpu_torch.parallel.ring import predict_ring
    from knn_tpu_torch.parallel.train_sharded import predict_train_sharded

    p = argparse.ArgumentParser(prog="knn_tpu_torch.probes.multicard")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--rows", type=int, default=None,
                   help="large-fixture train rows kept (default: all)")
    p.add_argument("--queries", type=int, default=None,
                   help="large-fixture queries kept (default: all)")
    p.add_argument("--shards", type=int, default=4,
                   help="logical shards of the host with --device cpu")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    dev = args.device
    if dev == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("multicard: needs two or more CUDA cards (or --device "
                  "cpu)", file=sys.stderr)
            return 1
        cards = min(4, torch.cuda.device_count())
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
        _build.build_all()
    else:
        cards, smi = args.shards, "cpu"
    print(smi, flush=True)

    x, y, tx, ty = large_fixture(seed=0)
    x, y = x[:args.rows], y[:args.rows]
    tx, ty = tx[:args.queries], ty[:args.queries]
    data = FIXTURE_DIR / "multicard"
    data.mkdir(parents=True, exist_ok=True)
    train_path, test_path = data / "large-train.arff", data / "large-test.arff"
    write_arff(train_path, x, y, "large-train")
    write_arff(test_path, tx, ty, "large-test")
    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    xl_x, xl_y = tiled_large(train.features, train.labels)
    xl = Dataset(xl_x, xl_y)
    q, k = test.num_instances, 10
    n, d = xl_x.shape
    ncls = int(xl_y.max()) + 1
    cuda = get_backend("cuda")
    want = cuda(xl, test, k, device=dev)
    res = {"device": smi, "cards": cards, "shape": f"xl n={n} d={d} q={q} "
           f"k={k}", "single_ms": _wall_ms(
               lambda: cuda(xl, test, k, device=dev), args.reps)[0],
           "engines": {}, "launch": {}}

    for s in sorted({2, cards}):
        mesh = make_mesh(s, dev)
        for name, fn, kw in (
                ("query_sharded", predict_query_sharded, {}),
                ("train_sharded", predict_train_sharded,
                 {"mesh_shape": (1, s)}),
                ("ring", predict_ring, {})):
            def call(log=None):
                return fn(xl_x, xl_y, test.features, k, ncls, devices=mesh,
                          cache=xl.device_cache, log=log, engine="stripe",
                          **kw)

            log = []
            scans = cuda_knn.knn_stripe_scan.launches
            got = call(log)
            scans = cuda_knn.knn_stripe_scan.launches - scans
            if not np.array_equal(got, want):
                raise SystemExit(f"multicard: {name} on {s} devices differs "
                                 f"from the single-card answer")
            if name == "train_sharded":
                nbytes = comm_audit.audit_train_sharded(log, q, k, s)[0]
            elif name == "ring":
                rows = -(-n // s)
                nbytes = comm_audit.audit_ring(log, rows * d * 4, rows * 4,
                                               s)[0]
            else:
                nbytes = sum(o.nbytes for o in log)
            ms, all_ms = _wall_ms(call, args.reps)
            res["engines"][f"{name}_x{s}"] = {
                "ms": ms, "all_ms": all_ms, "scan_launches": scans,
                "bytes": nbytes}
            print(f"{name} on {s} devices: "
                  f"{json.dumps(res['engines'][f'{name}_x{s}'])}", flush=True)

    mask = re.compile(r"required \d+ ms")
    out = io.StringIO()
    if cli.run([str(train_path), str(test_path), "5", "--device", dev],
               stdout=out) != 0:
        raise SystemExit("multicard: the single-process CLI failed")
    single = out.getvalue().splitlines()[0]
    want5 = cuda(train, test, 5, device=dev)
    for ranks in sorted({2, cards}):
        for strategy in ("query-sharded", "train-sharded"):
            dump = data / f"launch-{ranks}-{strategy}.npy"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "knn_tpu_torch.parallel.launch",
                 "-np", str(ranks), "--device", dev, "--timeout", "240",
                 str(train_path), str(test_path), "5", "--strategy",
                 strategy, "--json", "--dump-predictions", str(dump)],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(f"multicard: launch -np {ranks} "
                                 f"{strategy} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
            line, js = proc.stdout.splitlines()[:2]
            js = json.loads(js)
            if (mask.sub("", line) != mask.sub("", single)
                    or not np.array_equal(np.load(dump), want5)):
                raise SystemExit(f"multicard: launch -np {ranks} {strategy}"
                                 f": {line!r} against {single!r}")
            res["launch"][f"{ranks}-{strategy}"] = {
                "dist_backend": js["dist_backend"], "ms": js["ms"],
                "wall_s": wall}
            print(f"launch -np {ranks} {strategy}: {line} "
                  f"{json.dumps(res['launch'][f'{ranks}-{strategy}'])}",
                  flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
