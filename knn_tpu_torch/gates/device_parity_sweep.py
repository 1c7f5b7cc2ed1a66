"""Randomized prediction-parity sweep through the port's card routes: the
counterpart of the JAX package's ``scripts/device_parity_sweep.py``.

The CPU tests hold each kernel's plain version against JAX; this gate
sends random problems through the public entries on the card — integer
grids for tie density, duplicated train rows, shapes straddling every
padding boundary, NaN-poisoned rows in every third trial — and requires
every path's predictions to equal the numpy oracle's exactly.

The draws are JAX's, from the same seed (20260730), so that trial *t* here
is JAX's trial *t*: n 3–6,000, q 1–700, d 1–128, k ≤ min(n, 16), 2–10
classes. Each JAX path has its counterpart (:data:`PATHS`). Around every
call the kernels' launch counters are read: a kernel path that launched
no kernel fails (no quiet fallback), and a torch-op path that launched a
hand kernel fails too. After JAX's trials, a block of trials from the same
generator at k 17–min(n, 300) (:data:`BIGK_PATHS`) covers the tile scan's
k > 16 selection, exact and bf16, at random shapes; JAX sends k > 16 to
XLA and has no such block.

With ``--device cpu`` every path runs its plain versions on the host and
no kernel launches, so the launch rule is off.

Exit 0 when every prediction is exact (and every launch rule holds); 1
otherwise.

Usage: ``python -m knn_tpu_torch.gates.device_parity_sweep [trials]
[--bigk-trials N] [--device cuda|cpu]`` (30 trials and 10 in the k > 16
block by default).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 20260730

#: Port path -> (the JAX path it answers for, the launch counters that must
#: move in each call; empty: a torch-op path, which must launch none).
PATHS = {
    "cuda-auto": ("tpu-auto", ("stripe_scan", "stripe_merge")),
    "cuda-xla": ("tpu-xla", ()),
    "cuda-tiled": ("tpu-tiled", ()),
    "tile-merge": ("pallas-merge", ("tile_exact", "stripe_merge")),
    "tile-fast": ("stripe-fast", ("tile_fast", "stripe_merge")),
    "tile-bf16": ("stripe-bf16", ("tile_bf16", "stripe_merge")),
    "qs-1dev-stripe": ("qs-1dev-stripe", ("stripe_scan", "stripe_merge")),
    "ts-1dev-stripe": ("ts-1dev-stripe", ("stripe_scan", "stripe_merge")),
}

#: The k > 16 block's paths: the kernels' route of predict_arrays and the
#: tile kernel's merge route in the exact and bf16 forms.
BIGK_PATHS = {
    "cuda-auto": (None, ("tile_exact", "stripe_merge")),
    "tile-exact": (None, ("tile_exact", "stripe_merge")),
    "tile-bf16": (None, ("tile_bf16", "stripe_merge")),
}


def draw_trial(rng, t: int, n_lo: int = 3, k_lo: int = 1, k_hi: int = 16):
    """One problem, drawn in the JAX script's order: ``(train_x, train_y,
    test_x, k, c, meta)``. JAX's trials use the defaults; the k > 16 block
    draws n from ``n_lo`` = 17 and k from [17, min(n, 300)]."""
    n = int(rng.integers(n_lo, 6000))
    q = int(rng.integers(1, 700))
    d = int(rng.integers(1, 129))
    k = int(rng.integers(k_lo, min(n, k_hi) + 1))
    c = int(rng.integers(2, 11))
    hi = int(rng.integers(2, 6))  # a small grid: dist == 0 ties abound
    train_x = rng.integers(0, hi, (n, d)).astype(np.float32)
    train_y = rng.integers(0, c, n).astype(np.int32)
    dup = min(q // 2, n)
    test_x = np.concatenate([
        train_x[rng.choice(n, dup, replace=False)] if dup else
        np.empty((0, d), np.float32),
        rng.integers(0, hi, (q - dup, d)).astype(np.float32),
    ])
    if t % 3 == 0:
        # NaN-poisoned: the kernels' +inf rule and the index-ordered inf
        # tail, which the finite trials never reach.
        nan_rows = rng.choice(n, max(1, n // 10), replace=False)
        train_x[nan_rows, rng.integers(0, d, nan_rows.size)] = np.nan
        test_x[rng.choice(q, max(1, q // 20), replace=False)] = np.nan
    return train_x, train_y, test_x, k, c, dict(n=n, q=q, d=d, k=k, c=c,
                                                hi=hi)


def _counters():
    from knn_tpu_torch.ops import cuda_knn, tile_knn

    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile = tile_knn.knn_tile_scan

    def reset():
        scan.launches = merge.launches = 0
        for form in tile.launches:
            tile.launches[form] = 0

    def read():
        return {"stripe_scan": scan.launches, "stripe_merge": merge.launches,
                **{f"tile_{f}": n for f, n in tile.launches.items()}}

    return reset, read


def _path_fns(dev, train_x, train_y, test_x, k, c):
    from knn_tpu_torch.backends.cuda import predict_arrays
    from knn_tpu_torch.ops.tile_knn import predict_tile
    from knn_tpu_torch.parallel.query_sharded import predict_query_sharded
    from knn_tpu_torch.parallel.train_sharded import predict_train_sharded

    a = (train_x, train_y, test_x, k, c)
    return {
        "cuda-auto": lambda: predict_arrays(*a, device=dev),
        "cuda-xla": lambda: predict_arrays(*a, engine="xla", device=dev),
        "cuda-tiled": lambda: predict_arrays(
            *a, force_tiled=True, query_tile=64, train_tile=256,
            engine="xla", device=dev),
        "tile-merge": lambda: predict_tile(*a, engine="merge", device=dev),
        # The fast and bf16 forms: on these small-integer grids every term
        # of |q|^2 - 2 q.t + |t|^2 is exactly representable (values < 2^8
        # even in bf16, float32 accumulation), so equality is exact here.
        "tile-fast": lambda: predict_tile(*a, precision="fast",
                                          engine="stripe", device=dev),
        "tile-bf16": lambda: predict_tile(*a, precision="bf16",
                                          engine="stripe", device=dev),
        "qs-1dev-stripe": lambda: predict_query_sharded(
            *a, num_devices=1, engine="stripe", device=dev),
        "ts-1dev-stripe": lambda: predict_train_sharded(
            *a, mesh_shape=(1, 1), engine="stripe", device=dev),
        "tile-exact": lambda: predict_tile(*a, device=dev),
    }


def _run_block(label, rng, t0, trials, paths, draw_kw, dev, on_card,
               launches) -> int:
    from knn_tpu_torch.backends.oracle import knn_oracle

    reset, read = _counters()
    failures = 0
    for t in range(t0, t0 + trials):
        train_x, train_y, test_x, k, c, meta = draw_trial(rng, t, **draw_kw)
        want = knn_oracle(train_x, train_y, test_x, k, c)
        fns = _path_fns(dev, train_x, train_y, test_x, k, c)
        for name, (_jax, need) in paths.items():
            reset()
            got = fns[name]()
            seen = read()
            for key, n in seen.items():
                launches[label][name][key] += n
            where = (f"n={meta['n']} q={meta['q']} d={meta['d']} "
                     f"k={meta['k']} c={meta['c']} hi={meta['hi']}")
            if not np.array_equal(got, want):
                failures += 1
                bad = int((got != want).sum())
                print(f"FAIL trial {t} [{name}]: {where} "
                      f"({bad}/{meta['q']} mismatches)")
            if not on_card:
                continue
            idle = [key for key in need if seen[key] < 1]
            stray = [key for key, n in seen.items() if n and not need]
            if idle or stray:
                failures += 1
                print(f"FAIL trial {t} [{name}]: {where}: "
                      + (f"no launch of {idle}" if idle else
                         f"hand kernels launched on a torch-op path")
                      + f"; launches {seen}")
        if (t - t0 + 1) % 10 == 0:
            print(f"{label}: {t - t0 + 1}/{trials} trials, {failures} "
                  f"failures", file=sys.stderr)
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="device_parity_sweep",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("trials", nargs="?", type=int, default=30)
    p.add_argument("--bigk-trials", type=int, default=10,
                   help="trials of the k > 16 block (default 10)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("device-parity-sweep: FAIL: torch.cuda.is_available() is "
              "false: run on the card or pass --device cpu", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    print(f"device: {torch.cuda.get_device_name(0) if on_card else 'cpu'}"
          + ("" if on_card else " (plain versions; launch rule off)"))
    rng = np.random.default_rng(SEED)
    launches = {
        label: {name: dict.fromkeys(
            ("stripe_scan", "stripe_merge", "tile_exact", "tile_fast",
             "tile_bf16"), 0) for name in paths}
        for label, paths in (("sweep", PATHS), ("bigk", BIGK_PATHS))}
    failures = _run_block("sweep", rng, 0, args.trials, PATHS, {}, dev,
                          on_card, launches)
    print("device parity sweep:",
          f"{args.trials} trials x {len(PATHS)} paths",
          "ALL EXACT" if failures == 0 else f"{failures} FAILURES")
    big_fail = _run_block("bigk", rng, args.trials, args.bigk_trials,
                          BIGK_PATHS, dict(n_lo=17, k_lo=17, k_hi=300), dev,
                          on_card, launches)
    print("device parity sweep, k > 16 block:",
          f"{args.bigk_trials} trials x {len(BIGK_PATHS)} paths",
          "ALL EXACT" if big_fail == 0 else f"{big_fail} FAILURES")
    print("launches: " + json.dumps(
        {label: {name: {key: n for key, n in seen.items() if n}
                 for name, seen in per.items()}
         for label, per in launches.items()}))
    return 1 if failures or big_fail else 0


if __name__ == "__main__":
    sys.exit(main())
