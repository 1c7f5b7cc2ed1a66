"""Every backend over the dataset ladder x k, held to the oracle: the
counterpart of the JAX package's ``scripts/parity_report.py``.

Runs each requested backend over the configurations (small k = 1, 5 and
medium k = 5; large k = 1, 5, 10 with ``--large``), requires each one's
predictions to equal the oracle's exactly (stronger than the reference's
accuracy-only grading), and prints JAX's markdown table. On the card each
kernel backend (``cuda``, ``cuda-tile``) must also have launched a kernel
in every run, or the run fails: no quiet fallback.

The data: the fixture ladder generated in the checkout
(``probes/data.py``, byte-identical to ``scripts/make_fixtures.py``'s), or
the ARFF files of the directory ``$KNN_TPU_DATASETS`` names. The
golden accuracies apply only to the reference's datasets (JAX's rule: a
directory whose path names ``reference``).

Usage: ``python -m knn_tpu_torch.gates.parity_report [--backends
oracle,native,...] [--large] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

GOLDEN = {
    ("small", 1): 0.8500, ("small", 5): 0.8625,
    ("medium", 5): 0.3081,
    ("large", 1): 0.9919, ("large", 5): 0.9948, ("large", 10): 0.7538,
}

KERNEL_BACKENDS = ("cuda", "cuda-tile")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="parity_report",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--backends",
                   default="oracle,native,native-mt,cuda,cuda-tile")
    p.add_argument("--large", action="store_true",
                   help="include the large dataset")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("parity-report: FAIL: torch.cuda.is_available() is false: run "
              "on the card or pass --device cpu", file=sys.stderr)
        return 1

    from knn_tpu_torch.backends import available_backends, get_backend
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.ops import cuda_knn, tile_knn
    from knn_tpu_torch.probes.data import FIXTURE_DIR, load_pair
    from knn_tpu_torch.utils.evaluate import accuracy, confusion_matrix

    configs = [("small", 1), ("small", 5), ("medium", 5)]
    if args.large:
        configs += [("large", 1), ("large", 5), ("large", 10)]
    backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    missing = [b for b in backends if b not in available_backends()]
    if missing:
        print(f"note: skipping unavailable backends {missing}", file=sys.stderr)
        backends = [b for b in backends if b not in missing]

    datasets = os.environ.get("KNN_TPU_DATASETS")
    data_dir = Path(datasets) if datasets else FIXTURE_DIR
    is_ref = "reference" in str(data_dir)

    def pair(size):
        if datasets:
            return tuple(load_arff(str(data_dir / f"{size}-{part}.arff"))
                         for part in ("train", "test"))
        return load_pair(size)

    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile = tile_knn.knn_tile_scan

    def launched():
        return scan.launches + merge.launches + sum(tile.launches.values())

    rows, launches = [], {}
    failures = 0
    for size, k in configs:
        train, test = pair(size)
        golden = None
        for name in backends:
            before = launched()
            t0 = time.monotonic()
            preds = get_backend(name)(train, test, k, device=args.device)
            ms = (time.monotonic() - t0) * 1e3
            acc = accuracy(confusion_matrix(preds, test.labels,
                                            test.num_classes))
            if golden is None:
                golden = preds
                parity = "oracle"
            else:
                parity = ("==" if np.array_equal(preds, golden)
                          else "DIVERGED")
                if parity == "DIVERGED":
                    failures += 1
            if on_card and name in KERNEL_BACKENDS:
                launches[f"{size} k={k} {name}"] = launched() - before
                if launched() == before:
                    failures += 1
                    parity += " NO-LAUNCH"
            gold_ok = ""
            if is_ref and (size, k) in GOLDEN:
                gold_ok = (" ✓" if round(acc, 4) == GOLDEN[(size, k)]
                           else " ✗GOLDEN")
                if "✗" in gold_ok:
                    failures += 1
            rows.append((size, k, name, acc, ms, parity + gold_ok))

    print("| dataset | k | backend | accuracy | ms | parity |")
    print("|---|---|---|---|---|---|")
    for size, k, name, acc, ms, parity in rows:
        print(f"| {size} | {k} | {name} | {acc:.4f} | {ms:.0f} | {parity} |")
    if on_card:
        print(f"\nlaunches on {torch.cuda.get_device_name(0)} (kernels per "
              f"run): {json.dumps(launches)}")
    if failures:
        print(f"\n{failures} PARITY FAILURE(S)", file=sys.stderr)
        return 1
    print(f"\nall {len(rows)} runs prediction-identical"
          + (" and golden-accurate" if is_ref else " (synthetic fixtures)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
