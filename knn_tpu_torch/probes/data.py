"""Generated data for the probes and ``chip_smoke.py``.

The port's copy of the JAX package's ``bench.py::load_large`` with the
``scripts/make_fixtures.py`` recipe, of its xl train set (the large train
rows tiled), and of the wide (MNIST-784-shaped) arrays of ``bench.py``'s
mnist784 config. Everything is made from a seed;
nothing is read from outside the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from knn_tpu_torch.data.arff import load_arff

# Where load_large writes its ARFF files: build/ at the repository root.
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "build" / "probe-fixtures"

LARGE_SHAPE = (30803, 1718, 11)  # train rows, test rows, features


def large_fixture(seed: int = 0):
    """The large fixture's arrays, by the recipe of scripts/make_fixtures.py:
    30,803 train x 1,718 test, 11 features, 10 classes; sentinel rows 0..9
    pin num_classes; half the test rows duplicate train rows (dist == 0)."""
    n_train, n_test, d = LARGE_SHAPE
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, size=(10, d))
    labels = rng.integers(0, 10, size=n_train)
    x = centers[labels] + rng.normal(0, 1.5, size=(n_train, d))
    labels[:10] = np.arange(10)
    x[:10] = centers[np.arange(10)] + rng.normal(0, 1.5, size=(10, d))
    x = x.astype(np.float32)
    n_dup = n_test // 2
    dup_idx = rng.choice(n_train, size=n_dup, replace=False)
    tl = rng.integers(0, 10, size=n_test - n_dup)
    tx = np.concatenate([x[dup_idx], (centers[tl] + rng.normal(
        0, 1.5, size=(n_test - n_dup, d))).astype(np.float32)])
    ty = np.concatenate([labels[dup_idx], tl])
    return x, labels.astype(np.int32), tx, ty.astype(np.int32)


def tiled_large(x: np.ndarray, y: np.ndarray, reps: int = 33):
    """The xl train set (BASELINE.json config 4, bench.py::_tiled_large):
    ``x`` tiled ``reps`` times with 1e-3 float32 noise (seed 0) so that the
    copies are not duplicates; 33 copies of the large fixture's train rows
    are 1,016,499 x 11."""
    rng = np.random.default_rng(0)
    feats = np.tile(x, (reps, 1))
    feats += 1e-3 * rng.standard_normal(feats.shape, dtype=np.float32)
    return feats, np.tile(y, reps)


def wide_data(seed: int = 0):
    """bench.py's mnist784 shape: 65,536 x 784 uniform [0, 1) float32 train
    rows, 2,048 queries, 10 random classes, from ``seed``."""
    n, q, d, classes = 65536, 2048, 784, 10
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), dtype=np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    y[:classes] = np.arange(classes)  # pin num_classes
    tx = rng.random((q, d), dtype=np.float32)
    ty = rng.integers(0, classes, q).astype(np.int32)
    return x, y, tx, ty


def write_arff(path: Path, x: np.ndarray, y: np.ndarray, relation: str) -> None:
    """ARFF as scripts/make_fixtures.py writes it (``%.6g`` cells), one
    ``np.savetxt`` format call per row: ~15 s for the wide train set."""
    d = x.shape[1]
    with open(path, "w") as fh:
        fh.write("\n".join([f"@relation {relation}", ""]
                           + [f"@attribute attr{i} NUMERIC" for i in range(d)]
                           + ["@attribute class NUMERIC", "", "@data", ""]))
        np.savetxt(fh, np.column_stack([x.astype(np.float64), y]),
                   fmt=["%.6g"] * d + ["%d"], delimiter=",")


def load_large(directory: "Path | None" = None):
    """``(train, test)`` Datasets of the large fixture (seed 0), parsed from
    ARFF files as bench.py's ``load_large`` parses the fixture ladder's: the
    ``%.6g`` cells round the features. The files are written under
    ``directory`` (default :data:`FIXTURE_DIR`) at first use; a file is
    renamed into place whole."""
    directory = Path(directory or FIXTURE_DIR)
    paths = [directory / f"large-{part}.arff" for part in ("train", "test")]
    if not all(p.exists() for p in paths):
        directory.mkdir(parents=True, exist_ok=True)
        x, y, tx, ty = large_fixture(seed=0)
        for path, xs, ys in zip(paths, (x, tx), (y, ty)):
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            write_arff(tmp, xs, ys, path.stem)
            os.replace(tmp, path)
    return load_arff(str(paths[0])), load_arff(str(paths[1]))
