"""Generated data for the probes, the gates and ``chip_smoke.py``.

The port's copy of the JAX package's ``scripts/make_fixtures.py`` (the
small, medium and large fixtures; the ARFF files are byte-identical to
that script's for the same seed) and of ``bench.py::load_large``, of its
xl train set (the large train rows tiled), and of the wide
(MNIST-784-shaped) arrays of ``bench.py``'s mnist784 config. Everything is
made from a seed; nothing is read from outside the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from knn_tpu_torch.data.arff import load_arff

# Where the fixture ladder's ARFF files are written: build/ at the
# repository root.
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "build" / "probe-fixtures"

#: The fixture ladder of scripts/make_fixtures.py: name -> (train rows,
#: test rows, features).
SIZES = {
    "small": (592, 80, 7),
    "medium": (7354, 370, 11),
    "large": (30803, 1718, 11),
}


def fixture(size: str, seed: int = 0):
    """``(train_x, train_y, test_x, test_y)`` of fixture ``size`` by the
    recipe of scripts/make_fixtures.py: sentinel rows 0..9 pin
    num_classes = 10; half the test rows duplicate train rows
    (dist == 0)."""
    n_train, n_test, d = SIZES[size]
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


def large_fixture(seed: int = 0):
    """The large fixture's arrays: 30,803 train x 1,718 test, 11 features,
    10 classes (:func:`fixture`)."""
    return fixture("large", seed)


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


def fixture_paths(size: str, directory: "Path | None" = None):
    """``(train, test)`` ARFF paths of fixture ``size`` (seed 0) under
    ``directory`` (default :data:`FIXTURE_DIR`), written at first use as
    scripts/make_fixtures.py writes them; a file is renamed into place
    whole."""
    directory = Path(directory or FIXTURE_DIR)
    paths = [directory / f"{size}-{part}.arff" for part in ("train", "test")]
    if not all(p.exists() for p in paths):
        directory.mkdir(parents=True, exist_ok=True)
        x, y, tx, ty = fixture(size, seed=0)
        for path, xs, ys in zip(paths, (x, tx), (y, ty)):
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            write_arff(tmp, xs, ys, path.stem)
            os.replace(tmp, path)
    return paths[0], paths[1]


def load_pair(size: str, directory: "Path | None" = None):
    """``(train, test)`` Datasets of fixture ``size``, parsed from its ARFF
    files (:func:`fixture_paths`) as the JAX package's tests and bench.py
    parse the fixture ladder's: the ``%.6g`` cells round the features."""
    train, test = fixture_paths(size, directory)
    return load_arff(str(train)), load_arff(str(test))


def load_large(directory: "Path | None" = None):
    """``(train, test)`` Datasets of the large fixture (:func:`load_pair`)."""
    return load_pair("large", directory)
