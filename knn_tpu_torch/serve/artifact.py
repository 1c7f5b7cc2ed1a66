"""Index artifact store: versioned save/load of a fitted model (the port of
``knn_tpu/serve/artifact.py``, format 3, byte-compatible both ways).

A serving process boots from a PREBUILT index, not from raw ARFF: the parse
is paid once at build time by ``save-index``, not on every server start.
An artifact is a directory:

    index/
    ├── manifest.json   — format version, model family + hyperparameters
    │                     (k, metric, weights, backend/engine, opts),
    │                     array schema, attribute metadata, the training
    │                     distribution sketch and a schema hash
    └── arrays.npz      — the train arrays (features, labels, and
                          raw_targets when the source kept them)

The manifest is the contract: ``format`` gates forward compatibility
(loaders reject artifacts from a NEWER format rather than misread them),
and ``schema_hash`` pins manifest↔arrays consistency, so a hand-edited
manifest or a swapped ``arrays.npz`` fails typed
(:class:`~knn_tpu_torch.resilience.errors.DataError`).

**Both packages read each other's artifacts.** The manifest's ``backend``
names a rung, and the JAX loader hands ``backend_opts`` to its own
``KNNClassifier``, so the port writes only names and options the JAX
loader accepts and maps them on load, by one table
(:data:`BACKEND_NAMES`): ``cuda ↔ tpu``, ``cuda-tile ↔ tpu-pallas``,
``cuda-sharded ↔ tpu-sharded``, ``cuda-train-sharded ↔
tpu-train-sharded``, ``cuda-ring ↔ tpu-ring``, the host rungs as they
are. Run-time choices of the port (``device``) are
never manifest fields: :func:`load_index` takes the device as an argument.

**The IVF partition** (format 3, the index family): ``save_index(model,
path, ivf=...)`` writes the ``ivf`` manifest block and the three ``ivf_*``
arrays as the JAX package does, and :func:`load_index` validates them
(metric, row count, cell count, corrupt arrays: each a typed
:class:`DataError`) and attaches the partition as ``model.ivf_``.

**The mutable tier's files** (``serve --mutable on``, ``mutable/``): a
write-ahead epoch log (``epochs/epoch-<N>.jsonl``, one JSON record per
acknowledged mutation, flushed before the ack), compacted generations
(``generations/gen-<N>/``, ordinary format-3 artifacts with an additive
``mutable`` manifest block and a ``mutable_stable_ids`` array) and an
atomically replaced ``CURRENT.json`` pointer naming the base generation and
the sequence number folded into it. None of this bumps the format: with
``--mutable off`` an artifact that carries them loads as a plain one, as
the JAX package's does, and the epoch files are byte-equal to the JAX
package's for the same mutations.

:func:`warmup` is the boot step between load and ready. The card has no
compile to hide, but the first retrieval builds the kernel library when it
is missing, uploads the train and its feature-major copy, and sizes the
split plans; warming every dispatch shape before ``/healthz`` reports
ready keeps all of that out of user requests.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.data.dataset import Attribute, Dataset
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor
from knn_tpu_torch.resilience.errors import DataError

#: The JAX package's format (1: the layout; 2: ``drift_sketch``; 3: the
#: optional IVF partition). Loaders accept 1-3.
ARTIFACT_FORMAT = 3
MANIFEST_NAME = "manifest.json"
ARRAYS_NAME = "arrays.npz"

#: The mutable tier's files in an artifact directory (see the module
#: docstring).
EPOCHS_DIR = "epochs"
GENERATIONS_DIR = "generations"
CURRENT_NAME = "CURRENT.json"

#: Port backend -> the manifest's (JAX) backend name. The one table both
#: directions read: save writes the right-hand name, load maps it back.
BACKEND_NAMES = {
    "cuda": "tpu",
    "cuda-tile": "tpu-pallas",
    "cuda-sharded": "tpu-sharded",
    "cuda-train-sharded": "tpu-train-sharded",
    "cuda-ring": "tpu-ring",
    "native": "native",
    "native-mt": "native-mt",
    "oracle": "oracle",
}
_PORT_BACKEND = {v: k for k, v in BACKEND_NAMES.items()}

#: Backend options of the port that are run-time choices, never manifest
#: fields (the JAX loader would hand them to its backend).
RUNTIME_OPTS = ("device",)


def schema_hash(ds: Dataset) -> str:
    """Digest over the dataset's SCHEMA — attribute metadata plus array
    shapes/dtypes, not the data values. The JAX package's definition, so
    an index hashes the same in either package."""
    payload = json.dumps(
        {
            "attributes": [
                {
                    "name": a.name,
                    "type": a.type,
                    "nominal_values": a.nominal_values,
                    "string_values": a.string_values,
                }
                for a in ds.attributes
            ],
            "features": [list(ds.features.shape), str(ds.features.dtype)],
            "labels": [list(ds.labels.shape), str(ds.labels.dtype)],
            "raw_targets": (
                [list(ds.raw_targets.shape), str(ds.raw_targets.dtype)]
                if ds.raw_targets is not None else None
            ),
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def _model_manifest(model) -> dict:
    if isinstance(model, KNNClassifier):
        backend = BACKEND_NAMES.get(model.backend_name)
        if backend is None:
            raise ValueError(f"backend {model.backend_name!r} has no "
                             f"artifact name; choose from "
                             f"{sorted(BACKEND_NAMES)}")
        return {
            "family": "classifier",
            "k": model.k,
            "metric": model.metric,
            "weights": model.weights,
            "backend": backend,
            "backend_opts": {k: v for k, v in model.backend_opts.items()
                             if k not in RUNTIME_OPTS},
        }
    if isinstance(model, KNNRegressor):
        return {
            "family": "regressor",
            "k": model.k,
            "metric": model.metric,
            "weights": model.weights,
            "engine": model.engine,
        }
    raise TypeError(
        f"cannot save a {type(model).__name__}; expected KNNClassifier or "
        f"KNNRegressor"
    )


def save_index(model, path, ivf=None, mutable_block=None) -> Path:
    """Write a fitted model to ``path`` (a directory; created if missing).

    ``ivf`` — an optional :class:`~knn_tpu_torch.index.ivf.IVFIndex` to
    persist with the model (``save-index --ivf-cells``); when None, a
    partition already attached to the model (``model.ivf_``, the load and
    re-save round trip) is kept. It must span exactly the train rows, and
    the model's metric must be euclidean (``ValueError`` otherwise).

    ``mutable_block`` — the compactor's generation metadata (a dict with
    ``stable_ids``, int64 per train row, plus JSON fields such as
    ``folded_seq``/``next_stable``/``generation``): persisted as an additive
    ``mutable`` manifest entry and a ``mutable_stable_ids`` array, ignored
    by plain loads.

    Refuses to clobber a non-empty directory that is not already an
    artifact (no ``manifest.json``) — re-saving over an existing artifact
    is fine. Raises ``ValueError``/``OSError`` for bad inputs/paths (the
    CLI maps both to exit 2). The manifest lands last and atomically."""
    from knn_tpu_torch.index.ivf import IVF_ATTR
    from knn_tpu_torch.obs.drift import StreamSketch

    train = model.train_  # RuntimeError before fit
    manifest = _model_manifest(model)
    if ivf is None:
        ivf = getattr(model, IVF_ATTR, None)
    if ivf is not None and ivf.num_rows != train.num_instances:
        raise ValueError(
            f"ivf partition spans {ivf.num_rows} rows but the train set "
            f"has {train.num_instances} — rebuild the partition from "
            f"this data"
        )
    if ivf is not None and manifest.get("metric") != "euclidean":
        # The cells are Voronoi regions of squared-euclidean k-means.
        raise ValueError(
            f"ivf partitions are euclidean-only; this model uses metric "
            f"{manifest.get('metric')!r}"
        )
    out = Path(path)
    if out.exists():
        if not out.is_dir():
            raise ValueError(f"{out}: exists and is not a directory")
        if any(out.iterdir()) and not (out / MANIFEST_NAME).exists():
            raise ValueError(
                f"{out}: non-empty directory without a {MANIFEST_NAME} — "
                f"refusing to overwrite something that is not an index "
                f"artifact"
            )
    out.mkdir(parents=True, exist_ok=True)
    arrays = {"features": train.features, "labels": train.labels}
    if train.raw_targets is not None:
        arrays["raw_targets"] = train.raw_targets
    if ivf is not None:
        arrays.update(ivf.to_arrays())
        manifest["ivf"] = ivf.manifest_entry()
    if mutable_block is not None:
        block = dict(mutable_block)
        stable = np.asarray(block.pop("stable_ids"), np.int64)
        if stable.shape != (train.num_instances,):
            raise ValueError(
                f"mutable stable_ids must be one int64 per train row "
                f"({train.num_instances}), got shape {stable.shape}"
            )
        arrays["mutable_stable_ids"] = stable
        manifest["mutable"] = block
    np.savez(out / ARRAYS_NAME, **arrays)
    manifest.update(
        format=ARTIFACT_FORMAT,
        drift_sketch=StreamSketch.from_data(train.features).to_dict(),
        created_unix=round(time.time(), 3),
        relation=train.relation,
        attributes=[
            {
                "name": a.name,
                "type": a.type,
                "nominal_values": a.nominal_values,
                "string_values": a.string_values,
            }
            for a in train.attributes
        ],
        train_rows=int(train.num_instances),
        num_features=int(train.num_features),
        num_classes=int(train.num_classes),
        dtype=str(train.features.dtype),
        schema_hash=schema_hash(train),
    )
    tmp = out / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, out / MANIFEST_NAME)
    return out


def read_manifest(path) -> dict:
    """Read + validate an artifact's manifest without loading the arrays.
    Raises :class:`DataError` like :func:`load_index`."""
    return _read_manifest(Path(path))


def reference_sketch(manifest: dict) -> Optional[dict]:
    """The artifact's training-distribution sketch, or None for a
    pre-sketch (format 1) artifact."""
    sketch = manifest.get("drift_sketch")
    return sketch if isinstance(sketch, dict) else None


def index_version(manifest: dict) -> str:
    """Opaque version tag for an artifact: ``<created_unix>-<hash8>`` (a
    re-save moves the timestamp, so an operator can tell builds apart)."""
    return (f"{manifest.get('created_unix', 0)}-"
            f"{str(manifest.get('schema_hash', ''))[:8]}")


def _read_manifest(root: Path) -> dict:
    mf = root / MANIFEST_NAME
    if not root.exists():
        raise DataError(f"{root}: index artifact not found")
    if not root.is_dir() or not mf.exists():
        raise DataError(
            f"{root}: not an index artifact (no {MANIFEST_NAME}); build one "
            f"with `save-index`"
        )
    try:
        manifest = json.loads(mf.read_text())
    except (OSError, ValueError) as e:
        raise DataError(f"{mf}: unreadable manifest: {e}") from e
    fmt = manifest.get("format")
    if not isinstance(fmt, int) or fmt < 1:
        raise DataError(f"{mf}: missing/invalid format field: {fmt!r}")
    if fmt > ARTIFACT_FORMAT:
        raise DataError(
            f"{mf}: artifact format {fmt} is newer than this build "
            f"supports ({ARTIFACT_FORMAT}); rebuild the index or upgrade"
        )
    return manifest


def load_index(path, device="cuda"):
    """Load an artifact (the port's or the JAX package's) into a fitted
    model that runs on ``device``. Raises :class:`DataError` — typed,
    never a traceback — for missing, corrupt or newer-format artifacts. The
    mutable tier's parts (epochs, generations, ``CURRENT.json``, a
    ``mutable`` block) are not read here: ``resolve_mutable_base`` names
    the directory a mutable boot loads."""
    import zipfile

    root = Path(path)
    manifest = _read_manifest(root)
    ivf_manifest = manifest.get("ivf")
    ivf_arrays = None
    try:
        with np.load(root / ARRAYS_NAME, allow_pickle=False) as z:
            features = z["features"]
            labels = z["labels"]
            raw_targets = z["raw_targets"] if "raw_targets" in z else None
            if isinstance(ivf_manifest, dict):
                # Validated into an IVFIndex below, after the dataset's
                # own schema checks pass.
                ivf_arrays = {k: z[k] for k in
                              ("ivf_centroids", "ivf_row_perm",
                               "ivf_cell_offsets") if k in z}
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        raise DataError(f"{root / ARRAYS_NAME}: unreadable arrays: {e}") from e
    attrs = [
        Attribute(
            a["name"], a["type"], a.get("nominal_values"),
            a.get("string_values"),
        )
        for a in manifest.get("attributes", [])
    ]
    train = Dataset(
        features=features, labels=labels,
        relation=manifest.get("relation", ""), attributes=attrs,
        raw_targets=raw_targets,
    )
    want = manifest.get("schema_hash")
    got = schema_hash(train)
    if want != got:
        raise DataError(
            f"{root}: schema hash mismatch (manifest {want!r}, arrays "
            f"{got!r}) — the manifest and arrays.npz are not from the same "
            f"save; rebuild the index"
        )
    family = manifest.get("family")
    try:
        if family == "classifier":
            name = manifest.get("backend", "tpu")
            backend = _PORT_BACKEND.get(name)
            if backend is None:
                raise DataError(
                    f"{root}: backend {name!r} is not a backend of this "
                    f"package; known: {sorted(_PORT_BACKEND)}"
                )
            opts = {k: v for k, v in manifest.get("backend_opts", {}).items()
                    if k not in RUNTIME_OPTS}
            model = KNNClassifier(
                k=manifest["k"], backend=backend,
                metric=manifest.get("metric", "euclidean"),
                weights=manifest.get("weights", "uniform"),
                device=device, **opts,
            )
        elif family == "regressor":
            model = KNNRegressor(
                k=manifest["k"],
                weights=manifest.get("weights", "uniform"),
                metric=manifest.get("metric", "euclidean"),
                engine=manifest.get("engine", "auto"), device=device,
            )
        else:
            raise DataError(f"{root}: unknown model family {family!r}")
        model.fit(train)
    except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, DataError):
            raise
        raise DataError(f"{root}: manifest does not describe a loadable "
                        f"model: {e}") from e
    if isinstance(ivf_manifest, dict):
        from knn_tpu_torch.index.ivf import IVF_ATTR, IVFIndex

        if manifest.get("metric") != "euclidean":
            # save_index refuses this pairing; an artifact carrying it was
            # hand-edited (schema_hash does not cover the metric field).
            raise DataError(
                f"{root}: artifact pairs an ivf partition with metric "
                f"{manifest.get('metric')!r}; ivf partitions are "
                f"euclidean-only — rebuild the index"
            )
        setattr(model, IVF_ATTR, IVFIndex.from_arrays(
            ivf_arrays or {}, ivf_manifest,
            train_rows=train.num_instances,
            num_features=train.num_features, where=str(root),
        ))
    return model


# -- delta-epoch persistence (the mutable tier) -----------------------------


def epoch_path(root, epoch: int) -> Path:
    return Path(root) / EPOCHS_DIR / f"epoch-{epoch:08d}.jsonl"


def generation_path(root, generation: int) -> Path:
    return Path(root) / GENERATIONS_DIR / f"gen-{generation:06d}"


def list_epochs(root) -> "list[tuple[int, Path]]":
    """Epoch-log files under ``root``, sorted by epoch number. A file that
    does not match the naming scheme is a typed refusal (something else
    wrote into the write-ahead log's directory); a ``.jsonl.tmp`` left by a
    crash inside :func:`repair_epoch` is skipped (the original is intact)."""
    d = Path(root) / EPOCHS_DIR
    if not d.is_dir():
        return []
    out = []
    for p in sorted(d.iterdir()):
        if p.name.endswith(".jsonl.tmp"):
            continue
        if not (p.name.startswith("epoch-") and p.name.endswith(".jsonl")):
            raise DataError(
                f"{p}: not an epoch-log file; the {EPOCHS_DIR}/ directory "
                f"belongs to the mutable tier's write-ahead log"
            )
        try:
            out.append((int(p.name[len("epoch-"):-len(".jsonl")]), p))
        except ValueError as e:
            raise DataError(f"{p}: unparseable epoch number") from e
    out.sort()
    return out


def read_epoch_records(path, tolerate_torn: bool = False):
    """Parse one epoch log: ``(records, torn)``. ``torn`` is True when the
    FINAL line is an unparseable fragment and ``tolerate_torn`` allowed it
    (a crash mid-append: that mutation was never acknowledged). A bad line
    anywhere else, or a final fragment without tolerance, is a typed
    :class:`DataError`: the log is corrupt, not merely truncated."""
    path = Path(path)
    try:
        lines = path.read_text(encoding="utf-8").splitlines()
    except OSError as e:
        raise DataError(f"{path}: unreadable epoch log: {e}") from e
    records = []
    for n, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict) or "seq" not in rec:
                raise ValueError("not a mutation record")
        except ValueError as e:
            if tolerate_torn and n == len(lines) - 1:
                return records, True
            raise DataError(
                f"{path}:{n + 1}: corrupt epoch-log record: {e}"
            ) from e
        records.append(rec)
    return records, False


def _record_line(record: dict) -> str:
    """One epoch-log line: the JAX package's bytes for the same record."""
    return json.dumps(record, separators=(",", ":")) + "\n"


def repair_epoch(path, records: "list[dict]") -> None:
    """Rewrite an epoch log as exactly ``records`` (atomic replace) — boot
    replay's repair after it dropped a tolerated torn final fragment (once
    a later epoch exists this one loses its torn-tolerance, so an
    unrepaired fragment would make the next boot refuse)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(_record_line(rec))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class EpochLog:
    """Append side of one write-ahead epoch file. Every record is written
    and FLUSHED before the mutation is acknowledged: a killed process loses
    at most the in-flight (never-acked) append."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def append(self, record: dict) -> None:
        self._f.write(_record_line(record))
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def read_current(root) -> Optional[dict]:
    """The compaction pointer, or None for a never-compacted artifact."""
    p = Path(root) / CURRENT_NAME
    if not p.exists():
        return None
    try:
        doc = json.loads(p.read_text())
        if not isinstance(doc, dict) or "generation" not in doc:
            raise ValueError("not a compaction pointer")
        return doc
    except (OSError, ValueError) as e:
        raise DataError(f"{p}: unreadable compaction pointer: {e}") from e


def write_current(root, doc: dict) -> None:
    """Atomically replace the compaction pointer — the commit point of a
    compaction: a crash before it leaves the old generation serving with
    every epoch record still replayable."""
    p = Path(root) / CURRENT_NAME
    tmp = p.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, p)


def resolve_mutable_base(root) -> "tuple[Path, Optional[dict]]":
    """Where a mutable boot loads its base model from: the generation
    ``CURRENT.json`` points at, or ``root`` itself for a never-compacted
    artifact. Returns ``(base_dir, current_doc)``."""
    root = Path(root)
    cur = read_current(root)
    if cur is None:
        return root, None
    rel = cur.get("base")
    base = root / rel if rel else root
    if not (base / MANIFEST_NAME).exists():
        raise DataError(
            f"{root}: {CURRENT_NAME} points at missing generation "
            f"{rel!r}; the artifact is corrupt"
        )
    return base, cur


def read_mutable_block(base_dir) -> "tuple[Optional[dict], Optional[np.ndarray]]":
    """The generation's mutable metadata: ``(manifest block, stable_ids)``
    — both None for a never-compacted artifact, whose base rows keep
    stable ids ``0..N-1``."""
    import zipfile

    base_dir = Path(base_dir)
    manifest = _read_manifest(base_dir)
    block = manifest.get("mutable")
    if not isinstance(block, dict):
        return None, None
    try:
        with np.load(base_dir / ARRAYS_NAME, allow_pickle=False) as z:
            stable = np.asarray(z["mutable_stable_ids"], np.int64)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        raise DataError(
            f"{base_dir}: manifest declares a mutable block but "
            f"mutable_stable_ids is unreadable: {e}"
        ) from e
    return block, stable


def warmup(model, batch_sizes=(1, 256), kinds=("predict",)) -> dict:
    """Run the serving dispatch at each batch size before ready.

    Each ``kind`` runs at each batch size on rows drawn from the fitted
    train set. On the card the first call builds the kernel library when
    it is missing, uploads the train (and the kernels' feature-major copy)
    and asks the card for its split plans; later shapes launch the kernels
    once each. Returns ``{f"{kind}@{rows}": wall_ms}``."""
    train = model.train_
    out = {}
    with obs.span("serve.warmup", shapes=len(batch_sizes) * len(kinds)):
        for rows in sorted({int(b) for b in batch_sizes}):
            if rows < 1:
                raise ValueError(f"warmup batch sizes must be >= 1: {rows}")
            reps = -(-rows // train.num_instances)  # ceil
            feats = np.tile(train.features, (reps, 1))[:rows]
            ds = Dataset(feats, np.zeros(rows, np.int32))
            for kind in kinds:
                t0 = time.monotonic()
                if kind == "predict":
                    if isinstance(model, KNNClassifier):
                        model.predict_from_candidates(*model.kneighbors(ds))
                    else:
                        model.predict(ds)
                elif kind == "kneighbors":
                    model.kneighbors(ds)
                else:
                    raise ValueError(f"unknown warmup kind {kind!r}")
                out[f"{kind}@{rows}"] = round(
                    (time.monotonic() - t0) * 1e3, 3
                )
    return out
