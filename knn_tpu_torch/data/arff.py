"""ARFF loading front-end.

Parses with the pure-Python dialect implementation
(:mod:`knn_tpu_torch.data.pyarff`), whose arrays are byte-equal to the JAX
package's parsers. An optional ``.npz`` cache keyed on the ARFF file's
path, size and mtime skips re-parsing; it has the JAX package's schema
(``_CACHE_SCHEMA = 3``) and environment variable, so either package reads a
cache the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from knn_tpu_torch.data import pyarff
from knn_tpu_torch.data.dataset import Attribute, Dataset
from knn_tpu_torch.resilience.errors import DataError

_CACHE_ENV = "KNN_TPU_ARFF_CACHE"
# Bumped when the cached array schema changes (v2: + raw_targets; v3:
# + Attribute.string_values for interned STRING/DATE columns), so caches
# written by older code are simply never found rather than silently read
# without the newer fields.
_CACHE_SCHEMA = 3


def _cache_path(path: str) -> Optional[Path]:
    cache_dir = os.environ.get(_CACHE_ENV, "")
    if not cache_dir:
        return None
    st = os.stat(path)
    key = f"v{_CACHE_SCHEMA}:{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}"
    digest = hashlib.sha256(key.encode()).hexdigest()[:24]
    return Path(cache_dir) / f"{Path(path).stem}-{digest}.npz"


def load_arff(path: str) -> Dataset:
    """Parse an ARFF file into a dense :class:`Dataset`. Parse failures are
    :class:`DataError` with file:line context; a missing or unreadable file
    is a :class:`DataError` too."""
    try:
        return _load_arff(path)
    except OSError as e:
        raise DataError(f"{path}: {e.strerror or e}") from e


def _load_arff(path: str) -> Dataset:
    cache = _cache_path(path)
    if cache is not None and cache.exists():
        with np.load(cache, allow_pickle=False) as z:
            attrs = [
                Attribute(
                    a["name"], a["type"], a.get("nominal_values"),
                    a.get("string_values"),
                )
                for a in json.loads(str(z["attributes"]))
            ]
            return Dataset(
                features=z["features"],
                labels=z["labels"],
                relation=str(z["relation"]),
                attributes=attrs,
                raw_targets=z["raw_targets"] if "raw_targets" in z else None,
            )

    ds = pyarff.parse_arff_file(path)
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            cache,
            features=ds.features,
            labels=ds.labels,
            raw_targets=ds.targets,
            relation=ds.relation,
            attributes=json.dumps(
                [
                    {
                        "name": a.name,
                        "type": a.type,
                        "nominal_values": a.nominal_values,
                        "string_values": a.string_values,
                    }
                    for a in ds.attributes
                ]
            ),
        )
    return ds
