"""ARFF loading front-end, and :func:`write_arff`.

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


def _quote(value: str) -> str:
    """Quote with whichever quote char the value doesn't contain — the
    dialect has no backslash escapes, so a value containing BOTH quote
    chars cannot be written."""
    if "'" not in value:
        return "'" + value + "'"
    if '"' not in value:
        return '"' + value + '"'
    raise ValueError(
        f"value {value!r} contains both quote characters and cannot be "
        f"represented in the ARFF dialect (no escape syntax exists)"
    )


def _quote_if_needed(name: str) -> str:
    # A leading %, { or @ must be quoted: a bare value opening a data line
    # re-reads as a comment, a sparse row, or a header directive.
    if name and name[0] not in "%{@" \
            and not any(c.isspace() for c in name) and "," not in name \
            and "'" not in name and '"' not in name:
        return name
    return _quote(name)


def write_arff(ds: Dataset, path: str) -> None:
    """Serialize a :class:`Dataset` to ARFF (the port of
    ``knn_tpu/data/arff.py::write_arff``).

    The output round-trips through :func:`load_arff` to identical arrays:
    features with NaN written as ``?``, the class column as its uncast
    target (``Dataset.targets``: an integer when it is whole, else the
    float's repr), nominal cells mapped back to their declared value
    strings.
    """
    n, d = ds.features.shape
    attrs = list(ds.attributes)
    if not attrs:
        attrs = [Attribute(f"attr{i}", "numeric") for i in range(d)] + [
            Attribute("class", "numeric")
        ]
    if len(attrs) != d + 1:
        raise ValueError(
            f"dataset declares {len(attrs)} attributes but has {d} feature "
            f"columns + 1 class column"
        )

    def data_value(raw: str) -> str:
        # "?" cannot round-trip: the dialect strips quotes before the
        # missing-value check, so even '?' reads back as missing.
        if raw == "?":
            raise ValueError(
                'the value "?" cannot be represented in the ARFF dialect: '
                "quoted or not, it parses back as a missing value"
            )
        return _quote_if_needed(raw)

    def attr_line(a: Attribute) -> str:
        if a.type == "nominal":
            vals = ",".join(data_value(v) for v in (a.nominal_values or []))
            return f"@attribute {_quote_if_needed(a.name)} {{{vals}}}"
        return f"@attribute {_quote_if_needed(a.name)} {a.type.upper()}"

    def cell(value: float, a: Attribute) -> str:
        if np.isnan(value):
            return "?"
        if a.type == "nominal" and a.nominal_values:
            return data_value(str(a.nominal_values[int(value)]))
        if a.type in ("string", "date") and a.string_values:
            # Interned code -> its original value, quoted where needed.
            return data_value(str(a.string_values[int(value)]))
        f = float(value)
        return str(int(f)) if f.is_integer() else repr(f)

    with open(path, "w", encoding="utf-8") as out:
        out.write(f"@relation {_quote_if_needed(ds.relation or 'dataset')}\n\n")
        for a in attrs:
            out.write(attr_line(a) + "\n")
        out.write("\n@data\n")
        for r in range(n):
            row = [cell(ds.features[r, c], attrs[c]) for c in range(d)]
            row.append(cell(float(ds.targets[r]), attrs[d]))
            out.write(",".join(row) + "\n")
