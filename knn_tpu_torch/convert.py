"""Carry a ``knn_tpu`` dataset, and an IVF partition, across to the port.

KNN has no learned weights: its state is the train set, and for the index
family the partition built from it. A ``knn_tpu`` ``Dataset`` crosses as
its fields — numpy arrays and plain values, never the object itself, so
this module needs nothing of the JAX package — and comes out as the port's
:class:`~knn_tpu_torch.data.dataset.Dataset`; a ``knn_tpu`` ``IVFIndex``
crosses as its three arrays and its manifest block
(:func:`ivf_from_arrays`).
Attributes cross as dicts with the keys of the ARFF ``.npz`` cache's JSON
schema (``name``, ``type``, ``nominal_values``, ``string_values``), which
``dataclasses.asdict`` of a ``knn_tpu`` ``Attribute`` produces.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from knn_tpu_torch.data.dataset import Attribute, Dataset
from knn_tpu_torch.index.ivf import IVFIndex


def dataset_from_arrays(
    features: np.ndarray,
    labels: np.ndarray,
    attributes: Optional[Sequence[Mapping]] = None,
    relation: str = "",
    raw_targets: Optional[np.ndarray] = None,
) -> Dataset:
    """``features`` ``[N, D-1]`` float32, ``labels`` ``[N]`` int32 and,
    optionally, the attribute dicts, relation name and uncast class column
    -> the port's Dataset (arrays copied, so the source stays untouched)."""
    attrs = [
        Attribute(a["name"], a["type"], a.get("nominal_values"),
                  a.get("string_values"))
        for a in attributes or ()
    ]
    return Dataset(
        features=np.array(features, dtype=np.float32),
        labels=np.array(labels, dtype=np.int32),
        relation=relation,
        attributes=attrs,
        raw_targets=None if raw_targets is None
        else np.array(raw_targets, dtype=np.float32),
    )


def ivf_from_arrays(centroids: np.ndarray, row_perm: np.ndarray,
                    cell_offsets: np.ndarray,
                    meta: Optional[Mapping] = None) -> IVFIndex:
    """A ``knn_tpu`` partition's ``centroids [C, D]``, ``row_perm [N]`` and
    ``cell_offsets [C+1]`` (``IVFIndex.to_arrays``) and manifest block
    (``IVFIndex.meta``) -> the port's :class:`IVFIndex`, validated as the
    artifact loader validates it (a typed ``DataError`` for a partition
    that is not one). Arrays are copied."""
    c = np.array(centroids, dtype=np.float32)
    perm = np.array(row_perm, dtype=np.int64)
    offsets = np.array(cell_offsets, dtype=np.int64)
    return IVFIndex.from_arrays(
        {"ivf_centroids": c, "ivf_row_perm": perm,
         "ivf_cell_offsets": offsets},
        dict(meta or {}), train_rows=perm.shape[0],
        num_features=c.shape[1] if c.ndim == 2 else -1,
        where="ivf_from_arrays")
