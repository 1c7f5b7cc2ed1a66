"""Carry a ``knn_tpu`` dataset across to the port.

KNN has no learned weights: its state is the train set. A ``knn_tpu``
``Dataset`` crosses as its fields — numpy arrays and plain values, never
the object itself, so this module needs nothing of the JAX package —
and comes out as the port's :class:`~knn_tpu_torch.data.dataset.Dataset`.
Attributes cross as dicts with the keys of the ARFF ``.npz`` cache's JSON
schema (``name``, ``type``, ``nominal_values``, ``string_values``), which
``dataclasses.asdict`` of a ``knn_tpu`` ``Attribute`` produces.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from knn_tpu_torch.data.dataset import Attribute, Dataset


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
