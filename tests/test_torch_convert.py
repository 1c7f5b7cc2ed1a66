"""Carrying a ``knn_tpu`` dataset across to the port (``convert.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.data.arff import load_arff as jax_load_arff  # noqa: E402
from knn_tpu_torch.backends import cuda as cuda_backend  # noqa: E402
from knn_tpu_torch.convert import dataset_from_arrays  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from tests import fixtures  # noqa: E402


def _convert(ds):
    return dataset_from_arrays(
        ds.features, ds.labels,
        attributes=[dataclasses.asdict(a) for a in ds.attributes],
        relation=ds.relation, raw_targets=ds.raw_targets,
    )


@pytest.mark.parametrize("size", ["small", "medium"])
def test_converted_fixture_predicts_like_own_load(size):
    d = fixtures.datasets_dir()
    tr, te = str(d / f"{size}-train.arff"), str(d / f"{size}-test.arff")
    train, test = _convert(jax_load_arff(tr)), _convert(jax_load_arff(te))
    own_train, own_test = load_arff(tr), load_arff(te)
    for got, own in ((train, own_train), (test, own_test)):
        assert got.features.tobytes() == own.features.tobytes()
        np.testing.assert_array_equal(got.labels, own.labels)
        assert got.num_classes == own.num_classes
        assert got.attributes == own.attributes
        assert got.relation == own.relation
    want = cuda_backend.predict(own_train, own_test, 5, device="cpu")
    np.testing.assert_array_equal(
        cuda_backend.predict(train, test, 5, device="cpu"), want)


def test_arrays_are_copied_and_coerced():
    features = np.arange(12, dtype=np.float64).reshape(4, 3)
    labels = np.array([0, 1, 1, 2], dtype=np.int64)
    ds = dataset_from_arrays(features, labels)
    assert ds.features.dtype == np.float32 and ds.labels.dtype == np.int32
    assert ds.num_classes == 3 and ds.attributes == [] and ds.relation == ""
    features[0, 0] = 99.0
    assert ds.features[0, 0] == 0.0
    with pytest.raises(ValueError):
        dataset_from_arrays(features, labels[:3])
