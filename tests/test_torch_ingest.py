"""Ingest parity: the port's ARFF loader against the JAX package's.

``knn_tpu_torch.data.arff.load_arff`` must return arrays byte-equal to
``knn_tpu.data.arff.load_arff(..., use_native=False)``, the same
attributes and ``num_classes``, and raise ``DataError`` with the same
message on malformed input.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.test_arff_malformed as malformed  # noqa: E402
from knn_tpu.data import arff as jarff  # noqa: E402
from knn_tpu.resilience.errors import DataError as JaxDataError  # noqa: E402
from knn_tpu_torch.data import arff as tarff  # noqa: E402
from knn_tpu_torch.resilience.errors import DataError  # noqa: E402
from tests import fixtures  # noqa: E402

# A file that takes the slow path: missing values, nominal and string
# columns, quoted cells, a comment, a row split over two lines.
DIALECT = """% comment
@relation 'mixed rel'
@attribute a NUMERIC
@attribute b {x,'y z'}
@attribute s STRING
@attribute c REAL
@data
1.5,x,'hello, world',0
?,'y z',foo,1
3e-2,x,
foo,2
"""


def _assert_same_dataset(got, want):
    for field in ("features", "labels", "raw_targets"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field
    assert got.relation == want.relation
    assert got.num_classes == want.num_classes
    assert [dataclasses.asdict(a) for a in got.attributes] == \
        [dataclasses.asdict(a) for a in want.attributes]


@pytest.mark.parametrize("size", ["small", "medium"])
@pytest.mark.parametrize("part", ["train", "test"])
def test_fixture_arrays_byte_equal(size, part):
    path = str(fixtures.datasets_dir() / f"{size}-{part}.arff")
    _assert_same_dataset(tarff.load_arff(path),
                         jarff.load_arff(path, use_native=False))


def test_dialect_file_byte_equal(tmp_path):
    path = tmp_path / "mixed.arff"
    path.write_text(DIALECT)
    got = tarff.load_arff(str(path))
    _assert_same_dataset(got, jarff.load_arff(str(path), use_native=False))
    assert np.isnan(got.features[1, 0])
    assert got.attributes[2].string_values == ["hello, world", "foo"]


@pytest.mark.parametrize(
    "case,content", [(m[0], m[1]) for m in malformed.MALFORMED],
    ids=[m[0] for m in malformed.MALFORMED],
)
def test_malformed_same_error(tmp_path, case, content):
    path = tmp_path / f"{case}.arff"
    path.write_text(content)
    with pytest.raises(JaxDataError) as want:
        jarff.load_arff(str(path), use_native=False)
    with pytest.raises(DataError) as got:
        tarff.load_arff(str(path))
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_missing_file_is_data_error():
    with pytest.raises(DataError, match="no-such.arff"):
        tarff.load_arff("/no/such/dir/no-such.arff")


def test_npz_cache_shared_with_jax_package(tmp_path, monkeypatch):
    # Same schema and environment variable: a cache the JAX package wrote
    # is read by the port, and the port's own round trip is byte-equal.
    src = tmp_path / "mixed.arff"
    src.write_text(DIALECT)
    monkeypatch.setenv("KNN_TPU_ARFF_CACHE", str(tmp_path / "cache"))
    want = jarff.load_arff(str(src), use_native=False)  # writes the cache
    cached = list((tmp_path / "cache").glob("*.npz"))
    assert len(cached) == 1 and tarff._cache_path(str(src)) == cached[0]
    _assert_same_dataset(tarff.load_arff(str(src)), want)
    cached[0].unlink()
    first = tarff.load_arff(str(src))  # parses and writes
    assert cached[0].exists()
    _assert_same_dataset(tarff.load_arff(str(src)), first)
