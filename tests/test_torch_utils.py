"""The port's utils against the JAX package's: same output, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu.utils import cli_format as jfmt  # noqa: E402
from knn_tpu.utils import evaluate as jeval  # noqa: E402
from knn_tpu.utils import padding as jpad  # noqa: E402
from knn_tpu_torch.utils import cli_format, evaluate, padding  # noqa: E402
from knn_tpu_torch.utils.timing import RegionTimer  # noqa: E402


@pytest.mark.parametrize("args", [
    (1, 80, 592, 3, 0.85), (5, 1718, 30803, 1234, 0.99485), (10, 0, 1, 0, 0.0),
])
def test_result_line_and_json_byte_identical(args):
    assert cli_format.result_line(*args) == jfmt.result_line(*args)
    assert cli_format.result_json(*args, "cuda") == jfmt.result_json(*args, "cuda")


def test_confusion_matrix_and_accuracy_match():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 5, 300).astype(np.int32)
    true = rng.integers(0, 4, 300).astype(np.int32)  # predictions exceed it
    cm = evaluate.confusion_matrix(pred, true, 4)
    np.testing.assert_array_equal(cm, jeval.confusion_matrix(pred, true, 4))
    assert evaluate.accuracy(cm) == jeval.accuracy(cm)
    assert evaluate.accuracy(np.zeros((2, 2))) == 0.0


def test_padding_matches():
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    for axis, mult in ((0, 4), (1, 3), (0, 5)):
        got, n = padding.pad_axis_to_multiple(a, mult, axis=axis, value=-1)
        want, wn = jpad.pad_axis_to_multiple(a, mult, axis=axis, value=-1)
        np.testing.assert_array_equal(got, want)
        assert n == wn
    np.testing.assert_array_equal(padding.pad_axis_to_size(a, 7),
                                  jpad.pad_axis_to_size(a, 7))
    with pytest.raises(ValueError):
        padding.pad_axis_to_size(a, 4)


def test_region_timer():
    t = RegionTimer()
    with pytest.raises(RuntimeError):
        t.ms
    with t:
        pass
    assert t.ms == t.ns // 1_000_000 >= 0
