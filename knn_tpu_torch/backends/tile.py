"""The ``cuda-tile`` backend: the wide-feature rung.

The port of ``knn_tpu/backends/pallas.py`` (``tpu-pallas``), the rung that
BASELINE.json config 5 (MNIST-784-shaped data) runs. It calls
``ops/tile_knn.py::predict_tile``, the port of ``predict_pallas``:
``precision`` (exact, fast, bf16, or auto: exact for d <= 128, fast above)
picks the distance form, and ``engine`` (auto, stripe, merge) the route.

``device`` defaults to ``"cuda"``; ``"cpu"`` runs the kernels' plain
PyTorch versions on the host. On the card a kernel that fails raises: there
is no fallback to another route or to the host.
"""

from __future__ import annotations

import numpy as np

from knn_tpu_torch.backends import register
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.ops.tile_knn import predict_tile


@register("cuda-tile")
def predict(
    train: Dataset,
    test: Dataset,
    k: int,
    precision: str = "auto",
    engine: str = "auto",
    metric: str = "euclidean",
    device="cuda",
    **_unused,
) -> np.ndarray:
    if metric != "euclidean":
        raise ValueError("the tile kernels implement euclidean only")
    train.validate_for_knn(k, test)
    return predict_tile(
        train.features, train.labels, test.features, k, train.num_classes,
        precision=precision, engine=engine, device=device,
        cache=train.device_cache,
    )
