"""The ``cuda-tile`` backend: the wide-feature rung.

The port of ``knn_tpu/backends/pallas.py`` (``tpu-pallas``), the rung that
BASELINE.json config 5 (MNIST-784-shaped data) runs. It calls
``ops/tile_knn.py::predict_tile``, the port of ``predict_pallas``:
``precision`` (exact, fast, bf16, or auto: exact for d <= 128, fast above)
picks the distance form, and ``engine`` (auto, stripe, merge) the route.

``device`` defaults to ``"cuda"``; ``"cpu"`` runs the kernels' plain
PyTorch versions on the host. The call runs under JAX's nested
``device.put``/``backend.compile`` guards and ``kernel`` span; on the card
a kernel that fails raises after the retries: there is no fallback to
another route or to the host.
"""

from __future__ import annotations

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.backends import register
from knn_tpu_torch.backends.cuda import record_lookup
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.obs.instrument import record_transfer
from knn_tpu_torch.ops.tile_knn import predict_tile
from knn_tpu_torch.resilience.retry import guarded_call


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
    if obs.enabled():
        record_transfer(train.features.nbytes + train.labels.nbytes
                        + test.features.nbytes, backend="cuda-tile")
        record_lookup("cuda-tile", (engine, precision, test.num_instances, k,
                                    train.num_features))
    # The host entry uploads, launches and copies back inside one call:
    # nested guards give both fault points coverage over it.
    with obs.span("kernel", backend="cuda-tile", engine=engine):
        return guarded_call("device.put", lambda: guarded_call(
            "backend.compile", lambda: predict_tile(
                train.features, train.labels, test.features, k,
                train.num_classes, precision=precision, engine=engine,
                device=device, cache=train.device_cache,
            )))
