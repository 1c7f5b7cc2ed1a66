"""The ``cuda`` backend: classify through the stripe route's kernels.

The port of ``knn_tpu/backends/tpu.py``'s stripe route. In the JAX package,
``predict_arrays`` with engine ``auto`` sends to the stripe kernel the
problems ``stripe_route_ok`` admits — the exact form with d <= 128, the
bf16 form at any width, the fast form with d > 128, each with k <= 16 — and
everything else to the XLA scans. Here the stripe route is the only route:
the exact form with d <= 128 runs the stripe kernel, the bf16 and wide fast
forms the tile kernel (``ops/tile_knn.py``). An option the route cannot
honor raises a ``ValueError`` naming the ROADMAP item that will port it,
and is never computed some other way.

``device`` defaults to ``"cuda"``; ``"cpu"`` runs the kernels' plain
PyTorch versions on the host. A CUDA device that is absent is a
:class:`~knn_tpu_torch.resilience.errors.DeviceError`, never a fallback.
"""

from __future__ import annotations

import numpy as np

from knn_tpu_torch.backends import register
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.ops.cuda_knn import (
    STRIPE_MAX_K,
    _resolve_stripe_precision,
    stripe_classify_arrays,
    stripe_route_ok,
)
from knn_tpu_torch.ops.distance import resolve_form


def _check_supported(d: int, k: int, precision: str, metric: str,
                     engine: str, approx: bool) -> str:
    """The distance form to run, or a ``ValueError`` naming the ROADMAP
    item for what the stripe route does not take."""
    if engine == "xla":
        raise ValueError("engine='xla' (the XLA tiled scan) is not ported "
                         "yet (ROADMAP A3); use engine='auto' or 'stripe'")
    if engine not in ("auto", "stripe"):
        raise ValueError(
            f"unknown engine {engine!r}; choose 'auto', 'stripe', or 'xla'"
        )
    if approx:
        raise ValueError("approx top-k is not ported yet (ROADMAP B6)")
    if resolve_form(precision, metric) != precision:
        raise ValueError(f"metric {metric!r} is not ported yet (ROADMAP A3); "
                         "the cuda backend computes euclidean only")
    form = _resolve_stripe_precision(precision, d)
    if k > STRIPE_MAX_K:
        raise ValueError(f"k={k} > {STRIPE_MAX_K}: not ported yet (ROADMAP B1d)")
    if not stripe_route_ok(form, d, k):
        raise ValueError(
            f"precision {form!r} with d={d} takes the XLA scans on the tpu "
            "backend, which are not ported yet (ROADMAP A3); the cuda-tile "
            "backend runs it")
    return form


def predict_arrays(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    precision: str = "exact",
    metric: str = "euclidean",
    engine: str = "auto",
    approx: bool = False,
    device="cuda",
    device_cache: "dict | None" = None,
) -> np.ndarray:
    """Host-side entry: ``[Q]`` int32 predictions. ``device_cache``
    (normally the train ``Dataset.device_cache``) memoizes the device-side
    train arrays."""
    form = _check_supported(train_x.shape[1], k, precision, metric, engine,
                            approx)
    return stripe_classify_arrays(
        train_x, train_y, test_x, k, num_classes, precision=form,
        device=device, cache=device_cache,
    )


@register("cuda")
def predict(
    train: Dataset,
    test: Dataset,
    k: int,
    precision: str = "exact",
    metric: str = "euclidean",
    engine: str = "auto",
    approx: bool = False,
    device="cuda",
    **_unused,
) -> np.ndarray:
    train.validate_for_knn(k, test)
    return predict_arrays(
        train.features, train.labels, test.features, k, train.num_classes,
        precision=precision, metric=metric, engine=engine, approx=approx,
        device=device,
        device_cache=train.device_cache,
    )
