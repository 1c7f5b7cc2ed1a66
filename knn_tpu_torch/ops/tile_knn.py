"""Tile KNN on the card: the wide-feature rung's kernel wrapper, its plain
version, and its host entry.

The port of ``knn_tpu/ops/pallas_knn.py``'s tile-merge kernel
(``_knn_kernel``, engine ``merge``, in its exact, fast and bf16 forms), of
the fast and bf16 forms of its stripe kernel (``_knn_stripe_kernel``), and
of ``predict_pallas``, the host entry of the ``tpu-pallas`` backend. One
hand-written kernel, ``csrc/tile_knn.cu``, takes the form as a template
parameter and any number of features; see its header for the design. Its
per-split key lists are folded by the stripe kernel's merge
(``cuda_knn.knn_stripe_merge``). Both take any k up to 256
(``cuda_knn.KERNEL_MAX_K``), as the JAX tile-merge kernel takes any k; a
larger k is a ``ValueError`` naming ROADMAP B1d.

:func:`knn_tile_scan` is the wrapper (``knn_tile_scan.launches`` counts its
launches per form); :func:`knn_tile_scan_reference` its plain version;
:func:`knn_tile_candidates` plans the splits and runs scan and merge.

The norms of the matmul forms are hoisted out of the kernel, as in the JAX
package: the wrapper sums them in float32 with ``distance.sq_norms`` from
the values as stored, so a train matrix stored as bfloat16 gives the norms
of its rounded values, and the query norms come from the float32 queries.
Which store a route uses is part of the function: the stripe route stores
the bf16 form's train as bfloat16 only past 128 features
(``cuda_knn.stripe_store_dtype``), the merge route always
(:func:`merge_store_dtype`).

Not carried: the v5e block tunings (``block_q``/``block_n``), the feature
padding to 128 lanes, ``_wide_tile_fits``, and ``predict_pallas``'s
fallback from the stripe to the merge engine when a stripe dispatch fails:
on the card a failing kernel raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch.ops import _build
from knn_tpu_torch.ops.cuda_knn import (
    INT_MAX,
    _resolve_stripe_precision,
    cached_labels,
    cached_train,
    check_k,
    check_splits,
    knn_stripe_candidates_reference,
    knn_stripe_merge,
    knn_stripe_scan_reference,
    resolve_device,
    split_plan,
    stripe_classify_arrays,
    stripe_route_ok,
    to_device,
)
from knn_tpu_torch.ops.distance import sq_norms
from knn_tpu_torch.ops.vote import vote_neighbors
from knn_tpu_torch.resilience.errors import DeviceError

FORMS = ("exact", "fast", "bf16")  # the kernel's form codes 0, 1, 2

# Must match csrc/tile_knn.cu: train rows per tile (the split granule).
_TILE_ROWS = 128
# Scan blocks to aim for per SM (256 threads and ~83 KB of shared memory
# each): about two waves of resident blocks.
_BLOCKS_PER_SM = 4


def merge_store_dtype(form: str) -> torch.dtype:
    """How the JAX merge route stores the train matrix
    (``predict_pallas``, engine ``merge``): bfloat16 for the bf16 form at
    any width, float32 otherwise."""
    return torch.bfloat16 if form == "bf16" else torch.float32


def knn_tile_scan_reference(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    form: str, n_splits: int, rows_per_split: int,
) -> torch.Tensor:
    """The tile kernel's plain version: ``[Q, n_splits, k]`` int64 keys, for
    each split the k smallest keys of the ``form`` distances
    (``distance.DIST_FNS``) over its rows below ``n_valid``, selected
    through the packed key (``torch.topk`` and a matmul order ties
    otherwise)."""
    return knn_stripe_scan_reference(train_x, test_x, n_valid, k, n_splits,
                                     rows_per_split, form)


def knn_tile_candidates_reference(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    form: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan and merge as one plain function: ``([Q, k]`` float32
    distances, ``[Q, k]`` int32 indices``)``, ascending by the packed key."""
    return knn_stripe_candidates_reference(train_x, test_x, n_valid, k, form)


def _check_tile_inputs(train_x, test_x, n_valid: int, k: int, form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; the tile kernel takes {FORMS}")
    for name, t in (("train_x", train_x), ("test_x", test_x)):
        if t.device.type != "cuda" or t.device != train_x.device:
            raise ValueError(
                f"{name} is on {t.device}; the kernel needs both inputs on "
                f"one CUDA device (train_x is on {train_x.device})"
            )
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                             f"{tuple(t.shape)} contiguous={t.is_contiguous()}")
    if test_x.dtype != torch.float32:
        raise ValueError(f"test_x must be float32, got {test_x.dtype}")
    if train_x.dtype not in (torch.float32, torch.bfloat16) or (
            train_x.dtype == torch.bfloat16 and form != "bf16"):
        raise ValueError(f"train_x is {train_x.dtype}: the {form} form takes "
                         "float32, and only the bf16 form takes bfloat16")
    n, d = train_x.shape
    if test_x.shape[1] != d:
        raise ValueError(f"train has {d} features but test has {test_x.shape[1]}")
    check_k(k)
    if not 0 <= n_valid <= n or n >= INT_MAX:
        raise ValueError(f"n_valid={n_valid} must lie in [0, {n}] "
                         f"and N below {INT_MAX}")


_p, _i = ctypes.c_void_p, ctypes.c_int
# The C entry of csrc/tile_knn.cu; pointers and the stream are 64-bit.
_SIGNATURES = {
    "tile_knn_scan": ([_i, _i, _p, _p, _i, _p, _p, _i, _i, _i, _i, _i, _p, _p],
                      _i),
}


def _library():
    return _build.load_library("tile_knn", _SIGNATURES)


def knn_tile_scan(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    form: str, n_splits: int, rows_per_split: int,
) -> torch.Tensor:
    """``[N, D]`` train (float32, or bfloat16 for the bf16 form) and
    ``[Q, D]`` float32 queries -> ``[Q, n_splits, k]`` int64 keys, as
    :func:`knn_tile_scan_reference` gives them.

    CPU tensors take the plain version. CUDA tensors launch the tile kernel
    on the current stream, after the norms of the matmul forms, or raise.
    ``knn_tile_scan.launches[form]`` counts the launches."""
    n_valid, k = int(n_valid), int(k)
    n_splits, rows_per_split = int(n_splits), int(rows_per_split)
    if train_x.device.type == "cpu" and test_x.device.type == "cpu":
        return knn_tile_scan_reference(train_x, test_x, n_valid, k, form,
                                       n_splits, rows_per_split)
    _check_tile_inputs(train_x, test_x, n_valid, k, form)
    check_splits(n_valid, n_splits, rows_per_split)
    fn = _library().tile_knn_scan
    q, d = test_x.shape
    dev = train_x.device
    partial = torch.empty((q, n_splits, k), dtype=torch.int64, device=dev)
    if q == 0:
        return partial
    with torch.cuda.device(dev):
        q2 = t2 = None
        if form != "exact":
            q2, t2 = sq_norms(test_x), sq_norms(train_x)
        rc = fn(FORMS.index(form), int(train_x.dtype == torch.bfloat16),
                train_x.data_ptr(), None if t2 is None else t2.data_ptr(),
                n_valid, test_x.data_ptr(),
                None if q2 is None else q2.data_ptr(), q, d, k, n_splits,
                rows_per_split, partial.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise DeviceError(f"tile_knn_scan launch failed: CUDA error {rc}")
    knn_tile_scan.launches[form] += 1
    return partial


knn_tile_scan.launches = dict.fromkeys(FORMS, 0)


def knn_tile_candidates(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    form: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([Q, k]`` float32 distances, ``[Q, k]`` int32 indices``)``,
    ascending by (distance, index) over rows ``< n_valid``, in the distance
    form ``form``.

    CPU tensors take the plain version. CUDA tensors run
    :func:`knn_tile_scan` over the splits of ``split_plan`` (tiles of 128
    rows), then ``knn_stripe_merge``, or raise: a build failure is a
    :class:`CompileError`, a refused launch a :class:`DeviceError`, inputs
    the kernels do not take a ``ValueError``."""
    if train_x.device.type == "cpu" and test_x.device.type == "cpu":
        return knn_tile_candidates_reference(train_x, test_x, n_valid, k, form)
    n_valid = int(n_valid)
    _check_tile_inputs(train_x, test_x, n_valid, int(k), form)
    sm_count = torch.cuda.get_device_properties(
        train_x.device).multi_processor_count
    plan = split_plan(n_valid, test_x.shape[0], sm_count,
                      tile_rows=_TILE_ROWS, blocks_per_sm=_BLOCKS_PER_SM)
    return knn_stripe_merge(knn_tile_scan(train_x, test_x, n_valid, k, form,
                                          *plan))


def predict_tile(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    precision: str = "exact",
    engine: str = "auto",
    device="cuda",
    cache: Optional[dict] = None,
) -> np.ndarray:
    """Host entry of the ``cuda-tile`` backend, the port of
    ``predict_pallas``: ``[Q]`` int32 predictions.

    ``precision`` ``auto`` resolves to exact for d <= 128 and fast above.
    ``engine`` ``auto`` takes the stripe route where ``stripe_route_ok``
    holds (exact with d <= 128, bf16 at any width, fast with d > 128, each
    with k <= 16: ``cuda_knn.stripe_classify_arrays``) and the merge route
    otherwise (the tile kernel, train stored as :func:`merge_store_dtype`
    says), k > 16 included; ``stripe`` and ``merge`` force one. Both routes
    take 1 <= k <= 256; a larger k raises before any routing. ``cache`` (a ``Dataset.device_cache`` dict)
    memoizes the device-side train arrays. Nothing falls back: a route that
    fails raises."""
    d = train_x.shape[1]
    form = _resolve_stripe_precision(precision, d)
    check_k(k)
    if engine == "auto":
        engine = "stripe" if stripe_route_ok(form, d, k) else "merge"
    if engine not in ("stripe", "merge"):
        raise ValueError(
            f"unknown engine {engine!r}; use 'auto', 'stripe', or 'merge'")
    if engine == "stripe":
        return stripe_classify_arrays(train_x, train_y, test_x, k, num_classes,
                                      precision=form, device=device,
                                      cache=cache)
    dev = resolve_device(device)
    if test_x.shape[0] == 0:
        return np.empty(0, np.int32)
    tx = cached_train(train_x, dev, cache, merge_store_dtype(form))
    ty = cached_labels(train_y, dev, cache)
    _, idx = knn_tile_candidates(tx, to_device(test_x, np.float32, dev),
                                 train_x.shape[0], k, form)
    return vote_neighbors(idx, ty, num_classes).cpu().numpy()
