"""Tile KNN on the card: the wide-feature rung's kernel wrapper, its plain
version, and its host entry.

The port of ``knn_tpu/ops/pallas_knn.py``'s tile-merge kernel
(``_knn_kernel``, engine ``merge``, in its exact, fast and bf16 forms), of
the fast and bf16 forms of its stripe kernel (``_knn_stripe_kernel``), and
of ``predict_pallas``, the host entry of the ``tpu-pallas`` backend. The
hand-written kernels of ``csrc/tile_knn.cu`` take any number of features:
one on the CUDA cores for the exact and fast forms (the form a template
parameter), and one on the tensor cores for the bf16 form (``wgmma`` fed by
TMA, ``csrc/wgmma_tile.cuh``); see the source's header for the design.
Their per-split key lists are folded by the stripe kernel's merge
(``cuda_knn.knn_stripe_merge``). Both take any k >= 1, as the JAX
tile-merge kernel does: up to 16 the scan keeps register lists, above it a
threshold-filtered list in its output row, and :func:`tile_split_plan`
makes each split at least 2k rows so that the list fills in its first half.

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
(:func:`merge_store_dtype`). The bf16 kernel reads bfloat16 copies of both
operands (:func:`bf16_operand`): rounded once to nearest even, as the plain
version rounds them, and zero-padded to a multiple of 64 features; the
train's copy is kept with the stored train tensor, so a train set in
``Dataset.device_cache`` is copied once per device and store.

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
from torch.utils.weak import WeakIdKeyDictionary

from knn_tpu_torch.ops import _build
from knn_tpu_torch.ops.cuda_knn import (
    INT_MAX,
    STRIPE_MAX_K,
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

FORMS = ("exact", "fast", "bf16")  # tile_knn_scan's form codes 0, 1

# Must match csrc/tile_knn.cu: train rows per tile (the split granule).
_TILE_ROWS = 128
# Scan blocks to aim for per SM: about two waves of the CUDA-core forms'
# resident blocks (256 threads and ~83 KB of shared memory each), one wave
# of the bf16 kernel's (one block per SM at ~200 KB).
_BLOCKS_PER_SM = 4
_BF16_BLOCKS_PER_SM = 1
# At k > 16, a split holds at least this many times k rows: longer splits
# pass fewer rows per split through the list's fill, shorter ones give the
# card more blocks (on an H100 at 30,803 rows and k = 1000, splits of 2k
# rows took 0.6 times the time of splits of 4k rows; see PERF.md).
_ROWS_PER_K = 2
# Must match csrc/wgmma_tile.cuh::kChunk: the bf16 operands' feature
# granule (64 bfloat16, one 128-byte swizzled row).
FEATURE_GRANULE = 64


def tile_split_plan(n_valid: int, n_queries: int, sm_count: int,
                    k: int, form: str = "exact") -> Tuple[int, int]:
    """``(n_splits, rows_per_split)`` of the tile kernels: ``split_plan`` at
    128-row tiles and about 4 blocks per SM (the bf16 kernel: 1), each split
    at least 2k rows when k > 16 (the list in the output row then fills
    within the first half of its split, and the threshold filters the
    rest)."""
    return split_plan(n_valid, n_queries, sm_count, tile_rows=_TILE_ROWS,
                      blocks_per_sm=(_BF16_BLOCKS_PER_SM if form == "bf16"
                                     else _BLOCKS_PER_SM),
                      min_rows=_ROWS_PER_K * k if k > STRIPE_MAX_K else 0)


def padded_features(d: int) -> int:
    """The bf16 operands' feature count: ``d`` rounded up to a multiple of
    :data:`FEATURE_GRANULE`, at least one granule."""
    return max(1, -(-d // FEATURE_GRANULE)) * FEATURE_GRANULE


# x -> {name: (x._version, value)}: what is kept with a tensor, dropped
# with it.
_kept = WeakIdKeyDictionary()


def _kept_with(x: torch.Tensor, name: str, make):
    """``make()``, kept with ``x`` under ``name`` while ``x`` lives and is
    not modified in place."""
    entries = _kept.setdefault(x, {})
    hit = entries.get(name)
    if hit is None or hit[0] != x._version:
        hit = entries[name] = (x._version, make())
    return hit[1]


def bf16_operand(x: torch.Tensor, cache: bool = False) -> torch.Tensor:
    """``[R, D]`` float32 or bfloat16 -> the ``[max(R, 1), padded_features(D)]``
    bfloat16 operand of the tensor-core kernels: ``x`` rounded once to
    nearest even (a bfloat16 ``x`` is copied as it is), zeros past D and in
    the one row of an empty ``x``. With ``cache`` the copy is kept with
    ``x``."""
    def make():
        r, d = x.shape
        out = torch.zeros((max(r, 1), padded_features(d)),
                          dtype=torch.bfloat16, device=x.device)
        out[:r, :d] = x
        return out

    return _kept_with(x, "bf16_operand", make) if cache else make()


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
# The C entries of csrc/tile_knn.cu; pointers and the stream are 64-bit.
_SIGNATURES = {
    "tile_knn_scan": ([_i, _p, _p, _i, _p, _p, _i, _i, _i, _i, _i, _p, _p], _i),
    "tile_knn_scan_bf16": ([_p, _i, _p, _i, _p, _p, _i, _i, _i, _i, _i, _p, _p],
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

    CPU tensors take the plain version. CUDA tensors launch a tile kernel
    on the current stream, after the norms of the matmul forms, or raise:
    the exact and fast forms the CUDA-core kernel, the bf16 form the
    tensor-core kernel over :func:`bf16_operand` copies (the train's copy
    and norms kept with it). ``knn_tile_scan.launches[form]`` counts the
    launches.

    The bf16 kernel's tolerance: its operands are the plain version's
    (rounded once, to nearest even; zero features add exactly 0) and so
    are its norms; each product of two bfloat16 values is exact in float32,
    and the tensor cores, summing in their own order, may truncate, so the
    cross term is off its exact value by at most ``d * 2**-23 * S`` with
    ``S = sum |q_f t_f| <= (q2 + t2) / 2`` (times ``1 + 2**-7`` for the
    operands' rounding). With the finish's three roundings a distance is
    off its formula's exact value by about ``2 * (d + 2) * 2**-24 * (q2 +
    t2)``, inside the ``4 * (d + 2) * 2**-24 * (q2 + max t2)`` that
    ``chip_smoke.py``'s ``check_near`` allows the kernel and the plain
    version together. On integer grids every product and partial sum is an
    exact integer, so the keys are bit-equal."""
    n_valid, k = int(n_valid), int(k)
    n_splits, rows_per_split = int(n_splits), int(rows_per_split)
    if train_x.device.type == "cpu" and test_x.device.type == "cpu":
        return knn_tile_scan_reference(train_x, test_x, n_valid, k, form,
                                       n_splits, rows_per_split)
    _check_tile_inputs(train_x, test_x, n_valid, k, form)
    check_splits(n_valid, n_splits, rows_per_split)
    lib = _library()
    q, d = test_x.shape
    dev = train_x.device
    partial = torch.empty((q, n_splits, k), dtype=torch.int64, device=dev)
    if q == 0:
        return partial
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        q2 = t2 = None
        if form == "fast":
            q2, t2 = sq_norms(test_x), sq_norms(train_x)
        if form == "bf16":
            # The fast form's norms, the train's kept with it.
            q2 = sq_norms(test_x)
            t2 = _kept_with(train_x, "sq_norms", lambda: sq_norms(train_x))
            tb = bf16_operand(train_x, cache=True)
            qb = bf16_operand(test_x)
            rc = lib.tile_knn_scan_bf16(
                tb.data_ptr(), tb.shape[0], t2.data_ptr(), n_valid,
                qb.data_ptr(), q2.data_ptr(), q, tb.shape[1], k, n_splits,
                rows_per_split, partial.data_ptr(), stream)
        else:
            rc = lib.tile_knn_scan(
                FORMS.index(form), train_x.data_ptr(),
                None if t2 is None else t2.data_ptr(), n_valid,
                test_x.data_ptr(), None if q2 is None else q2.data_ptr(), q,
                d, k, n_splits, rows_per_split, partial.data_ptr(), stream)
    if rc != 0:
        raise DeviceError(f"tile_knn_scan ({form}) launch failed: CUDA "
                          f"error {rc}")
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
    :func:`knn_tile_scan` over the splits of :func:`tile_split_plan`, then
    ``knn_stripe_merge``, or raise: a build failure is a
    :class:`CompileError`, a refused launch a :class:`DeviceError`, inputs
    the kernels do not take a ``ValueError``."""
    if train_x.device.type == "cpu" and test_x.device.type == "cpu":
        return knn_tile_candidates_reference(train_x, test_x, n_valid, k, form)
    n_valid = int(n_valid)
    _check_tile_inputs(train_x, test_x, n_valid, int(k), form)
    sm_count = torch.cuda.get_device_properties(
        train_x.device).multi_processor_count
    plan = tile_split_plan(n_valid, test_x.shape[0], sm_count, int(k), form)
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
    take any k >= 1. ``cache`` (a ``Dataset.device_cache`` dict) memoizes the device-side train arrays. Nothing falls back: a route that
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
