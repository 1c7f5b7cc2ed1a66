"""The ``cuda`` backend: the port of ``knn_tpu/backends/tpu.py``.

Two routes, chosen as the JAX ``predict_arrays`` chooses them:

- The stripe route (``ops/cuda_knn.py::stripe_classify_arrays``), the
  hand-written kernels: the stripe kernel for the exact form with
  d <= 128 and k <= 16, the tile kernel otherwise. Engine ``stripe`` sends
  every euclidean problem there, at any k. Engine ``auto`` sends every
  euclidean problem there too, at any k and form, unless ``force_tiled``
  is set; with ``query_batch`` only the problems that ``stripe_route_ok``
  admits (the exact form with d <= 128, the bf16 form at any width, the
  fast form with d > 128, each with k <= 16). JAX sends the euclidean
  problems outside ``stripe_route_ok`` to its XLA scans, and admits the
  rest only on a real TPU; here both routes compute the same function on
  either device, so the card's euclidean problems take the kernels.
- The XLA route, everything else (engine ``xla`` forces it; the manhattan,
  chebyshev and cosine metrics, ``force_tiled``, and ``query_batch``
  outside ``stripe_route_ok`` take it): the JAX package's XLA scans as
  PyTorch ops on the tensors' device, each under its JAX name. :func:`_predict_query_batched` streams ``query_batch`` chunks;
  otherwise :func:`knn_forward` takes the whole ``[Q, N]`` distance matrix
  when it has at most ``_FULL_MATRIX_CELL_LIMIT`` cells (and not
  ``force_tiled``), else :func:`forward_tiled_core` scans train tiles with
  a running top-k. Every metric and distance form runs here. Where
  ``lax.map`` walks one query tile at a time, the port runs as many query
  tiles as one block as fit ``_TILED_BLOCK_CELLS``: each query's scan is
  independent, so the function is the same.

:func:`candidates_arrays` is the XLA route's retrieval entry, which the
models (``models/knn.py``) take for ``engine="xla"`` and the non-euclidean
metrics.

``approx`` (``lax.approx_max_k``) is not ported and raises a ``ValueError``
naming ROADMAP B6. ``device`` defaults to ``"cuda"``; ``"cpu"`` runs the
kernels' plain versions and the XLA route's ops on the host. A CUDA device
that is absent is a :class:`~knn_tpu_torch.resilience.errors.DeviceError`,
never a fallback, and no route falls back to another.
"""

from __future__ import annotations

import numpy as np
import torch

from knn_tpu_torch.backends import register
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.ops.cuda_knn import (
    INT_MAX,
    _resolve_stripe_precision,
    cached_labels,
    cached_train,
    host_copy_async,
    memo,
    resolve_device,
    stripe_classify_arrays,
    stripe_route_ok,
    to_device,
    to_device_async,
)
from knn_tpu_torch.ops.distance import DIST_FNS, resolve_form
from knn_tpu_torch.ops.topk import merge_topk, topk_smallest
from knn_tpu_torch.ops.vote import vote
from knn_tpu_torch.utils.windowed import windowed_dispatch

# [Q, N] float32 distance-matrix cells above which the tiled path is used.
_FULL_MATRIX_CELL_LIMIT = 16 * 1024 * 1024
# Cells of the tiled scan's distance block per step (several query tiles
# at once): 64 MB of float32 distances, 128 MB of keys.
_TILED_BLOCK_CELLS = 1 << 24


def knn_forward(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    test_x: torch.Tensor,
    k: int,
    num_classes: int,
    precision: str = "exact",
    approx: bool = False,
) -> torch.Tensor:
    """Full-matrix KNN classify: [N, D] train, [N] labels, [Q, D] queries
    -> [Q] int32 predictions, through the whole [Q, N] distance matrix and
    an exact (distance, index) top-k."""
    if approx:
        raise ValueError("approx top-k (lax.approx_max_k) is not ported yet "
                         "(ROADMAP B6)")
    d = DIST_FNS[precision](test_x, train_x)
    _, idx = topk_smallest(d, k)
    return vote(train_y[idx.long()], num_classes)


def _check_tiles(n_pad: int, q_pad: int, query_tile: int, train_tile: int):
    if query_tile < 1 or train_tile < 1 or n_pad % train_tile or q_pad % query_tile:
        raise ValueError(f"train rows {n_pad} and query rows {q_pad} must be "
                         f"padded to multiples of train_tile={train_tile} and "
                         f"query_tile={query_tile}")


def _scan_tiles(train_x, test_x, n_train_valid: int, k: int, precision: str,
                query_tile: int, train_tile: int, index_base: int = 0):
    """The tiled scan's carry after every train tile: ``([Q, k]`` distances,
    ``[Q, k]`` int32 indices``)`` by (distance, index). Per tile, columns at
    or past ``n_train_valid`` are +inf (keeping their positions), the tile's
    ``min(k, train_tile)`` best are taken by position, and merged with the
    carry, which starts at (+inf, INT32_MAX)."""
    _check_tiles(train_x.shape[0], test_x.shape[0], query_tile, train_tile)
    dist_fn = DIST_FNS[precision]
    kk = min(k, train_tile)
    dev = test_x.device
    rows = query_tile * max(1, _TILED_BLOCK_CELLS // (query_tile * train_tile))
    out_d, out_i = [], []
    for s in range(0, test_x.shape[0], rows):
        block = test_x[s : s + rows]
        run_d = torch.full((block.shape[0], k), torch.inf, device=dev)
        run_i = torch.full((block.shape[0], k), INT_MAX, dtype=torch.int32,
                           device=dev)
        for t0 in range(0, train_x.shape[0], train_tile):
            d = dist_fn(block, train_x[t0 : t0 + train_tile])
            col = torch.arange(t0, t0 + train_tile, device=dev)
            d = torch.where(col < n_train_valid, d, torch.inf)
            tile_d, tile_i = topk_smallest(d, kk, index_base=t0 + index_base)
            run_d, run_i = merge_topk(run_d, run_i, tile_d, tile_i, k)
        out_d.append(run_d)
        out_i.append(run_i)
    return torch.cat(out_d), torch.cat(out_i)


def forward_tiled_core(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    test_x: torch.Tensor,
    n_train_valid: int,
    k: int,
    num_classes: int,
    precision: str = "exact",
    query_tile: int = 256,
    train_tile: int = 2048,
) -> torch.Tensor:
    """Tiled KNN classify with a running top-k: [q_pad] int32 predictions.

    Both axes must already be padded to tile multiples (train rows at or
    past ``n_train_valid`` count as +inf). A carried index past the labels
    (INT32_MAX, when k exceeds the columns) is clamped to the last label,
    as in JAX."""
    _, run_i = _scan_tiles(train_x, test_x, int(n_train_valid), k, precision,
                           query_tile, train_tile)
    safe_i = run_i.clamp(max=train_y.shape[0] - 1).long()
    return vote(train_y[safe_i], num_classes)


def forward_candidates_core(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    test_x: torch.Tensor,
    n_train_valid: int,
    k: int,
    precision: str = "exact",
    query_tile: int = 128,
    train_tile: int = 2048,
    index_base: int = 0,
):
    """Like :func:`forward_tiled_core` but stops before the vote:
    ``(dists [Q, k], global_idx [Q, k], labels [Q, k])`` by (distance,
    index), the indices offset by ``index_base``. A slot's label is its
    row's label, and 0 for an INT32_MAX slot (the carry's start), which is
    what JAX's carried labels hold."""
    d, i = _scan_tiles(train_x, test_x, int(n_train_valid), k, precision,
                       query_tile, train_tile, index_base)
    empty = i == INT_MAX
    rows = torch.where(empty, 0, i - index_base).long()
    labels = torch.where(empty, 0, train_y[rows])
    return d, i, labels.to(train_y.dtype)


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``multiple``."""
    extra = -x.shape[0] % multiple
    if not extra:
        return x
    return torch.cat([x, x.new_zeros((extra, *x.shape[1:]))])


def _padded_train_x(train_x, dev, cache, train_tile: int):
    """The device train matrix with zero rows appended up to a multiple of
    ``train_tile``, memoized in ``cache`` per device and tile."""
    return memo(cache, ("train_padded_x", str(dev), train_tile),
                lambda: _pad_rows(cached_train(train_x, dev, cache),
                                  train_tile))


def _padded_train(train_x, train_y, dev, cache, train_tile: int):
    """The device train matrix and labels with zero rows appended up to a
    multiple of ``train_tile``, memoized in ``cache`` per device and tile
    so repeat calls skip the copy."""
    return memo(cache, ("train_padded", str(dev), train_tile), lambda: (
        _padded_train_x(train_x, dev, cache, train_tile),
        _pad_rows(cached_labels(train_y, dev, cache), train_tile)))


# Query rows per tile of the retrieval's scan (candidates_arrays): JAX's
# pad quantum, models/knn.py::QUERY_PAD_QUANTUM.
_RETRIEVAL_QUERY_TILE = 128


def candidates_arrays(
    train_x: np.ndarray,
    test_x: np.ndarray,
    k: int,
    precision: str = "exact",
    device="cuda",
    cache: "dict | None" = None,
    deferred: bool = False,
):
    """Host entry of the XLA route's retrieval, the twin of
    ``knn_forward_candidates`` as the JAX models call it: ``([Q, k]``
    distances, ``[Q, k]`` int32 indices``)`` by (distance, index) in the
    distance form ``precision`` (a euclidean form or a metric's name), from
    the tiled scan of :func:`forward_candidates_core` (without its label
    gather) over train tiles of ``max(min(2048, N), k)`` rows. The padded
    train is memoized in ``cache``; the queries are padded to a multiple of
    128 rows (fewer: one tile of them all) and the answers trimmed.
    ``deferred=True`` returns a zero-argument ``resolve()``: the scan is
    enqueued and its answers' copy to pinned host memory started before
    this returns (``cuda_knn.host_copy_async``); on the CPU the scan runs
    now."""
    dev = resolve_device(device)
    n, q = train_x.shape[0], test_x.shape[0]
    if precision not in DIST_FNS:
        raise ValueError(f"unknown distance form {precision!r}; choose from "
                         f"{sorted(DIST_FNS)}")
    if k < 1:
        raise ValueError(f"k={k}: k must be >= 1")
    if q == 0:
        empty = (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
        return (lambda: empty) if deferred else empty
    train_tile = max(min(2048, n), k)
    query_tile = min(q, _RETRIEVAL_QUERY_TILE)
    tx = _padded_train_x(train_x, dev, cache, train_tile)
    qx = _pad_rows(to_device_async(test_x, dev), query_tile)
    d, i = _scan_tiles(tx, qx, n, k, precision, query_tile, train_tile)
    wait = host_copy_async(d[:q], i[:q])
    memo_out = []

    def resolve():
        if not memo_out:
            memo_out.append(wait())
        return memo_out[0]

    return resolve if deferred else resolve()


def _predict_query_batched(train_x, train_y, test_x, k, num_classes, *,
                           precision, query_tile, train_tile, force_tiled,
                           query_batch, dev, cache):
    """Stream the queries in ``query_batch`` chunks, the last padded to the
    same rows, through the full-matrix or the tiled scan (as
    ``query_batch * N`` compares with the cell limit), with a window of
    chunks in flight (``utils/windowed.py``): only the window's outputs are
    on the device at once."""
    q, n = test_x.shape[0], train_x.shape[0]
    use_full = not force_tiled and query_batch * n <= _FULL_MATRIX_CELL_LIMIT
    if use_full:
        tx = cached_train(train_x, dev, cache)
        ty = cached_labels(train_y, dev, cache)
    else:
        tx, ty = _padded_train(train_x, train_y, dev, cache, train_tile)

    def dispatch(s):
        chunk = test_x[s : s + query_batch]
        chunk = np.pad(chunk, ((0, query_batch - chunk.shape[0]), (0, 0)))
        qx = to_device(chunk, np.float32, dev)
        if use_full:
            return knn_forward(tx, ty, qx, k, num_classes, precision)
        return forward_tiled_core(tx, ty, _pad_rows(qx, query_tile), n, k,
                                  num_classes, precision, query_tile,
                                  train_tile)

    def fetch(out, s):
        return out.cpu().numpy()[:query_batch]

    results = windowed_dispatch(range(0, q, query_batch), dispatch, fetch)
    return np.concatenate(results)[:q]


def predict_arrays(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    precision: str = "exact",
    query_tile: int = 256,
    train_tile: int = 2048,
    force_tiled: bool = False,
    approx: bool = False,
    metric: str = "euclidean",
    query_batch: "int | None" = None,
    engine: str = "auto",
    device="cuda",
    device_cache: "dict | None" = None,
) -> np.ndarray:
    """Host-side entry: ``[Q]`` int32 predictions, through the route the
    module docstring describes. ``metric`` selects the distance (euclidean
    honors the ``precision`` forms; ``auto`` is exact for d <= 128 and fast
    above). ``device_cache`` (normally the train ``Dataset.device_cache``)
    memoizes the device-side train arrays."""
    if engine not in ("auto", "stripe", "xla"):
        raise ValueError(
            f"unknown engine {engine!r}; choose 'auto', 'stripe', or 'xla'"
        )
    d = train_x.shape[1]
    form = resolve_form(precision, metric)
    if form in ("exact", "fast", "bf16", "auto"):
        form = _resolve_stripe_precision(form, d)
    elif form not in DIST_FNS:
        raise ValueError(f"unknown precision {precision!r}; choose auto, "
                         "exact, fast, or bf16")
    if query_batch is not None and query_batch < 1:
        raise ValueError(f"query_batch must be >= 1, got {query_batch}")
    if approx:
        raise ValueError("approx top-k (lax.approx_max_k) is not ported yet "
                         "(ROADMAP B6)")
    if engine == "stripe" and (metric != "euclidean" or force_tiled):
        raise ValueError("the stripe engine implements euclidean only and is "
                         "incompatible with force_tiled")
    q, n = test_x.shape[0], train_x.shape[0]
    if q == 0:
        return np.empty(0, np.int32)
    if engine == "stripe" or (
            engine == "auto" and not force_tiled and metric == "euclidean"
            and (query_batch is None or stripe_route_ok(form, d, k))):
        return stripe_classify_arrays(
            train_x, train_y, test_x, k, num_classes, precision=form,
            device=device, cache=device_cache,
        )
    dev = resolve_device(device)
    train_tile = max(train_tile, k)  # a tile's top-k needs k <= its width
    if query_batch is not None and q > query_batch:
        return _predict_query_batched(
            train_x, train_y, test_x, k, num_classes, precision=form,
            query_tile=query_tile, train_tile=train_tile,
            force_tiled=force_tiled, query_batch=query_batch, dev=dev,
            cache=device_cache,
        )
    qx = to_device(test_x, np.float32, dev)
    if not force_tiled and q * n <= _FULL_MATRIX_CELL_LIMIT:
        tx = cached_train(train_x, dev, device_cache)
        ty = cached_labels(train_y, dev, device_cache)
        return knn_forward(tx, ty, qx, k, num_classes, form).cpu().numpy()
    tx, ty = _padded_train(train_x, train_y, dev, device_cache, train_tile)
    out = forward_tiled_core(tx, ty, _pad_rows(qx, query_tile), n, k,
                             num_classes, form, query_tile, train_tile)
    return out.cpu().numpy()[:q]


@register("cuda")
def predict(
    train: Dataset,
    test: Dataset,
    k: int,
    precision: str = "exact",
    query_tile: int = 256,
    train_tile: int = 2048,
    force_tiled: bool = False,
    approx: bool = False,
    metric: str = "euclidean",
    query_batch: "int | None" = None,
    engine: str = "auto",
    device="cuda",
    **_unused,
) -> np.ndarray:
    train.validate_for_knn(k, test)
    return predict_arrays(
        train.features, train.labels, test.features, k, train.num_classes,
        precision=precision, query_tile=query_tile, train_tile=train_tile,
        force_tiled=force_tiled, approx=approx, metric=metric,
        query_batch=query_batch, engine=engine, device=device,
        device_cache=train.device_cache,
    )
