"""Exact stripe KNN on the card: the kernel wrappers, their plain versions,
and the host entries of the classify path.

The port of ``knn_tpu/ops/pallas_knn.py``'s stripe route, exact form. The
kernel (``csrc/stripe_knn.cu``) is written for the GPU, not translated from
the Pallas blocks: no 128-lane layout, no v5e block tunings, no padding of
the features (rows at or past ``n_valid`` are masked inside the kernel),
and no super-chunks or chunk sizes tuned to the TPU's fetch round trip: the
retrieval entry cuts the queries only as far as the kernels' partial-key
buffer needs (:func:`candidate_chunk_rows`). Like the TPU
kernel, it reads a transposed train: :func:`feature_major` makes the
``[D, N]`` copy (rows rounded up to 128) once per train tensor and keeps it
with it, for this kernel and the tile kernel's exact and fast forms.

Two kernels, each with its own wrapper, launch counter and plain version:
:func:`knn_stripe_scan` keeps the k best keys of each (query, train split),
and :func:`knn_stripe_merge` folds a query's split lists into its k best
(the counterpart of the JAX package's XLA ``_merge_topk_rounds``).
:func:`knn_stripe_candidates` plans the splits and runs both. The scan
keeps a register list, so it takes 1 <= k <= 16 (:data:`STRIPE_MAX_K`);
the merge takes any k. At k > 16 :func:`knn_stripe_candidates` runs the
tile kernel's exact form (``ops/tile_knn.py``), the same function: a
zero-filled feature adds exactly 0. The JAX stripe route's own rule
(:func:`stripe_route_ok`) sends only k <= 16 to it by default.

:func:`knn_stripe_scan_variant` is the scan with another selection, the
port of ``scripts/tune_stripe_selection.py``'s ``make_variant_kernel``
(``rounds``, ``lite``, ``nosel``; k <= 16): a tuning probe's kernel, on no
classify path (``knn_tpu_torch/probes/tune_stripe_selection.py`` runs it).

The host entries (:func:`stripe_candidates_arrays`,
:func:`stripe_classify_arrays`) take the JAX stripe route's three distance
forms: the exact form with d <= 128 runs the stripe kernel; the matmul forms
(and the exact form past 128 features) run the tile kernel of
``ops/tile_knn.py``, with the train matrix stored as the JAX route stores it.
:func:`stripe_candidates_arrays` is also the models' retrieval entry, and
with ``deferred=True`` returns before the card has finished: its queries go
up through pinned host memory and its answers come back by copies into
pinned host memory that an event marks done (:func:`to_device_async`,
:func:`host_copy_async`).

Semantics, shared by the kernel and :func:`knn_stripe_candidates_reference`:
per query, the k smallest ``(distance, train index)`` pairs over rows
``< n_valid``, ascending, the lowest index winning a distance tie; the
distance is ``acc = acc + diff*diff`` over the features in source order,
rounded twice; a NaN distance counts as +inf and keeps its row's index;
slots beyond the valid rows are ``(+inf, INT32_MAX)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from knn_tpu_torch.ops import _build
from knn_tpu_torch.ops.distance import DIST_FNS, pairwise_sq_dists
from knn_tpu_torch.ops.vote import vote_neighbors
from knn_tpu_torch.resilience.errors import DeviceError

STRIPE_MAX_D = 128
STRIPE_MAX_K = 16  # csrc/stripe_knn.cuh::kMaxRegisterK
MERGE_MAX_SPLITS = 16384  # csrc/stripe_knn.cu::kMaxMergeSplits
INT_MAX = 2**31 - 1
_SENTINEL_KEY = (0x7F800000 << 32) | INT_MAX  # (+inf, INT32_MAX)

# Must match csrc/stripe_knn.cuh.
_QUERIES_PER_BLOCK = 128
_TILE_ROWS = 128  # kTileRows: the stripe scan's tile and split granule
# kRowGranule: the rows of a feature-major operand come in multiples of
# this, zero-filled past the matrix's own rows.
ROW_GRANULE = 128
# kSplitAlign: the feature-major kernels' splits start on a multiple of
# this many rows (16 bytes of float32), so each run they copy is aligned.
SPLIT_ALIGN = 4
# Scan blocks to aim for per SM: enough resident blocks to fill the card
# when there are few queries, by splitting the train rows across blocks.
_BLOCKS_PER_SM = 16
# Elements of the plain version's [queries, N] distance block per step.
_REFERENCE_BLOCK = 1 << 26
# Bytes of the kernels' [rows, splits, k] int64 partial keys that one chunk
# of a retrieval may hold on the card (stripe_candidates_arrays).
PARTIAL_BYTES_CAP = 256 << 20


def stripe_route_ok(precision: str, d: int, k: int) -> bool:
    """The JAX package's rule for which problems take the stripe route:
    the exact form with narrow features, the bf16 form at any width, the
    fast form with wide features, each with k <= 16. JAX also declines the
    matmul forms past ~24k (fast) or ~33k (bf16) features, where no block
    fits a v5e's VMEM budget (``_wide_tile_fits``); that limit is a TPU's
    and is left out: on the card both routes of a form compute the same
    function."""
    return (
        (precision == "bf16"
         or (precision == "fast" and d > STRIPE_MAX_D)
         or (precision == "exact" and d <= STRIPE_MAX_D))
        and k <= STRIPE_MAX_K
    )


def stripe_inputs_finite(*arrays: np.ndarray) -> bool:
    """True when every array is NaN/inf-free AND small enough in magnitude
    that no squared euclidean distance can overflow float32 to +inf — the
    JAX package's gate for its ``assume_finite`` variant. The port's kernel
    has no such variant (it always applies the NaN rule); the gate is kept
    so callers can tell when the NaN rule can matter."""
    limit = None
    for a in arrays:
        if a.size == 0:
            continue
        if limit is None:
            # |q_f - t_f|^2 summed over d features stays < FLT_MAX when every
            # value's magnitude is below sqrt(FLT_MAX / (4 d)); the extra
            # factor of 2 is headroom for float32 accumulation rounding.
            d = a.shape[-1] if a.ndim > 1 else 1
            limit = float(np.sqrt(np.finfo(np.float32).max / (8.0 * max(d, 1))))
        m = float(np.max(np.abs(a), initial=0.0))  # NaN propagates -> not finite
        if not np.isfinite(m) or m >= limit:
            return False
    return True


def _resolve_stripe_precision(precision: str, d: int) -> str:
    """``auto`` resolves as in the JAX package — exact for narrow features,
    fast for wide; an unknown name is a ``ValueError``."""
    if precision == "auto":
        return "exact" if d <= STRIPE_MAX_D else "fast"
    if precision not in ("exact", "fast", "bf16"):
        raise ValueError(
            f"unknown precision {precision!r}; choose auto, exact, fast, or bf16"
        )
    return precision


def resolve_device(device) -> torch.device:
    """``"cuda"`` (the default everywhere) or ``"cpu"``. Asking for CUDA on
    a host without a usable card is an error, never a quiet fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' (--device cpu) to run on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def split_plan(n_valid: int, n_queries: int, sm_count: int,
               tile_rows: int = _TILE_ROWS,
               blocks_per_sm: int = _BLOCKS_PER_SM,
               queries_per_block: int = _QUERIES_PER_BLOCK,
               min_rows: int = 0) -> Tuple[int, int]:
    """``(n_splits, rows_per_split)`` for a kernel's grid of
    ``queries_per_block``-query blocks: the train rows are cut into
    contiguous splits of whole ``tile_rows`` tiles, as many as it takes to
    give the card about ``blocks_per_sm`` blocks per SM, each split at
    least ``min_rows`` rows (rounded up to whole tiles) where there are."""
    q_blocks = max(1, -(-n_queries // queries_per_block))
    tiles = max(1, -(-n_valid // tile_rows))
    want = max(1, sm_count * blocks_per_sm // q_blocks)
    per_split = max(-(-tiles // min(want, tiles, 65535)),
                    -(-min_rows // tile_rows))
    rows_per_split = min(per_split, tiles) * tile_rows
    n_splits = max(1, -(-n_valid // rows_per_split))
    return n_splits, rows_per_split


def _pack_keys(dists: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ``(float bits << 32) | index``; positive, because the bits
    of a non-negative float (or +inf) are < 2**31."""
    return (dists.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def _unpack_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dists = (keys >> 32).to(torch.int32).view(torch.float32)
    idx = (keys & 0xFFFFFFFF).to(torch.int32)
    return dists, idx


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


def feature_major(x: torch.Tensor, cache: bool = False) -> torch.Tensor:
    """``[R, D]`` float32 -> the ``[max(D, 1), R_pad]`` float32 operand of
    the stripe kernel and the tile kernel's exact and fast forms: ``x``
    transposed, so that each feature's values over the rows are one
    contiguous run, ``R_pad`` the rows rounded up to a multiple of
    :data:`ROW_GRANULE` (at least one), zeros past R (and in the one row of
    a matrix with no features). Every run then starts 16-byte aligned, and
    a kernel stages it with 16-byte asynchronous copies. With ``cache`` the
    copy is kept with ``x`` (``N * D * 4`` more bytes for a train matrix,
    rows rounded up), so a train tensor is transposed once."""
    def make():
        r, d = x.shape
        rows = -(-max(r, 1) // ROW_GRANULE) * ROW_GRANULE
        if d == 0:
            return x.new_zeros((1, rows), dtype=torch.float32)
        # One op (a per-call copy of the queries costs host time before the
        # kernel's launch): the transposed view, zero-padded to `rows`.
        return torch.nn.functional.pad(x.T, (0, rows - r)).contiguous()

    return _kept_with(x, "feature_major", make) if cache else make()


def knn_stripe_candidates_reference(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    form: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of scan + merge, on whatever device the
    tensors are on: the [rows, N] distance block of ``DIST_FNS[form]``
    (:func:`pairwise_sq_dists` for the exact form), rows ``>= n_valid``
    masked to (+inf, INT32_MAX), packed into int64 keys, the k smallest keys
    by ``torch.topk``, sorted, unpacked. The keys are unique, so the order
    is fully determined."""
    distances = DIST_FNS[form]
    n, q = train_x.shape[0], test_x.shape[0]
    dev = test_x.device
    index = torch.arange(n, dtype=torch.int64, device=dev)
    valid = index < n_valid
    index = torch.where(valid, index, INT_MAX)
    kk = min(k, n)
    out = torch.full((q, k), _SENTINEL_KEY, dtype=torch.int64, device=dev)
    rows = max(1, _REFERENCE_BLOCK // max(n, 1))
    for s in range(0, q if kk else 0, rows):
        d = distances(test_x[s : s + rows], train_x)
        d = torch.where(valid, d, torch.inf)
        top = torch.topk(_pack_keys(d, index), kk, dim=1, largest=False).values
        out[s : s + rows, :kk] = torch.sort(top, dim=1).values
    return _unpack_keys(out)


def knn_stripe_scan_reference(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    n_splits: int, rows_per_split: int, form: str = "exact",
) -> torch.Tensor:
    """The scan kernel's plain version: ``[Q, n_splits, k]`` int64 keys,
    for each split ``s`` the k smallest keys over the train rows
    ``[s * rows_per_split, min((s + 1) * rows_per_split, n_valid))`` with
    their global indices, ascending, sentinel-filled past the split's rows."""
    q = test_x.shape[0]
    out = torch.full((q, n_splits, k), _SENTINEL_KEY, dtype=torch.int64,
                     device=test_x.device)
    for s in range(n_splits):
        lo = s * rows_per_split
        hi = min(lo + rows_per_split, n_valid)
        if hi > lo:
            d, i = knn_stripe_candidates_reference(train_x[lo:hi], test_x,
                                                   hi - lo, k, form)
            out[:, s] = _pack_keys(d, torch.where(i == INT_MAX, i, i + lo))
    return out


def knn_stripe_merge_reference(
    partial: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel's plain version: a query's ``[n_splits, k]`` keys
    -> its k smallest, sorted and unpacked to float32 distances and int32
    indices."""
    q, n_splits, k = partial.shape
    top = torch.topk(partial.reshape(q, n_splits * k), k, dim=1,
                     largest=False).values
    return _unpack_keys(torch.sort(top, dim=1).values)


def _check_kernel_inputs(train_x, test_x, n_valid: int, k: int) -> None:
    for name, t in (("train_x", train_x), ("test_x", test_x)):
        if t.device.type != "cuda" or t.device != train_x.device:
            raise ValueError(
                f"{name} is on {t.device}; the kernel needs both inputs on "
                f"one CUDA device (train_x is on {train_x.device})"
            )
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 2-D float32 tensor, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    n, d = train_x.shape
    if test_x.shape[1] != d:
        raise ValueError(f"train has {d} features but test has {test_x.shape[1]}")
    if d > STRIPE_MAX_D:
        raise ValueError(f"d={d} exceeds the stripe kernel's {STRIPE_MAX_D} "
                         "(wide features take the tile kernel, ops/tile_knn.py)")
    check_stripe_k(k)
    if not 0 <= n_valid <= n or n >= INT_MAX:
        raise ValueError(f"n_valid={n_valid} must lie in [0, {n}] "
                         f"and N below {INT_MAX}")


def check_k(k: int) -> None:
    """Raise a ``ValueError`` unless ``k >= 1``: the merge and the tile scan
    take any k (past the valid rows the slots are sentinels)."""
    if k < 1:
        raise ValueError(f"k={k}: k must be >= 1")


def check_stripe_k(k: int) -> None:
    """Raise a ``ValueError`` unless the stripe scan's register lists take
    ``k``: 1..16 (a larger k runs the tile kernel's exact form)."""
    if not 1 <= k <= STRIPE_MAX_K:
        raise ValueError(f"k={k} outside the stripe scan's 1..{STRIPE_MAX_K}; "
                         "knn_stripe_candidates runs a larger k on the tile "
                         "kernel")


def check_splits(n_valid: int, n_splits: int, rows_per_split: int,
                 align: int = 1) -> None:
    """Raise unless ``n_splits`` splits of ``rows_per_split`` rows cut
    ``n_valid`` rows into non-empty splits that a kernel grid can hold,
    each starting on a multiple of ``align`` rows."""
    if not (1 <= n_splits <= 65535 and 1 <= rows_per_split
            and rows_per_split % align == 0
            and (n_splits - 1) * rows_per_split < max(n_valid, 1)
            <= n_splits * rows_per_split
            and n_valid + rows_per_split <= INT_MAX):
        raise ValueError(f"{n_splits} splits of {rows_per_split} rows do not "
                         f"cut n_valid={n_valid} into non-empty splits of a "
                         f"multiple of {align} rows")


_p, _i = ctypes.c_void_p, ctypes.c_int
# The C entries of csrc/stripe_knn.cu; pointers and the stream are 64-bit.
_SIGNATURES = {
    "stripe_knn_scan": ([_p, _i, _i, _p, _i, _i, _i, _i, _i, _p, _p], _i),
    "stripe_knn_merge": ([_p, _i, _i, _i, _p, _p, _p], _i),
    "stripe_knn_scan_variant": ([_i, _p, _i, _i, _p, _i, _i, _i, _i, _i, _p,
                                 _p], _i),
    "stripe_knn_blocks_per_sm": ([_i, _i], _i),
}


def _library():
    return _build.load_library("stripe_knn", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def stripe_blocks_per_sm(device, d: int, k: int) -> int:
    """How many blocks of the stripe scan one SM of ``device`` holds at once
    at ``d`` features and ``k``, by the kernel's registers and shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), asked of the card
    once."""
    with torch.cuda.device(device):
        blocks = _library().stripe_knn_blocks_per_sm(int(d), int(k))
    if blocks < 1:
        raise DeviceError(f"the stripe scan fits no block on an SM at d={d}, "
                          f"k={k}")
    return blocks


def stripe_split_plan(n_valid: int, n_queries: int, device, d: int,
                      k: int) -> Tuple[int, int]:
    """The stripe scan's split plan on ``device``: :func:`split_plan` at the
    blocks per SM that the kernel's occupancy allows
    (:func:`stripe_blocks_per_sm`), so that its blocks run as one wave,
    each thread scanning as many rows as that wave leaves it."""
    dev = torch.device(device)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    return split_plan(n_valid, n_queries, sm_count,
                      blocks_per_sm=stripe_blocks_per_sm(dev, int(d), int(k)))


def knn_stripe_scan(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    n_splits: int, rows_per_split: int,
) -> torch.Tensor:
    """``[N, D]`` train and ``[Q, D]`` queries (float32) -> ``[Q, n_splits,
    k]`` int64 keys, as :func:`knn_stripe_scan_reference` gives them;
    1 <= k <= 16 on either device.

    CPU tensors take the plain version. CUDA tensors launch the scan kernel
    on the current stream over the train's :func:`feature_major` copy (kept
    with ``train_x``), or raise; each split must start on a multiple of
    :data:`SPLIT_ALIGN` rows. ``knn_stripe_scan.launches`` counts the
    launches."""
    n_valid, k = int(n_valid), int(k)
    n_splits, rows_per_split = int(n_splits), int(rows_per_split)
    check_stripe_k(k)
    if train_x.device.type == "cpu" and test_x.device.type == "cpu":
        return knn_stripe_scan_reference(train_x, test_x, n_valid, k,
                                         n_splits, rows_per_split)
    _check_kernel_inputs(train_x, test_x, n_valid, k)
    check_splits(n_valid, n_splits, rows_per_split, SPLIT_ALIGN)
    fn = _library().stripe_knn_scan
    q, d = test_x.shape
    dev = train_x.device
    partial = torch.empty((q, n_splits, k), dtype=torch.int64, device=dev)
    if q == 0:
        return partial
    train_t = feature_major(train_x, cache=True)
    with torch.cuda.device(dev):
        rc = fn(train_t.data_ptr(), train_t.shape[1], n_valid,
                test_x.data_ptr(), q, d, k, n_splits, rows_per_split,
                partial.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise DeviceError(f"stripe_knn_scan launch failed: CUDA error {rc}")
    knn_stripe_scan.launches += 1
    return partial


knn_stripe_scan.launches = 0


def knn_stripe_merge(partial: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[Q, n_splits, k]`` int64 keys, each split's list ascending ->
    ``([Q, k]`` float32 distances, ``[Q, k]`` int32 indices``)``: any
    k >= 1, 1 <= n_splits <= 16384.

    A CPU tensor takes the plain version. A CUDA tensor launches the merge
    kernel on the current stream, or raises. ``knn_stripe_merge.launches``
    counts the launches."""
    if partial.dim() == 3:
        check_k(partial.shape[2])
    if partial.device.type == "cpu":
        return knn_stripe_merge_reference(partial)
    if (partial.dtype != torch.int64 or partial.dim() != 3
            or not partial.is_contiguous() or partial.device.type != "cuda"):
        raise ValueError(
            "partial must be a contiguous 3-D int64 CUDA tensor, got "
            f"{partial.dtype} {tuple(partial.shape)} on {partial.device}")
    q, n_splits, k = partial.shape
    if not 1 <= n_splits <= MERGE_MAX_SPLITS:
        raise ValueError(f"n_splits={n_splits} outside 1..{MERGE_MAX_SPLITS}")
    fn = _library().stripe_knn_merge
    dev = partial.device
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        rc = fn(partial.data_ptr(), n_splits, q, k, out_d.data_ptr(),
                out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise DeviceError(f"stripe_knn_merge launch failed: CUDA error {rc}")
    knn_stripe_merge.launches += 1
    return out_d, out_i


knn_stripe_merge.launches = 0


# The selection variants of the scan (csrc/stripe_knn.cu codes 1, 2, 3).
SELECT_MODES = ("rounds", "lite", "nosel")


def knn_stripe_scan_variant_reference(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    mode: str, n_splits: int, rows_per_split: int,
) -> torch.Tensor:
    """The plain version of :func:`knn_stripe_scan_variant`: ``[Q, n_splits,
    k]`` int64 keys of the selection ``mode`` over the same split layout.

    ``nosel``: slot 0 is (the split's smallest distance, INT32_MAX), a NaN
    distance counting as +inf; the other slots are the sentinel.
    ``rounds`` and ``lite``: the kernel's passes, replayed. A split's rows go
    in groups of 4 from its first row, rows at or past the split's end or
    ``n_valid`` being (+inf, INT32_MAX); each group and the k levels go
    through k rounds (min distance, then min index at it; the taken entry's
    distance retired to +inf, and for ``rounds`` its index to INT32_MAX)."""
    _check_variant(mode, k)
    q, dev = test_x.shape[0], test_x.device
    total = n_splits * rows_per_split
    dist = torch.full((q, total), torch.inf, dtype=torch.float32, device=dev)
    if n_valid:
        dist[:, :n_valid] = pairwise_sq_dists(test_x, train_x[:n_valid])
    dist = dist.reshape(q, n_splits, rows_per_split)
    out = torch.full((q, n_splits, k), _SENTINEL_KEY, dtype=torch.int64,
                     device=dev)
    if mode == "nosel":
        out[..., 0] = _pack_keys(dist.min(dim=2).values,
                                 torch.full((), INT_MAX, device=dev))
        return out
    groups = -(-rows_per_split // 4)
    pad = groups * 4 - rows_per_split
    dist = torch.nn.functional.pad(dist, (0, pad), value=torch.inf)
    index = torch.arange(total, dtype=torch.int64, device=dev)
    index = torch.where(index < n_valid, index, INT_MAX)
    index = torch.nn.functional.pad(index.reshape(n_splits, rows_per_split),
                                    (0, pad), value=INT_MAX)
    fresh_d = dist.reshape(q, n_splits, groups, 4)
    fresh_i = index.reshape(n_splits, groups, 4).expand(q, -1, -1, -1)
    # A split's kernel thread runs the groups that hold its rows.
    rows = (n_valid - torch.arange(n_splits, device=dev) * rows_per_split
            ).clamp(0, rows_per_split)
    lev_d = torch.full((q, n_splits, k), torch.inf, device=dev)
    lev_i = torch.full((q, n_splits, k), INT_MAX, dtype=torch.int64,
                       device=dev)
    for g in range(groups):
        active = (4 * g < rows)[None, :, None]
        cd = torch.cat([fresh_d[:, :, g], lev_d], dim=2)
        ci = torch.cat([fresh_i[:, :, g], lev_i], dim=2)
        new_d, new_i = [], []
        for level in range(k):
            m_d = cd.min(dim=2, keepdim=True).values
            m_i = torch.where(cd == m_d, ci, INT_MAX).min(dim=2,
                                                          keepdim=True).values
            new_d.append(m_d)
            new_i.append(m_i)
            if level + 1 < k:
                taken = ci == m_i
                cd = torch.where(taken, torch.inf, cd)
                if mode == "rounds":
                    ci = torch.where(taken, INT_MAX, ci)
        lev_d = torch.where(active, torch.cat(new_d, dim=2), lev_d)
        lev_i = torch.where(active, torch.cat(new_i, dim=2), lev_i)
    return _pack_keys(lev_d, lev_i)


def _check_variant(mode: str, k: int) -> None:
    if mode not in SELECT_MODES:
        raise ValueError(f"unknown selection {mode!r}; choose from "
                         f"{SELECT_MODES}")
    if not 1 <= k <= STRIPE_MAX_K:
        raise ValueError(f"k={k} outside the selection variants' "
                         f"1..{STRIPE_MAX_K}")


def knn_stripe_scan_variant(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    mode: str, n_splits: int, rows_per_split: int,
) -> torch.Tensor:
    """The scan with selection ``mode`` (``rounds``, ``lite``, ``nosel``;
    1 <= k <= 16): ``[Q, n_splits, k]`` int64 keys, as
    :func:`knn_stripe_scan_variant_reference` gives them. ``rounds`` gives
    :func:`knn_stripe_scan`'s keys; ``lite``'s merge
    (:func:`knn_stripe_merge`) gives :func:`knn_stripe_candidates`' answer
    when :func:`stripe_inputs_finite` holds and k <= n_valid.

    CPU tensors take the plain version. CUDA tensors launch the scan kernel
    with that selection on the current stream, over the same operands as
    :func:`knn_stripe_scan`, or raise.
    ``knn_stripe_scan_variant.launches[mode]`` counts the launches."""
    n_valid, k = int(n_valid), int(k)
    n_splits, rows_per_split = int(n_splits), int(rows_per_split)
    _check_variant(mode, k)
    if train_x.device.type == "cpu" and test_x.device.type == "cpu":
        return knn_stripe_scan_variant_reference(
            train_x, test_x, n_valid, k, mode, n_splits, rows_per_split)
    _check_kernel_inputs(train_x, test_x, n_valid, k)
    check_splits(n_valid, n_splits, rows_per_split, SPLIT_ALIGN)
    fn = _library().stripe_knn_scan_variant
    q, d = test_x.shape
    dev = train_x.device
    partial = torch.empty((q, n_splits, k), dtype=torch.int64, device=dev)
    if q == 0:
        return partial
    train_t = feature_major(train_x, cache=True)
    with torch.cuda.device(dev):
        rc = fn(SELECT_MODES.index(mode) + 1, train_t.data_ptr(),
                train_t.shape[1], n_valid, test_x.data_ptr(), q, d, k,
                n_splits, rows_per_split, partial.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise DeviceError(f"stripe_knn_scan_variant launch failed: CUDA "
                          f"error {rc}")
    knn_stripe_scan_variant.launches[mode] += 1
    return partial


knn_stripe_scan_variant.launches = dict.fromkeys(SELECT_MODES, 0)


def knn_stripe_candidates(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N, D]`` train and ``[Q, D]`` queries (float32) -> ``([Q, k]``
    float32 distances, ``[Q, k]`` int32 indices``)``, ascending by
    (distance, index) over rows ``< n_valid``; any k >= 1.

    CPU tensors take the plain version. CUDA tensors run
    :func:`knn_stripe_scan` over the splits of :func:`stripe_split_plan`,
    then :func:`knn_stripe_merge` (k > 16: the tile kernel's exact form,
    ``tile_knn.knn_tile_candidates``), or raise: a build failure is a
    :class:`CompileError`, a refused launch a :class:`DeviceError`, inputs
    the kernels do not take a ``ValueError``."""
    check_k(int(k))
    if train_x.device.type == "cpu" and test_x.device.type == "cpu":
        return knn_stripe_candidates_reference(train_x, test_x, n_valid, k)
    if k > STRIPE_MAX_K:
        from knn_tpu_torch.ops import tile_knn  # tile_knn imports this module

        return tile_knn.knn_tile_candidates(train_x, test_x, n_valid, k,
                                            "exact")
    n_valid = int(n_valid)
    _check_kernel_inputs(train_x, test_x, n_valid, int(k))
    plan = stripe_split_plan(n_valid, test_x.shape[0], train_x.device,
                             train_x.shape[1], int(k))
    return knn_stripe_merge(knn_stripe_scan(train_x, test_x, n_valid, k,
                                            *plan))


def memo(cache: Optional[dict], key: tuple, make):
    """Return ``cache[key]``, else ``make()`` it and store it when a cache
    dict (normally ``Dataset.device_cache``) was supplied."""
    if cache is not None and key in cache:
        return cache[key]
    entry = make()
    if cache is not None:
        cache[key] = entry
    return entry


def to_device(a: np.ndarray, dtype, dev: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``dev`` (a copy on the host too: Dataset arrays
    are read-only, and a tensor must not share their memory)."""
    return torch.tensor(np.ascontiguousarray(a, dtype), device=dev)


def cached_train(train_x: np.ndarray, dev: torch.device, cache: Optional[dict],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The device-resident ``[N, D]`` train matrix stored as ``dtype``
    (float32, or bfloat16 rounded to nearest even), memoized per device and
    dtype in ``cache`` so repeat calls skip the upload."""
    return memo(cache, ("train", str(dev), str(dtype)),
                lambda: to_device(train_x, np.float32, dev).to(dtype))


def cached_labels(train_y: np.ndarray, dev: torch.device,
                  cache: Optional[dict]) -> torch.Tensor:
    """The device-resident ``[N]`` int32 labels, memoized per device."""
    return memo(cache, ("labels", str(dev)),
                lambda: to_device(train_y, np.int32, dev))


def stripe_store_dtype(form: str, d: int) -> torch.dtype:
    """How the JAX stripe route stores the train matrix
    (``pallas_knn.py::_cached_stripe_train``): bfloat16 for the bf16 form on
    wide features, float32 otherwise. The norms of a matmul form are summed
    from the stored values, so this choice is part of the function."""
    return torch.bfloat16 if form == "bf16" and d > STRIPE_MAX_D else torch.float32


def stripe_route_candidates(
    train_x: torch.Tensor, test_x: torch.Tensor, n_valid: int, k: int,
    form: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stripe route on device tensors: the exact form with d <= 128 runs
    the stripe kernel (:func:`knn_stripe_candidates`); every other form and
    width runs the tile kernel (``tile_knn.knn_tile_candidates``), which
    computes the same function as the JAX stripe kernel's form."""
    if form == "exact" and train_x.shape[1] <= STRIPE_MAX_D:
        return knn_stripe_candidates(train_x, test_x, n_valid, k)
    from knn_tpu_torch.ops import tile_knn  # tile_knn imports this module

    return tile_knn.knn_tile_candidates(train_x, test_x, n_valid, k, form)


def to_device_async(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` as a float32 tensor on ``dev``. For a CUDA device the copy is
    staged in pinned host memory and enqueued on the current stream without
    waiting: a copy from pageable memory would wait for the work already on
    the stream, and a deferred call would then return only after it."""
    if dev.type != "cuda":
        return to_device(a, np.float32, dev)
    host = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
    host.numpy()[...] = a
    return host.to(dev, non_blocking=True)


def host_copy_async(*tensors: torch.Tensor):
    """Start copying ``tensors`` to the host and return ``wait()``, which
    gives them as numpy arrays (copies the caller owns).

    CUDA tensors are copied into pinned host tensors on the current stream
    (``non_blocking``), and an event recorded after the copies; ``wait()``
    waits on that event. CPU tensors are read now."""
    if tensors[0].device.type != "cuda":
        out = tuple(t.numpy().copy() for t in tensors)
        return lambda: out
    dev = tensors[0].device
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))

    def wait():
        done.synchronize()
        return tuple(h.numpy().copy() for h in host)

    return wait


def route_split_plan(n_valid: int, n_queries: int, dev, d: int, k: int,
                     form: str) -> Tuple[int, int]:
    """The split plan that :func:`stripe_route_candidates` gives its scan
    kernel on ``dev``: the stripe scan's for the exact form with d <= 128
    and k <= 16, the tile kernel's otherwise."""
    if form == "exact" and d <= STRIPE_MAX_D and k <= STRIPE_MAX_K:
        return stripe_split_plan(n_valid, n_queries, dev, d, k)
    from knn_tpu_torch.ops import tile_knn  # tile_knn imports this module

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    return tile_knn.tile_split_plan(n_valid, n_queries, sm_count, k, form)


def candidate_chunk_rows(n_valid: int, n_queries: int, dev, d: int, k: int,
                         form: str) -> int:
    """The most query rows one call of the kernels takes on ``dev``: all of
    them, halved until their ``[rows, splits, k]`` int64 partial keys (at
    the route's split plan for that many rows) fit
    :data:`PARTIAL_BYTES_CAP`. Fewer rows get more splits, so the halving
    stops at the plan's least splits."""
    rows = n_queries
    while rows > 1 and rows * k * 8 * route_split_plan(
            n_valid, rows, dev, d, k, form)[0] > PARTIAL_BYTES_CAP:
        rows = -(-rows // 2)
    return rows


def stripe_candidates_arrays(
    train_x: np.ndarray,
    test_x: np.ndarray,
    k: int,
    precision: str = "exact",
    device="cuda",
    cache: Optional[dict] = None,
    chunk_rows: Optional[int] = None,
    deferred: bool = False,
):
    """Host entry of the stripe route and the models' retrieval: numpy in,
    unpadded ``([Q, k]`` float32 distances, ``[Q, k]`` int32 indices``)``
    out, ascending by (distance, index); any k >= 1, and ``(0, k)`` empties
    for no queries. ``cache`` (a ``Dataset.device_cache`` dict) memoizes
    the device-side train matrix.

    The queries go to the card once and run in chunks of at most
    ``chunk_rows`` rows (default :func:`candidate_chunk_rows`, which bounds
    the kernels' partial-key buffer), streamed through
    ``utils/windowed.py::windowed_dispatch_deferred``: each chunk's answers
    start their copy to pinned host memory as soon as its kernels are
    enqueued (:func:`host_copy_async`). ``deferred=True`` returns a
    zero-argument ``resolve()`` instead of the arrays: the queries are
    uploaded and every chunk enqueued before this returns, and ``resolve()``
    waits for the copies and memoizes. On the CPU the plain versions run
    now and ``resolve()`` returns their result."""
    from knn_tpu_torch.utils.windowed import windowed_dispatch_deferred

    form = _resolve_stripe_precision(precision, train_x.shape[1])
    dev = resolve_device(device)
    check_k(int(k))
    n, q = train_x.shape[0], test_x.shape[0]
    if q == 0:
        empty = (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
        return (lambda: empty) if deferred else empty
    if chunk_rows is not None and chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    tx = cached_train(train_x, dev, cache,
                      stripe_store_dtype(form, train_x.shape[1]))
    qx = to_device_async(test_x, dev)
    if chunk_rows is None:
        chunk_rows = q if dev.type == "cpu" else candidate_chunk_rows(
            n, q, dev, train_x.shape[1], k, form)

    def dispatch(s0):
        return host_copy_async(*stripe_route_candidates(
            tx, qx[s0 : s0 + chunk_rows], n, k, form))

    def fetch(wait, s0):
        return wait()

    drain = windowed_dispatch_deferred(range(0, q, chunk_rows), dispatch,
                                       fetch)
    memo_out = []

    def resolve():
        if not memo_out:
            parts = drain()
            memo_out.append((np.concatenate([p[0] for p in parts]),
                             np.concatenate([p[1] for p in parts])))
        return memo_out[0]

    return resolve if deferred else resolve()


def knn_stripe_classify(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    test_x: torch.Tensor,
    n_valid: int,
    k: int,
    num_classes: int,
    form: str = "exact",
) -> torch.Tensor:
    """Classify on device tensors: the stripe route's kernels, the label
    gather and the vote. Returns ``[Q]`` int32 predictions on the same
    device."""
    _, idx = stripe_route_candidates(train_x, test_x, n_valid, k, form)
    return vote_neighbors(idx, train_y, num_classes)


def stripe_classify_arrays(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    precision: str = "exact",
    device="cuda",
    cache: Optional[dict] = None,
) -> np.ndarray:
    """Host entry for a full stripe-route classify: uploads (train memoized
    in ``cache``, stored as :func:`stripe_store_dtype` says), runs
    :func:`knn_stripe_classify`, and returns ``[Q]`` int32 predictions on
    the host — the copy back waits for the device work."""
    form = _resolve_stripe_precision(precision, train_x.shape[1])
    dev = resolve_device(device)
    if test_x.shape[0] == 0:
        return np.empty(0, np.int32)
    tx = cached_train(train_x, dev, cache,
                      stripe_store_dtype(form, train_x.shape[1]))
    ty = cached_labels(train_y, dev, cache)
    qx = to_device(test_x, np.float32, dev)
    return knn_stripe_classify(tx, ty, qx, train_x.shape[0], k, num_classes,
                               form).cpu().numpy()
