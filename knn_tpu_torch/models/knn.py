"""High-level model API: the port of ``knn_tpu/models/knn.py``.

``KNNClassifier`` and ``KNNRegressor`` fit a train :class:`Dataset` and
answer through the port's retrieval core, :func:`_kneighbors_arrays`:

- engine ``auto`` (and ``stripe``) sends the euclidean metric to the
  hand-written kernels through ``ops/cuda_knn.py::stripe_candidates_arrays``
  at every d and k: the stripe scan and merge for d <= 128 and k <= 16, the
  tile kernel's exact form and the merge elsewhere;
- engine ``xla``, and every other metric, takes the XLA route's tiled scan
  as torch ops (``backends/cuda.py::candidates_arrays``).

Every entry runs on the card (``device="cuda"``, the default) unless the
caller asks for the host (``device="cpu"``: the kernels' plain versions and
the torch scan on CPU tensors). A missing card is a ``DeviceError``, and no
route falls back to another. The distance form is always the exact one.

The call sites carry the JAX package's fault points (``guarded_call``
with ``device.put`` around ``backend.compile`` on the kernel route; the
XLA route's own in ``backends/cuda.py::candidates_arrays``) and its spans:
``fit``, ``distance``, ``vote``, ``sweep_k``, and ``kneighbors`` around
the classifier's public retrieval; the routes' entries open ``prepare``,
``dispatch`` (the kernels' route) and ``fetch`` below ``distance``, a
deferred call's ``fetch`` when it is resolved. The mutable tier's device merge
enters as ``merge_tail`` (torch-scan route only, as in JAX). The serving
batcher's staged upload enters as ``prefetched_queries``, and every
retrieval counts its signature in ``obs/devprof.py``'s executable-cache
hit/miss. The compiled-shape bucket ladder is an argument of the shape
helpers, never process-wide state: the server scopes it to itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.backends import get_backend
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.resilience.retry import guarded_call
from knn_tpu_torch.utils.evaluate import accuracy, confusion_matrix

#: Query rows pad to this quantum on the XLA retrieval path when no bucket
#: ladder is given (the JAX package's compiled-shape rule; the port's torch
#: scan needs no more than its query tile).
QUERY_PAD_QUANTUM = 128

#: The serving default for ``serve --batch-buckets auto``: a geometric
#: ladder; a batch pads to the smallest bucket >= its rows.
DEFAULT_BATCH_BUCKETS = (16, 32, 64, 128, 256)

#: The candidate-count bucket ladder of the IVF gather+score step
#: (ROADMAP A9/B3): past the top bucket the shape steps in top-bucket
#: multiples.
DEFAULT_CANDIDATE_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384)

ENGINES = ("auto", "stripe", "xla")


def normalize_buckets(buckets) -> "tuple[int, ...]":
    """Validate + canonicalize a bucket ladder: positive ints, sorted,
    deduplicated. Raises ``ValueError`` on anything else."""
    try:
        out = tuple(sorted({int(b) for b in buckets}))
    except (TypeError, ValueError):
        raise ValueError(f"batch buckets must be integers, got {buckets!r}")
    if not out or out[0] < 1:
        raise ValueError(f"batch buckets must be positive, got {buckets!r}")
    return out


def _bucket_rows(rows: int, ladder) -> int:
    """The smallest bucket of ``ladder`` >= rows; past the top bucket, the
    next multiple of it; 0 for no rows."""
    rows = int(rows)
    if rows <= 0:
        return 0
    for size in ladder:
        if rows <= size:
            return size
    top = ladder[-1]
    return -(-rows // top) * top


def query_padded_rows(rows: int, buckets=None) -> int:
    """The compiled-shape query-row count for ``rows`` actual rows under
    the ladder ``buckets`` (normalized first): the smallest bucket >= rows,
    and past the top bucket the next multiple of it; with ``buckets=None``
    the next multiple of :data:`QUERY_PAD_QUANTUM`. 0 for no rows."""
    if buckets is None:
        rows = int(rows)
        return -(-rows // QUERY_PAD_QUANTUM) * QUERY_PAD_QUANTUM if rows > 0 else 0
    return _bucket_rows(rows, normalize_buckets(buckets))


def candidate_padded_rows(rows: int) -> int:
    """The compiled-shape candidate-row count for ``rows`` actual
    candidates per query, on :data:`DEFAULT_CANDIDATE_BUCKETS`."""
    return _bucket_rows(rows, DEFAULT_CANDIDATE_BUCKETS)


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; choose 'auto', 'stripe', or 'xla'"
        )


def retrieval_route(engine: str, metric: str = "euclidean") -> str:
    """THE route rule of :func:`_kneighbors_arrays`, shared with the cost
    layer (``obs/accounting.resolved_retrieval_engine``): ``stripe`` (the
    hand-written kernels, at every d and k) for the euclidean metric on
    engines ``auto`` and ``stripe``, ``xla`` (the torch scan) otherwise."""
    _check_engine(engine)
    if engine in ("auto", "stripe") and metric in (None, "euclidean"):
        return "stripe"
    return "xla"


def _kneighbors_arrays(
    train_x: np.ndarray,
    test_x: np.ndarray,
    k: int,
    metric: str = "euclidean",
    engine: str = "auto",
    cache: "dict | None" = None,
    deferred: bool = False,
    device="cuda",
    prefetched_queries=None,
    merge_tail=None,
):
    """Shared retrieval core for both model families: ``(dists [Q, k],
    indices [Q, k])`` sorted by (distance, train index). Pure geometry — no
    label semantics, so the regressor can use it with negative or float
    targets that the classifier's label validation would reject.

    ``engine``: ``auto`` sends the euclidean metric to the kernels (any d
    and k), ``stripe`` forces them (euclidean only, else ``ValueError``),
    ``xla`` takes the tiled torch scan; other metrics always take the scan
    (:func:`retrieval_route`). ``cache`` (normally the train
    ``Dataset.device_cache``) memoizes the device-side train. ``deferred``
    returns a zero-argument ``resolve()`` instead of the arrays: the device
    work and the copies back are enqueued before this returns, and
    ``resolve()`` waits for them (memoized) — the primitive under
    ``kneighbors_async`` and the serving batcher. No queries give ``(0, k)``
    empties on every engine.

    ``prefetched_queries`` (the serving batcher's staged upload,
    ``serve/batcher.py``): a float32 tensor on the retrieval's device whose
    first ``Q`` rows are ``test_x`` (the batcher stages a whole bucket and
    the rows past ``Q`` are never read). It takes the place of the upload
    this call would make, on either route; the answers are bit-identical
    with and without it. A block of another device, dtype, width, or with
    fewer than ``Q`` rows is not used, and the queries are uploaded as
    usual.

    ``merge_tail`` (the mutable tier's delta tail on the card,
    ``mutable/device_tail.py``): a callable ``(d_dev, i_dev, queries_dev)
    -> (d_dev, i_dev)`` applied to the torch-scan route's device outputs
    before the copy back, so base and delta merge in the same round trip.
    Torch-scan route only (``ValueError`` on the kernels' route, whose
    callers take the host merge); its ``sig`` joins the signature."""
    from knn_tpu_torch.backends.cuda import candidates_arrays
    from knn_tpu_torch.obs.accounting import padded_query_rows
    from knn_tpu_torch.ops.cuda_knn import (
        resolve_device,
        stripe_candidates_arrays,
    )
    from knn_tpu_torch.ops.distance import resolve_form

    _check_engine(engine)
    form = resolve_form("exact", metric)
    if engine == "stripe" and metric not in (None, "euclidean"):
        raise ValueError("the stripe engine implements euclidean only")
    route = retrieval_route(engine, metric)
    q, d = test_x.shape
    swept = padded_query_rows(route, q)
    if prefetched_queries is not None and not _usable_block(
            prefetched_queries, q, d, resolve_device(device)):
        prefetched_queries = None
    if obs.enabled():
        from knn_tpu_torch.obs import devprof

        # A launch is configured by its route, form, swept rows, k and d:
        # the port's counterpart of the JAX executable signature.
        sig = (route, form, swept, int(k), int(d))
        if merge_tail is not None:
            sig = sig + (getattr(merge_tail, "sig", "merge_tail"),)
        devprof.record_executable_lookup("retrieval", sig)
    if route == "stripe":
        if merge_tail is not None:
            raise ValueError(
                "merge_tail is a torch-scan route hook; the kernels' route "
                "copies its answers back inside its own entry (the caller "
                "takes the host merge instead)")
        with obs.span("distance", engine="stripe", note="fused distance+top-k",
                      rows=q, padded_rows=swept):
            out = guarded_call("device.put", lambda: guarded_call(
                "backend.compile", lambda: stripe_candidates_arrays(
                    train_x, test_x, k, precision=form, device=device,
                    cache=cache, deferred=deferred,
                    prefetched_queries=prefetched_queries,
                )))
        return out
    return candidates_arrays(train_x, test_x, k, form, device=device,
                             cache=cache, deferred=deferred,
                             prefetched_queries=prefetched_queries,
                             merge_tail=merge_tail)


def _usable_block(block, q: int, d: int, dev) -> bool:
    """Whether a staged query block can stand in for the upload of ``q``
    rows of width ``d`` on ``dev``."""
    import torch

    return (isinstance(block, torch.Tensor) and block.dtype == torch.float32
            and block.dim() == 2 and block.shape[0] >= q
            and block.shape[1] == d and block.device.type == dev.type
            and dev.index in (None, block.device.index))


class AsyncResult:
    """Handle for an in-flight retrieval or predict (``kneighbors_async``,
    ``predict_async``): the device work and its copies to the host are
    enqueued when the handle is returned; :meth:`result` waits for them
    once and memoizes. Many handles resolved together let the host enqueue
    the next call's work while the card runs the last.

    The handle is single-consumer: resolve it from one thread.

    ``meta`` is an optional side-channel dict the producer may attach; it
    never affects :meth:`result`."""

    __slots__ = ("_finish", "_value", "_waiter", "_outcome", "meta")

    def __init__(self, finish, meta: "dict | None" = None):
        self._finish = finish
        self._value = None
        self._waiter = None
        self._outcome = None
        self.meta = meta

    def result(self, timeout: "float | None" = None):
        """Block until the result is ready and return it (memoized).

        ``timeout`` (seconds) bounds the wait: on expiry a
        :class:`~knn_tpu_torch.resilience.errors.DeadlineExceededError` is
        raised and the in-flight work keeps running — a later ``result()``
        call can still collect it. Two resolution strategies:

        - a finish closure marked ``__accepts_timeout__ = True`` is called
          as ``finish(timeout=...)`` and owns its own bounded wait;
        - a generic closure (the deferred copies, which block in CUDA) is
          moved to a daemon waiter thread the first time a timeout is
          requested, and the caller joins it with the timeout.
        """
        if self._waiter is not None:
            return self._join_waiter(timeout)
        if self._finish is None:
            return self._value
        if timeout is None:
            self._value = self._finish()
            self._finish = None
            return self._value
        if getattr(self._finish, "__accepts_timeout__", False):
            # The closure raises DeadlineExceededError itself on expiry,
            # leaving the handle resolvable later.
            self._value = self._finish(timeout=timeout)
            self._finish = None
            return self._value
        import threading

        fn, self._finish = self._finish, None
        box = []

        def run():
            try:
                box.append(("ok", fn()))
            except BaseException as e:  # delivered to the consumer below
                box.append(("err", e))

        self._outcome = box
        self._waiter = threading.Thread(
            target=run, name="knn-async-result", daemon=True
        )
        self._waiter.start()
        return self._join_waiter(timeout)

    def _join_waiter(self, timeout):
        from knn_tpu_torch.resilience.errors import DeadlineExceededError

        self._waiter.join(timeout)
        if self._waiter.is_alive():
            raise DeadlineExceededError(
                f"async result not ready within {timeout * 1e3:.0f} ms; the "
                f"work continues — call result() again to collect it"
            )
        kind, payload = self._outcome[0]
        if kind == "err":
            # Memoized failure: the dead waiter is kept so every later
            # result() joins at once and re-raises the same error.
            raise payload
        self._value = payload
        self._waiter = None
        self._outcome = None
        return self._value


def _host_counts(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """[Q, C] neighbor-label histogram on host. One flattened bincount
    (np.add.at's unbuffered scatter is ~10x slower at scale)."""
    nq, c = labels.shape[0], num_classes
    return np.bincount(
        (np.arange(nq)[:, None] * c + labels).ravel(), minlength=nq * c
    ).reshape(nq, c)


def _host_vote(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """NumPy twin of ops/vote.py: per-row class counts, argmax with ties to
    the LOWEST class id (np.argmax returns the first maximum — the same
    first-max rule, main.cpp:70-74)."""
    return np.argmax(_host_counts(labels, num_classes), axis=1).astype(np.int32)


def _inverse_distance_weights(dists: np.ndarray):
    """Shared inverse-distance weighting for both model families: float64
    weights (1/d on tiny f32 distances overflows), exact-distance-0 matches
    claim all the weight, and rows whose weights all vanish (all-inf
    distances) are flagged for a uniform fallback. Returns ``(w, degenerate)``
    where ``degenerate`` marks rows needing the uniform treatment."""
    dists = dists.astype(np.float64)
    exact = dists == 0.0
    any_exact = exact.any(axis=1)
    with np.errstate(divide="ignore"):
        w = np.where(exact, 0.0, 1.0 / dists)
    w = np.where(any_exact[:, None], exact.astype(np.float64), w)
    degenerate = w.sum(axis=1) == 0
    return w, degenerate


def _distance_scores(dists: np.ndarray, labels: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """[Q, C] per-class sums of inverse-distance weights (degenerate rows:
    uniform weights)."""
    w, degenerate = _inverse_distance_weights(np.asarray(dists))
    w = np.where(degenerate[:, None], 1.0, w)
    scores = np.zeros((labels.shape[0], num_classes))
    for c in range(num_classes):
        scores[:, c] = np.where(labels == c, w, 0.0).sum(axis=1)
    return scores


def vote_from_labels(dists: np.ndarray, labels: np.ndarray,
                     num_classes: int, weights: str) -> np.ndarray:
    """Classifier vote from an EXPLICIT per-candidate label matrix
    ``labels [Q, k]`` — the label-lookup-agnostic half of
    :meth:`KNNClassifier.predict_from_candidates`, shared with the mutable
    tier (``mutable/state.predict_from_view``): first-max for ``uniform``,
    per-class inverse-distance weight sums for ``distance`` (ties to the
    lowest class id either way)."""
    if weights == "distance":
        return np.argmax(_distance_scores(dists, labels, num_classes),
                         axis=1).astype(np.int32)
    return _host_vote(labels, num_classes)


def aggregate_targets(dists: np.ndarray, neigh: np.ndarray,
                      weights: str) -> np.ndarray:
    """Regression aggregation from an EXPLICIT neighbor-target matrix
    ``neigh [Q, k]`` — the target-lookup-agnostic half of
    :meth:`KNNRegressor.predict`, shared with the mutable tier for the same
    reason as :func:`vote_from_labels`."""
    if weights == "uniform":
        return neigh.mean(axis=1).astype(np.float32)
    w, degenerate = _inverse_distance_weights(dists)
    w_sum = w.sum(axis=1)
    weighted = (w * neigh).sum(axis=1) / np.where(degenerate, 1.0, w_sum)
    # All-inf distances (e.g. NaN queries) zero every weight; fall back to
    # the uniform mean rather than emitting 0/0.
    return np.where(degenerate, neigh.mean(axis=1), weighted).astype(np.float32)


def radius_neighbors_arrays(
    train_x: np.ndarray,
    test_x: np.ndarray,
    radius: float,
    max_neighbors: int = 128,
    metric: str = "euclidean",
    engine: str = "auto",
    cache: "dict | None" = None,
    device="cuda",
):
    """All train rows within ``radius`` of each query, as fixed-shape masked
    arrays: ``(dists [Q, m], indices [Q, m], mask [Q, m])`` where
    ``m = min(max_neighbors, N)``, candidates sorted by (distance, index),
    ``mask`` marking the within-radius entries. Euclidean radii are compared
    against *squared* distances, matching the framework's distance values.
    At the default 128 the euclidean retrieval is the tile kernel's k > 16
    path on the card.

    Raises when a query's neighborhood might exceed ``max_neighbors`` (every
    returned candidate in-radius with more train rows unseen) rather than
    silently truncating.
    """
    n = train_x.shape[0]
    m = min(max_neighbors, n)
    d, i = _kneighbors_arrays(
        train_x, test_x, m, metric=metric, engine=engine, cache=cache,
        device=device,
    )
    mask = d <= radius
    full = mask.all(axis=1)
    if m < n and bool(full.any()):
        rows = np.nonzero(full)[0][:5]
        raise ValueError(
            f"queries {rows.tolist()} have at least {m} neighbors within "
            f"radius {radius}; raise max_neighbors (or shrink the radius) to "
            f"get complete neighborhoods"
        )
    return d, i, mask


def sweep_k(train: Dataset, test: Dataset, ks, metric="euclidean",
            engine="auto", device="cuda"):
    """Predictions for EVERY k in ``ks`` from one shared retrieval.

    The candidate list is computed once for ``max(ks)`` and each k votes
    over its prefix — correct because candidates are sorted ascending by
    (distance, train index), so the first k entries ARE that k's exact
    neighbor set under the reference's tie rule (SURVEY.md §3.5). The votes
    run on ``device`` (``ops/vote.py``) and come back in one copy. Returns
    ``{k: [Q] int32 predictions}``; each entry is identical to an
    individual ``predict`` at that k.
    """
    import torch

    from knn_tpu_torch.ops.cuda_knn import resolve_device, to_device
    from knn_tpu_torch.ops.vote import vote

    ks = sorted({int(k) for k in ks})
    if not ks or ks[0] < 1:
        raise ValueError(f"ks must be positive integers, got {sorted(ks)}")
    kmax = ks[-1]
    train.validate_for_knn(kmax, test)
    dev = resolve_device(device)
    with obs.span("sweep_k", kmax=kmax, num_ks=len(ks)):
        _, idx = _kneighbors_arrays(
            train.features, test.features, kmax, metric=metric, engine=engine,
            cache=train.device_cache, device=dev,
        )
        if idx.shape[0] == 0:
            return {k: np.empty(0, np.int32) for k in ks}
        with obs.span("vote", num_ks=len(ks)):
            labels = to_device(
                train.labels[np.minimum(idx, train.num_instances - 1)],
                np.int32, dev)
            votes = torch.stack([vote(labels[:, :k], train.num_classes)
                                 for k in ks]).cpu().numpy()
    return {k: votes[j] for j, k in enumerate(ks)}


class KNNClassifier:
    """k-nearest-neighbor classifier with reference-exact tie semantics
    (SURVEY.md §3.5) and a pluggable execution strategy.

    >>> model = KNNClassifier(k=5)           # backend "cuda", on the card
    >>> model.fit(train_ds)
    >>> preds = model.predict(test_ds)
    >>> model.score(test_ds)

    ``backend_opts`` go to the backend's predict; ``engine`` and ``device``
    (default ``"cuda"``) are honored by the retrieval methods too.
    """

    def __init__(
        self, k: int, backend: str = "cuda", metric: str = "euclidean",
        weights: str = "uniform", **backend_opts,
    ):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if weights not in ("uniform", "distance"):
            raise ValueError(f"weights must be 'uniform' or 'distance', got {weights!r}")
        if weights == "distance" and (
            backend != "cuda" or set(backend_opts) - {"engine", "device"}
        ):
            # The weighted vote runs on the retrieval core, which honors
            # only the engine and the device.
            raise ValueError(
                "weights='distance' computes its vote from the retrieval "
                "core; a backend choice or backend options (except 'engine' "
                "and 'device') would be silently ignored — drop them or use "
                "weights='uniform'"
            )
        from knn_tpu_torch.ops.distance import resolve_form

        resolve_form("exact", metric)  # validate early
        self.k = k
        self.backend_name = backend
        self.metric = metric
        self.weights = weights
        self.backend_opts = backend_opts
        self._train: Optional[Dataset] = None

    def fit(self, train: Dataset) -> "KNNClassifier":
        with obs.span("fit", k=self.k):
            train.validate_for_knn(self.k)
            self._train = train
        return self

    @property
    def train_(self) -> Dataset:
        if self._train is None:
            raise RuntimeError("call fit() before predict()/score()")
        return self._train

    @property
    def device(self):
        return self.backend_opts.get("device", "cuda")

    def predict(self, test: Dataset) -> np.ndarray:
        if self.weights == "distance":
            # Weighted vote (opt-in extension; the reference vote is an
            # unweighted bincount, main.cpp:65-67), on the retrieval core.
            return self.predict_from_candidates(*self.kneighbors(test))
        fn = get_backend(self.backend_name)
        return fn(self.train_, test, self.k, metric=self.metric, **self.backend_opts)

    def predict_from_candidates(
        self, dists: np.ndarray, idx: np.ndarray
    ) -> np.ndarray:
        """Predictions from an already-retrieved candidate set — the vote
        half of :meth:`predict_async`. Identical predictions to
        :meth:`predict` by the shared (distance, train-index, first-max
        vote) contracts (SURVEY.md §3.5)."""
        train = self.train_
        labels = train.labels[np.minimum(idx, train.num_instances - 1)]
        attrs = {"weighted": True} if self.weights == "distance" else {}
        with obs.span("vote", **attrs):
            return vote_from_labels(dists, labels, train.num_classes,
                                    self.weights)

    def _retrieve(self, test: Dataset, deferred: bool = False):
        train = self.train_
        train.validate_for_knn(self.k, test)
        return _kneighbors_arrays(
            train.features, test.features, self.k, metric=self.metric,
            engine=self._retrieval_engine(), cache=train.device_cache,
            deferred=deferred, device=self.device,
        )

    def kneighbors(self, test: Dataset):
        """Per-query neighbor candidates: ``(dists [Q, k], indices [Q, k])``
        sorted ascending by (distance, train index) — the framework's
        tie-break order. No reference analogue (its kernel discards the
        candidate set after voting, main.cpp:64-78); standard retrieval API.
        """
        with obs.span("kneighbors", k=self.k):
            return self._retrieve(test)

    def kneighbors_async(self, test: Dataset) -> AsyncResult:
        """:meth:`kneighbors` with the wait deferred: the device work and
        the copies to the host are enqueued when this returns;
        ``.result()`` on the handle waits once and returns the identical
        ``(dists, indices)``."""
        with obs.span("kneighbors", k=self.k, deferred=True):
            return AsyncResult(self._retrieve(test, deferred=True))

    def predict_async(self, test: Dataset) -> AsyncResult:
        """:meth:`predict` as a future. Computed from the retrieval core
        (same engine selection as :meth:`kneighbors`) with the host-side
        vote twin — identical predictions to ``predict`` by the shared
        (distance, train-index, first-max vote) contracts (SURVEY.md §3.5),
        independent of the fitted ``backend`` name."""
        resolve = self._retrieve(test, deferred=True)
        return AsyncResult(lambda: self.predict_from_candidates(*resolve()))

    def _retrieval_engine(self) -> str:
        """The backend ``engine`` opt translated for the retrieval core:
        ring-only per-step scorers ('full'/'tiled') have no retrieval
        counterpart, so they defer to auto selection."""
        engine = self.backend_opts.get("engine", "auto")
        return "auto" if engine in ("full", "tiled") else engine

    def radius_neighbors(
        self, test: Dataset, radius: float, max_neighbors: int = 128
    ):
        """Within-radius retrieval (``(dists, indices, mask)`` fixed-shape
        masked arrays — see :func:`radius_neighbors_arrays`)."""
        train = self.train_
        train.validate_for_knn(1, test)
        return radius_neighbors_arrays(
            train.features, test.features, radius, max_neighbors, self.metric,
            engine=self._retrieval_engine(), cache=train.device_cache,
            device=self.device,
        )

    def predict_proba(self, test: Dataset) -> np.ndarray:
        """[Q, num_classes] neighbor-vote fractions: counts/k for uniform
        weights, normalized inverse-distance weight sums otherwise."""
        train = self.train_
        dists, idx = self.kneighbors(test)
        labels = train.labels[np.minimum(idx, train.num_instances - 1)]
        if self.weights == "distance":
            scores = _distance_scores(dists, labels, train.num_classes)
            return scores / scores.sum(axis=1, keepdims=True)
        return _host_counts(labels, train.num_classes).astype(np.float64) / self.k

    def confusion_matrix(self, test: Dataset, predictions: Optional[np.ndarray] = None) -> np.ndarray:
        if predictions is None:
            predictions = self.predict(test)
        return confusion_matrix(predictions, test.labels, test.num_classes)

    def score(self, test: Dataset, predictions: Optional[np.ndarray] = None) -> float:
        return accuracy(self.confusion_matrix(test, predictions))


class KNNRegressor:
    """k-nearest-neighbor regression — a model family the reference does not
    have (its pipeline casts the class column to int unconditionally,
    main.cpp:57); the framework keeps the uncast column
    (``Dataset.raw_targets``) so numeric targets survive ingest.

    Neighbor selection is the classifier's (the same retrieval core, the
    (distance, train-index) order — SURVEY.md §3.5), on ``engine`` and
    ``device`` (default ``"cuda"``). ``weights``:

    - ``"uniform"``: mean of the k neighbor targets.
    - ``"distance"``: inverse-distance weighting; when a query coincides
      exactly with train rows (distance 0), the prediction is the mean of
      those exact matches only.
    """

    def __init__(
        self, k: int, weights: str = "uniform", metric: str = "euclidean",
        engine: str = "auto", device="cuda",
    ):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if weights not in ("uniform", "distance"):
            raise ValueError(f"weights must be 'uniform' or 'distance', got {weights!r}")
        _check_engine(engine)
        from knn_tpu_torch.ops.distance import resolve_form

        resolve_form("exact", metric)  # validate early
        self.k = k
        self.weights = weights
        self.metric = metric
        self.engine = engine
        self.device = device
        self._train: Optional[Dataset] = None

    def fit(self, train: Dataset) -> "KNNRegressor":
        with obs.span("fit", k=self.k):
            if self.k > train.num_instances:
                raise ValueError(
                    f"k={self.k} exceeds the number of train instances "
                    f"({train.num_instances})"
                )
            self._train = train
        return self

    @property
    def train_(self) -> Dataset:
        if self._train is None:
            raise RuntimeError("call fit() before predict()/score()")
        return self._train

    def _check_features(self, test: Dataset) -> Dataset:
        train = self.train_
        if test.num_features != train.num_features:
            raise ValueError(
                f"train has {train.num_features} features but test has "
                f"{test.num_features}"
            )
        return train

    def radius_neighbors(
        self, test: Dataset, radius: float, max_neighbors: int = 128
    ):
        """Within-radius retrieval — see :func:`radius_neighbors_arrays`."""
        train = self._check_features(test)
        return radius_neighbors_arrays(
            train.features, test.features, radius, max_neighbors, self.metric,
            engine=self.engine, cache=train.device_cache, device=self.device,
        )

    def _retrieve(self, test: Dataset, deferred: bool = False):
        train = self._check_features(test)
        return _kneighbors_arrays(
            train.features, test.features, self.k, metric=self.metric,
            engine=self.engine, cache=train.device_cache, deferred=deferred,
            device=self.device,
        )

    def kneighbors(self, test: Dataset):
        """Same retrieval core as the classifier, without its label
        validation (regression targets may be negative/non-integer)."""
        return self._retrieve(test)

    def kneighbors_async(self, test: Dataset) -> AsyncResult:
        """:meth:`kneighbors` as a future — see
        :meth:`KNNClassifier.kneighbors_async`."""
        return AsyncResult(self._retrieve(test, deferred=True))

    def predict_async(self, test: Dataset) -> AsyncResult:
        """:meth:`predict` as a future (identical values: same retrieval,
        same host-side aggregation)."""
        handle = self.kneighbors_async(test)
        return AsyncResult(lambda: self._predict_from(handle.result()))

    def predict(self, test: Dataset) -> np.ndarray:
        return self._predict_from(self.kneighbors(test))

    def _predict_from(self, neighbors) -> np.ndarray:
        train = self.train_
        dists, idx = neighbors
        neigh = train.targets[np.minimum(idx, train.num_instances - 1)]
        return aggregate_targets(dists, neigh, self.weights)

    def score(self, test: Dataset, predictions: Optional[np.ndarray] = None) -> float:
        """Coefficient of determination R^2 against ``test.targets``."""
        if predictions is None:
            predictions = self.predict(test)
        y = test.targets.astype(np.float64)
        p = predictions.astype(np.float64)
        ss_res = float(((y - p) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot else (1.0 if ss_res == 0 else 0.0)
