"""Serving on the card (the port of ``knn_tpu/serve/``): long-lived,
low-latency request serving over a prebuilt index.

- :mod:`knn_tpu_torch.serve.batcher`  — the dynamic micro-batcher:
  coalesces concurrent ``predict``/``kneighbors`` requests into one
  dispatch of the hand-written kernels under a ``max_batch`` /
  ``max_wait_ms`` policy, stages the next batch's upload in pinned memory
  on a side CUDA stream while the current batch runs, and scatters
  per-request slices back to :class:`~knn_tpu_torch.models.knn.AsyncResult`
  futures — bit-identical to the synchronous API;
- :mod:`knn_tpu_torch.serve.artifact` — the versioned index artifact
  (format 3, shared with the JAX package both ways) and the warmup step;
- :mod:`knn_tpu_torch.serve.cache`    — the exact-match result cache;
- :mod:`knn_tpu_torch.serve.server`   — the HTTP front-end (stdlib
  ``ThreadingHTTPServer``): ``/predict``, ``/kneighbors``, ``/healthz``,
  ``/metrics``, ``/debug/*``, ``/admin/reload``, ``/admin/capture``; with
  ``--shadow-rate``, ``--drift-rate`` and ``--capture-dir`` it builds the
  answer-quality and workload layers of :mod:`knn_tpu_torch.obs` and taps
  the batcher into them (host threads; nothing more on the card); with
  ``--mutable on`` the mutable tier (:mod:`knn_tpu_torch.mutable`):
  ``/insert``, ``/delete``, ``/admin/compact``, every answer merged with
  the delta rows and tombstones at its ``mutation_seq``.

The serving ladder stops at the card: a failing kernel is retried in place
(transient), rerun in halved batches (out of memory), or reported typed —
never answered by another route or by the host. With ``serve
--ivf-probes`` the ``ivf`` rung (probed retrieval over the artifact's IVF
partition) sits above it and degrades to it on any typed failure. A circuit breaker fails
batches at once while the card keeps failing and re-closes when it
recovers.

CLI: ``python -m knn_tpu_torch save-index train.arff index/`` then
``python -m knn_tpu_torch serve index/`` (``--device cpu`` runs the
kernels' plain versions on the host).
"""

from __future__ import annotations

from knn_tpu_torch.serve.artifact import load_index, save_index, warmup
from knn_tpu_torch.serve.batcher import MicroBatcher

__all__ = ["MicroBatcher", "load_index", "save_index", "warmup"]
