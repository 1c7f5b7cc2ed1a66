"""The IVF index family on the card (the port of ``knn_tpu/index/``,
ROADMAP A9).

- :mod:`knn_tpu_torch.index.kmeans`       — batched Lloyd's with k-means++
  seeding; the assignment step runs on the card;
- :mod:`knn_tpu_torch.index.ivf`          — the inverted-file index:
  centroids and a cell-sorted row permutation persisted in the artifact
  (format 3, the JAX package's layout), probed search with exact
  distances and the shared (distance, index) tie order, scored on the
  host or by the segment scorer on the card (``ops/segment_score.py``);
- :mod:`knn_tpu_torch.index.probe_policy` — the quality-burn-driven
  ``nprobe`` controller.
"""

from knn_tpu_torch.index.ivf import IVFIndex, IVFServing  # noqa: F401
from knn_tpu_torch.index.kmeans import kmeans  # noqa: F401
from knn_tpu_torch.index.probe_policy import ProbePolicy  # noqa: F401
