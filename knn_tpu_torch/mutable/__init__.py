"""Online mutable indexes on the card: delta tier, tombstones, compaction
(the port of ``knn_tpu/mutable/``, ROADMAP A10 and B4).

The LSM-style split: an immutable base — every retrieval rung and device
cache untouched — plus a small mutable tail merged into every answer under
the shared (distance, index) contract, folded back into a fresh immutable
generation by compaction through the live swap path.

- :mod:`knn_tpu_torch.mutable.state`       — the per-dispatch immutable
  view and the lexicographic base+delta+tombstone merge (host numpy);
- :mod:`knn_tpu_torch.mutable.engine`      — write-ahead epoch log,
  mutation application, boot replay, compaction seal/rebase;
- :mod:`knn_tpu_torch.mutable.compact`     — the fold + the compactor;
- :mod:`knn_tpu_torch.mutable.device_tail` — the delta block on the card
  and its merge, as torch ops.

Nothing here is imported unless a server boots with ``--mutable on``.
"""

from knn_tpu_torch.mutable.state import (  # noqa: F401
    MutableView,
    MutationConflict,
)
