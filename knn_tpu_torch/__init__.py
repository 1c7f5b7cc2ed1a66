"""knn_tpu_torch — the PyTorch/CUDA port of ``knn_tpu``, for one NVIDIA H100.

A second package beside ``knn_tpu`` (the JAX reference, which stays as it
is), laid out like it so each module's counterpart sits at the same
relative path. It imports ``torch`` and numpy, never ``jax`` and never
``knn_tpu``. Its entry points run on the card (``device="cuda"``) unless
the caller asks for the host (``device="cpu"``).

- ``knn_tpu_torch.data``     — ARFF ingest into dense ``float32 [N, D]``.
- ``knn_tpu_torch.ops``      — the distance forms, the vote, the stripe
  and tile KNN kernels (``csrc/stripe_knn.cu``, ``csrc/tile_knn.cu``) and
  the bf16 matmul probe kernel (``csrc/probe_matmul.cu``), built with nvcc
  at first use, beside their plain PyTorch versions.
- ``knn_tpu_torch.probes``   — the diagnostic probes (selection variants,
  the matmul floor) and the generated data they and ``chip_smoke.py`` read.
- ``knn_tpu_torch.obs``      — spans, metrics and their exports
  (``--metrics-out``/``--trace-out``), and the timing primitives
  (``bench_timing``).
- ``knn_tpu_torch.resilience`` — typed errors, fault injection, retry and
  the degradation ladder, which stops at the card.
- ``knn_tpu_torch.native``   — the C++ ARFF parser and runtime kernel (the
  port's copies of the JAX package's sources), built with ``g++``.
- ``knn_tpu_torch.backends`` — ``cuda`` (the stripe route), ``cuda-tile``
  (the wide-feature rung), ``native``/``native-mt`` (C++ on the host) and
  ``oracle`` (numpy).
- ``knn_tpu_torch.models``   — ``KNNClassifier``, ``KNNRegressor`` and
  ``sweep_k`` on the retrieval core (the kernels, or the XLA route's scan).
- ``knn_tpu_torch.index``    — the IVF index family: the k-means partition
  (its assignment steps on the card) and probed retrieval, scored on the
  host or by the segment scorer (``ops/segment_score.py``) on the card.
- ``knn_tpu_torch.serve``    — ``save-index`` and ``serve``: the index
  artifact, the micro-batcher (the ``ivf`` rung above ``fast``) and the
  HTTP front-end.
- ``knn_tpu_torch.mutable``  — ``serve --mutable on``: the delta tier,
  tombstones, the write-ahead epoch log and compaction; the delta rows on
  the card for the torch-scan route and the ivf rung.
- ``knn_tpu_torch.cli``      — ``python -m knn_tpu_torch TRAIN TEST k
  [threads]``, with the JAX CLI's personas and classify flags.
- ``knn_tpu_torch.convert``  — a ``knn_tpu`` dataset's fields (or IVF
  partition's arrays) in, the port's :class:`Dataset` (``IVFIndex``) out.

The behavioral contract (SURVEY.md §3.5) is the JAX package's: squared
Euclidean over the first D-1 attributes, first-seen train index wins
distance ties, lowest class id wins vote ties, ``num_classes =
max(label)+1``.
"""

__version__ = "0.2.0"

from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.data.arff import load_arff, write_arff
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor, sweep_k

__all__ = [
    "Dataset", "load_arff", "write_arff", "KNNClassifier", "KNNRegressor",
    "sweep_k", "__version__",
]
