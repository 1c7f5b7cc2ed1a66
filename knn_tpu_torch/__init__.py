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
- ``knn_tpu_torch.obs``      — the timing primitives (``bench_timing``).
- ``knn_tpu_torch.backends`` — ``cuda`` (the stripe route), ``cuda-tile``
  (the wide-feature rung) and ``oracle`` (numpy).
- ``knn_tpu_torch.cli``      — ``python -m knn_tpu_torch TRAIN TEST k``.
- ``knn_tpu_torch.convert``  — a ``knn_tpu`` dataset's fields in, the
  port's :class:`Dataset` out.

The behavioral contract (SURVEY.md §3.5) is the JAX package's: squared
Euclidean over the first D-1 attributes, first-seen train index wins
distance ties, lowest class id wins vote ties, ``num_classes =
max(label)+1``.
"""

__version__ = "0.2.0"

from knn_tpu_torch.data.arff import load_arff
from knn_tpu_torch.data.dataset import Dataset

__all__ = ["Dataset", "load_arff", "__version__"]
