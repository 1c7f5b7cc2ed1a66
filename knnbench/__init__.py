"""The benchmark of ``knn_tpu_torch`` on one NVIDIA H100.

``python3 -m knnbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. A cell
names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); each metric is read by ``metrics/<name>.py``.
Nothing here imports ``jax`` or the JAX package ``knn_tpu``.
"""
