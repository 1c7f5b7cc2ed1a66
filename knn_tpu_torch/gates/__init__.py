"""The repo's gates, on the port: the counterparts of the JAX package's
``scripts/check_disabled_overhead.py`` (``disabled_overhead``),
``scripts/device_parity_sweep.py`` (``device_parity_sweep``),
``scripts/parity_report.py`` (``parity_report``) and
``scripts/capacity_probe.py`` (``capacity_probe``), and of
``scripts/procgroup.py`` (``procgroup``), which spawns the servers they
boot. Each gate runs with ``python -m knn_tpu_torch.gates.<name>``, on the
card unless given ``--device cpu``, and exits 0 when its invariants hold,
1 with a diagnosis otherwise."""
