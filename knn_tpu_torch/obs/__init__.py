"""The port's measurement helpers (``bench_timing``)."""
