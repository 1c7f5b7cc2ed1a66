"""Replica sets and fault-tolerant routing, on the port (the port of
``knn_tpu/fleet/``; docs/SERVING.md §Running a replica set).

Three layers, each importable on its own, all host code:

- :mod:`knn_tpu_torch.fleet.replica` — the replica-side role: a PRIMARY
  fans every acknowledged WAL record out to its followers
  (``WALShipper``, one ordered cursor per follower, semi-synchronous
  ack), a FOLLOWER applies shipped records through the exact
  local-mutation validation path — on its batcher's worker thread, the
  one thread that touches the card — and can be promoted in place;
- :mod:`knn_tpu_torch.fleet.bootstrap` — the chunked, digest-verified
  snapshot transfer a blank or diverged follower re-seeds from;
- :mod:`knn_tpu_torch.fleet.health` — the router's view of N replicas:
  active ``/healthz`` polling plus passive demotion on connection errors;
- :mod:`knn_tpu_torch.fleet.router` — the thin HTTP front-end
  (``python -m knn_tpu_torch route``): reads routed to healthy replicas
  with cross-replica retry and optional tail hedging, writes routed to
  the one primary, coordinated reload (all-or-nothing), serialized
  compaction, optional auto-failover, re-seed and autoscaling. The router
  loads no model and no kernel library: its process never creates a CUDA
  context.

The wire, the WAL records, the snapshot files and every status and JSON
body are the JAX package's, so a port follower follows a JAX primary and
either package's router fronts the other's replicas.

Everything here is OPT-IN: a plain ``serve`` (no ``--follower-of``, no
``--replicate-to``) never imports this package
(tests/test_torch_isolation.py pins it).
"""
