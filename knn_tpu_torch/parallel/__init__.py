"""Multi-device execution strategies over a mesh of ``torch.device``s (the
port of ``knn_tpu/parallel/``).

- ``query_sharded`` — data parallelism over test queries (the MPI
  analogue: ``MPI_Scatter`` of ranges + ``MPI_Gatherv`` of predictions,
  mpi.cpp:151-186): backend ``cuda-sharded``, ``--persona mpi``.
- ``train_sharded`` — train rows sharded across the mesh with a gathered
  top-k candidate merge: backend ``cuda-train-sharded``.
- ``ring``          — train shards rotating around the mesh with a running
  top-k (ring attention's structure): backend ``cuda-ring``.
- ``collectives``   — the only places where data crosses devices, each
  recording what it moved; ``comm_audit`` holds the record to the byte
  model.
- ``mesh``          — mesh construction (a tuple of devices; a device
  named N times is N logical shards).
- ``multihost``/``launch`` — the multi-process path on
  ``torch.distributed`` and its ``mpiexec``-like launcher.
"""
