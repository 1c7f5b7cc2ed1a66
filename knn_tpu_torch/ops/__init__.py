"""The port's ops: the distance forms, the vote, the stripe kernel
(``cuda_knn``), the tile kernel (``tile_knn``) and the matmul probe kernel
(``probe_matmul``), with their build in ``_build``. Import the modules directly; this package imports nothing at
load time."""
