"""The port's ops: the distance forms, the vote, the stripe kernel
(``cuda_knn``) and the tile kernel (``tile_knn``), with their build in
``_build``. Import the modules directly; this package imports nothing at
load time."""
