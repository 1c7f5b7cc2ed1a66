"""The port's ops: the exact distance, the vote, and the stripe kernel
(``cuda_knn``, with its build in ``_build``). Import the modules directly;
this package imports nothing at load time."""
