"""Diagnostic entry points of the port: the counterparts of the JAX
package's ``scripts/tune_stripe_selection.py`` (``tune_stripe_selection``)
and ``scripts/probe_mnist_r3.py`` (``probe_mnist_r3``), and the data they
read (``data``). Each runs with ``python -m knn_tpu_torch.probes.<name>``,
on the card unless given ``--device cpu``."""
