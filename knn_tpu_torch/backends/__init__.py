"""Execution backends: one algorithm, pluggable execution strategies.

Registry keys, as in the JAX package:

- ``oracle`` — NumPy, the reference's serial kernel semantics on the host
  (the truth rung).
- ``cuda``   — the port's device rung: the exact stripe kernel on the card
  (``--device cpu`` runs its plain PyTorch version on the host instead).

The JAX package's other rungs (native, sharded, pallas) and its degradation
ladder are still to port (ROADMAP A7, A11).
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Register a backend predict fn under ``name``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_backend(name: str) -> Callable:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # Import for registration side effects.
    from knn_tpu_torch.backends import cuda as _cuda  # noqa: F401
    from knn_tpu_torch.backends import oracle as _oracle  # noqa: F401
