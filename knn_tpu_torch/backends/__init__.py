"""Execution backends: one algorithm, pluggable execution strategies.

Registry keys, as in the JAX package:

- ``oracle`` — NumPy, the reference's serial kernel semantics on the host
  (the truth rung).
- ``cuda``   — the port's device rung, the twin of ``tpu``'s stripe route:
  the stripe kernel, and the tile kernel for the bf16 and wide fast forms
  (``--device cpu`` runs their plain PyTorch versions on the host instead).
- ``cuda-tile`` — the wide-feature rung, the twin of ``tpu-pallas``: the
  stripe route or the tile kernel's merge route, in every distance form.

The JAX package's other rungs (native, sharded) and its degradation ladder
are still to port (ROADMAP A7, A11).
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
    from knn_tpu_torch.backends import tile as _tile  # noqa: F401
