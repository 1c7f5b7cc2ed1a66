"""Execution backends: one algorithm, pluggable execution strategies.

Registry keys, as in the JAX package:

- ``oracle``    — NumPy, the reference's serial kernel semantics on the
  host (the truth rung).
- ``native``    — the C++ serial kernel (``native/runtime``), the
  reference's ``make main``, on the host.
- ``native-mt`` — the same kernel on a thread pool, ``make multi-thread``.
- ``cuda``      — the port's device rung, the twin of ``tpu``: the stripe
  kernel, the tile kernel for the other forms and widths, or the XLA
  route's torch ops (``--device cpu`` runs their plain PyTorch versions on
  the host instead).
- ``cuda-tile`` — the wide-feature rung, the twin of ``tpu-pallas``: the
  stripe route or the tile kernel's merge route, in every distance form.
- ``cuda-sharded``, ``cuda-train-sharded``, ``cuda-ring`` — the mesh rungs,
  twins of ``tpu-sharded``, ``tpu-train-sharded`` and ``tpu-ring``
  (``knn_tpu_torch/parallel/``): the same kernels per shard, the shards'
  answers moved between devices by ``parallel/collectives.py``.

``native``/``native-mt`` are registered only when their library loads
(built with ``g++`` when one of them is first asked for, or when
:func:`available_backends` lists every backend; the card rungs never wait
on that build). Every registered fn is wrapped by
``obs.instrument.observed_backend`` (a ``predict`` span and the
per-backend metrics, no-ops while obs is off); the module-level fns stay
unwrapped. ``resilience/degrade.py`` walks these rungs; a card rung
(``cuda``, ``cuda-tile``) has no fallback, and a sharded rung falls to
``cuda``.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Register a backend predict fn under ``name``, wrapped with the
    observability layer. The module-level fn stays unwrapped, so direct
    imports see the raw strategy."""

    def deco(fn):
        from knn_tpu_torch.obs.instrument import observed_backend

        _REGISTRY[name] = observed_backend(name, fn)
        return fn

    return deco


_NATIVE = ("native", "native-mt")


def get_backend(name: str) -> Callable:
    _ensure_loaded(name)
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def is_available(name: str) -> bool:
    """Whether backend ``name`` is registered; builds the native library
    only when ``name`` is a native rung."""
    _ensure_loaded(name)
    return name in _REGISTRY


def available_backends():
    """Every registered backend (this builds the native library)."""
    _ensure_loaded(*_NATIVE)
    return sorted(_REGISTRY)


_LOADED = False
_NATIVE_TRIED = False


def _ensure_loaded(*names: str):
    """Register the backends, and the native rungs when ``names`` asks for
    one of them: they are registered only if their library loads."""
    global _LOADED, _NATIVE_TRIED
    if not _LOADED:
        # Import for registration side effects.
        from knn_tpu_torch.backends import cuda as _cuda  # noqa: F401
        from knn_tpu_torch.backends import oracle as _oracle  # noqa: F401
        from knn_tpu_torch.backends import tile as _tile  # noqa: F401
        from knn_tpu_torch.parallel import query_sharded as _q  # noqa: F401
        from knn_tpu_torch.parallel import ring as _ring  # noqa: F401
        from knn_tpu_torch.parallel import train_sharded as _t  # noqa: F401

        _LOADED = True
    if _NATIVE_TRIED or not set(names) & set(_NATIVE):
        return
    from knn_tpu_torch.backends import native as _native

    try:
        _native.library()
    except OSError:  # no C++ compiler: the native rungs are unavailable
        for name in _NATIVE:
            _REGISTRY.pop(name, None)
    # Set last: a failed native build (NativeBuildError) raises again on
    # the next call instead of leaving a partial registry behind.
    _NATIVE_TRIED = True
