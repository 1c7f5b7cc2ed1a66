"""Graceful backend degradation: the port's ladder (the port of
``knn_tpu/resilience/degrade.py``).

The JAX package walks ``tpu → tpu-pallas → native → oracle``. On the card
that walk would answer a failing kernel, or a missing GPU, from another
route or from the host: a fault hidden behind a slower right answer. So
the port's ladder stops at the card:

    cuda: ()          cuda-tile: ()
    cuda-sharded → cuda    cuda-train-sharded → cuda    cuda-ring → cuda
    native-mt → native → oracle

Every move whose two ends are both on the host is kept (``native-mt`` to
``native`` to ``oracle``; parser to parser in ``data/arff.py``). On a card
rung only two recoveries remain, and both rerun the same rung and the same
kernels:

- transient faults are retried in place (:mod:`.retry`, inside the
  backend call sites);
- ``DeviceError(oom=True)`` on ``cuda`` (the rung that takes
  ``query_batch``) halves ``query_batch``, releases the caching
  allocator's blocks (``torch.cuda.empty_cache()``) and reruns the rung.

A sharded rung (``cuda-sharded``, ``cuda-train-sharded``, ``cuda-ring``)
that fails for good moves to ``cuda``: the same kernels over the whole
train on one card, counted and warned as any move, with ``num_devices``
and the mesh options dropped (JAX moves them to ``tpu``, then on down to
the host; the port's walk ends at ``cuda``). Any other typed failure on
``cuda`` or ``cuda-tile`` raises. On a host rung it moves down the ladder, warning on stderr and counting
``knn_fallback_total{from_backend,to,reason}``; a host rung that rejects
the *options* (``--metric cosine`` on the native kernel) is skipped the
same way, but only as a fallback rung — the user's chosen backend reports
its own option errors verbatim.

``no_fallback=True`` (the CLI's ``--no-fallback``) disables ladder moves
AND batch-halving: the first typed failure propagates.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Tuple

from knn_tpu_torch import obs
from knn_tpu_torch.resilience.errors import DataError, DeviceError, ResilienceError

#: The OVERLOAD degradation order the JAX control plane enforces past a
#: replica's knee (scale, then shed low priority, then brownout, then the
#: queue-full backstop). Shared as data; the serving front end reports it
#: on ``/debug/control`` while no controller runs (ROADMAP A12).
DEGRADATION_ORDER: Tuple[str, ...] = (
    "scale", "shed_low_priority", "brownout_quality", "availability")

#: backend -> fallback rungs, most-capable first. The card rungs have none.
LADDER: Dict[str, Tuple[str, ...]] = {
    "cuda-sharded": ("cuda",),
    "cuda-train-sharded": ("cuda",),
    "cuda-ring": ("cuda",),
    "cuda": (),
    "cuda-tile": (),
    "native-mt": ("native", "oracle"),
    "native": ("oracle",),
    "oracle": (),
}

_SHARDED = ("cuda-sharded", "cuda-train-sharded", "cuda-ring")

#: options meaningful only to specific rungs — stripped when degrading so
#: a fallback rung isn't rejected over a knob it never had.
_RUNG_ONLY_OPTS = {
    "device": ("cuda", "cuda-tile", *_SHARDED),
    "approx": ("cuda",),
    "recall_target": ("cuda",),
    "query_batch": ("cuda",),
    "num_threads": ("native-mt",),
    "num_devices": _SHARDED,
    "devices": _SHARDED,
    "mesh_shape": ("cuda-train-sharded",),
}


def fallback_for(backend: str, available) -> Optional[str]:
    """First ladder rung for ``backend`` present in ``available`` — the
    static unavailable-backend substitution (CLI startup)."""
    for rung in LADDER.get(backend, ()):
        if rung in available:
            return rung
    return None


def known_backend(backend: str) -> bool:
    """Whether ``backend`` is a name the ladder knows (a real backend that
    may merely be unavailable on this install, as opposed to a typo)."""
    return backend in LADDER


def opts_for_rung(rung: str, origin: str, opts: dict) -> dict:
    """Sanitize ``opts`` for a fallback ``rung``: drop knobs owned by other
    rungs and map the ring-only engine names to ``auto``. The origin rung
    (``rung == origin``) keeps its opts verbatim."""
    if rung == origin:
        return dict(opts)
    out = {
        name: value
        for name, value in opts.items()
        if rung in _RUNG_ONLY_OPTS.get(name, (rung,))
    }
    if out.get("engine") in ("full", "tiled") and rung != "cuda-ring":
        out["engine"] = "auto"  # the ring's own per-step scorers
    return out


def _default_warn(msg: str) -> None:
    print(f"warning: {msg}", file=sys.stderr)


def _record_fallback(frm: str, to: str, reason: str) -> None:
    obs.counter_add(
        "knn_fallback_total",
        help="degradation-ladder moves (backend -> fallback backend)",
        from_backend=frm, to=to, reason=reason,
    )
    # Also lands in any active request contexts (a laddered predict run
    # inside a traced serving dispatch); one predicate otherwise.
    from knn_tpu_torch.obs import reqtrace

    reqtrace.emit("fallback", from_backend=frm, to=to, reason=reason)


def _release_cached_blocks() -> None:
    """Hand the blocks of the failed attempt back to the card before the
    halved rerun, or the caching allocator keeps them."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class LadderResult:
    """Outcome of a laddered predict: the predictions plus where (and with
    what options) they were actually computed — so a caller timing repeat
    runs can start from the surviving rung instead of re-walking failures."""

    __slots__ = ("predictions", "backend", "opts", "degraded")

    def __init__(self, predictions, backend: str, opts: dict, degraded: bool):
        self.predictions = predictions
        self.backend = backend
        self.opts = opts
        self.degraded = degraded


def predict_with_ladder(
    backend: str,
    train,
    test,
    k: int,
    opts: Optional[dict] = None,
    *,
    no_fallback: bool = False,
    warn: Optional[Callable[[str], None]] = None,
) -> LadderResult:
    """Classify through ``backend``, degrading down the ladder on typed
    failures. Returns a :class:`LadderResult`; raises the last typed error
    when every rung fails (or the first one under ``no_fallback``, or on a
    card rung)."""
    from knn_tpu_torch.backends import get_backend, is_available

    if opts is None:
        opts = {}
    if warn is None:
        warn = _default_warn
    rungs = [backend] + [r for r in LADDER.get(backend, ()) if is_available(r)]
    if not is_available(backend):
        rungs = rungs[1:]
        if not rungs:
            raise DeviceError(f"backend '{backend}' unavailable and no "
                              f"fallback rung is registered", transient=False)
    last_err: Optional[Exception] = None
    degraded = False
    for pos, rung in enumerate(rungs):
        rung_opts = opts_for_rung(rung, backend, opts)
        while True:  # OOM batch-halving loop (same rung, smaller batches)
            try:
                fn = get_backend(rung)
                preds = fn(train, test, k, **rung_opts)
                return LadderResult(preds, rung, rung_opts, degraded)
            except DeviceError as e:
                batch = rung_opts.get("query_batch") or test.num_instances
                if e.oom and not no_fallback and rung == "cuda" and batch > 1:
                    rung_opts = dict(rung_opts, query_batch=max(1, batch // 2))
                    warn(
                        f"backend '{rung}' out of memory; retrying with "
                        f"query_batch={rung_opts['query_batch']}"
                    )
                    _record_fallback(rung, rung, "oom_halve_batch")
                    _release_cached_blocks()
                    degraded = True
                    continue
                last_err = e
            except DataError:
                # Bad input is bad input on every rung: switching backends
                # cannot fix it, so don't walk the ladder pretending it might.
                raise
            except ResilienceError as e:
                last_err = e
            except ValueError as e:
                # Option/validation rejection. On the user's chosen rung
                # this is their error to see; on a fallback rung it means
                # "this rung can't serve these opts" — skip it.
                if pos == 0:
                    raise
                last_err = e
            break
        if no_fallback:
            raise last_err
        nxt = rungs[pos + 1] if pos + 1 < len(rungs) else None
        if nxt is not None:
            warn(
                f"backend '{rung}' failed "
                f"({type(last_err).__name__}: {last_err}); "
                f"falling back to '{nxt}'"
            )
            _record_fallback(rung, nxt, type(last_err).__name__)
            degraded = True
    assert last_err is not None
    raise last_err
