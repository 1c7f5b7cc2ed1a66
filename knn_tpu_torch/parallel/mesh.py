"""Device meshes and multi-process initialization (the port of
``knn_tpu/parallel/mesh.py``).

JAX's mesh is a ``jax.sharding.Mesh`` over its devices. The port's is a
plain tuple of ``torch.device``s, one per shard, in shard order: the
engines (``query_sharded``, ``train_sharded``, ``ring``) place shard ``s``
on ``devices[s]`` and move data between shards only through
``parallel/collectives.py``.

A tuple may name one device more than once: N logical shards on one
device, the counterpart of JAX's virtual CPU devices
(``--xla_force_host_platform_device_count``). That is how the CPU tests
run the 8-shard meshes, and how one card runs 2 or 4 shards. The answer
does not depend on how many distinct devices the tuple names.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

Mesh = Tuple[torch.device, ...]


def maybe_init_distributed(device: Optional[str] = None) -> bool:
    """``MPI_Init`` when launched by ``parallel/launch.py`` (or torchrun):
    join the process group the environment describes, for ranks computing
    on ``device``. No-op (False) without such an environment, so
    single-process runs need no configuration."""
    from knn_tpu_torch.parallel.multihost import init_from_env

    return init_from_env(device)


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh of ``num_devices`` shards on ``device``.

    On ``cuda``: the first ``num_devices`` cards (default: every visible
    card), one shard each; asking for more than are visible raises JAX's
    ``ValueError``. On ``cpu``: ``num_devices`` logical shards (default 1)
    on the host. A missing card is a ``DeviceError``, never the host."""
    from knn_tpu_torch.ops.cuda_knn import resolve_device

    dev = resolve_device(device)
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if dev.type == "cpu":
        return (dev,) * (num_devices or 1)
    have = torch.cuda.device_count()
    n = num_devices or have
    if n > have:
        raise ValueError(f"requested {n} devices but only {have} available")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh_2d(q_devices: int, t_devices: int,
                 devices: Sequence[torch.device]) -> Tuple[Mesh, ...]:
    """2-D (query x train) grid over ``devices``: row ``i`` is query group
    ``i``, column ``j`` train shard ``j``; ``devices`` must hold at least
    ``q_devices * t_devices`` entries."""
    need = q_devices * t_devices
    if need > len(devices):
        raise ValueError(
            f"mesh {q_devices}x{t_devices} needs {need} devices, have "
            f"{len(devices)}")
    return tuple(tuple(devices[i * t_devices:(i + 1) * t_devices])
                 for i in range(q_devices))


def default_mesh_shape(n: int) -> Tuple[int, int]:
    """Factor ``n`` into (q, t) as close to square as possible, favoring the
    query (pure-DP) axis for any remainder."""
    t = int(np.floor(np.sqrt(n)))
    while t > 1 and n % t:
        t -= 1
    return n // t, t


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` names the current card: give it its index, so that two
    names of one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_mesh(devices: Optional[Sequence] = None,
                 num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The engines' mesh argument: an explicit ``devices`` tuple (each
    entry a ``torch.device`` or a name; repeats are logical shards), else
    :func:`make_mesh` of ``num_devices`` on ``device``."""
    if devices is not None:
        from knn_tpu_torch.ops.cuda_knn import resolve_device

        mesh = tuple(_indexed(resolve_device(d)) for d in devices)
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        return mesh
    return make_mesh(num_devices, device)
