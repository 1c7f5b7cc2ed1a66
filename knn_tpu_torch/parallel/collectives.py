"""The copies between shards: the collectives XLA inserts under
``shard_map``, written out.

In the JAX package the sharded engines are ``shard_map`` programs, and XLA
emits their collectives (``all_gather``, ``collective_permute``) over ICI
from the sharding layout. The port's engines run each shard's body as
torch ops and kernels on its own device, and every byte that crosses from
one shard to another goes through one of the functions here:

- :func:`all_gather_to` — every shard's ``[q_local, k]`` candidates to the
  lead device of its query group, concatenated along the candidate axis in
  shard order (JAX's ``all_gather(..., axis=1, tiled=True)``);
- :func:`ppermute_ring` — one shard's block to the next device of the ring
  (``lax.ppermute`` with the ring permutation);
- :func:`gather_predictions` — the query groups' ``[q_local]`` predictions
  to the lead device (the out_spec: ``MPI_Gatherv``);
- :func:`scatter_rows` — the padded query block's slices to their shards
  (the in_spec: ``MPI_Scatter``);
- :func:`all_gather_processes` — one equal-shaped block from every process
  of the launcher's ``torch.distributed`` group, in rank order.

Each copy is ``Tensor.to(dev, non_blocking=True)`` on a side stream of the
receiving card, which first waits on an event recorded on the producing
card's stream; the receiving card's current stream then waits on the side
stream, so no consumer reads a block before it has landed. A shard on the
same device as its destination (logical shards on one card, or the CPU)
makes no copy, but its bytes are recorded all the same: the audit
(``parallel/comm_audit.py``) then holds at N logical shards exactly as at
N cards.

Every call appends one :class:`CollectiveOp` per tensor to each open
:func:`recording` (thread-local), which the engines read for their
``knn_collective_bytes_total`` and the audit compares with the byte model.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, NamedTuple, Sequence, Tuple

import torch

_DTYPE_NAMES = {
    torch.float32: "f32", torch.int32: "i32", torch.int64: "i64",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.uint8: "ui8",
    torch.bool: "i1",
}

#: The ops of a sharded body: those JAX's lowering shows as collectives
#: (the scatter and gather are its in/out specs).
BODY_OPS = ("all_gather", "collective_permute")


class CollectiveOp(NamedTuple):
    """One tensor moved by one collective: ``shard`` is the receiving query
    group (``all_gather``, ``gather``), the sending shard
    (``collective_permute``) or the receiving shard (``scatter``);
    ``step`` the ring step (0 elsewhere); ``shape`` the tensor as one
    device holds it after the op."""

    op: str
    shard: int
    step: int
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int


_local = threading.local()


@contextlib.contextmanager
def recording():
    """Collect the :class:`CollectiveOp` of every collective this thread
    runs inside the block into the list it yields (nested recordings each
    see every op)."""
    log: List[CollectiveOp] = []
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(log)
    try:
        yield log
    finally:
        # By identity: two recordings of the same ops compare equal.
        stack[:] = [other for other in stack if other is not log]


def _note(op: str, shard: int, t: torch.Tensor, step: int = 0) -> None:
    entry = CollectiveOp(op, int(shard), int(step), tuple(t.shape),
                         _DTYPE_NAMES.get(t.dtype, str(t.dtype)),
                         t.numel() * t.element_size())
    for log in getattr(_local, "stack", ()):
        log.append(entry)


_side_streams: dict = {}


def _side_stream(dev: torch.device):
    stream = _side_streams.get(dev.index)
    if stream is None:
        stream = _side_streams[dev.index] = torch.cuda.Stream(dev)
    return stream


def _move(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself when it is there already, else a copy made
    as the module docstring says."""
    if t.device == dev:
        return t
    if dev.type != "cuda":
        return t.to(dev)
    stream = _side_stream(dev)
    if t.device.type == "cuda":
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(t.device))
        stream.wait_event(produced)
    with torch.cuda.stream(stream):
        out = t.to(dev, non_blocking=True)
    if t.device.type == "cuda":
        t.record_stream(stream)
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_stream(stream)
    out.record_stream(consumer)
    return out


def all_gather_to(parts: Sequence[torch.Tensor], dev: torch.device,
                  group: int = 0) -> torch.Tensor:
    """``[q_local, k_s]`` blocks, one per train shard in shard order ->
    their concatenation ``[q_local, sum k_s]`` on ``dev``."""
    out = torch.cat([_move(p, dev) for p in parts], dim=1)
    _note("all_gather", group, out)
    return out


def ppermute_ring(block: Sequence[torch.Tensor], dev: torch.device,
                  shard: int, step: int) -> Tuple[torch.Tensor, ...]:
    """One ring hop: shard ``shard``'s ``block`` (its train rows and
    labels) to ``dev``, the next device of the ring, at step ``step``."""
    out = tuple(_move(t, dev) for t in block)
    for t in out:
        _note("collective_permute", shard, t, step)
    return out


def gather_predictions(parts: Sequence[torch.Tensor],
                       dev: torch.device) -> torch.Tensor:
    """The query groups' ``[q_local]`` predictions -> ``[sum q_local]`` on
    ``dev``."""
    out = torch.cat([_move(p, dev) for p in parts])
    _note("gather", 0, out)
    return out


def scatter_rows(x: torch.Tensor, devices: Sequence[torch.device],
                 rows: int) -> List[torch.Tensor]:
    """``x``'s consecutive blocks of ``rows`` rows, block ``s`` on
    ``devices[s]`` (``x`` holds ``len(devices) * rows`` rows)."""
    out = []
    for s, dev in enumerate(devices):
        block = _move(x[s * rows:(s + 1) * rows], dev)
        _note("scatter", s, block)
        out.append(block)
    return out


def all_gather_processes(t: torch.Tensor) -> torch.Tensor:
    """``[rows, ...]`` on every rank -> ``[world * rows, ...]`` in rank order
    on every rank, through the default process group. On NCCL the blocks
    stay on the card; on gloo they cross through host memory (as
    ``MPI_Gatherv`` does in mpi.cpp), while the compute stays where it
    ran. The result is on ``t``'s device either way."""
    import torch.distributed as dist

    host = dist.get_backend() != "nccl"
    src = t.cpu() if host else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src.contiguous())
    out = torch.cat(parts)
    _note("all_gather", 0, out)
    return out.to(t.device) if host else out
