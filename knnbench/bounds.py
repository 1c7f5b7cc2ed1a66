"""The least time of a retrieval on one H100, from the problem's shapes.

A frozen copy of the port's ``stripe_bound_ms`` arithmetic (scan and merge
as one function), kept here so that a change to the program cannot move the
yardstick. It counts only the problem, never a kernel's plan: per (query,
train row) ``3 * d`` unfused FP32 instructions (sub, mul, add) and one key
compare; the train and the queries read once and the ``[Q, k]`` float32
distances and int32 indices written once.

Peaks: NVIDIA H100 SXM data sheet. Its 67 TFLOP/s FP32 outside the tensor
cores counts a fused multiply-add as two operations; the exact kernels are
built with ``--fmad=false`` and issue sub, mul and add as one instruction
each, so their instruction rate is half of it. HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

PEAK_FP32_INSTR = 67e12 / 2
PEAK_HBM_BYTES = 3.35e12


def retrieval_ops(q: int, n: int, d: int) -> int:
    """FP32 instructions of an exact retrieval of ``q`` queries over ``n``
    rows of width ``d``."""
    return q * n * (3 * d + 1)


def retrieval_bytes(q: int, n: int, d: int, k: int) -> int:
    """Bytes of the float32 inputs read once and the ``[q, k]`` answers
    (float32 distance and int32 index) written once."""
    return (n * d + q * d) * 4 + q * k * 8


def retrieval_bound_s(q: int, n: int, d: int, k: int) -> "tuple[float, str]":
    """The larger of the operations at the FP32 instruction rate and the
    bytes at the HBM rate, in seconds, and which of the two it is."""
    t_ops = retrieval_ops(q, n, d) / PEAK_FP32_INSTR
    t_bytes = retrieval_bytes(q, n, d, k) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
