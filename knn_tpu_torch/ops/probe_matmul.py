"""The bf16 cross-term floor on the card: P1's kernel wrapper and its plain
version.

The port of ``scripts/probe_mnist_r3.py``'s ``_matmul_kernel`` and
``pure_matmul``: the bare bf16 product of the queries and the train rows,
which that probe times as the floor under the tile kernels. Its function:
``out[q, s]`` sums ``q . t_r`` over the train rows ``r`` with
``(r mod block_n) div (block_n / 8) == s``, each product of two bfloat16
operands, accumulated in float32. Rows past N count as zero rows (the probe
pads N to a multiple of ``block_n``). The fold keeps the output at
``[Q, 8]`` so the product cannot be dropped.

:func:`pure_matmul` is the wrapper (``pure_matmul.launches`` counts its
launches) of ``csrc/probe_matmul.cu``, ``wgmma`` fed by TMA over the
mainloop of ``csrc/wgmma_tile.cuh`` that the tile kernel's bf16 form shares;
:func:`pure_matmul_reference` its plain version. The kernel reads the
operands' ``tile_knn.bf16_operand`` copies, zero-padded to a multiple of 64
features (the train's kept with the train tensor).
"""

from __future__ import annotations

import ctypes

import torch

from knn_tpu_torch.ops import _build, cuda_knn
from knn_tpu_torch.ops.tile_knn import bf16_operand
from knn_tpu_torch.resilience.errors import DeviceError

SLOTS = 8

# Must match csrc/wgmma_tile.cuh: queries per block, train rows per tile.
_TILE_Q = 128
_TILE_N = 128
# Blocks to aim for per SM: one wave (288 threads and ~129 KB of shared
# memory each, one resident block per SM).
_BLOCKS_PER_SM = 1


def pure_matmul_reference(train: torch.Tensor, test: torch.Tensor,
                          block_n: int) -> torch.Tensor:
    """The plain version: ``(q.float() @ t.float().T)`` over the
    bfloat16-rounded operands (TF32 off on the card), zero columns up to a
    multiple of ``block_n``, each block's columns summed per slot, then the
    blocks summed: ``[Q, 8]`` float32."""
    _check_block_n(block_n)
    n, q = train.shape[0], test.shape[0]
    if test.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    cross = (test.to(torch.bfloat16).float()
             @ train.to(torch.bfloat16).float().T)
    n_pad = -(-n // block_n) * block_n
    cross = torch.nn.functional.pad(cross, (0, n_pad - n))
    return cross.reshape(q, n_pad // block_n, SLOTS, block_n // SLOTS
                         ).sum(dim=3).sum(dim=1)


def _check_block_n(block_n: int) -> None:
    if block_n < SLOTS or block_n % SLOTS:
        raise ValueError(f"block_n={block_n} must be a positive multiple of "
                         f"{SLOTS}")


_p, _i = ctypes.c_void_p, ctypes.c_int
# The C entry of csrc/probe_matmul.cu; pointers and the stream are 64-bit.
_SIGNATURES = {
    "probe_matmul_fold": ([_p, _i, _p, _i, _i, _i, _i, _i, _p, _p], _i),
}


def pure_matmul(train: torch.Tensor, test: torch.Tensor,
                block_n: int) -> torch.Tensor:
    """``[N, D]`` train and ``[Q, D]`` queries -> ``[Q, 8]`` float32 folded
    products, as :func:`pure_matmul_reference` gives them.

    CPU tensors take the plain version. CUDA tensors (bfloat16, contiguous,
    on one card) launch the kernel on the current stream, or raise.
    ``pure_matmul.launches`` counts the launches."""
    block_n = int(block_n)
    if train.device.type == "cpu" and test.device.type == "cpu":
        return pure_matmul_reference(train, test, block_n)
    _check_block_n(block_n)
    for name, t in (("train", train), ("test", test)):
        if t.device.type != "cuda" or t.device != train.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs both "
                             f"inputs on one CUDA device (train is on "
                             f"{train.device})")
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D bfloat16 tensor, "
                             f"got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
    (n, d), q = train.shape, test.shape[0]
    if test.shape[1] != d or min(n, q, d) < 1 or n >= 2**31 - _TILE_N:
        raise ValueError(f"train {tuple(train.shape)} and test "
                         f"{tuple(test.shape)} must be non-empty with equal "
                         "feature counts")
    fn = _build.load_library("probe_matmul", _SIGNATURES).probe_matmul_fold
    dev = train.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, rows_per_split = cuda_knn.split_plan(
        n, q, sm_count, tile_rows=_TILE_N, blocks_per_sm=_BLOCKS_PER_SM,
        queries_per_block=_TILE_Q)
    tb, qb = bf16_operand(train, cache=True), bf16_operand(test)
    out = torch.zeros((q, SLOTS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(tb.data_ptr(), n, qb.data_ptr(), q, tb.shape[1], block_n,
                n_splits, rows_per_split // _TILE_N, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise DeviceError(f"probe_matmul_fold launch failed: CUDA error {rc}")
    pure_matmul.launches += 1
    return out


pure_matmul.launches = 0
