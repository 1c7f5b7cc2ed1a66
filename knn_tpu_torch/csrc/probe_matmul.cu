// The bf16 cross-term floor for Hopper (sm_90a): per query, the products
// q . t over every train row, folded into 8 slots.
//
// Replaces scripts/probe_mnist_r3.py::_matmul_kernel (via pure_matmul): a
// bare bf16 matmul the TPU probe times as the floor under the tile kernels.
// Its function: out[q][s] = sum over train rows r with
// (r mod block_n) div (block_n / 8) == s of sum_f q[f] * t[r][f], the
// products of bfloat16 operands accumulated in float32. Rows past N count as
// zero rows, as the probe's padding to a multiple of block_n does.
//
// Design. The mainloop of wgmma_tile.cuh: a block of two consumer
// warpgroups and a producer warp owns 128 queries and one contiguous split
// of the train rows (gridDim.y splits of whole 128-row tiles); TMA stages
// 64-feature chunks of the queries and of each tile's rows in a ring of 4
// shared-memory stages (128 KB: one block per SM), and each warpgroup
// accumulates its 64 queries x 128 rows with wgmma. The operands are
// bfloat16 copies zero-padded to a multiple of 64 features (a zero feature
// adds exactly 0), and rows past N come from TMA's zero fill, so they add
// 0. The fold epilogue runs on the accumulator fragment: a thread holds two
// query rows and 32 columns of the tile; when a whole tile lies in one slot
// (block_n a multiple of 1,024, so a slot spans whole 128-row tiles) it sums
// its 32 columns and adds them to that slot, else each column goes to its
// own slot. At the end the four threads that share a query row (a quad)
// add their slot sums with two shuffles, and one of them adds the query's 8
// sums to the output with atomicAdd, so across splits the float32 sum order
// varies from run to run.
//
// Bound on this card: operations. 2*Q*N*D flops at the dense bf16
// tensor-core rate, 989 TFLOP/s; the bytes (bfloat16 train and queries read
// once) are far below it at D = 784. A block re-reads its queries' chunk
// from L2 for every tile, and each tile's rows once per 128-query block.
//
// Left for later: a tile wider than 128 rows (m64n256 per warpgroup) and
// query blocks resident across tiles, to cut the re-reads from L2.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tile.cuh"

namespace probe_matmul {

constexpr int kSlots = 8;
constexpr size_t kSmemBytes = wgmma_tile::kRingSmemBytes;

__device__ __forceinline__ void add_to_slot(float (&sums)[kSlots], int slot,
                                            float v) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) sums[s] += s == slot ? v : 0.0f;
}

__global__ void __launch_bounds__(wgmma_tile::kThreads, 1)
matmul_fold_kernel(const __grid_constant__ CUtensorMap t_map, int n,
                   const __grid_constant__ CUtensorMap q_map, int n_queries,
                   int d_pad, int block_n, int tiles_per_split,
                   float* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const wgmma_tile::Ring ring = wgmma_tile::make_ring(smem_raw);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * wgmma_tile::kTileM;
  const int tiles = (n + wgmma_tile::kTileN - 1) / wgmma_tile::kTileN;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int n_tiles = max(0, min(tile_begin + tiles_per_split, tiles) - tile_begin);
  const int n_chunks = d_pad / wgmma_tile::kChunk;
  if (tid >= wgmma_tile::kConsumerThreads) {
    if (tid == wgmma_tile::kConsumerThreads) {
      wgmma_tile::produce(ring, &q_map, &t_map, q0,
                          tile_begin * wgmma_tile::kTileN, n_tiles, n_chunks);
    }
    return;
  }

  // This thread's accumulator rows (queries) qr and qr + 8; its columns
  // (train rows of the tile) 8j + 2(lane % 4) + h.
  const int wg = tid / 128, lane = tid % 32;
  const int qr = wg * wgmma_tile::kWgRows + ((tid % 128) / 32) * 16 + lane / 4;
  const int width = block_n / kSlots;
  const bool whole_tiles = block_n % (kSlots * wgmma_tile::kTileN) == 0;
  float sums[2][kSlots] = {};
  wgmma_tile::Consumer consumer;
  float acc[64] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int r0 = (tile_begin + i) * wgmma_tile::kTileN;
    consumer.tile(ring, acc, wg, n_chunks);
    if (whole_tiles) {
      float run[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 64; ++j) run[(j >> 1) & 1] += acc[j];
      const int s = (r0 % block_n) / width;
      add_to_slot(sums[0], s, run[0]);
      add_to_slot(sums[1], s, run[1]);
    } else {
#pragma unroll
      for (int j = 0; j < wgmma_tile::kTileN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = ((r0 + 8 * j + 2 * (lane % 4) + h) % block_n) / width;
          add_to_slot(sums[0], s, acc[4 * j + h]);
          add_to_slot(sums[1], s, acc[4 * j + 2 + h]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      sums[r][s] += __shfl_xor_sync(0xffffffffu, sums[r][s], 1);
      sums[r][s] += __shfl_xor_sync(0xffffffffu, sums[r][s], 2);
    }
    const int q = q0 + qr + 8 * r;
    if (lane % 4 == 0 && q < n_queries && n_tiles > 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) atomicAdd(out + size_t(q) * kSlots + s, sums[r][s]);
    }
  }
}

}  // namespace probe_matmul

// Add the folded products of `test` [n_queries, d_pad] and `train`
// [n, d_pad] (bfloat16, row-major, d_pad a multiple of 64, zero past the
// true features, 16-byte aligned) to `out` [n_queries, 8] float32, which
// the caller zeroes, on `stream`; returns the CUDA status (0 = launched).
// The caller validates shapes (n_queries, n >= 1; block_n a positive
// multiple of 8; n_splits * tiles_per_split >= ceil(n / 128)).
extern "C" int probe_matmul_fold(const void* train, int n, const void* test,
                                 int n_queries, int d_pad, int block_n,
                                 int n_splits, int tiles_per_split, void* out,
                                 void* stream) {
  using namespace probe_matmul;
  CUtensorMap t_map, q_map;
  cudaError_t err = wgmma_tile::encode_operand(&t_map, train, n, d_pad);
  if (err != cudaSuccess) return int(err);
  err = wgmma_tile::encode_operand(&q_map, test, n_queries, d_pad);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(matmul_fold_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n_queries + wgmma_tile::kTileM - 1) / wgmma_tile::kTileM,
                  n_splits);
  matmul_fold_kernel<<<grid, wgmma_tile::kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      t_map, n, q_map, n_queries, d_pad, block_n, tiles_per_split,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}
