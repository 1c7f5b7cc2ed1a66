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
// Design. The port's first tensor-core kernel: warp-level MMA through
// nvcuda::wmma bf16 fragments (16x16x16, float accumulators). A block of 4
// warps owns 64 queries and one contiguous split of the train rows
// (gridDim.y splits of whole 64-row tiles). For each tile it loops over the
// features in chunks of 32, staging the chunk of the 64 queries and the 64
// rows in shared memory as bfloat16, zero past D and past the last row (a
// zero operand adds exactly 0); each warp accumulates a 32x32 quadrant of
// the tile's products in 2x2 fragments. The tile's 64x64 products then go
// through shared memory (the accumulator layout is opaque), and each thread
// folds 32 of a query's products into its 8 slot sums in registers: one run
// sum when the 32 rows share a slot (every tile, at block_n >= 256), else
// row by row. At the end each thread adds its slot sums to the output with
// atomicAdd, so across splits the float32 sum order varies from run to run.
//
// Bound on this card: operations. 2*Q*N*D flops at the dense bf16
// tensor-core rate, 989 TFLOP/s; the bytes (bfloat16 train and queries read
// once) are far below it at D = 784. The train rows of a split are re-read
// once per 64-query block (from L2 when the blocks of a split run together).
//
// Left for later (ROADMAP B1e): wgmma from shared memory over 64-row
// warpgroup tiles, TMA loads into a ring of stages with mbarriers, and larger
// query tiles to cut the train re-reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace probe_matmul {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps
constexpr int kTileQ = 64;     // queries per block
constexpr int kTileN = 64;     // train rows per tile
constexpr int kChunk = 32;     // features staged per step: two k16 steps
constexpr int kSlots = 8;
// Pitches: a bf16 row of 40 (80 bytes: 16-byte aligned rows, and a multiple
// of 8 elements as wmma needs), a float row of 68 (a multiple of 4).
constexpr int kLd = kChunk + 8;
constexpr int kProdLd = kTileN + 4;

using Bf16 = __nv_bfloat16;

// dst[r * kLd + f] = src[row0 + r][f0 + f] for row0 + r < rows and
// f0 + f < d, else 0. With `vec` (d a multiple of 8, 16-byte aligned rows)
// each thread copies whole 16-byte runs of 8 features.
__device__ __forceinline__ void stage(Bf16* __restrict__ dst,
                                      const Bf16* __restrict__ src, int row0,
                                      int rows, int d, int f0, bool vec) {
  if (vec) {
    for (int c = threadIdx.x; c < kTileN * (kChunk / 8); c += kThreads) {
      const int r = c / (kChunk / 8);
      const int f = (c % (kChunk / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < rows && f0 + f < d) {
        v = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * d + f0 + f);
      }
      *reinterpret_cast<uint4*>(dst + r * kLd + f) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kTileN * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int f = e % kChunk;
      dst[r * kLd + f] = row0 + r < rows && f0 + f < d
                             ? src[size_t(row0 + r) * d + f0 + f]
                             : __float2bfloat16_rn(0.0f);
    }
  }
}

__device__ __forceinline__ void add_to_slot(float (&sums)[kSlots], int slot,
                                            float v) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) sums[s] += s == slot ? v : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
matmul_fold_kernel(const Bf16* __restrict__ train, int n,
                   const Bf16* __restrict__ test, int n_queries, int d,
                   int block_n, int tiles_per_split, int vec,
                   float* __restrict__ out) {
  __shared__ __align__(32) Bf16 q_s[kTileQ * kLd];
  __shared__ __align__(32) Bf16 t_s[kTileN * kLd];
  __shared__ __align__(32) float prod_s[kTileQ * kProdLd];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wq = (warp / 2) * 32;  // the warp's quadrant: queries
  const int wn = (warp % 2) * 32;  // and train rows
  const int q0 = blockIdx.x * kTileQ;
  const int tiles = (n + kTileN - 1) / kTileN;
  const int tile_end = min((blockIdx.y + 1) * tiles_per_split, tiles);
  const int fold_q = tid / 2;         // the query row this thread folds
  const int fold_c = (tid % 2) * 32;  // and its first of 32 columns
  const int width = block_n / kSlots;
  float sums[kSlots] = {};

  for (int tile = blockIdx.y * tiles_per_split; tile < tile_end; ++tile) {
    const int r0 = tile * kTileN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    }
    for (int f0 = 0; f0 < d; f0 += kChunk) {
      __syncthreads();  // the previous chunk (and tile's fold) is consumed
      stage(q_s, test, q0, n_queries, d, f0, vec);
      stage(t_s, train, r0, n, d, f0, vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16, wmma::row_major> a[2];
        // B = t^T: element (f, r) at t_s[r * kLd + f], column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(a[i], q_s + (wq + 16 * i) * kLd + kk, kLd);
          wmma::load_matrix_sync(b[i], t_s + (wn + 16 * i) * kLd + kk, kLd);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(prod_s + (wq + 16 * i) * kProdLd + wn + 16 * j,
                                acc[i][j], kProdLd, wmma::mem_row_major);
      }
    }
    __syncthreads();
    const float* row = prod_s + fold_q * kProdLd + fold_c;
    const int p0 = (r0 + fold_c) % block_n;  // position in the block_n tile
    if (p0 / width == (p0 + 31) / width) {
      float run = 0.0f;
#pragma unroll
      for (int c = 0; c < 32; ++c) run += row[c];
      add_to_slot(sums, p0 / width, run);
    } else {
      for (int c = 0; c < 32; ++c) {
        add_to_slot(sums, ((r0 + fold_c + c) % block_n) / width, row[c]);
      }
    }
  }
  if (q0 + fold_q < n_queries) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      atomicAdd(out + size_t(q0 + fold_q) * kSlots + s, sums[s]);
    }
  }
}

}  // namespace probe_matmul

// Add the folded products of `test` [n_queries, d] and `train` [n, d]
// (bfloat16, row-major) to `out` [n_queries, 8] float32, which the caller
// zeroes, on `stream`; returns the CUDA status (0 = launched). The caller
// validates shapes (n_queries, n, d >= 1; block_n a positive multiple of 8;
// n_splits * tiles_per_split >= ceil(n / 64)) and sets `vec` only when d is
// a multiple of 8 and both matrices start 16-byte aligned.
extern "C" int probe_matmul_fold(const void* train, int n, const void* test,
                                 int n_queries, int d, int block_n,
                                 int n_splits, int tiles_per_split, int vec,
                                 void* out, void* stream) {
  using namespace probe_matmul;
  const dim3 grid((n_queries + kTileQ - 1) / kTileQ, n_splits);
  matmul_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Bf16*>(train), n, static_cast<const Bf16*>(test),
      n_queries, d, block_n, tiles_per_split, vec, static_cast<float*>(out));
  return int(cudaGetLastError());
}
