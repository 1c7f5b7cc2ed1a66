// Tile KNN for Hopper (sm_90a): per query, the k smallest (squared euclidean
// distance, train index) pairs over train rows < n_valid, in one of three
// distance forms, at any number of features.
//
// Replaces knn_tpu/ops/pallas_knn.py::_knn_kernel (the tile-merge kernel, in
// its exact, fast and bf16 forms) and the fast and bf16 forms of
// ::_knn_stripe_kernel. Both give, per query, the k best (distance, index)
// pairs over the valid rows, ascending, the lowest index winning a tie; this
// kernel writes them per train split as packed keys, and stripe_knn.cu's
// merge kernel folds the splits (as the XLA _merge_topk_rounds does for the
// stripe kernel, and _merge_topk_rounds inside _knn_kernel's body does per
// train tile).
//
// The forms (a template parameter):
// - exact: d = d + diff*diff over the true features in source order, rounded
//   after the subtraction, the multiply and the add (__fsub_rn, __fmul_rn,
//   __fadd_rn; the library is built with --fmad=false). Bit-equal to
//   ops/distance.py::pairwise_sq_dists.
// - fast: cross = sum of q_f*t_f in source order, one __fmaf_rn per feature
//   (--fmad=false would otherwise split a multiply-add in two); then
//   (q2 + t2) - 2*cross, clamped at 0. The norms q2 and t2 come from the
//   wrapper (ops/distance.py::sq_norms), summed from the stored values.
// - bf16: the fast form with both operands of the cross term rounded to
//   bfloat16 (nearest even) as they are staged; a train matrix stored as
//   bfloat16 converts exactly. The product of two bfloat16 values is exact in
//   float32, so each fma rounds once, in the add. This runs on the CUDA
//   cores; a tensor-core (wgmma) version is later work.
// NaN: CUDA's fmaxf(NaN, 0) returns 0 where jnp.maximum propagates NaN, and
// a row with a NaN feature would then win at distance 0. So the clamp skips
// NaN, and pack_key maps it to +inf with the row's own index. The clamp also
// keeps every distance >= 0 or +inf, which the packed-key order needs.
//
// Design. A block of 256 threads owns 128 queries and one contiguous split
// of the train rows (gridDim.y splits, planned by ops/cuda_knn.py::
// split_plan). It walks its split in tiles of 128 rows. For each tile it
// loops over the features in chunks of 16 in source order: the chunk of the
// 128 queries and of the 128 rows is staged transposed in shared memory
// (zero past d and past the last row: a zero feature adds exactly 0 in every
// form), and each thread accumulates an 8x8 register tile of (query, row)
// pairs from two float4 loads of each operand per feature. The 128x128
// distances then go through shared memory to threads 0..127, one per query,
// which insert them into a sorted list of k packed keys (stripe_knn.cuh: in
// registers for k <= 16, a local-memory bucket of 32..256 keys above). Each
// (query, split) list goes to [Q, splits, k] scratch.
//
// Bound on this card (see chip_smoke.py): operations. exact: 3*d + 1 FP32
// instructions per (query, valid row) at 33.5e12/s (no FMA); fast: 2*d
// flops at 67 TFLOP/s; bf16: 2*d flops at the tensor cores' 989 TFLOP/s,
// which this CUDA-core kernel cannot reach. Per feature a thread issues 64
// multiply-adds (192 instructions in the exact form) against four 16-byte
// shared-memory loads. Queries and rows are re-read from L2 for every
// (query block, row tile) pair.
//
// Left for later: wgmma for the bf16 form, cp.async/TMA double buffering of
// the chunks, vectorised global loads, and a selection that uses all 256
// threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stripe_knn.cuh"

namespace tile_knn {

using stripe_knn::list_insert;
using stripe_knn::list_length;
using stripe_knn::kSentinelKey;
using stripe_knn::pack_key;

enum Form { kExact = 0, kFast = 1, kBf16 = 2 };

constexpr int kThreads = 256;
constexpr int kTile = 128;   // queries per block, and train rows per tile
constexpr int kChunk = 16;   // features staged per step
// Pitch of a staged feature row, in floats: 16-byte aligned for the float4
// loads, and off a multiple of 32 so the transposed stores spread over banks.
constexpr int kPitch = kTile + 4;
// Pitch of the distance tile: odd, so one query per thread reads one bank.
constexpr int kDistPitch = kTile + 1;
constexpr size_t kSmemBytes =
    (2 * kChunk * kPitch + kTile * kDistPitch) * sizeof(float);

// Slot `a` (0..7) of a thread's 8 queries or rows: 4*g + a for a < 4, then
// the same 64 further on, so that neighbouring threads load neighbouring
// float4s without bank conflicts.
__device__ __forceinline__ int slot(int a, int g) {
  return (a >> 2) * 64 + 4 * g + (a & 3);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int F>
__device__ __forceinline__ float operand(float x) {
  if constexpr (F == kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// dst[f * kPitch + r] = operand(src[row0 + r][f0 + f]) for r < rows and
// f0 + f < d, else 0. Consecutive threads read consecutive features of a row.
template <int F, typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, int row0,
                                      int rows, int d, int f0) {
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int r = e / kChunk;
    const int f = e % kChunk;
    float v = 0.0f;
    if (r < rows && f0 + f < d) {
      v = operand<F>(to_float(src[size_t(row0 + r) * d + f0 + f]));
    }
    dst[f * kPitch + r] = v;
  }
}

template <int F>
__device__ __forceinline__ float step(float acc, float q, float t) {
  if constexpr (F == kExact) {
    const float diff = __fsub_rn(q, t);
    return __fadd_rn(acc, __fmul_rn(diff, diff));
  } else {
    return __fmaf_rn(q, t, acc);
  }
}

template <int F>
__device__ __forceinline__ float finish(float acc, float q2, float t2) {
  if constexpr (F == kExact) {
    return acc;
  } else {
    const float v = __fsub_rn(__fadd_rn(q2, t2), __fmul_rn(2.0f, acc));
    return isnan(v) ? v : fmaxf(v, 0.0f);
  }
}

template <int F, typename T, int K>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const T* __restrict__ train, const float* __restrict__ t2,
                 int n_valid, const float* __restrict__ test,
                 const float* __restrict__ q2, int n_queries, int d, int k,
                 int rows_per_split, uint64_t* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [kChunk][kPitch]
  float* t_s = q_s + kChunk * kPitch;      // [kChunk][kPitch]
  float* dist_s = t_s + kChunk * kPitch;   // [kTile][kDistPitch]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // row group
  const int ty = tid / 16;  // query group
  const int q0 = blockIdx.x * kTile;
  const int q_rows = min(kTile, n_queries - q0);
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, n_valid);
  const int n = list_length<K>(k);

  float qn[8] = {};
  if constexpr (F != kExact) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (slot(a, ty) < q_rows) qn[a] = q2[q0 + slot(a, ty)];
    }
  }

  uint64_t list[K];
#pragma unroll
  for (int j = 0; j < n; ++j) list[j] = kSentinelKey;

  for (int t0 = r_begin; t0 < r_end; t0 += kTile) {
    const int rows = min(kTile, r_end - t0);
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
    }

    for (int f0 = 0; f0 < d; f0 += kChunk) {
      __syncthreads();  // the previous chunk is consumed
      stage<F>(q_s, test, q0, q_rows, d, f0);
      stage<F>(t_s, train, t0, rows, d, f0);
      __syncthreads();
#pragma unroll
      for (int f = 0; f < kChunk; ++f) {
        const float* qf = q_s + f * kPitch;
        const float* tf = t_s + f * kPitch;
        const float4 qa = *reinterpret_cast<const float4*>(qf + 4 * ty);
        const float4 qb = *reinterpret_cast<const float4*>(qf + 64 + 4 * ty);
        const float4 ta = *reinterpret_cast<const float4*>(tf + 4 * tx);
        const float4 tb = *reinterpret_cast<const float4*>(tf + 64 + 4 * tx);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float tv[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = step<F>(acc[a][b], qv[a], tv[b]);
        }
      }
    }

    float tn[8] = {};
    if constexpr (F != kExact) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (slot(b, tx) < rows) tn[b] = t2[t0 + slot(b, tx)];
      }
    }
    __syncthreads();  // the previous tile's selection has read dist_s
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        dist_s[slot(a, ty) * kDistPitch + slot(b, tx)] =
            finish<F>(acc[a][b], qn[a], tn[b]);
      }
    }
    __syncthreads();
    if (tid < q_rows) {
      // Columns past `rows` hold the zero fill: never inserted.
      const float* row = dist_s + tid * kDistPitch;
      for (int r = 0; r < rows; ++r) {
        list_insert<K>(list, k, pack_key(row[r], t0 + r));
      }
    }
  }

  if (tid < q_rows) {
    uint64_t* out = partial + (size_t(q0 + tid) * gridDim.y + split) * n;
#pragma unroll
    for (int j = 0; j < n; ++j) out[j] = list[j];
  }
}

template <int F, typename T, int K>
cudaError_t launch_scan(const void* train, const float* t2, int n_valid,
                        const float* test, const float* q2, int n_queries,
                        int d, int k, int n_splits, int rows_per_split,
                        uint64_t* partial, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_scan_kernel<F, T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_queries + kTile - 1) / kTile, n_splits);
  tile_scan_kernel<F, T, K><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(train), t2, n_valid, test, q2, n_queries, d, k,
      rows_per_split, partial);
  return cudaGetLastError();
}

}  // namespace tile_knn

// Launch the tile scan on `stream`; returns the CUDA status (0 = launched).
// `form` is 0 exact, 1 fast, 2 bf16; `train_bf16` says the train matrix is
// stored as bfloat16 (bf16 form only), else float32. The caller validates
// shapes (1 <= k <= 256, n_queries >= 1, 0 <= n_valid <= rows of train,
// n_splits * rows_per_split >= n_valid), passes the [n_queries] and [N]
// float32 norms for the fast and bf16 forms (null for exact), and allocates
// `partial` as [n_queries, n_splits, k] uint64.
extern "C" int tile_knn_scan(int form, int train_bf16, const void* train,
                             const void* t2, int n_valid, const void* test,
                             const void* q2, int n_queries, int d, int k,
                             int n_splits, int rows_per_split, void* partial,
                             void* stream) {
  using namespace tile_knn;
  const auto* t2f = static_cast<const float*>(t2);
  const auto* testf = static_cast<const float*>(test);
  const auto* q2f = static_cast<const float*>(q2);
  auto* out = static_cast<uint64_t*>(partial);
  auto* s = static_cast<cudaStream_t>(stream);
  return int(stripe_knn::with_k(k, [&](auto kc) -> cudaError_t {
    constexpr int K = decltype(kc)::value;
    if (form == kBf16 && train_bf16) {
      return launch_scan<kBf16, __nv_bfloat16, K>(train, t2f, n_valid, testf,
                                                 q2f, n_queries, d, k, n_splits,
                                                 rows_per_split, out, s);
    }
    if (train_bf16) return cudaErrorInvalidValue;
    switch (form) {
      case kExact:
        return launch_scan<kExact, float, K>(train, t2f, n_valid, testf, q2f,
                                             n_queries, d, k, n_splits,
                                             rows_per_split, out, s);
      case kFast:
        return launch_scan<kFast, float, K>(train, t2f, n_valid, testf, q2f,
                                            n_queries, d, k, n_splits,
                                            rows_per_split, out, s);
      case kBf16:
        return launch_scan<kBf16, float, K>(train, t2f, n_valid, testf, q2f,
                                            n_queries, d, k, n_splits,
                                            rows_per_split, out, s);
      default:
        return cudaErrorInvalidValue;
    }
  }));
}
