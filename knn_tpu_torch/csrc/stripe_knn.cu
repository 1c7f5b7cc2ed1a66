// Exact stripe KNN for Hopper (sm_90a): per query, the k smallest
// (squared euclidean distance, train index) pairs over train rows < n_valid.
//
// Replaces knn_tpu/ops/pallas_knn.py::_knn_stripe_kernel, exact form
// (stripe_scan_kernel), and the XLA _merge_topk_rounds that follows it
// (stripe_merge_kernel): the same [Q, k] float32 distances and int32 global
// indices, ascending by (distance, index).
//
// Contract, as in the TPU kernel and the reference's main.cpp:17-19:
// - d = d + diff*diff over the true features in source order, rounded after
//   the multiply AND after the add (__fmul_rn/__fadd_rn, and the library is
//   built with --fmad=false): no fused multiply-add.
// - A NaN distance counts as +inf but keeps its row's real index; only rows
//   at or past n_valid are (+inf, INT32_MAX). The lowest index wins a tie.
//
// Design. stripe_scan_kernel: a block owns 128 queries (one per thread,
// staged transposed in shared memory) and one contiguous split of the train
// rows, which it walks in tiles of 64 rows staged transposed in shared
// memory. Each thread scores 4 rows per pass over the features (one float4
// broadcast load per feature) and keeps a sorted register list of k packed
// keys (stripe_knn.cuh). Splitting the train rows over gridDim.y fills the
// card when there are few queries; each (query, split) list goes to a
// [Q, splits, k] scratch buffer. stripe_merge_kernel: one thread per query
// folds its sorted split lists into k keys, stopping each list at the first
// key that cannot enter, and unpacks them. The merge runs even when there is
// one split (it then only unpacks): one split happens only past ~270k
// queries on a 132-SM card, where the merge is a small share of the scan.
//
// Bound on this card (scan): 3*d FP32 instructions (sub, mul, add) per
// (query, train row) plus one key compare for the selection. With FMA
// contraction forbidden each is one instruction, so the rate is the card's
// FP32 instruction rate, half its FMA-counted 67 TFLOP/s: 33.5e12 per
// second. The bytes (train once, queries once, the [Q, splits, k] keys out)
// are far below it at d = 11. The train rows of a split are re-read once
// per 128-query block (from L2 when they fit). The merge is bound by the
// bytes of the keys it reads.
//
// Left for later: TMA/cp.async staging with double buffering, larger query
// tiles per thread (register blocking over queries as well as rows), and the
// knn_tpu/ops/topk_net.py merge network in place of the insertion list.
#include <cuda_runtime.h>

#include <cstdint>

#include "stripe_knn.cuh"

namespace stripe_knn {

template <int K>
__global__ void __launch_bounds__(kQueriesPerBlock)
stripe_scan_kernel(const float* __restrict__ train, int n_valid,
                   const float* __restrict__ test, int n_queries, int d,
                   int rows_per_split, uint64_t* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // [d][kQueriesPerBlock]
  float* t_s = smem + d * kQueriesPerBlock;  // [d][kTileRows]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, n_valid);

  // Stage the query tile transposed; the global read is contiguous.
  for (int e = tid; e < kQueriesPerBlock * d; e += kQueriesPerBlock) {
    const int qi = e / d;
    const int f = e - qi * d;
    q_s[f * kQueriesPerBlock + qi] =
        q0 + qi < n_queries ? test[size_t(q0 + qi) * d + f] : 0.0f;
  }

  uint64_t list[K];
#pragma unroll
  for (int j = 0; j < K; ++j) list[j] = kSentinelKey;

  for (int t0 = r_begin; t0 < r_end; t0 += kTileRows) {
    const int rows = min(kTileRows, r_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kTileRows * d; e += kQueriesPerBlock) {
      const int ri = e / d;
      const int f = e - ri * d;
      t_s[f * kTileRows + ri] = ri < rows ? train[size_t(t0 + ri) * d + f] : 0.0f;
    }
    __syncthreads();

    for (int r = 0; r < rows; r += kRowsPerStep) {
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll 4
      for (int f = 0; f < d; ++f) {
        const float qf = q_s[f * kQueriesPerBlock + tid];
        const float4 t = *reinterpret_cast<const float4*>(&t_s[f * kTileRows + r]);
        const float d0 = __fsub_rn(qf, t.x);
        const float d1 = __fsub_rn(qf, t.y);
        const float d2 = __fsub_rn(qf, t.z);
        const float d3 = __fsub_rn(qf, t.w);
        acc0 = __fadd_rn(acc0, __fmul_rn(d0, d0));
        acc1 = __fadd_rn(acc1, __fmul_rn(d1, d1));
        acc2 = __fadd_rn(acc2, __fmul_rn(d2, d2));
        acc3 = __fadd_rn(acc3, __fmul_rn(d3, d3));
      }
      // Rows past `rows` are the tile's zero fill: never inserted.
      const int base = t0 + r;
      insert_key<K>(list, pack_key(acc0, base));
      if (r + 1 < rows) insert_key<K>(list, pack_key(acc1, base + 1));
      if (r + 2 < rows) insert_key<K>(list, pack_key(acc2, base + 2));
      if (r + 3 < rows) insert_key<K>(list, pack_key(acc3, base + 3));
    }
  }

  if (q0 + tid < n_queries) {
    uint64_t* out = partial + (size_t(q0 + tid) * gridDim.y + split) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = list[j];
  }
}

template <int K>
__global__ void stripe_merge_kernel(const uint64_t* __restrict__ partial,
                                    int n_splits, int n_queries,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  uint64_t list[K];
#pragma unroll
  for (int j = 0; j < K; ++j) list[j] = kSentinelKey;
  for (int s = 0; s < n_splits; ++s) {
    const uint64_t* src = partial + (size_t(q) * n_splits + s) * K;
    for (int j = 0; j < K; ++j) {
      const uint64_t key = src[j];
      if (!(key < list[K - 1])) break;  // src is sorted: nothing later enters
      insert_key<K>(list, key);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_d[size_t(q) * K + j] = key_distance(list[j]);
    out_i[size_t(q) * K + j] = key_index(list[j]);
  }
}

template <int K>
cudaError_t launch_scan(const float* train, int n_valid, const float* test,
                        int n_queries, int d, int n_splits, int rows_per_split,
                        uint64_t* partial, cudaStream_t stream) {
  const size_t smem = size_t(d) * (kQueriesPerBlock + kTileRows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stripe_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock,
                  n_splits);
  stripe_scan_kernel<K><<<grid, kQueriesPerBlock, smem, stream>>>(
      train, n_valid, test, n_queries, d, rows_per_split, partial);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_merge(const uint64_t* partial, int n_splits, int n_queries,
                         float* out_d, int* out_i, cudaStream_t stream) {
  constexpr int kMergeThreads = 128;
  stripe_merge_kernel<K>
      <<<(n_queries + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
         stream>>>(partial, n_splits, n_queries, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace stripe_knn

// Launch the scan on `stream`; returns the CUDA status (0 = launched). The
// caller validates shapes (1 <= k <= 16, 0 <= d <= 128, n_queries >= 1,
// 0 <= n_valid <= rows of train, n_splits * rows_per_split >= n_valid) and
// allocates `partial` as [n_queries, n_splits, k] uint64.
extern "C" int stripe_knn_scan(const void* train, int n_valid,
                               const void* test, int n_queries, int d, int k,
                               int n_splits, int rows_per_split,
                               void* partial, void* stream) {
  using namespace stripe_knn;
  return int(with_k(k, [&](auto kc) {
    return launch_scan<decltype(kc)::value>(
        static_cast<const float*>(train), n_valid,
        static_cast<const float*>(test), n_queries, d, n_splits,
        rows_per_split, static_cast<uint64_t*>(partial),
        static_cast<cudaStream_t>(stream));
  }));
}

// Launch the merge of the scan's [n_queries, n_splits, k] keys into
// [n_queries, k] distances and indices on `stream`; returns the CUDA status.
extern "C" int stripe_knn_merge(const void* partial, int n_splits,
                                int n_queries, int k, void* out_d, void* out_i,
                                void* stream) {
  using namespace stripe_knn;
  return int(with_k(k, [&](auto kc) {
    return launch_merge<decltype(kc)::value>(
        static_cast<const uint64_t*>(partial), n_splits, n_queries,
        static_cast<float*>(out_d), static_cast<int*>(out_i),
        static_cast<cudaStream_t>(stream));
  }));
}
