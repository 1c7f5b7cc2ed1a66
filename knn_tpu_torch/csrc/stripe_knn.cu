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
// Design. stripe_scan_kernel: a block owns 128 queries (one per thread)
// and one contiguous split of the train rows, which it walks in tiles of
// 128 rows (32 past 64 features). The train is read from its feature-major
// copy (ops/cuda_knn.py::feature_major, kept with the train tensor): a
// tile is d runs of contiguous, 16-byte aligned floats, which cp.async
// copies into a ring of two stages, 16 bytes a copy and no index
// arithmetic per element, the next tile's copy in flight while this one
// is scored (one barrier a tile). The query block sits in shared memory
// one query per row, its pitch an odd number of float4s, so a thread reads
// four of its query's features with one conflict-free float4 load (and
// holds the last d % 4 in registers). Each thread scores 16 rows per pass
// over the features (four broadcast float4 loads per feature) and keeps a
// sorted register list of k packed keys. A pass whose smallest distance is
// above the list's last key is dropped with one float compare; otherwise
// each lane inserts its passing rows one per round (a 32-bit compare per
// slot: its rows come in ascending index order), so a warp runs as many
// rounds as its busiest lane has rows, not one per row any lane passes. Splitting the train rows over gridDim.y fills
// the card when there are few queries: ops/cuda_knn.py::stripe_split_plan
// sizes one wave at the blocks per SM that the kernel's registers and
// shared memory allow (stripe_knn_blocks_per_sm). Each (query, split) list
// goes to a [Q, splits, k] scratch buffer. stripe_merge_kernel folds a
// query's sorted split lists into its k best and unpacks them (below). The
// merge runs even when there is one split (it then only unpacks): one
// split happens only past ~270k queries on a 132-SM card, where the merge
// is a small share of the scan.
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
// The scan takes 1 <= k <= 16 (an exact-length register list); a larger k
// on the stripe route runs tile_knn.cu's exact form, the same function.
//
// The merge takes any k. One warp per query, and the sorted split lists
// are used as runs: each lane owns the runs s = lane, lane + 32, ... and
// keeps their heads (and its position in each) in shared memory, and its
// own smallest head in a register. A round takes the warp minimum of the
// lanes' heads (a butterfly of 64-bit shuffles), writes it to the next
// output slot, and advances the one run that held it (the lowest lane on a
// tie): k rounds of one dependent key load each, with no list of k
// anywhere. Once the minimum is the sentinel, every key left is the
// sentinel (it is the largest key there is), so the rest of the row is
// filled with it. Same multiset, same order: bit-equal to the plain
// version's topk-then-sort. Outputs are written 32 slots at a time, one per
// lane. Shared memory is 12 bytes per split per warp, so the warps per
// block shrink as the splits grow (kMaxMergeSplits at one warp).
//
// Selection variants (stripe_knn_scan_variant; k <= 16). The port of
// scripts/tune_stripe_selection.py::make_variant_kernel, the TPU probe that
// swaps the stripe kernel's selection. There, each 128-lane stripe merges
// the "fresh planes" of a train tile into k "levels" per lane; here the
// fresh planes are kGroupRows rows of a thread's pass, in turn, and the
// levels are its k running (distance, index) pairs:
// - rounds (the probe's "current"): k rounds of min distance, then min
//   index among the candidates at that distance; the taken entry is retired
//   on both keys (distance +inf, index INT32_MAX). Its output equals the
//   insertion list's.
// - lite: the same rounds, retiring only the distance. Once a round's
//   minimum is +inf it re-takes the smallest retired index, so a list with
//   fewer finite candidates than k ends in (+inf, stale index) duplicates;
//   with no NaN and at least k valid rows in all, the merge never keeps one.
// - nosel: a plain min of the distances into slot 0, index INT32_MAX, the
//   other slots the sentinel: no selection, a floor for its cost.
// The shipped scan (stripe_knn_scan) is the insertion list, unchanged.
//
// Left for later: the knn_tpu/ops/topk_net.py merge network in place of
// the insertion list, register blocking over queries, and a prefetched
// window of each run in the merge.
#include <cuda_runtime.h>

#include <cstdint>

#include "stripe_knn.cuh"

namespace stripe_knn {

// How the scan keeps a thread's k best: the shipped insertion list, or one
// of the selection variants of the header comment.
enum Select { kInsert = 0, kRounds = 1, kLite = 2, kNosel = 3 };

// P2's selections take a thread's rows in groups of this many, from the
// split's first row (the TPU probe's fresh planes).
constexpr int kGroupRows = 4;

// One pass of the rounds selection: the kGroupRows fresh rows (those at or
// past `left` are (+inf, INT32_MAX), a NaN distance is +inf with its index)
// and the K levels -> the K levels. kRetireIndex false is "lite".
template <int K, bool kRetireIndex>
__device__ __forceinline__ void select_rounds(float (&lev_d)[K],
                                              int (&lev_i)[K],
                                              const float (&acc)[kGroupRows],
                                              int base, int left) {
  constexpr int kCand = kGroupRows + K;
  const float inf = __uint_as_float(kInfBits);
  float cd[kCand];
  int ci[kCand];
#pragma unroll
  for (int p = 0; p < kGroupRows; ++p) {
    cd[p] = p < left && !isnan(acc[p]) ? acc[p] : inf;
    ci[p] = p < left ? base + p : int(kIndexSentinel);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cd[kGroupRows + j] = lev_d[j];
    ci[kGroupRows + j] = lev_i[j];
  }
#pragma unroll
  for (int level = 0; level < K; ++level) {
    float m_d = cd[0];
#pragma unroll
    for (int p = 1; p < kCand; ++p) m_d = fminf(m_d, cd[p]);
    int m_i = int(kIndexSentinel);
#pragma unroll
    for (int p = 0; p < kCand; ++p) m_i = min(m_i, cd[p] == m_d ? ci[p] : m_i);
    lev_d[level] = m_d;
    lev_i[level] = m_i;
    if (level + 1 < K) {
#pragma unroll
      for (int p = 0; p < kCand; ++p) {
        const bool taken = ci[p] == m_i;
        cd[p] = taken ? inf : cd[p];
        if constexpr (kRetireIndex) ci[p] = taken ? int(kIndexSentinel) : ci[p];
      }
    }
  }
}

// The query block's pitch in shared memory, in floats: one float4 per 4
// features, and an odd number of float4s, so that the 8 threads of a
// quarter warp, each reading its own query's float4, hit 8 different
// 16-byte bank groups.
__host__ __device__ constexpr int query_pitch(int d) {
  return 4 * (((d + 3) / 4) | 1);
}

// Train rows per tile: kTileRows, or kTileRowsWide past kWideD features.
__host__ __device__ constexpr int tile_rows_for(int d) {
  return d <= kWideD ? kTileRows : kTileRowsWide;
}

// Pitch of a thread's row of the pick buffer, in floats: room for a pass's
// kRowsPerStep distances, 16-byte aligned and off a multiple of 32 so that
// a quarter warp's float4 stores hit 8 different 16-byte bank groups.
constexpr int kPickPitch = kRowsPerStep + 4;

// One feature of the thread's query against the pass's kRowsPerStep train
// rows t[0..kRowsPerStep) (broadcast float4 loads): acc_j = acc_j +
// diff_j*diff_j, rounded after the subtraction, the multiply and the add.
__device__ __forceinline__ void dist_step(float (&acc)[kRowsPerStep], float q,
                                          const float* t) {
  float tv[kRowsPerStep];
#pragma unroll
  for (int v = 0; v < kRowsPerStep / 4; ++v) {
    const float4 a = *reinterpret_cast<const float4*>(t + 4 * v);
    tv[4 * v] = a.x;
    tv[4 * v + 1] = a.y;
    tv[4 * v + 2] = a.z;
    tv[4 * v + 3] = a.w;
  }
#pragma unroll
  for (int j = 0; j < kRowsPerStep; ++j) {
    const float diff = __fsub_rn(q, tv[j]);
    acc[j] = __fadd_rn(acc[j], __fmul_rn(diff, diff));
  }
}

template <int K, int Sel>
__global__ void __launch_bounds__(kQueriesPerBlock)
stripe_scan_kernel(const float* __restrict__ train_t, int n_pad, int n_valid,
                   const float* __restrict__ test, int n_queries, int d,
                   int k, int rows_per_split, uint64_t* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int qp = query_pitch(d);
  const int tile_rows = tile_rows_for(d);
  const int tile_floats = d * tile_rows;
  float* q_s = smem;                          // [kQueriesPerBlock][qp]
  float* t_s = smem + kQueriesPerBlock * qp;  // [2][d][tile_rows]
  // This thread's row of the pick buffer, [kQueriesPerBlock][kPickPitch].
  float* pick = t_s + 2 * tile_floats + threadIdx.x * kPickPitch;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, n_valid);
  const int n_tiles =
      r_end > r_begin ? (r_end - r_begin + tile_rows - 1) / tile_rows : 0;

  // Tile i of the split into stage `buf`: the d runs of tile_rows floats of
  // the feature-major train, 16 bytes a copy; rows at or past r_end are
  // zero-filled (and never selected).
  const int runs_shift = 31 - __clz(tile_rows / 4);  // copies per run, log2
  auto stage = [&](int i, int buf) {
    const int t0 = r_begin + i * tile_rows;
    float* dst = t_s + buf * tile_floats;
    for (int p = tid; p < d << runs_shift; p += kQueriesPerBlock) {
      const int f = p >> runs_shift;
      const int c = (p - (f << runs_shift)) * 4;
      const bool in = t0 + c < r_end;
      cp_async16(dst + f * tile_rows + c,
                 in ? train_t + size_t(f) * n_pad + t0 + c : train_t, in);
    }
  };
  if (n_tiles > 0) stage(0, 0);
  cp_async_commit();

  // The query block, one query per row of q_s; the global read is
  // contiguous. The pitch's padding is never read.
  for (int e = tid; e < kQueriesPerBlock * d; e += kQueriesPerBlock) {
    const int qi = e / d;
    const int f = e - qi * d;
    q_s[qi * qp + f] = q0 + qi < n_queries ? test[size_t(q0 + qi) * d + f] : 0.0f;
  }
  __syncthreads();
  const float* q_row = q_s + tid * qp;
  const int d4 = d & ~3;  // features read as float4s; the last d - d4 held
  float q_tail[3];        // in registers
#pragma unroll
  for (int j = 0; j < 3; ++j) q_tail[j] = d4 + j < d ? q_row[d4 + j] : 0.0f;

  uint64_t list[K];  // kInsert
  float lev_d[K];    // kRounds, kLite
  int lev_i[K];
  float best = __uint_as_float(kInfBits);  // kNosel
#pragma unroll
  for (int j = 0; j < K; ++j) {
    list[j] = kScanSentinelKey;
    lev_d[j] = best;
    lev_i[j] = int(kIndexSentinel);
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed for every thread; tile i-1 is consumed
    if (i + 1 < n_tiles) stage(i + 1, (i + 1) & 1);
    cp_async_commit();

    const float* tile = t_s + (i & 1) * tile_floats;
    const int t0 = r_begin + i * tile_rows;
    const int rows = min(tile_rows, r_end - t0);
    for (int r = 0; r < rows; r += kRowsPerStep) {
      float acc[kRowsPerStep] = {};
      const float* t = tile + r;
      for (int f = 0; f < d4; f += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_row + f);
        dist_step(acc, q4.x, t + f * tile_rows);
        dist_step(acc, q4.y, t + (f + 1) * tile_rows);
        dist_step(acc, q4.z, t + (f + 2) * tile_rows);
        dist_step(acc, q4.w, t + (f + 3) * tile_rows);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (d4 + j < d) dist_step(acc, q_tail[j], t + (d4 + j) * tile_rows);
      }
      // Rows past `rows` are the tile's zero fill: never selected.
      const int base = t0 + r;
      if constexpr (Sel == kInsert) {
        // A row enters the list only below its last key, so a pass whose
        // smallest distance lies above that key's distance adds nothing:
        // one float min per row and one compare drop it (the sentinel's
        // distance is a NaN, which drops nothing; fminf skips a NaN
        // distance, which counts as +inf and so enters only a list that
        // still holds sentinels). Otherwise each lane marks its rows at or
        // below that distance (NaN too) and inserts them one per round,
        // lowest first, reading each from its pick buffer: a warp runs as
        // many rounds as its busiest lane has rows, not one per row that
        // any lane passes.
        const float limit = key_distance(list[K - 1]);
        float lowest = acc[0];
#pragma unroll
        for (int j = 1; j < kRowsPerStep; ++j) lowest = fminf(lowest, acc[j]);
        if (!(lowest > limit)) {
          unsigned pass = 0;
#pragma unroll
          for (int j = 0; j < kRowsPerStep; ++j) {
            pass |= !(acc[j] > limit) && r + j < rows ? 1u << j : 0u;
          }
#pragma unroll
          for (int v = 0; v < kRowsPerStep / 4; ++v) {
            *reinterpret_cast<float4*>(pick + 4 * v) = make_float4(
                acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
          }
          while (pass) {
            const int j = __ffs(pass) - 1;
            pass &= pass - 1;
            insert_row<K>(list, pick[j], base + j);
          }
        }
      } else if constexpr (Sel == kNosel) {
        // fminf drops a NaN operand: a NaN distance counts as +inf.
#pragma unroll
        for (int j = 0; j < kRowsPerStep; ++j) {
          if (r + j < rows) best = fminf(best, acc[j]);
        }
      } else {
        // P2's selections take the rows in groups of kGroupRows.
#pragma unroll
        for (int g = 0; g < kRowsPerStep / kGroupRows; ++g) {
          if (r + g * kGroupRows < rows) {
            const float fresh[kGroupRows] = {acc[4 * g], acc[4 * g + 1],
                                             acc[4 * g + 2], acc[4 * g + 3]};
            select_rounds<K, Sel == kRounds>(lev_d, lev_i, fresh,
                                             base + g * kGroupRows,
                                             rows - r - g * kGroupRows);
          }
        }
      }
    }
  }

  if (q0 + tid < n_queries) {
    uint64_t* out = partial + (size_t(q0 + tid) * gridDim.y + split) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if constexpr (Sel == kInsert) {
        out[j] = scan_key(list[j]);
      } else if constexpr (Sel == kNosel) {
        out[j] = j == 0 ? (uint64_t(__float_as_uint(best)) << 32) | kIndexSentinel
                        : kSentinelKey;
      } else {
        out[j] = pack_key(lev_d[j], lev_i[j]);
      }
    }
  }
}

constexpr unsigned kFullMask = 0xffffffffu;
// Past every key: the head of an exhausted run, and of a lane with no run.
constexpr uint64_t kNoKey = ~uint64_t(0);
// Shared memory of the merge: a head (8 bytes) and a position (4) per split
// per warp. At one warp per block it holds this many splits.
constexpr int kMaxMergeSplits = 16384;
constexpr int kMergeSmemBytes = 48 * 1024;  // the default per block
constexpr int kMergeMaxWarps = 8;

__device__ __forceinline__ uint64_t warp_min(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t other = __shfl_xor_sync(kFullMask, v, o);
    v = other < v ? other : v;
  }
  return v;
}

__device__ __forceinline__ void write_key(float* out_d, int* out_i, size_t at,
                                          uint64_t key) {
  out_d[at] = key_distance(key);
  out_i[at] = key_index(key);
}

__global__ void stripe_merge_kernel(const uint64_t* __restrict__ partial,
                                    int n_splits, int n_queries, int k,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i) {
  extern __shared__ __align__(16) uint64_t merge_smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * warps + warp;
  if (q >= n_queries) return;  // the whole warp; the kernel never syncs the block
  uint64_t* head = merge_smem + size_t(warp) * n_splits;
  int* pos = reinterpret_cast<int*>(merge_smem + size_t(warps) * n_splits) +
             size_t(warp) * n_splits;
  const uint64_t* src = partial + size_t(q) * n_splits * k;

  // Only this lane touches the heads and positions of its runs.
  uint64_t best = kNoKey;
  int best_s = 0;
  for (int s = lane; s < n_splits; s += 32) {
    const uint64_t key = src[size_t(s) * k];
    head[s] = key;
    pos[s] = 0;
    if (key < best) {
      best = key;
      best_s = s;
    }
  }

  const size_t row = size_t(q) * k;
  uint64_t mine = kSentinelKey;  // this lane's slot of the current 32 rounds
  int r = 0;
  for (; r < k; ++r) {
    const uint64_t m = warp_min(best);
    if (m >= kSentinelKey) break;  // warp-uniform: only sentinels are left
    if ((r & 31) == lane) mine = m;
    if ((r & 31) == 31) write_key(out_d, out_i, row + r - 31 + lane, mine);
    const unsigned holders = __ballot_sync(kFullMask, best == m);
    if (lane == __ffs(holders) - 1) {
      const int p = ++pos[best_s];
      head[best_s] = p < k ? src[size_t(best_s) * k + p] : kNoKey;
      best = kNoKey;
      for (int s = lane; s < n_splits; s += 32) {
        if (head[s] < best) {
          best = head[s];
          best_s = s;
        }
      }
    }
  }
  const int base = r & ~31;  // the rounds since the last full group of 32
  if (base + lane < r) write_key(out_d, out_i, row + base + lane, mine);
  for (int j = r + lane; j < k; j += 32) write_key(out_d, out_i, row + j, kSentinelKey);
}

// The scan's shared memory at d features: the query block, two stages of
// the train tile and the pick buffer.
inline size_t scan_smem_bytes(int d) {
  return (size_t(kQueriesPerBlock) * (query_pitch(d) + kPickPitch) +
          2 * size_t(d) * tile_rows_for(d)) *
         sizeof(float);
}

// Blocks of `kernel` (kQueriesPerBlock threads, `smem` bytes of dynamic
// shared memory) one SM holds at once.
template <typename Kernel>
cudaError_t occupancy(int* blocks, Kernel kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kQueriesPerBlock, smem);
}

template <int K, int Sel>
cudaError_t launch_scan(const float* train_t, int n_pad, int n_valid,
                        const float* test, int n_queries, int d, int k,
                        int n_splits, int rows_per_split, uint64_t* partial,
                        cudaStream_t stream) {
  if (d < 0 || d > kMaxD || rows_per_split % kSplitAlign != 0 ||
      n_pad % kRowGranule != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = scan_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      stripe_scan_kernel<K, Sel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock,
                  n_splits);
  stripe_scan_kernel<K, Sel><<<grid, kQueriesPerBlock, smem, stream>>>(
      train_t, n_pad, n_valid, test, n_queries, d, k, rows_per_split, partial);
  return cudaGetLastError();
}

cudaError_t launch_merge(const uint64_t* partial, int n_splits, int n_queries,
                         int k, float* out_d, int* out_i, cudaStream_t stream) {
  if (n_splits < 1 || n_splits > kMaxMergeSplits || k < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t per_warp = size_t(n_splits) * (sizeof(uint64_t) + sizeof(int));
  int warps = kMergeMaxWarps;
  while (warps > 1 && warps * per_warp > kMergeSmemBytes) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > kMergeSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        stripe_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  stripe_merge_kernel<<<(n_queries + warps - 1) / warps, warps * 32, smem,
                        stream>>>(partial, n_splits, n_queries, k, out_d,
                                  out_i);
  return cudaGetLastError();
}

}  // namespace stripe_knn

// Launch the scan on `stream`; returns the CUDA status (0 = launched).
// `train_t` is the feature-major train, [d, n_pad] float32 (n_pad a
// multiple of kRowGranule, rows past the train's zero); `test` the
// row-major [n_queries, d] float32 queries. The caller validates shapes
// (1 <= k <= 16, 0 <= d <= 128, n_queries >= 1, 0 <= n_valid <= rows of
// train, n_splits * rows_per_split >= n_valid, rows_per_split a multiple of
// kSplitAlign) and allocates `partial` as [n_queries, n_splits, k] uint64.
extern "C" int stripe_knn_scan(const void* train_t, int n_pad, int n_valid,
                               const void* test, int n_queries, int d, int k,
                               int n_splits, int rows_per_split,
                               void* partial, void* stream) {
  using namespace stripe_knn;
  return int(with_register_k(k, [&](auto kc) {
    return launch_scan<decltype(kc)::value, kInsert>(
        static_cast<const float*>(train_t), n_pad, n_valid,
        static_cast<const float*>(test), n_queries, d, k, n_splits,
        rows_per_split, static_cast<uint64_t*>(partial),
        static_cast<cudaStream_t>(stream));
  }));
}

// How many blocks of the scan at k and d one SM holds at once, by its
// registers and shared memory; 0 when k or d is out of range.
// ops/cuda_knn.py::stripe_split_plan sizes one wave of blocks with it.
extern "C" int stripe_knn_blocks_per_sm(int d, int k) {
  using namespace stripe_knn;
  if (d < 0 || d > kMaxD) return 0;
  int blocks = 0;
  const cudaError_t err = with_register_k(k, [&](auto kc) -> cudaError_t {
    return occupancy(&blocks, stripe_scan_kernel<decltype(kc)::value, kInsert>,
                     scan_smem_bytes(d));
  });
  return err == cudaSuccess ? blocks : 0;
}

// The scan with selection variant `select` (1 rounds, 2 lite, 3 nosel) on
// `stream`; returns the CUDA status. As stripe_knn_scan, with 1 <= k <= 16.
extern "C" int stripe_knn_scan_variant(int select, const void* train_t,
                                       int n_pad, int n_valid,
                                       const void* test, int n_queries, int d,
                                       int k, int n_splits, int rows_per_split,
                                       void* partial, void* stream) {
  using namespace stripe_knn;
  return int(with_register_k(k, [&](auto kc) -> cudaError_t {
    constexpr int K = decltype(kc)::value;
    const auto* t = static_cast<const float*>(train_t);
    const auto* q = static_cast<const float*>(test);
    auto* out = static_cast<uint64_t*>(partial);
    auto* s = static_cast<cudaStream_t>(stream);
    switch (select) {
      case kRounds:
        return launch_scan<K, kRounds>(t, n_pad, n_valid, q, n_queries, d, k,
                                       n_splits, rows_per_split, out, s);
      case kLite:
        return launch_scan<K, kLite>(t, n_pad, n_valid, q, n_queries, d, k,
                                     n_splits, rows_per_split, out, s);
      case kNosel:
        return launch_scan<K, kNosel>(t, n_pad, n_valid, q, n_queries, d, k,
                                      n_splits, rows_per_split, out, s);
      default:
        return cudaErrorInvalidValue;
    }
  }));
}

// Launch the merge of the scan's [n_queries, n_splits, k] keys into
// [n_queries, k] distances and indices on `stream`; returns the CUDA status.
// Any k >= 1; 1 <= n_splits <= 16384.
extern "C" int stripe_knn_merge(const void* partial, int n_splits,
                                int n_queries, int k, void* out_d, void* out_i,
                                void* stream) {
  return int(stripe_knn::launch_merge(
      static_cast<const uint64_t*>(partial), n_splits, n_queries, k,
      static_cast<float*>(out_d), static_cast<int*>(out_i),
      static_cast<cudaStream_t>(stream)));
}
