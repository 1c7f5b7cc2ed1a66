// Tile KNN for Hopper (sm_90a): per query, the k smallest (squared euclidean
// distance, train index) pairs over train rows < n_valid, in one of three
// distance forms, at any number of features.
//
// Replaces knn_tpu/ops/pallas_knn.py::_knn_kernel (the tile-merge kernel, in
// its exact, fast and bf16 forms) and the fast and bf16 forms of
// ::_knn_stripe_kernel. Both give, per query, the k best (distance, index)
// pairs over the valid rows, ascending, the lowest index winning a tie; the
// kernels here write them per train split as packed keys, and
// stripe_knn.cu's merge kernel folds the splits (as the XLA
// _merge_topk_rounds does for the stripe kernel, and _merge_topk_rounds
// inside _knn_kernel's body does per train tile).
//
// The forms:
// - exact (tile_scan_kernel<kExact>): d = d + diff*diff over the true
//   features in source order, rounded after the subtraction, the multiply
//   and the add (__fsub_rn, __fmul_rn, __fadd_rn; the library is built with
//   --fmad=false). Bit-equal to ops/distance.py::pairwise_sq_dists.
// - fast (tile_scan_kernel<kFast>): cross = sum of q_f*t_f in source order,
//   one __fmaf_rn per feature (--fmad=false would otherwise split a
//   multiply-add in two); then (q2 + t2) - 2*cross, clamped at 0. The norms
//   q2 and t2 come from the wrapper (ops/distance.py::sq_norms), summed from
//   the stored values.
// - bf16 (tile_scan_bf16_kernel): the fast form's finish over a cross term of
//   bfloat16 operands on the tensor cores (wgmma_tile.cuh: wgmma fed by
//   TMA). The wrapper hands it bfloat16 copies of the train rows and the
//   queries, rounded once to nearest even and zero-padded to a multiple of 64
//   features; the norms are the fast form's, from the stored values. Each
//   product of two bfloat16 values is exact in float32; the tensor cores sum
//   them in their own order and may truncate, so the cross term is off its
//   exact value by at most d * 2^-23 * S, S = sum |q_f t_f| <= (q2 + t2)/2
//   up to the operands' rounding (a factor 1 + 2^-7), and the distance by
//   about 2 * (d + 2) * 2^-24 * (q2 + t2) with the finish's three roundings.
//   On integer grids every product and partial sum is exact: bit-equal.
// NaN: CUDA's fmaxf(NaN, 0) returns 0 where jnp.maximum propagates NaN, and
// a row with a NaN feature would then win at distance 0. So the clamp skips
// NaN, and pack_key maps it to +inf with the row's own index. The clamp also
// keeps every distance >= 0 or +inf, which the packed-key order needs.
//
// Design, exact and fast. A block of 256 threads owns 128 queries and one
// contiguous split of the train rows (gridDim.y splits, planned by
// ops/tile_knn.py::tile_split_plan). It walks its split in tiles of 128
// rows. For each tile it loops over the features in chunks of 16 in source
// order, and each thread accumulates an 8x8 register tile of (query, row)
// pairs from two float4 loads of each operand per feature. Both operands
// are feature-major copies (ops/cuda_knn.py::feature_major: the train's
// kept with the train tensor, the queries' made per call), so a chunk of
// the 128 queries or of the tile's 128 rows is 16 runs of 512 contiguous,
// 16-byte aligned bytes: cp.async copies them into a ring of two stages
// (16 bytes a copy, no index arithmetic per element, zero-filled past d and
// past the split's rows: a zero feature adds exactly 0). The block walks
// its (tile, chunk) steps in order with one barrier a step: at step s it
// waits for its own copies of s, syncs, issues the copies of s + 1 into
// the stage that step s - 1 read, and multiplies s. So chunk c + 1 is in
// flight while chunk c is multiplied. The ring shares its 32 KB with the
// distance tile (a block needs 66 KB, 75 KB at k > 16, where the old
// synchronous staging needed 83 and 92), so two blocks per SM leave more of
// the SM's memory to L1; a tile's first chunk is issued after the previous
// tile's selection.
//
// Design, bf16. A block of two consumer warpgroups and a producer warp owns
// 128 queries and one split, in tiles of 128 rows; each warpgroup's 64x128
// cross term accumulates in registers over 64-feature chunks that TMA
// stages in a ring of 4 shared-memory stages (about 200 KB of shared memory
// with the distance tile: one block per SM). The producer runs up to four
// chunks ahead, so the next tile's loads overlap this tile's finish and
// selection.
//
// Both kernels then put the 128x128 distances in shared memory and select
// from them with the same code (Selection), and each (query, split) list of
// k packed keys goes to [Q, splits, k] scratch.
//
// Selection, k <= 16: threads 0..127, one per query, insert the tile's
// distances into a sorted register list of exactly k keys
// (stripe_knn.cuh::insert_row, as the stripe scan does: a query's rows
// arrive in ascending index order).
//
// Selection, k > 16 (K == kLargeK), any k: the list is the query's output
// row partial[q, split, :k] itself, sentinel-filled at the start and kept
// sorted in place (in L2 while the block runs), and shared memory keeps its
// last key as the query's threshold. All 8 warps select, each for its 16
// queries in turn: the warp compares the query's 128 distances of the tile
// against the threshold (4 per lane), compacts the survivors (ballot and
// popcount) into its 128-key buffer, sorts them (a bitonic network over
// the next power of two), and folds them into the list (fold_into_list).
// Once the list is full, a distance passes the threshold only if it beats
// the k-th key so far (about 128*k/r of a tile's 128 at row r of the
// split, on rows in random order); the wrapper's split plan makes a split
// at least 2k rows, so each list fills in at most half of its split.
//
// Bound on this card (see chip_smoke.py): operations. exact: 3*d + 1 FP32
// instructions per (query, valid row) at 33.5e12/s (no FMA); fast: 2*d
// flops at 67 TFLOP/s; bf16: 2*d flops at the tensor cores' 989 TFLOP/s.
// In the CUDA-core forms a thread issues 64 multiply-adds (192 instructions
// in the exact form) per feature against four 16-byte shared-memory loads.
// Queries and rows are re-read from L2 for every (query block, row tile)
// pair, in every form.
//
// Left for later: all 256 threads on the k <= 16 selection, a list in
// shared memory for moderate k, and a bf16 tile wider than 128 rows (fewer
// query re-reads per row).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stripe_knn.cuh"
#include "wgmma_tile.cuh"

namespace tile_knn {

using stripe_knn::cp_async16;
using stripe_knn::cp_async_commit;
using stripe_knn::cp_async_wait;
using stripe_knn::insert_row;
using stripe_knn::kScanSentinelKey;
using stripe_knn::kSentinelKey;
using stripe_knn::pack_key;
using stripe_knn::scan_key;

enum Form { kExact = 0, kFast = 1, kBf16 = 2 };

constexpr int kThreads = 256;
constexpr int kTile = 128;   // queries per block, and train rows per tile
constexpr int kChunk = 16;   // features staged per step (exact and fast)
// A chunk of one operand in shared memory: [kChunk][kTile] floats, each
// feature's 128 queries or rows one contiguous 512-byte run, as cp.async
// copies it from the feature-major operand. The float4 loads of the inner
// loop read it without bank conflicts (see the kernel).
constexpr int kChunkFloats = kChunk * kTile;
// Stages of the ring: chunk c + 1 is copied while chunk c is multiplied.
constexpr int kStages = 2;
constexpr size_t kRingBytes = size_t(kStages) * 2 * kChunkFloats * sizeof(float);
// 16-byte copies of one operand's chunk per thread.
constexpr int kCopiesPerThread = kChunkFloats / 4 / kThreads;
static_assert(kCopiesPerThread * 4 * kThreads == kChunkFloats,
              "the threads copy a chunk in whole rounds");
// Pitch of the distance tile: odd, so one query per thread reads one bank.
constexpr int kDistPitch = kTile + 1;
constexpr size_t kDistBytes = kTile * kDistPitch * sizeof(float);
// The ring and the distance tile share their shared memory: the ring holds
// a tile's chunks while it is multiplied, the distance tile its finished
// distances while they are selected.
constexpr size_t kSmemBytes = kDistBytes;
static_assert(kRingBytes <= kDistBytes, "the ring fits in the distance tile");
// The K of the k > 16 selection, and its extra shared memory: a candidate
// buffer of kTile keys per warp and a threshold key per query.
constexpr int kLargeK = 0;
constexpr int kWarps = kThreads / 32;
constexpr size_t kLargeExtraBytes = (kWarps * kTile + kTile) * sizeof(uint64_t);
// The bf16 kernel: the ring of wgmma_tile.cuh, then the distance tile.
constexpr size_t kBf16SmemBytes = wgmma_tile::kRingSmemBytes + kDistBytes;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint64_t kNoKey = ~uint64_t(0);  // pads the bitonic network
static_assert(wgmma_tile::kConsumerThreads == kThreads &&
                  wgmma_tile::kTileM == kTile && wgmma_tile::kTileN == kTile,
              "the bf16 kernel's consumers run the same selection");

// Slot `a` (0..7) of a thread's 8 queries or rows: 4*g + a for a < 4, then
// the same 64 further on, so that neighbouring threads load neighbouring
// float4s without bank conflicts.
__device__ __forceinline__ int slot(int a, int g) {
  return (a >> 2) * 64 + 4 * g + (a & 3);
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

// Sort buf[0..n) ascending, n <= kTile, with the warp: a bitonic network
// over the next power of two, the tail padded with kNoKey.
__device__ __forceinline__ void warp_sort(uint64_t* buf, int n, int lane) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + lane; i < p; i += 32) buf[i] = kNoKey;
  __syncwarp();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < p / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const uint64_t a = buf[i], b = buf[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[i + stride] = a;
        }
      }
      __syncwarp();
    }
  }
}

// How many of the sorted c[0..n) lie below x.
__device__ __forceinline__ int count_below(const uint64_t* c, int n,
                                           uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Fold the sorted candidates c[0..n), n >= 1, each below list[k-1], into the
// sorted list[0..k), keeping its k smallest keys; returns the new list[k-1]
// to every lane. Keys are unique, so each key's new slot is its rank: a
// list key at j has j + (candidates below it) keys before it, and the
// candidates between list[j-1] and list[j] follow each other from j +
// (candidates below list[j-1]). The warp walks the list 32 keys at a time
// from the top: every slot it writes lies at or above the chunk it reads,
// so no key is overwritten before it is read, and the walk stops at the
// first chunk below which no candidate falls.
__device__ uint64_t fold_into_list(uint64_t* list, int k, const uint64_t* c,
                                   int n, int lane) {
  uint64_t last = 0;
  bool wrote_last = false;
  for (int j0 = (k - 1) & ~31; j0 >= 0; j0 -= 32) {
    const int j = j0 + lane;
    const uint64_t key = j < k ? list[j] : kNoKey;
    const int below = j < k ? count_below(c, n, key) : n;
    int before = __shfl_up_sync(kFullMask, below, 1);
    if (lane == 0) before = j0 > 0 ? count_below(c, n, list[j0 - 1]) : 0;
    const bool done = __shfl_sync(kFullMask, before, 0) == 0;
    __syncwarp();
    if (j < k) {
      if (j + below < k) list[j + below] = key;
      if (j + below == k - 1) {
        last = key;
        wrote_last = true;
      }
      for (int i = before; i < below && i + j < k; ++i) {
        list[i + j] = c[i];
        if (i + j == k - 1) {
          last = c[i];
          wrote_last = true;
        }
      }
    }
    __syncwarp();
    if (done) break;
  }
  const unsigned who = __ballot_sync(kFullMask, wrote_last);
  return __shfl_sync(kFullMask, last, __ffs(who) - 1);
}

// The selection of one block's 128 queries against one split, run by the
// block's first 256 threads (8 warps) in both scan kernels: begin(), then
// add() for each tile's distances in shared memory (after a barrier of the
// 256), then end().
template <int K>
struct Selection {
  uint64_t list[K > 0 ? K : 1];  // K <= 16: thread tid's query's list
  uint64_t* rows_out;            // the block's first query's output row
  size_t q_stride;               // between queries' output rows
  uint64_t* cbuf;                // kLargeK: this warp's candidates
  uint64_t* thresh;              // kLargeK: each query's list[k-1]
  int k, q_rows, tid;

  // `large` is the kLargeExtraBytes of shared memory of the k > 16 path.
  __device__ __forceinline__ Selection(uint64_t* partial, int q0, int k_,
                                       int q_rows_, uint64_t* large)
      : rows_out(partial + (size_t(q0) * gridDim.y + blockIdx.y) * k_),
        q_stride(size_t(gridDim.y) * k_),
        cbuf(large + (threadIdx.x / 32) * kTile),
        thresh(large + kWarps * kTile),
        k(k_),
        q_rows(q_rows_),
        tid(threadIdx.x) {}

  __device__ __forceinline__ void begin() {
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) list[j] = kScanSentinelKey;
    } else {
      const int warp = tid / 32, lane = tid % 32;
      for (int qi = warp; qi < q_rows; qi += kWarps) {
        for (int j = lane; j < k; j += 32) rows_out[qi * q_stride + j] = kSentinelKey;
        if (lane == 0) thresh[qi] = kSentinelKey;
      }
    }
  }

  // The tile's rows t0..t0+rows-1: dist_s[q * kDistPitch + r]. Columns
  // past `rows` hold the zero fill and are never selected.
  __device__ __forceinline__ void add(const float* dist_s, int rows, int t0) {
    if constexpr (K > 0) {
      if (tid < q_rows) {
        const float* row = dist_s + tid * kDistPitch;
        for (int r = 0; r < rows; ++r) insert_row<K>(list, row[r], t0 + r);
      }
    } else {
      const int warp = tid / 32, lane = tid % 32;
      for (int qi = warp; qi < q_rows; qi += kWarps) {
        const float* row = dist_s + qi * kDistPitch;
        const uint64_t limit = thresh[qi];
        int n = 0;
#pragma unroll
        for (int m = 0; m < kTile / 32; ++m) {
          const int r = lane + 32 * m;
          const uint64_t key = r < rows ? pack_key(row[r], t0 + r) : kNoKey;
          const bool pass = key < limit;
          const unsigned ball = __ballot_sync(kFullMask, pass);
          if (pass) cbuf[n + __popc(ball & ((1u << lane) - 1))] = key;
          n += __popc(ball);
        }
        if (n == 0) continue;
        warp_sort(cbuf, n, lane);
        const uint64_t last = fold_into_list(rows_out + qi * q_stride, k, cbuf, n, lane);
        if (lane == 0) thresh[qi] = last;
        __syncwarp();
      }
    }
  }

  __device__ __forceinline__ void end() {
    if constexpr (K > 0) {
      if (tid < q_rows) {
#pragma unroll
        for (int j = 0; j < K; ++j) rows_out[tid * q_stride + j] = scan_key(list[j]);
      }
    }
  }
};

template <int F, int K>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const float* __restrict__ train_t, int n_pad,
                 const float* __restrict__ t2, int n_valid,
                 const float* __restrict__ test_t, int q_pad,
                 const float* __restrict__ q2, int n_queries, int d, int k,
                 int rows_per_split, uint64_t* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;    // [kStages][2][kChunkFloats], while multiplying
  float* dist_s = smem;  // [kTile][kDistPitch], while selecting

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // row group
  const int ty = tid / 16;  // query group
  const int q0 = blockIdx.x * kTile;
  const int q_rows = min(kTile, n_queries - q0);
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, n_valid);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + kTile - 1) / kTile : 0;
  const int n_chunks = max(1, (d + kChunk - 1) / kChunk);

  // Step s of the block (tile s / n_chunks, chunk s % n_chunks) into stage
  // s % kStages: the chunk's kChunk feature runs of the 128 queries and of
  // the tile's 128 rows, 16 bytes a copy. Features at or past d, and rows
  // at or past r_end, are zero-filled: a zero feature adds exactly 0 in
  // both forms, and those rows are never selected.
  auto issue = [&](int s) {
    const int i = s / n_chunks;
    const int f0 = (s - i * n_chunks) * kChunk;
    const int t0 = r_begin + i * kTile;
    float* q_dst = ring + (s % kStages) * 2 * kChunkFloats;
    float* t_dst = q_dst + kChunkFloats;
#pragma unroll
    for (int j = 0; j < kCopiesPerThread; ++j) {
      const int p = tid + j * kThreads;
      const int f = p / (kTile / 4);
      const int c = (p % (kTile / 4)) * 4;
      const bool feature = f0 + f < d;
      const bool row = feature && t0 + c < r_end;
      cp_async16(q_dst + f * kTile + c,
                 feature ? test_t + size_t(f0 + f) * q_pad + q0 + c : test_t,
                 feature);
      cp_async16(t_dst + f * kTile + c,
                 row ? train_t + size_t(f0 + f) * n_pad + t0 + c : train_t, row);
    }
  };

  float qn[8] = {};
  if constexpr (F != kExact) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (slot(a, ty) < q_rows) qn[a] = q2[q0 + slot(a, ty)];
    }
  }
  Selection<K> sel(partial, q0, k, q_rows,
                   reinterpret_cast<uint64_t*>(dist_s + kTile * kDistPitch));
  sel.begin();

  int s = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = r_begin + i * kTile;
    const int rows = min(kTile, r_end - t0);
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
    }
    __syncthreads();  // the previous tile's selection is done with dist_s
    issue(s);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c, ++s) {
      cp_async_wait<0>();
      // Step s has landed for every thread, and every thread is done with
      // step s - 1, so its stage can take step s + 1.
      __syncthreads();
      if (c + 1 < n_chunks) issue(s + 1);
      cp_async_commit();
      const float* q_s = ring + (s % kStages) * 2 * kChunkFloats;
      const float* t_s = q_s + kChunkFloats;
#pragma unroll
      for (int f = 0; f < kChunk; ++f) {
        // A warp's threads read two query float4s (broadcast) and sixteen
        // consecutive row float4s: conflict-free.
        const float* qf = q_s + f * kTile;
        const float* tf = t_s + f * kTile;
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
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        dist_s[slot(a, ty) * kDistPitch + slot(b, tx)] =
            finish<F>(acc[a][b], qn[a], tn[b]);
      }
    }
    __syncthreads();
    sel.add(dist_s, rows, t0);
  }
  sel.end();
}

// The bf16 form: the cross term of wgmma_tile.cuh's mainloop over the
// [rows, d_pad] bfloat16 operands behind t_map and q_map, then finish<kBf16>
// and the selection of the CUDA-core forms.
template <int K>
__global__ void __launch_bounds__(wgmma_tile::kThreads, 1)
tile_scan_bf16_kernel(const __grid_constant__ CUtensorMap t_map,
                      const float* __restrict__ t2, int n_valid,
                      const __grid_constant__ CUtensorMap q_map,
                      const float* __restrict__ q2, int n_queries, int d_pad,
                      int k, int rows_per_split,
                      uint64_t* __restrict__ partial) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const wgmma_tile::Ring ring = wgmma_tile::make_ring(smem_raw);
  float* dist_s = reinterpret_cast<float*>(ring.extra);  // [kTile][kDistPitch]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const int q_rows = min(kTile, n_queries - q0);
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, n_valid);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + kTile - 1) / kTile : 0;
  const int n_chunks = d_pad / wgmma_tile::kChunk;
  if (tid >= wgmma_tile::kConsumerThreads) {
    if (tid == wgmma_tile::kConsumerThreads) {
      wgmma_tile::produce(ring, &q_map, &t_map, q0, r_begin, n_tiles, n_chunks);
    }
    return;
  }

  Selection<K> sel(partial, q0, k, q_rows,
                   reinterpret_cast<uint64_t*>(dist_s + kTile * kDistPitch));
  sel.begin();
  // This thread's accumulator rows (queries) qr and qr + 8; its columns
  // (train rows of the tile) 8j + 2(lane % 4) + h.
  const int wg = tid / 128, lane = tid % 32;
  const int qr = wg * wgmma_tile::kWgRows + ((tid % 128) / 32) * 16 + lane / 4;
  const float qa = qr < q_rows ? q2[q0 + qr] : 0.0f;
  const float qb = qr + 8 < q_rows ? q2[q0 + qr + 8] : 0.0f;
  wgmma_tile::Consumer consumer;
  float acc[64] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = r_begin + i * kTile;
    const int rows = min(kTile, r_end - t0);
    consumer.tile(ring, acc, wg, n_chunks);
    wgmma_tile::sync_consumers();  // the previous tile's selection is done
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * (lane % 4) + h;
        const float tn = c < rows ? __ldg(t2 + t0 + c) : 0.0f;
        dist_s[qr * kDistPitch + c] = finish<kBf16>(acc[4 * j + h], qa, tn);
        dist_s[(qr + 8) * kDistPitch + c] =
            finish<kBf16>(acc[4 * j + 2 + h], qb, tn);
      }
    }
    wgmma_tile::sync_consumers();
    sel.add(dist_s, rows, t0);
  }
  sel.end();
}

template <int F, int K>
cudaError_t launch_scan(const float* train_t, int n_pad, const float* t2,
                        int n_valid, const float* test_t, int q_pad,
                        const float* q2, int n_queries, int d, int k,
                        int n_splits, int rows_per_split, uint64_t* partial,
                        cudaStream_t stream) {
  if (rows_per_split % stripe_knn::kSplitAlign != 0 ||
      n_pad % stripe_knn::kRowGranule != 0 || q_pad % kTile != 0 ||
      q_pad < n_queries) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = kSmemBytes + (K > 0 ? 0 : kLargeExtraBytes);
  cudaError_t err = cudaFuncSetAttribute(
      tile_scan_kernel<F, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_queries + kTile - 1) / kTile, n_splits);
  tile_scan_kernel<F, K><<<grid, kThreads, smem, stream>>>(
      train_t, n_pad, t2, n_valid, test_t, q_pad, q2, n_queries, d, k,
      rows_per_split, partial);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_bf16(const void* train, int n_rows, const float* t2,
                        int n_valid, const void* test, const float* q2,
                        int n_queries, int d_pad, int k, int n_splits,
                        int rows_per_split, uint64_t* partial,
                        cudaStream_t stream) {
  CUtensorMap t_map, q_map;
  cudaError_t err = wgmma_tile::encode_operand(&t_map, train, n_rows, d_pad);
  if (err != cudaSuccess) return err;
  err = wgmma_tile::encode_operand(&q_map, test, n_queries, d_pad);
  if (err != cudaSuccess) return err;
  const size_t smem = kBf16SmemBytes + (K > 0 ? 0 : kLargeExtraBytes);
  err = cudaFuncSetAttribute(tile_scan_bf16_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_queries + kTile - 1) / kTile, n_splits);
  tile_scan_bf16_kernel<K><<<grid, wgmma_tile::kThreads, smem, stream>>>(
      t_map, t2, n_valid, q_map, q2, n_queries, d_pad, k, rows_per_split,
      partial);
  return cudaGetLastError();
}

}  // namespace tile_knn

// Launch the exact (form 0) or fast (form 1) tile scan on `stream`; returns
// the CUDA status (0 = launched). `train_t` [d, n_pad] and `test_t`
// [d, q_pad] are the feature-major float32 operands (ops/cuda_knn.py::
// feature_major: n_pad a multiple of kRowGranule, q_pad a multiple of 128
// and at least n_queries, zeros past the true rows). The caller validates
// shapes (k >= 1, n_queries >= 1, 0 <= n_valid <= N, n_splits *
// rows_per_split >= n_valid, rows_per_split a multiple of kSplitAlign),
// passes the [n_queries] and [N] float32 norms for the fast form (null for
// exact), and allocates `partial` as [n_queries, n_splits, k] uint64.
extern "C" int tile_knn_scan(int form, const void* train_t, int n_pad,
                             const void* t2, int n_valid, const void* test_t,
                             int q_pad, const void* q2, int n_queries, int d,
                             int k, int n_splits, int rows_per_split,
                             void* partial, void* stream) {
  using namespace tile_knn;
  const auto* trainf = static_cast<const float*>(train_t);
  const auto* t2f = static_cast<const float*>(t2);
  const auto* testf = static_cast<const float*>(test_t);
  const auto* q2f = static_cast<const float*>(q2);
  auto* out = static_cast<uint64_t*>(partial);
  auto* s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kc) -> cudaError_t {
    constexpr int K = decltype(kc)::value;
    switch (form) {
      case kExact:
        return launch_scan<kExact, K>(trainf, n_pad, t2f, n_valid, testf,
                                      q_pad, q2f, n_queries, d, k, n_splits,
                                      rows_per_split, out, s);
      case kFast:
        return launch_scan<kFast, K>(trainf, n_pad, t2f, n_valid, testf,
                                     q_pad, q2f, n_queries, d, k, n_splits,
                                     rows_per_split, out, s);
      default:
        return cudaErrorInvalidValue;
    }
  };
  if (k > stripe_knn::kMaxRegisterK) {
    return int(run(std::integral_constant<int, kLargeK>{}));
  }
  return int(stripe_knn::with_register_k(k, run));
}

// Launch the bf16 tile scan on `stream`: `train` [n_rows, d_pad] and `test`
// [n_queries, d_pad] bfloat16, d_pad a multiple of 64, zero past the true
// features, 16-byte aligned; `t2` [n_rows] and `q2` [n_queries] the float32
// norms; otherwise as tile_knn_scan. Returns the CUDA status (0 =
// launched).
extern "C" int tile_knn_scan_bf16(const void* train, int n_rows, const void* t2,
                                  int n_valid, const void* test, const void* q2,
                                  int n_queries, int d_pad, int k, int n_splits,
                                  int rows_per_split, void* partial,
                                  void* stream) {
  using namespace tile_knn;
  auto run = [&](auto kc) -> cudaError_t {
    constexpr int K = decltype(kc)::value;
    return launch_bf16<K>(train, n_rows, static_cast<const float*>(t2), n_valid,
                          test, static_cast<const float*>(q2), n_queries, d_pad,
                          k, n_splits, rows_per_split,
                          static_cast<uint64_t*>(partial),
                          static_cast<cudaStream_t>(stream));
  };
  if (k > stripe_knn::kMaxRegisterK) {
    return int(run(std::integral_constant<int, kLargeK>{}));
  }
  return int(stripe_knn::with_register_k(k, run));
}
