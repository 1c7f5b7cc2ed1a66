// Helpers shared by the KNN kernels (stripe_knn.cu, tile_knn.cu).
//
// A candidate is one packed 64-bit key: (float bits of the distance << 32)
// | train index. Distances are +0, positive or +inf once NaN has been mapped
// to +inf, and the bit pattern of such a float orders like the float, so the
// key's integer order IS the (distance, index) order with the lowest index
// winning a distance tie. One unsigned compare applies the whole tie rule.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace stripe_knn {

// A register list of k keys has exactly k entries, every index a
// compile-time constant, so it stays in registers; the kernels keep such
// lists for k <= kMaxRegisterK. Larger k take other designs (tile_knn.cu's
// threshold-filtered fold, stripe_knn.cu's warp merge).
constexpr int kMaxRegisterK = 16;
constexpr int kMaxD = 128;
// One query per thread: a block holds this many queries.
constexpr int kQueriesPerBlock = 128;
// Train rows the stripe scan stages per tile at d <= kWideD (and the split
// granule of ops/cuda_knn.py::split_plan); kTileRowsWide above it, so that
// two stages and the query block leave room for two blocks per SM.
constexpr int kTileRows = 128;
constexpr int kTileRowsWide = 32;
constexpr int kWideD = 64;
// Train rows each thread scores per pass over the features (four float4s).
constexpr int kRowsPerStep = 16;
// The rows of a feature-major operand (ops/cuda_knn.py::feature_major) come
// in multiples of kRowGranule, zero-filled past the matrix's own rows, so
// every feature's run of rows starts 16-byte aligned. A kernel's train
// splits start on multiples of kSplitAlign rows (16 bytes), so every run it
// copies does too.
constexpr int kRowGranule = 128;
constexpr int kSplitAlign = 4;

constexpr uint32_t kInfBits = 0x7f800000u;
constexpr uint32_t kIndexSentinel = 0x7fffffffu;  // INT32_MAX
// (+inf, INT32_MAX): what a row at or past n_valid counts as; it never wins.
constexpr uint64_t kSentinelKey = (uint64_t(kInfBits) << 32) | kIndexSentinel;

// NaN distance -> +inf, then pack with the train index.
__device__ __forceinline__ uint64_t pack_key(float dist, int index) {
  const uint32_t bits = isnan(dist) ? kInfBits : __float_as_uint(dist);
  return (uint64_t(bits) << 32) | uint32_t(index);
}

__device__ __forceinline__ float key_distance(uint64_t key) {
  return __uint_as_float(uint32_t(key >> 32));
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return int(uint32_t(key));
}

// Copy 16 bytes from device memory to shared memory asynchronously
// (cp.async, .cg: cached in L2 only), or write 16 zero bytes and read
// nothing when `fill` is false. Both addresses are 16-byte aligned; `src`
// is a valid address either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// Close the group of this thread's cp.async copies issued since the last.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight; a
// barrier after it makes every thread's landed copies visible to all.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The register lists' sentinel: above every distance's bits (+inf included)
// in the high word, so that a compare of the high words alone orders a row
// against it; written out as kSentinelKey (scan_key).
constexpr uint32_t kScanSentinelBits = kInfBits + 1;
constexpr uint64_t kScanSentinelKey =
    (uint64_t(kScanSentinelBits) << 32) | kIndexSentinel;

// Insert row `index` at distance `dist` into the ascending register list
// `list[0..K)` of a scan that visits its rows in ascending index order
// (NaN counts as +inf), dropping the largest key. Every key in the list
// then has a lower index, so a new key lies below a list key exactly when
// its distance bits do: one 32-bit compare per slot where the packed keys
// would take 64 bits, and a tie keeps the earlier row. A list starts as
// kScanSentinelKey. The stripe scan and the tile kernels' k <= 16
// selection (tile_knn.cu) insert with it.
template <int K>
__device__ __forceinline__ void insert_row(uint64_t (&list)[K], float dist,
                                           int index) {
  const uint32_t bits = isnan(dist) ? kInfBits : __float_as_uint(dist);
  if (bits < uint32_t(list[K - 1] >> 32)) {
    const uint64_t key = (uint64_t(bits) << 32) | uint32_t(index);
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const bool above = bits < uint32_t(list[j - 1] >> 32);
      const bool here = bits < uint32_t(list[j] >> 32);
      list[j] = above ? list[j - 1] : (here ? key : list[j]);
    }
    list[0] = bits < uint32_t(list[0] >> 32) ? key : list[0];
  }
}

// An entry of a register list as the packed key it stands for.
__device__ __forceinline__ uint64_t scan_key(uint64_t entry) {
  return uint32_t(entry >> 32) == kScanSentinelBits ? kSentinelKey : entry;
}

// f(std::integral_constant<int, K>{}) for the K == k in 1..kMaxRegisterK,
// so the register list's length is a compile-time constant.
template <int K = 1, typename F>
cudaError_t with_register_k(int k, F&& f) {
  if constexpr (K > kMaxRegisterK) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K) return f(std::integral_constant<int, K>{});
    return with_register_k<K + 1>(k, static_cast<F&&>(f));
  }
}

}  // namespace stripe_knn
