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

// The largest k any kernel takes. Up to kMaxRegisterK the key list has
// exactly k entries, every index a compile-time constant, so it stays in
// registers; above it the list is a bucket of 32, 64, 128 or 256 entries
// (with_k) indexed at run time, which the compiler places in local memory
// (per-thread, cached in L1), of which the first k are used.
constexpr int kMaxK = 256;
constexpr int kMaxRegisterK = 16;
constexpr int kMaxD = 128;
// One query per thread: a block holds this many queries.
constexpr int kQueriesPerBlock = 128;
// Train rows staged in shared memory per tile; a multiple of kRowsPerStep.
constexpr int kTileRows = 64;
// Train rows each thread scores per pass over the features (one float4).
constexpr int kRowsPerStep = 4;

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

// Insert `key` into the ascending register list `list[0..K)`, dropping the
// largest. Every index is a compile-time constant, so the list stays in
// registers. A key equal to one in the list goes after it (keys are unique
// per query except the +inf tail of a "lite" selection list, whose
// duplicates never reach a merged result).
template <int K>
__device__ __forceinline__ void insert_key(uint64_t (&list)[K], uint64_t key) {
  if (key < list[K - 1]) {
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const uint64_t prev = list[j - 1];
      list[j] = key < prev ? prev : (key < list[j] ? key : list[j]);
    }
    list[0] = key < list[0] ? key : list[0];
  }
}

// The used length of a list of K entries for a given k: K itself for a
// register list (K == k), k for a bucket.
template <int K>
__device__ __forceinline__ int list_length(int k) {
  if constexpr (K <= kMaxRegisterK) {
    return K;
  } else {
    return k;
  }
}

// Insert `key` into the ascending list `list[0..list_length<K>(k))`,
// dropping the largest: the unrolled register insert for K <= 16, else an
// insertion loop over the bucket's first k entries. A key equal to one in
// the list goes after it.
template <int K>
__device__ __forceinline__ void list_insert(uint64_t (&list)[K], int k,
                                            uint64_t key) {
  if constexpr (K <= kMaxRegisterK) {
    insert_key<K>(list, key);
  } else {
    if (key < list[k - 1]) {
      int j = k - 1;
      for (; j > 0 && key < list[j - 1]; --j) list[j] = list[j - 1];
      list[j] = key;
    }
  }
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

// with_register_k for k <= 16; above it f(std::integral_constant<int, K>{})
// for the smallest bucket K in {32, 64, 128, 256} that holds k.
template <typename F>
cudaError_t with_k(int k, F&& f) {
  if (k <= kMaxRegisterK) return with_register_k(k, f);
  if (k <= 32) return f(std::integral_constant<int, 32>{});
  if (k <= 64) return f(std::integral_constant<int, 64>{});
  if (k <= 128) return f(std::integral_constant<int, 128>{});
  if (k <= kMaxK) return f(std::integral_constant<int, kMaxK>{});
  return cudaErrorInvalidValue;
}

}  // namespace stripe_knn
