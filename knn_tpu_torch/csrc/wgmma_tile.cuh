// The tensor-core mainloop shared by the bf16 kernels (tile_knn.cu's bf16
// form, probe_matmul.cu): for a tile of 128 queries x 128 train rows, the
// float32 cross term sum_f q_f * t_f of bfloat16 operands, on Hopper's
// wgmma (sm_90a) fed by TMA.
//
// Layout. A block is two consumer warpgroups (warps 0-7, 256 threads) and
// one producer warp (warp 8). Features are staged in chunks of 64 bfloat16,
// 128 bytes a row, which TMA writes with the 128-byte swizzle that wgmma's
// K-major descriptors read. A stage holds the chunk of the block's 128
// queries and of the tile's 128 rows: 32 KB; kStages of them form a ring.
// Lane 0 of the producer warp walks every (tile, chunk) of the block in
// order and keeps the ring full: it waits for a stage's `empty` barrier,
// arms its `full` barrier with the stage's bytes and issues the two TMA
// loads. Each consumer warpgroup waits for `full`, issues four
// wgmma.mma_async m64n128k16 (its 64 queries against the 128 rows, 16
// features each), commits, and releases the previous chunk's stage once
// that chunk's group has completed (one group stays in flight).
//
// The operands are [rows, d_pad] bfloat16 in device memory, d_pad a
// multiple of 64 (the wrappers pad with zeros: a zero feature adds exactly
// 0), so every row stride is a multiple of 16 bytes as TMA needs. Rows past
// the end of an operand come from TMA's zero fill.
//
// The accumulator fragment (m64n128, 64 floats a thread): thread t of a
// warpgroup, warp w = t / 32, lane l, holds in acc[4j + h] the entry of
// query row 16w + l/4 and column 8j + 2(l%4) + h, and in acc[4j + 2 + h]
// that of row 16w + l/4 + 8, for j in 0..15 and h in 0..1.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wgmma_tile {

constexpr int kTileM = 128;   // queries per block: two warpgroups of 64
constexpr int kTileN = 128;   // train rows per tile
constexpr int kWgRows = 64;   // queries per warpgroup
constexpr int kChunk = 64;    // bf16 features per stage: one 128-byte row
constexpr int kRowBytes = kChunk * 2;
constexpr int kStages = 4;
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 32;  // and the producer warp
constexpr uint32_t kOperandBytes = kTileM * kRowBytes;  // == kTileN * kRowBytes
constexpr uint32_t kStageBytes = 2 * kOperandBytes;
// The ring and its barriers, with the slack to align the ring to the 1,024
// bytes the 128-byte swizzle repeats over; a kernel's own shared memory
// follows (Ring::extra).
constexpr size_t kRingSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

struct Ring {
  uint32_t base;     // shared address of stage 0: queries, then rows
  uint32_t full;     // shared address of full[0]; empty[s] follows full
  uint8_t* extra;    // generic pointer past the barriers, 8-byte aligned

  __device__ uint32_t queries(int s) const { return base + s * kStageBytes; }
  __device__ uint32_t rows(int s) const {
    return base + s * kStageBytes + kOperandBytes;
  }
  __device__ uint32_t full_bar(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full + 8 * (kStages + s); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Carve the ring out of the dynamic shared memory and, with thread 0,
// initialise its barriers: full[s] takes the producer's one arrival (and
// the TMA bytes), empty[s] one arrival per consumer warp. Every thread of
// the block calls it; it ends with __syncthreads.
__device__ __forceinline__ Ring make_ring(uint8_t* smem) {
  const uint32_t s0 = smem_addr(smem);
  const uint32_t pad = (1024 - (s0 & 1023)) & 1023;
  Ring ring;
  ring.base = s0 + pad;
  ring.full = ring.base + kStages * kStageBytes;
  ring.extra = smem + pad + kStages * kStageBytes + 2 * kStages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       ring.full_bar(s)), "r"(1) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       ring.empty_bar(s)), "r"(kConsumerWarps) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

__device__ __forceinline__ bool test_bar(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// About 10 s at the H100's clock: a phase that never completes (a fault in
// the pipeline) traps, so the launch fails instead of hanging the card.
constexpr long long kWaitLimitCycles = 20'000'000'000LL;

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  if (test_bar(bar, parity)) return;
  const long long start = clock64();
  while (!test_bar(bar, parity)) {
    if (clock64() - start > kWaitLimitCycles) __trap();
  }
}

__device__ __forceinline__ void arrive_bar(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The producer, lane 0 of warp 8: for each of n_tiles tiles of kTileN rows
// from row0 and each of n_chunks feature chunks, the queries' and the
// rows' chunk into the next stage.
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* q_map,
                                        const CUtensorMap* t_map, int q0,
                                        int row0, int n_tiles, int n_chunks) {
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    for (int c = 0; c < n_chunks; ++c) {
      wait_bar(ring.empty_bar(stage), phase ^ 1);  // the first round passes
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              ring.full_bar(stage)), "r"(kStageBytes) : "memory");
      tma_load(ring.queries(stage), q_map, ring.full_bar(stage), c * kChunk, q0);
      tma_load(ring.rows(stage), t_map, ring.full_bar(stage), c * kChunk,
               row0 + tile * kTileN);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A K-major operand with the 128-byte swizzle: rows of 128 bytes, 8-row
// groups 1,024 bytes apart (SBO); the leading offset is unused.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// acc = (scale_d ? acc : 0) + A B^T over 16 features: A the 64 query rows
// at desc_a, B the 128 train rows at desc_b, both K-major.
__device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a,
                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Keep the compiler from moving accesses of the accumulator across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wait_mma() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A consumer warpgroup's side of the ring: its position in the stages.
struct Consumer {
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ void release(const Ring& ring, int s) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) arrive_bar(ring.empty_bar(s));
  }

  // acc = the cross term of this warpgroup's 64 queries (warpgroup wg) and
  // the next tile's 128 rows, over its n_chunks >= 1 chunks.
  __device__ __forceinline__ void tile(const Ring& ring, float (&acc)[64],
                                       int wg, int n_chunks) {
    fence_acc(acc);
    int prev = -1;
    for (int c = 0; c < n_chunks; ++c) {
      wait_bar(ring.full_bar(stage), phase);
      const uint32_t a = ring.queries(stage) + wg * kWgRows * kRowBytes;
      const uint32_t b = ring.rows(stage);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        // 16 features are 32 bytes along the swizzled 128-byte row.
        mma(acc, descriptor(a + 32 * kk), descriptor(b + 32 * kk),
            (c | kk) != 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (prev >= 0) {
        wait_mma<1>();  // the previous chunk's products are done
        release(ring, prev);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wait_mma<0>();
    release(ring, prev);
    fence_acc(acc);
  }
};

// The consumers' own barrier (named barrier 1): the producer warp never
// joins it.
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime (the
// library is not linked against libcuda).
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a [rows, d_pad] bfloat16 operand (rows >= 1, d_pad a
// multiple of 64, 16-byte aligned), in boxes of 128 rows x 64 features with
// the 128-byte swizzle; rows past the end read as zeros.
inline cudaError_t encode_operand(CUtensorMap* map, const void* ptr, int rows,
                                  int d_pad) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (rows < 1 || d_pad < kChunk || d_pad % kChunk ||
      reinterpret_cast<uintptr_t>(ptr) % 16) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[2] = {cuuint64_t(d_pad), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(d_pad) * 2};
  const cuuint32_t box[2] = {kChunk, kTileM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wgmma_tile
