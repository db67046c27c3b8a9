// Building blocks of the mma.sync and FMA attention bodies that serve the
// launches the Hopper kernels do not take (fp32, head dims other than 64,
// unaligned pointers) and K5/K6: the tile sizes, synchronous tile loads,
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and its fragments. Both
// sources include it, and flash_bwd.cuh builds the backward's bodies from
// it.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4. A (16x16): regs {0,1,2,3} hold rows {g, g+8, g, g+8},
// columns {2t, 2t+1} (+8 for regs 2, 3). B (16x8): regs {0,1} hold rows
// {2t, 2t+1} (+8 for reg 1) of column g. C (16x8, fp32): {c0, c1} are row
// g, columns 2t, 2t+1; {c2, c3} the same columns of row g+8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
using sm90::aligned16;
using sm90::kLog2e;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Copies rows [row0, row0 + ROWS) of one head of a BSHD tensor into a
// (ROWS, LD) shared tile, zero-filling rows >= seq and columns >= head_dim;
// the block's NT threads share the copy.
template <typename T, int DP, int LD, int ROWS = 64, int NT = kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          size_t base, size_t row_stride,
                                          int row0, int seq, int head_dim,
                                          bool vec, int tid) {
  constexpr int kPerVec = 16 / sizeof(T);
  if (vec) {  // 16-byte loads: head_dim % kPerVec == 0, pointers aligned
    constexpr int kChunks = DP / kPerVec;
    for (int i = tid; i < ROWS * kChunks; i += NT) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * kPerVec;
      const int s = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (s < seq && c < head_dim)
        val = *reinterpret_cast<const uint4*>(src + base + s * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - (i / DP) * DP;
      const int s = row0 + r;
      dst[r * LD + c] = (s < seq && c < head_dim)
                            ? src[base + s * row_stride + c]
                            : zero_value<T>();
    }
  }
}

// Whether key `col` is visible to query `row` (top-left causal mask).
template <bool kCausal>
__device__ __forceinline__ bool visible(int row, int col, int kv_seq) {
  return col < kv_seq && (!kCausal || col <= row);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 in shared memory as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  return pack_pair(__float2bfloat16(lo), __float2bfloat16(hi));
}

// A fragment (16 x 16 at column c0) of a warp's 16 rows in a shared tile.
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4],
                                          const __nv_bfloat16* rows, int ld,
                                          int c0, int g, int t) {
  const int c = c0 + 2 * t;
  a[0] = ld_pair(rows + g * ld + c);
  a[1] = ld_pair(rows + (g + 8) * ld + c);
  a[2] = ld_pair(rows + g * ld + c + 8);
  a[3] = ld_pair(rows + (g + 8) * ld + c + 8);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
