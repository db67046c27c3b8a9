// PTX building blocks of the Hopper (sm_90a) attention kernels, shared by
// the forward (flash_fwd_sm90.cuh) and the backward (flash_bwd_sm90.cuh):
// mbarriers, TMA loads and stores through 4-D tensor maps over BSHD bf16
// tensors with 64-wide heads (128-byte swizzle), wgmma descriptors and
// products, setmaxnreg, and the host side that encodes the maps.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace {
namespace sm90 {

constexpr int kD = 64;         // head dim
constexpr int kTileRows = 64;  // rows of a tile: queries or keys
constexpr uint32_t kTileBytes = kTileRows * kD * 2;  // 8 KB of bf16
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that never
// ends (a fault in the ring) traps, so the launch fails instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's generic shared-memory writes visible to the
// asynchronous proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a bf16 shared operand in the 128-byte-swizzled layout:
// start address, leading and stride byte offsets (16-byte units), swizzle
// mode 1 (128 B) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A K-major 64-row tile (rows of 64 head dims): 8-row groups 1024 bytes
// apart (the leading offset is unused with the swizzle); the k-th
// 16-column slice starts 32 bytes on, inside the swizzle atom.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int k) {
  return desc(tile + 32 * k, 16, 1024);
}

// A 64-row tile read MN-major (its rows are the K dimension, its 64
// columns M or N): the j-th 16-row slice is two 8-row groups, 1024 bytes
// apart, from row 16j. 64 columns are one swizzle atom wide, so the offset
// between atoms along M/N is never used; it is set equal to the other so
// that either reading of the fields holds.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int j) {
  return desc(tile + 2048 * j, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching an accumulator across the asynchronous
// product (reads are ordered after wgmma_wait by passing through this).
__device__ __forceinline__ void pin(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SM90_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_OUT32(d, c)                                                     \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),   \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),   \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]),           \
      c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]),           \
      c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])

// d = A B (kAccumulate false) or d += A B, m64n64k16, A and B in shared
// memory: K-major, or with kMnMajor both MN-major (the transpose bits).
template <bool kAccumulate, bool kMnMajor = false>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", %32, %33, p, 1, 1, %35, %35;\n}\n"
        : SM90_OUT32(d, "+f")
        : "l"(a), "l"(b), "n"(1), "n"(kMnMajor ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", %32, %33, p, 1, 1, %35, %35;\n}\n"
        : SM90_OUT32(d, "=f")
        : "l"(a), "l"(b), "n"(0), "n"(kMnMajor ? 1 : 0));
  }
}

// d += A B, m64n64k16, A (bf16 pairs) in registers, B MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_OUT32(d, "+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

#undef SM90_D32
#undef SM90_OUT32

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// x as lane 0 of the warp holds it: a value the compiler knows is the
// same across the warp. A warp's role branches on it, so ptxas does not
// take the role branch for a divergent path (on threadIdx.x itself it
// serialized the backward's wgmma, C7518).
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the MUFU unit, subnormal results flushed to 0 (exp2f would add
// instructions to keep them).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator (the C fragment of wgmma m64n64: per warp w,
// rows 16w + g and 16w + g + 8, columns 8n + 2t and 8n + 2t + 1 of each
// 8-column slice n, in d[4n + {0, 1}] and d[4n + {2, 3}]) as bf16 into a
// 64-row tile of 128-byte rows in the 128-byte-swizzled layout of TMA and
// wgmma: 16-byte chunk n of row r sits at chunk n ^ (r % 8).
__device__ __forceinline__ void store_tile_bf16(unsigned char* tile,
                                                const float (&d)[32],
                                                int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int off = row * 128 + ((n ^ (row & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(tile + off) =
          pack_bf16(d[4 * n + 2 * r], d[4 * n + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// The map of one BSHD bf16 tensor with 64-wide heads: dims (64, heads, seq,
// batch), box (64, 1, 64, 1), 128-byte swizzle, zero fill past the ends
// (a store drops the rows past the end).
inline bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                     int heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(kD) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), 1,
                             static_cast<cuuint32_t>(kTileRows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t addr = 0;
  for (const void* ptr : ptrs) addr |= reinterpret_cast<uintptr_t>(ptr);
  return addr % 16 == 0;
}

// Whether a launch runs a Hopper body (the forward's or the backward's):
// bf16 at head dim 64 with every tensor that TMA reads or writes 16-byte
// aligned (TMA's rule for a global address; the row strides, heads * 128
// bytes, always meet its 16-byte stride rule). The other launches (fp32,
// other head dims, unaligned pointers) keep the mma.sync or FMA bodies.
inline bool Sm90Takes(int is_bf16, int head_dim,
                      std::initializer_list<const void*> ptrs) {
  return is_bf16 && head_dim == kD && aligned16(ptrs);
}

}  // namespace sm90
}  // namespace
