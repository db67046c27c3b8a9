// Fused AdaLN-modulate for Hopper (sm_90a): K3 and K4.
//
// Replaces the Pallas kernels of opendwm_tpu/ops/fused_adaln.py:
// - K3 _forward (:45, body _kernel :24): y = LN(x) * (1 + scale) + shift;
// - K4 _res_forward (:133, body _res_kernel :107): x' = x + gate * delta and
//   y = LN(x') * (1 + scale) + shift, both written.
// LN has no affine, eps 1e-6 by default; its statistics are fp32, the mean
// first and then the centred variance. K4 normalises the fp32 sum, not the
// sum rounded to x's type, as _res_kernel does. x (and delta) are (n, L, d)
// rows; scale, shift and gate are one d-vector a sample, read at a
// per-sample stride (the model's modulation vectors are chunks of an
// (n, 9d) output).
//
// What bounds it. About 2 fp32 operations a byte, far under the ~20 a byte
// at which the card's fp32 units would be the limit: the kernel is bound by
// device-memory bytes, x (and delta) read once and y (and x') written once.
// The TPU kernel tiled block_l rows of any width into VMEM; on Hopper the
// only gain is in moving each byte once with enough bytes in flight, which
// registers limit when each warp loads its own row.
//
// Design: a ring of 1-D bulk copies, compiled for each width of
// RingWidths (d 1024, the LiDAR DiT's 16 x 64 heads; d 1536, the 24 x 64
// of CTSD-3.5, UniMLVG and the layout flagship: every DiT config the port
// builds at full width). Rows reach shared memory by 1-D bulk copies
// (cp.async.bulk with an mbarrier's transaction count), so the bytes in
// flight cost no registers: persistent blocks, each over a contiguous run
// of tiles; a tile is one row for each of 8 consumer warps (4 in fp32) of
// one sample, with that sample's vectors. One producer thread issues the
// loads of a tile (x, delta, the vectors) and, once the consumers have
// released a stage, the bulk stores of its outputs from the stage. A
// consumer warp holds its row in registers as fp32 (d / 32 values a lane:
// 32 at d 1024, 48 at d 1536; read as conflict-free 16-byte pieces), takes
// mean and variance with __shfl_xor_sync within the warp (no
// __syncthreads), and writes y over x and x' over delta in the stage. x' is
// __fadd_rn(x, __fmul_rn(gate, delta)), with no FMA contraction, so that it
// equals the plain PyTorch version (x.float() + gate * delta.float(), then
// rounded to x's type) bit for bit. The width is a template parameter:
// the loads a lane makes, the stage layout, the bytes of each copy and the
// register row follow from it, and so do the blocks an SM and the stages
// (StreamCfg), by one rule: the most blocks, up to kRingMaxBlocks, whose
// 3-stage rings fit in the SM's 228 KB (less 1 KB a block that the card
// keeps); a block alone takes up to 4 stages. A stage is, in bf16 and
// fp16, 30 KB (K3) and 57 KB (K4) at d 1536, 20 KB and 38 KB at d 1024;
// in fp32 36 / 66 KB and 24 / 44 KB. So K4 runs one block an SM at every
// width (3 stages at d 1536, 4 at d 1024), and K3 two at d 1536, where a
// third does not fit, and three at d 1024 (kRingMaxBlocks): there three
// measured faster than two at (12, 1600, 1024) and no slower at
// (24, 1600, 1024), in one run of perf/adaln_ab.py against a copy of this
// source with two, with 64 registers a thread under the 72 that three
// blocks leave (PERF.md, section 6). Why bulk copies: a warp per row
// with the row and the next row in registers (loads from global, the
// vectors in shared memory as fp32) measured slower at 6 of the 8 d-1536
// path shapes; and why each stage copies its vectors: skipping them when a
// stage's last tile was of the same sample measured the same (PERF.md,
// section 6).
// Every other width or alignment runs a runtime-width kernel, a warp a row
// that streams the row three times (sum, centred squares, output; L1 serves
// the second and third) and reads the vectors from global memory: the
// synthetic configs' d 32, the tests' odd widths, rows that are not 16-byte
// aligned. Which one runs is the caller's choice (fused_adaln.instance) and
// is checked here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarrier helpers

namespace {

// The most blocks of the ring on an SM (StreamCfg).
constexpr int kRingMaxBlocks = 3;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;               // runtime-width kernel
constexpr int kRows = kWarps * kRowsPerWarp;  // rows of one sample a block

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Args {
  const void* x;
  const void* delta;  // K4 only
  const void* gate;   // K4 only
  const void* scale;
  const void* shift;
  void* xo;  // K4: x'
  void* out;
  int n, l, d;
  long long gate_stride, scale_stride, shift_stride;  // elements a sample
  float eps;
  int mod_dtype;  // one Dtype for scale, shift and gate
};

// A value of the row type to fp32 and back (round to nearest even).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// A 32-bit word of the row type: its values as fp32, and back.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kN = 1;
  static __device__ __forceinline__ void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    return __float_as_uint(v[0]);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kN = 2;
  static __device__ __forceinline__ void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[0]))) |
           static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[1])))
               << 16;
  }
};
template <>
struct Word<__half> {
  static constexpr int kN = 2;
  static __device__ __forceinline__ void unpack(uint32_t w, float* v) {
    v[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
    v[1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
  }
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(v[0]))) |
           static_cast<uint32_t>(__half_as_ushort(__float2half_rn(v[1]))) << 16;
  }
};

// 16 bytes of the row type (4 words) as fp32 values, and back.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* v) {
  constexpr int k = Word<T>::kN;
  Word<T>::unpack(u.x, v);
  Word<T>::unpack(u.y, v + k);
  Word<T>::unpack(u.z, v + 2 * k);
  Word<T>::unpack(u.w, v + 3 * k);
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v) {
  constexpr int k = Word<T>::kN;
  return make_uint4(Word<T>::pack(v), Word<T>::pack(v + k),
                    Word<T>::pack(v + 2 * k), Word<T>::pack(v + 3 * k));
}

// Element i of a modulation vector of type `code`, as fp32.
__device__ __forceinline__ float load_mod(const void* p, long long i,
                                          int code) {
  if (code == kF32) return static_cast<const float*>(p)[i];
  if (code == kBF16) return to_f32(static_cast<const __nv_bfloat16*>(p)[i]);
  return to_f32(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The block's sample and first row: blocks run over (sample, run of kRows
// rows), the samples outermost.
struct RowRun {
  int sample, row0;
  __device__ explicit RowRun(int l) {
    const int runs = (l + kRows - 1) / kRows;
    sample = blockIdx.x / runs;
    row0 = (blockIdx.x % runs) * kRows;
  }
};

// ---------------------------------------------------------------------------
// The ring: rows arrive in shared memory by 1-D bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// A tile is one row of width D of one sample for each consumer warp; a
// stage of the ring holds a tile of x (and delta) and the sample's vectors,
// in T.
template <typename T, bool kResidual, int D>
struct StreamCfg {
  static constexpr int kConsumers = sizeof(T) == 4 ? 4 : 8;
  static constexpr int kThreads = 32 * (kConsumers + 1);  // + a producer warp
  static constexpr uint32_t kRowBytes = D * sizeof(T);
  static_assert(kRowBytes % (32 * 16) == 0,
                "a row is whole 16-byte pieces for each of 32 lanes");
  static constexpr uint32_t kX = 0;
  static constexpr uint32_t kDelta = kConsumers * kRowBytes;
  static constexpr uint32_t kVecs =
      kDelta + (kResidual ? kConsumers * kRowBytes : 0);  // scale, shift, gate
  static constexpr uint32_t kStage = kVecs + (kResidual ? 3 : 2) * kRowBytes;
  // The most blocks an SM, up to kRingMaxBlocks, whose 3-stage rings fit
  // in the SM's 228 KB (less 1 KB a block that the card keeps); a block
  // alone takes up to 4 stages.
  static constexpr int kFit = (228 * 1024) / (128 + 3 * kStage + 1024);
  static constexpr int kBlocks =
      kFit < 1 ? 1 : (kFit < kRingMaxBlocks ? kFit : kRingMaxBlocks);
  static constexpr int kStages =
      kBlocks >= 2 ? 3
                   : ((200 * 1024) / kStage < 4 ? (200 * 1024) / kStage : 4);
  static constexpr uint32_t kSmem = 128 + kStages * kStage;
  static_assert(kStages >= 2, "a ring of at least two stages");
};

template <typename T, bool kResidual, int D>
__global__ void __launch_bounds__(StreamCfg<T, kResidual, D>::kThreads,
                                  StreamCfg<T, kResidual, D>::kBlocks)
    adaln_stream_kernel(Args a) {
  using C = StreamCfg<T, kResidual, D>;
  constexpr int kPer = 4 * Word<T>::kN;
  constexpr int kLoads = D / (32 * kPer);
  constexpr int kVals = kLoads * kPer;
  constexpr int S = C::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = sm90::smem_addr(smem);  // full[S], then empty[S]
  const uint32_t ring = bars + 128;
  unsigned char* ring_ptr = smem + 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int per_sample = (a.l + C::kConsumers - 1) / C::kConsumers;
  const long long total = static_cast<long long>(a.n) * per_sample;
  const long long first = total * blockIdx.x / gridDim.x;
  const int count = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x -
                                     first);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  // Tile t: its sample, its first row and its rows.
  auto tile = [&](long long t, int& sample, int& row0, int& rows) {
    sample = static_cast<int>(t / per_sample);
    row0 = static_cast<int>(t % per_sample) * C::kConsumers;
    rows = min(C::kConsumers, a.l - row0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kConsumers) {  // the producer: one thread loads and stores
    if (lane != 0) return;
    auto store = [&](int i) {  // tile i's outputs, out of its stage
      int sample, row0, rows;
      tile(first + i, sample, row0, rows);
      const long long off =
          (static_cast<long long>(sample) * a.l + row0) * D;
      const uint32_t st = ring + (i % S) * C::kStage;
      bulk_store(static_cast<T*>(a.out) + off, st + C::kX, rows * C::kRowBytes);
      if constexpr (kResidual)
        bulk_store(static_cast<T*>(a.xo) + off, st + C::kDelta,
                   rows * C::kRowBytes);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    };
    for (int i = 0; i < count; ++i) {
      const int s = i % S;
      if (i >= S) {
        sm90::mbar_wait(empty(s), ((i / S) - 1) & 1);
        store(i - S);
      }
      int sample, row0, rows;
      tile(first + i, sample, row0, rows);
      const long long off =
          (static_cast<long long>(sample) * a.l + row0) * D;
      const uint32_t st = ring + s * C::kStage;
      const uint32_t row_bytes = rows * C::kRowBytes;
      sm90::mbar_expect_tx(full(s), row_bytes * (kResidual ? 2 : 1) +
                                        (kResidual ? 3 : 2) * C::kRowBytes);
      bulk_load(st + C::kX, static_cast<const T*>(a.x) + off, row_bytes,
                full(s));
      if constexpr (kResidual)
        bulk_load(st + C::kDelta, static_cast<const T*>(a.delta) + off,
                  row_bytes, full(s));
      const long long smp = sample;
      bulk_load(st + C::kVecs,
                static_cast<const T*>(a.scale) + smp * a.scale_stride,
                C::kRowBytes, full(s));
      bulk_load(st + C::kVecs + C::kRowBytes,
                static_cast<const T*>(a.shift) + smp * a.shift_stride,
                C::kRowBytes, full(s));
      if constexpr (kResidual)
        bulk_load(st + C::kVecs + 2 * C::kRowBytes,
                  static_cast<const T*>(a.gate) + smp * a.gate_stride,
                  C::kRowBytes, full(s));
    }
    for (int i = count > S ? count - S : 0; i < count; ++i) {
      sm90::mbar_wait(empty(i % S), (i / S) & 1);
      store(i);
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // A consumer warp: row `warp` of each tile, read from and written back to
  // the stage (y over x, x' over delta), then released to the producer.
  for (int i = 0; i < count; ++i) {
    const int s = i % S;
    sm90::mbar_wait(full(s), (i / S) & 1);
    int sample, row0, rows;
    tile(first + i, sample, row0, rows);
    if (warp < rows) {
      unsigned char* st = ring_ptr + s * C::kStage;
      uint4* xs = reinterpret_cast<uint4*>(st + C::kX + warp * C::kRowBytes);
      uint4* ds = reinterpret_cast<uint4*>(st + C::kDelta + warp * C::kRowBytes);
      const uint4* sc = reinterpret_cast<const uint4*>(st + C::kVecs);
      const uint4* sh = sc + C::kRowBytes / 16;
      const uint4* sg = sh + C::kRowBytes / 16;
      float v[kVals];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) unpack16<T>(xs[j * 32 + lane], v + j * kPer);
      if constexpr (kResidual) {
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          float dv[kPer], g[kPer];
          unpack16<T>(ds[j * 32 + lane], dv);
          unpack16<T>(sg[j * 32 + lane], g);
#pragma unroll
          for (int c = 0; c < kPer; ++c)
            v[j * kPer + c] = __fadd_rn(v[j * kPer + c], __fmul_rn(g[c], dv[c]));
          ds[j * 32 + lane] = pack16<T>(v + j * kPer);
        }
      }
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kVals; ++k) sum += v[k];
      const float mean = warp_sum(sum) / D;
      float sq = 0.0f;
#pragma unroll
      for (int k = 0; k < kVals; ++k) {
        v[k] -= mean;
        sq += v[k] * v[k];
      }
      const float rstd = rsqrtf(warp_sum(sq) / D + a.eps);
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        float s1[kPer], b[kPer];
        unpack16<T>(sc[j * 32 + lane], s1);
        unpack16<T>(sh[j * 32 + lane], b);
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          v[j * kPer + c] = (v[j * kPer + c] * rstd) * (1.0f + s1[c]) + b[c];
        xs[j * 32 + lane] = pack16<T>(v + j * kPer);
      }
      sm90::fence_async_smem();  // the stores read the stage by bulk copy
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(s));
  }
}

// ---------------------------------------------------------------------------
// Any width and alignment: the row streamed three times
// ---------------------------------------------------------------------------

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads) adaln_any_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const RowRun run(a.l);
  const int d = a.d;
  const long long s = run.sample;
  for (int i = 0, r = run.row0 + warp; i < kRowsPerWarp && r < a.l;
       ++i, r += kWarps) {
    const long long base = (s * a.l + r) * d;
    const T* x = static_cast<const T*>(a.x) + base;
    const T* delta = static_cast<const T*>(a.delta) + base;
    auto value = [&](int e) -> float {  // x, or x + gate * delta
      if constexpr (kResidual)
        return __fadd_rn(to_f32(x[e]),
                         __fmul_rn(load_mod(a.gate, s * a.gate_stride + e,
                                            a.mod_dtype),
                                   to_f32(delta[e])));
      else
        return to_f32(x[e]);
    };
    float sum = 0.0f;
    for (int e = lane; e < d; e += 32) sum += value(e);
    const float mean = warp_sum(sum) / d;
    float sq = 0.0f;
    for (int e = lane; e < d; e += 32) {
      const float c = value(e) - mean;
      sq += c * c;
    }
    const float rstd = rsqrtf(warp_sum(sq) / d + a.eps);
    T* out = static_cast<T*>(a.out) + base;
    for (int e = lane; e < d; e += 32) {
      const float xn = value(e);
      if constexpr (kResidual) static_cast<T*>(a.xo)[base + e] = from_f32<T>(xn);
      const float s1 =
          1.0f + load_mod(a.scale, s * a.scale_stride + e, a.mod_dtype);
      const float sh = load_mod(a.shift, s * a.shift_stride + e, a.mod_dtype);
      out[e] = from_f32<T>(((xn - mean) * rstd) * s1 + sh);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kResidual, int D>
int launch_ring_at(const Args& a, cudaStream_t stream) {
  using C = StreamCfg<T, kResidual, D>;
  static bool configured = false;  // the ring needs > 48 KB of shared memory
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        adaln_stream_kernel<T, kResidual, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long tiles =
      static_cast<long long>(a.n) * ((a.l + C::kConsumers - 1) / C::kConsumers);
  const long long slots = static_cast<long long>(sms) * C::kBlocks;
  const unsigned grid = static_cast<unsigned>(tiles < slots ? tiles : slots);
  adaln_stream_kernel<T, kResidual, D><<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widths the ring is compiled for: an instance of each, and the launch
// of the one of width a.d. The wrapper reads its list from the line of
// RingWidths (fused_adaln.RING_WIDTHS).
template <int... Ds>
struct Widths {
  static bool has(int d) { return ((d == Ds) || ...); }
  template <typename T, bool kResidual>
  static int launch(const Args& a, cudaStream_t stream) {
    int rc = static_cast<int>(cudaErrorInvalidValue);
    (void)((a.d == Ds &&
            (rc = launch_ring_at<T, kResidual, Ds>(a, stream), true)) ||
           ...);
    return rc;
  }
};
using RingWidths = Widths<1024, 1536>;

template <typename T, bool kResidual>
int launch_typed(const Args& a, bool ring, cudaStream_t stream) {
  if (ring) return RingWidths::launch<T, kResidual>(a, stream);
  const dim3 grid(static_cast<unsigned>(a.n * ((a.l + kRows - 1) / kRows)));
  adaln_any_kernel<T, kResidual><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// `ring` asks for the ring: d one of its compiled widths, x, delta and the
// outputs 16-byte aligned, the vectors in x's type at 16-byte aligned
// addresses and strides. Else the runtime-width kernel, for any width and
// alignment.
template <bool kResidual>
int launch(const Args& a, int dtype, int ring, void* stream) {
  if (a.n < 0 || a.l < 0 || a.d <= 0 || dtype < kF32 || dtype > kF16 ||
      a.mod_dtype < kF32 || a.mod_dtype > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int size = dtype == kF32 ? 4 : 2;
  if (ring &&
      (!RingWidths::has(a.d) || !aligned16(a.x) || !aligned16(a.out) ||
       (kResidual && (!aligned16(a.delta) || !aligned16(a.xo))) ||
       a.mod_dtype != dtype || !aligned16(a.scale) || !aligned16(a.shift) ||
       (a.scale_stride * size) % 16 || (a.shift_stride * size) % 16 ||
       (kResidual && (!aligned16(a.gate) || (a.gate_stride * size) % 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(a.n) * ((a.l + kRows - 1) / kRows) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0 || a.l == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_typed<float, kResidual>(a, ring, st);
  if (dtype == kBF16)
    return launch_typed<__nv_bfloat16, kResidual>(a, ring, st);
  return launch_typed<__half, kResidual>(a, ring, st);
}

}  // namespace

// K3: out = LN(x) * (1 + scale) + shift over rows of d; x and out contiguous
// (n, l, d) of `dtype` (0 fp32, 1 bf16, 2 fp16), scale and shift one
// d-vector a sample at the given per-sample strides (elements), of
// `mod_dtype`, contiguous along d. `ring` asks for the ring at a compiled
// width (launch() says what it needs). Returns a cudaError_t.
extern "C" int adaln_forward(const void* x, const void* scale,
                             const void* shift, void* out, int n, int l, int d,
                             long long scale_stride, long long shift_stride,
                             float eps, int dtype, int mod_dtype, int ring,
                             void* stream) {
  Args a{};
  a.x = x;
  a.scale = scale;
  a.shift = shift;
  a.out = out;
  a.n = n;
  a.l = l;
  a.d = d;
  a.scale_stride = scale_stride;
  a.shift_stride = shift_stride;
  a.eps = eps;
  a.mod_dtype = mod_dtype;
  return launch<false>(a, dtype, ring, stream);
}

// K4: xo = x + gate * delta (fp32, rounded once to `dtype`) and
// out = LN(x + gate * delta) * (1 + scale) + shift; delta and xo as x, gate
// as scale. `ring` as for adaln_forward.
extern "C" int residual_adaln_forward(
    const void* x, const void* delta, const void* gate, const void* scale,
    const void* shift, void* xo, void* out, int n, int l, int d,
    long long gate_stride, long long scale_stride, long long shift_stride,
    float eps, int dtype, int mod_dtype, int ring, void* stream) {
  Args a{};
  a.x = x;
  a.delta = delta;
  a.gate = gate;
  a.scale = scale;
  a.shift = shift;
  a.xo = xo;
  a.out = out;
  a.n = n;
  a.l = l;
  a.d = d;
  a.gate_stride = gate_stride;
  a.scale_stride = scale_stride;
  a.shift_stride = shift_stride;
  a.eps = eps;
  a.mod_dtype = mod_dtype;
  return launch<true>(a, dtype, ring, stream);
}

extern "C" const char* adaln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
