// Tail-masked attention forward for Hopper (sm_90a), BSHD layout.
//
// Replaces the Pallas kernel opendwm_tpu/ops/flash_tail.py:_forward
// (body _kernel). Same result: non-causal softmax(q k^T * scale) v with
// the softmax taken in fp32 over the S valid keys only, probabilities
// rounded to the input type before the product with v, output in the
// input type.
//
// Design. The TPU kernel padded S to a multiple of 128 on the host and
// kept the whole K/V of one head in VMEM. A Hopper SM has at most 227 KB
// of shared memory and the registers are the scarcer resource, so here one
// block of 4 warps owns 64 query rows of one (batch, head) and streams K/V
// through shared memory in 64-key tiles with an online softmax (running
// max and sum per row), the loop the one-pass backward will reuse. Rows
// and keys past S are never read: loads past the end are zero-filled and
// key columns >= S get probability 0, so no padded copy of q/k/v is made.
// Offsets come from the BSHD strides, so no head transpose is made either.
// Head dims up to 128 are zero-padded to 32, 64 or 128 in shared memory.
//
// bf16 (the serving path): each warp keeps its 16 query rows, the scores,
// the probabilities and the output accumulator in registers, in the
// fragment layouts of mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
// score fragments are reused as the A operand of P.V without leaving
// registers. fp32: a plain FMA path of the same tiling that round-trips
// scores through shared memory, kept so that the card can hold the kernel
// against the plain PyTorch version in fp32 too.
//
// What bounds it. At the serving shapes (S = 602, 448, 168; D = 64) the
// work is ~4*S*S*D flops per head against ~4*S*D*2 bytes of q/k/v/o: the
// kernel is bound by the tensor cores' issue rate on paper. This version
// loads K/V synchronously (no cp.async/TMA double buffering) and uses the
// warp-level mma.sync, not the warpgroup wgmma; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

// Copies rows [row0, row0 + 64) of one head of a BSHD tensor into a
// (64, ld) shared tile, zero-filling rows >= seq and columns >= head_dim.
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          size_t base, size_t row_stride,
                                          int row0, int seq, int head_dim,
                                          bool vec, int tid) {
  constexpr int kPerVec = 16 / sizeof(T);
  if (vec) {  // 16-byte loads: head_dim % kPerVec == 0, pointers aligned
    constexpr int kChunks = DP / kPerVec;
    for (int i = tid; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * kPerVec;
      const int s = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (s < seq && c < head_dim)
        val = *reinterpret_cast<const uint4*>(src + base + s * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = tid; i < 64 * DP; i += kThreads) {
      const int r = i / DP, c = i - (i / DP) * DP;
      const int s = row0 + r;
      dst[r * LD + c] = (s < seq && c < head_dim)
                            ? src[base + s * row_stride + c]
                            : zero_value<T>();
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: register-resident online softmax on mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int DP>
struct MmaLayout {
  static constexpr int kLd = DP + 8;  // 16-byte row pad: conflict-free frags
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align128(2 * kBlockQ * kLd);
  static constexpr size_t kV = kK + align128(2 * kBlockK * kLd);
  static constexpr size_t kBytes = kV + align128(2 * kBlockK * kLd);
};

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

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4. A (16x16): regs {0,1,2,3} hold rows {g, g+8, g, g+8},
// columns {2t, 2t+1} (+8 for regs 2, 3). B (16x8): regs {0,1} hold rows
// {2t, 2t+1} (+8 for reg 1) of column g. C (16x8, fp32): {c0, c1} are row
// g, columns 2t, 2t+1; {c2, c3} the same columns of row g+8.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_tail_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int seq, int heads,
                           int head_dim, float scale_log2, bool vec) {
  using L = MmaLayout<DP>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);

  load_tile<__nv_bfloat16, DP, kLd>(sQ, q, base, row_stride, q0, seq,
                                    head_dim, vec, tid);
  __syncthreads();

  uint32_t qf[DP / 16][4];
  const __nv_bfloat16* wq = sQ + warp * 16 * kLd;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = ld_pair(wq + g * kLd + c);
    qf[kk][1] = ld_pair(wq + (g + 8) * kLd + c);
    qf[kk][2] = ld_pair(wq + g * kLd + c + 8);
    qf[kk][3] = ld_pair(wq + (g + 8) * kLd + c + 8);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};            // this lane's share of the sum

  for (int kv0 = 0; kv0 < seq; kv0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<__nv_bfloat16, DP, kLd>(sK, k, base, row_stride, kv0, seq,
                                      head_dim, vec, tid);
    load_tile<__nv_bfloat16, DP, kLd>(sV, v, base, row_stride, kv0, seq,
                                      head_dim, vec, tid);
    __syncthreads();

    // Scores S = Q K^T for 16 rows x 64 keys, as 8 C fragments.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        const uint32_t bk[2] = {ld_pair(kp), ld_pair(kp + 8)};
        mma_16816(s[n], qf[kk], bk);
      }
    }

    // Online softmax in the log2 domain; key columns >= seq get -inf.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + n * 8 + 2 * t + (i & 1);
        const float val = col < seq ? s[n][i] * scale_log2 : -INFINITY;
        s[n][i] = val;
        mx[i >> 1] = fmaxf(mx[i >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: kv0 < seq
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[n][i] - m_run[i >> 1]);
        s[n][i] = p;
        l_run[i >> 1] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // O += P V: score fragments 2j, 2j+1 form the A fragment of keys
    // [16j, 16j + 16); V's B fragments are gathered from shared memory.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_pair(s[2 * j][0], s[2 * j][1]),
          pack_pair(s[2 * j][2], s[2 * j][3]),
          pack_pair(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_pair(s[2 * j + 1][2], s[2 * j + 1][3]),
      };
#pragma unroll
      for (int d = 0; d < DP / 8; ++d) {
        const __nv_bfloat16* vp = sV + (j * 16 + 2 * t) * kLd + d * 8 + g;
        const uint32_t bv[2] = {pack_pair(vp[0], vp[kLd]),
                                pack_pair(vp[8 * kLd], vp[9 * kLd])};
        mma_16816(acc[d], pa, bv);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    const float inv = 1.0f / l_run[r];
    __nv_bfloat16* out = o + base + rows[r] * row_stride;
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int c = d * 8 + 2 * t;
      if (c < head_dim) out[c] = __float2bfloat16(acc[d][2 * r] * inv);
      if (c + 1 < head_dim)
        out[c + 1] = __float2bfloat16(acc[d][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the same tiling with plain FMAs, scores through shared memory
// ---------------------------------------------------------------------------

template <int DP>
struct F32Layout {
  static constexpr int kLdT = DP + 4;       // q, k, v tiles
  static constexpr int kLdS = kBlockK + 4;  // scores / probabilities
  static constexpr int kLdO = DP + 4;       // output accumulator
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align128(4 * kBlockQ * kLdT);
  static constexpr size_t kV = kK + align128(4 * kBlockK * kLdT);
  static constexpr size_t kS = kV + align128(4 * kBlockK * kLdT);
  static constexpr size_t kO = kS + align128(4 * kBlockQ * kLdS);
  static constexpr size_t kBytes = kO + align128(4 * kBlockQ * kLdO);
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_tail_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int seq, int heads, int head_dim, float scale_log2,
                          bool vec) {
  using L = F32Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sO = reinterpret_cast<float*>(smem + L::kO);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);

  load_tile<float, DP, L::kLdT>(sQ, q, base, row_stride, q0, seq, head_dim,
                                vec, tid);
  for (int i = tid; i < kBlockQ * DP; i += kThreads)
    sO[(i / DP) * L::kLdO + i % DP] = 0.0f;

  // Lane owns row (lane / 2) of its warp's 16 and half of the columns.
  const int r = lane >> 1;
  const int half = lane & 1;
  const float* wQ = sQ + (warp * 16 + r) * L::kLdT;
  float* wS = sS + (warp * 16 + r) * L::kLdS;
  float* wO = sO + (warp * 16 + r) * L::kLdO;
  float m_run = -INFINITY, l_run = 0.0f;

  for (int kv0 = 0; kv0 < seq; kv0 += kBlockK) {
    __syncthreads();
    load_tile<float, DP, L::kLdT>(sK, k, base, row_stride, kv0, seq,
                                  head_dim, vec, tid);
    load_tile<float, DP, L::kLdT>(sV, v, base, row_stride, kv0, seq,
                                  head_dim, vec, tid);
    __syncthreads();

    float mx = -INFINITY;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      float acc = 0.0f;
      for (int d = 0; d < DP; ++d) acc += wQ[d] * sK[c * L::kLdT + d];
      const float val = kv0 + c < seq ? acc * scale_log2 : -INFINITY;
      wS[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = exp2f(m_run - m_new);
    m_run = m_new;
    float sum = 0.0f;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float p = exp2f(wS[c] - m_new);
      wS[c] = p;
      sum += p;
    }
    l_run = l_run * corr + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();  // both halves of the row's probabilities are written
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d) {
      float acc = wO[d] * corr;
      for (int c = 0; c < kBlockK; ++c) acc += wS[c] * sV[c * L::kLdT + d];
      wO[d] = acc;
    }
    __syncwarp();
  }

  const int s = q0 + warp * 16 + r;
  if (s < seq) {
    const float inv = 1.0f / l_run;
    float* out = o + base + s * row_stride;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d)
      if (d < head_dim) out[d] = wO[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              int batch, int seq, int heads, int head_dim, float scale,
              int is_bf16, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (is_bf16) {
    const bool vec = head_dim % 8 == 0 && addr % 16 == 0;
    auto kernel = flash_tail_bf16_kernel<DP>;
    const size_t smem = MmaLayout<DP>::kBytes;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        seq, heads, head_dim, scale_log2, vec);
  } else {
    const bool vec = head_dim % 4 == 0 && addr % 16 == 0;
    auto kernel = flash_tail_f32_kernel<DP>;
    const size_t smem = F32Layout<DP>::kBytes;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
        head_dim, scale_log2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (batch, seq, heads, head_dim) tensors of one type,
// bf16 (is_bf16 = 1) or fp32 (is_bf16 = 0). Returns a cudaError_t.
extern "C" int flash_tail_forward(const void* q, const void* k, const void* v,
                                  void* o, int batch, int seq, int heads,
                                  int head_dim, float scale, int is_bf16,
                                  void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
      head_dim > 128 || (seq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim <= 32)
    return launch_dp<32>(q, k, v, o, batch, seq, heads, head_dim, scale,
                         is_bf16, st);
  if (head_dim <= 64)
    return launch_dp<64>(q, k, v, o, batch, seq, heads, head_dim, scale,
                         is_bf16, st);
  return launch_dp<128>(q, k, v, o, batch, seq, heads, head_dim, scale,
                        is_bf16, st);
}

extern "C" const char* flash_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
