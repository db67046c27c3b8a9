// Flash attention for Hopper (sm_90a), BSHD layout, forward (K7).
//
// Replaces the stock Pallas TPU kernel that opendwm_tpu/ops/attention.py
// (dot_product_attention, the _can_use_flash branch) calls through
// jax.experimental.pallas.ops.tpu.flash_attention. Same result:
// softmax(q k^T * scale) v with the logits and the softmax in fp32, the
// probabilities rounded to the input type before the product with v, the
// output in the input type; q and kv lengths may differ; with `causal`,
// key j is visible to query i iff j <= i (top-left, as the TPU kernel
// masks; the JAX package's XLA fallback masks bottom-right instead).
//
// Design. The TPU kernel walks (q block, k block) grid steps in order and
// carries the running max, sum and output of a q block in VMEM scratch
// from one k step to the next. Hopper blocks run in no order, so the k loop
// moves inside the block: one block of 4 warps owns 64 query rows of one
// (batch, head) and streams K/V through shared memory in 64-key tiles with
// an online softmax (running max and sum per row). It is the tile loop of
// K1 (csrc/flash_tail.cu) with separate q and kv lengths, the causal mask,
// and head dims up to 256; K1's source and launch are left as they are.
// Offsets come from the BSHD strides, so no head transpose is made (the
// TPU path transposes to BHSD and back). Rows and keys past the ends are
// zero-filled on load and masked, so any length works, though the
// dispatcher sends only multiples of 128. Causal: key tiles wholly above
// the diagonal (kv0 >= q0 + 64) are skipped; the first tile always holds
// key 0, so every row's running max is finite after it.
//
// bf16: each warp keeps its 16 query rows' scores, probabilities and
// output accumulator in registers, in the fragment layouts of mma.sync
// m16n8k16 (bf16 in, fp32 accumulate); score fragments are reused as the
// A operand of P.V. Head dims are zero-padded to 64, 128 or 256. The 256
// instance keeps Q in shared memory and reloads its A fragments per key
// tile: with Q's 64 fragment registers on top of the 128 of the output
// accumulator the thread would pass 255 registers and spill. fp32: a plain
// FMA path of the same tiling that round-trips scores through shared
// memory (32-key tiles at D = 256 to fit 227 KB), for the fp32 comparison.
//
// What bounds it. At the UNet's level-0 self-attention (72 x 5 heads,
// S = 1792, D = 64) the work is 4*S*S*D flops per head against 4*S*D*2
// bytes of q/k/v/o, ~900 flops per byte: the tensor cores' issue rate on
// paper. This version loads K/V synchronously (no cp.async or TMA double
// buffering), gathers V's B fragments with scalar shared loads and uses
// the warp-level mma.sync, not the warpgroup wgmma; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kBlockQ = 64;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;  // keys per K/V tile (bf16)
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

// Copies rows [row0, row0 + ROWS) of one head of a BSHD tensor into a
// (ROWS, LD) shared tile, zero-filling rows >= seq and columns >= head_dim.
template <typename T, int DP, int LD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          size_t base, size_t row_stride,
                                          int row0, int seq, int head_dim,
                                          bool vec, int tid) {
  constexpr int kPerVec = 16 / sizeof(T);
  if (vec) {  // 16-byte loads: head_dim % kPerVec == 0, pointers aligned
    constexpr int kChunks = DP / kPerVec;
    for (int i = tid; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * kPerVec;
      const int s = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (s < seq && c < head_dim)
        val = *reinterpret_cast<const uint4*>(src + base + s * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i - (i / DP) * DP;
      const int s = row0 + r;
      dst[r * LD + c] = (s < seq && c < head_dim)
                            ? src[base + s * row_stride + c]
                            : zero_value<T>();
    }
  }
}

// Whether key `col` is visible to query `row`.
template <bool kCausal>
__device__ __forceinline__ bool visible(int row, int col, int kv_seq) {
  return col < kv_seq && (!kCausal || col <= row);
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

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4. A (16x16): regs {0,1,2,3} hold rows {g, g+8, g, g+8},
// columns {2t, 2t+1} (+8 for regs 2, 3). B (16x8): regs {0,1} hold rows
// {2t, 2t+1} (+8 for reg 1) of column g. C (16x8, fp32): {c0, c1} are row
// g, columns 2t, 2t+1; {c2, c3} the same columns of row g+8.
template <int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int q_seq,
                                int kv_seq, int heads, int head_dim,
                                float scale_log2, bool vec) {
  using L = MmaLayout<DP>;
  constexpr int kLd = L::kLd;
  constexpr bool kQInRegs = DP <= 128;
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
  const size_t q_base = (static_cast<size_t>(b) * q_seq * heads + h) *
                        static_cast<size_t>(head_dim);
  const size_t kv_base = (static_cast<size_t>(b) * kv_seq * heads + h) *
                         static_cast<size_t>(head_dim);
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<__nv_bfloat16, DP, kLd, kBlockQ>(sQ, q, q_base, row_stride, q0,
                                             q_seq, head_dim, vec, tid);
  __syncthreads();

  const __nv_bfloat16* wq = sQ + warp * 16 * kLd;
  uint32_t qf[kQInRegs ? DP / 16 : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) ld_a_frag(qf[kk], wq, kLd, kk * 16, g, t);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};            // this lane's share of the sum

  const int kv_end = kCausal ? min(kv_seq, q0 + kBlockQ) : kv_seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<__nv_bfloat16, DP, kLd, kBlockK>(sK, k, kv_base, row_stride,
                                               kv0, kv_seq, head_dim, vec,
                                               tid);
    load_tile<__nv_bfloat16, DP, kLd, kBlockK>(sV, v, kv_base, row_stride,
                                               kv0, kv_seq, head_dim, vec,
                                               tid);
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
        if constexpr (kQInRegs) {
          mma_16816(s[n], qf[kk], bk);
        } else {
          uint32_t a[4];
          ld_a_frag(a, wq, kLd, kk * 16, g, t);
          mma_16816(s[n], a, bk);
        }
      }
    }

    // Online softmax in the log2 domain; hidden keys get -inf. Every row
    // sees key 0 in the first tile, so m_run is finite from then on.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + n * 8 + 2 * t + (i & 1);
        const float val = visible<kCausal>(rows[i >> 1], col, kv_seq)
                              ? s[n][i] * scale_log2
                              : -INFINITY;
        s[n][i] = val;
        mx[i >> 1] = fmaxf(mx[i >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= q_seq) continue;
    const float inv = 1.0f / l_run[r];
    __nv_bfloat16* out = o + q_base + rows[r] * row_stride;
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

template <int DP, int BK>
struct F32Layout {
  static constexpr int kLdT = DP + 4;  // q, k, v tiles
  static constexpr int kLdS = BK + 4;  // scores / probabilities
  static constexpr int kLdO = DP + 4;  // output accumulator
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align128(4 * kBlockQ * kLdT);
  static constexpr size_t kV = kK + align128(4 * BK * kLdT);
  static constexpr size_t kS = kV + align128(4 * BK * kLdT);
  static constexpr size_t kO = kS + align128(4 * kBlockQ * kLdS);
  static constexpr size_t kBytes = kO + align128(4 * kBlockQ * kLdO);
};

template <int DP, int BK, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int q_seq, int kv_seq,
                               int heads, int head_dim, float scale_log2,
                               bool vec) {
  using L = F32Layout<DP, BK>;
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
  const size_t q_base = (static_cast<size_t>(b) * q_seq * heads + h) *
                        static_cast<size_t>(head_dim);
  const size_t kv_base = (static_cast<size_t>(b) * kv_seq * heads + h) *
                         static_cast<size_t>(head_dim);

  load_tile<float, DP, L::kLdT, kBlockQ>(sQ, q, q_base, row_stride, q0,
                                         q_seq, head_dim, vec, tid);
  for (int i = tid; i < kBlockQ * DP; i += kThreads)
    sO[(i / DP) * L::kLdO + i % DP] = 0.0f;

  // Lane owns row (lane / 2) of its warp's 16 and half of the columns.
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * 16 + r;
  const float* wQ = sQ + (warp * 16 + r) * L::kLdT;
  float* wS = sS + (warp * 16 + r) * L::kLdS;
  float* wO = sO + (warp * 16 + r) * L::kLdO;
  float m_run = -INFINITY, l_run = 0.0f;

  const int kv_end = kCausal ? min(kv_seq, q0 + kBlockQ) : kv_seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();
    load_tile<float, DP, L::kLdT, BK>(sK, k, kv_base, row_stride, kv0,
                                      kv_seq, head_dim, vec, tid);
    load_tile<float, DP, L::kLdT, BK>(sV, v, kv_base, row_stride, kv0,
                                      kv_seq, head_dim, vec, tid);
    __syncthreads();

    float mx = -INFINITY;
    for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
      float acc = 0.0f;
      for (int d = 0; d < DP; ++d) acc += wQ[d] * sK[c * L::kLdT + d];
      const float val =
          visible<kCausal>(row, kv0 + c, kv_seq) ? acc * scale_log2 : -INFINITY;
      wS[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = exp2f(m_run - m_new);
    m_run = m_new;
    float sum = 0.0f;
    for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
      const float p = exp2f(wS[c] - m_new);
      wS[c] = p;
      sum += p;
    }
    l_run = l_run * corr + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();  // both halves of the row's probabilities are written
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d) {
      float acc = wO[d] * corr;
      for (int c = 0; c < BK; ++c) acc += wS[c] * sV[c * L::kLdT + d];
      wO[d] = acc;
    }
    __syncwarp();
  }

  if (row < q_seq) {
    const float inv = 1.0f / l_run;
    float* out = o + q_base + row * row_stride;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d)
      if (d < head_dim) out[d] = wO[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t addr = 0;
  for (const void* p : ptrs) addr |= reinterpret_cast<uintptr_t>(p);
  return addr % 16 == 0;
}

template <int DP, bool kCausal>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              int batch, int q_seq, int kv_seq, int heads, int head_dim,
              float scale, int is_bf16, cudaStream_t stream) {
  const dim3 grid(batch * heads, (q_seq + kBlockQ - 1) / kBlockQ);
  const bool aligned = aligned16({q, k, v});
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (is_bf16) {
    const bool vec = head_dim % 8 == 0 && aligned;
    auto kernel = flash_attention_bf16_kernel<DP, kCausal>;
    const size_t smem = MmaLayout<DP>::kBytes;
    if ((err = set_smem(kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        q_seq, kv_seq, heads, head_dim, scale_log2, vec);
  } else {
    constexpr int BK = DP > 128 ? 32 : 64;
    const bool vec = head_dim % 4 == 0 && aligned;
    auto kernel = flash_attention_f32_kernel<DP, BK, kCausal>;
    const size_t smem = F32Layout<DP, BK>::kBytes;
    if ((err = set_smem(kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), q_seq, kv_seq,
        heads, head_dim, scale_log2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int q_seq, int kv_seq, int heads, int head_dim, float scale,
           int is_bf16, cudaStream_t stream) {
  if (head_dim <= 64)
    return launch_dp<64, kCausal>(q, k, v, o, batch, q_seq, kv_seq, heads,
                                  head_dim, scale, is_bf16, stream);
  if (head_dim <= 128)
    return launch_dp<128, kCausal>(q, k, v, o, batch, q_seq, kv_seq, heads,
                                   head_dim, scale, is_bf16, stream);
  return launch_dp<256, kCausal>(q, k, v, o, batch, q_seq, kv_seq, heads,
                                 head_dim, scale, is_bf16, stream);
}

}  // namespace

// q: contiguous (batch, q_seq, heads, head_dim); k, v, o: contiguous
// (batch, kv_seq, heads, head_dim) and (batch, q_seq, heads, head_dim); one
// type, bf16 (is_bf16 = 1) or fp32 (is_bf16 = 0); head_dim <= 256. causal:
// key j visible to query i iff j <= i. Returns a cudaError_t.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int batch,
                                       int q_seq, int kv_seq, int heads,
                                       int head_dim, float scale, int causal,
                                       int is_bf16, void* stream) {
  if (batch <= 0 || q_seq <= 0 || kv_seq <= 0 || heads <= 0 ||
      head_dim <= 0 || head_dim > 256 ||
      (q_seq + kBlockQ - 1) / kBlockQ > 65535 ||
      static_cast<long long>(batch) * heads > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return launch<true>(q, k, v, o, batch, q_seq, kv_seq, heads, head_dim,
                        scale, is_bf16, st);
  return launch<false>(q, k, v, o, batch, q_seq, kv_seq, heads, head_dim,
                       scale, is_bf16, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
