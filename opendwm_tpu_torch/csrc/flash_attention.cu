// Flash attention for Hopper (sm_90a), BSHD layout: the forward (K7) and,
// further down, its backward.
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
// paper. The bf16 forward at head dim 64 (every launch on the port's
// paths, with or without the log-sum-exp or segment ids) therefore runs
// the Hopper forward of flash_fwd_sm90.cuh, shared with K1: a TMA ring of
// K/V tiles, wgmma for both products, masks on the last and the diagonal
// tiles only and a TMA store (the rule that picks it is
// fwd90::Sm90Takes). The mma.sync body below, which loads K/V synchronously
// and gathers V's B fragments with scalar shared loads, serves the other
// forward launches (fp32, D 128 and 256, pointers that are not 16-byte
// aligned); the backward keeps its own mma.sync kernels.
//
// When a gradient is needed the forward also writes the row log-sum-exp
// (fp32, in the log2 domain of the scaled scores, (B*H, q_seq)); it is a
// template flag, so the serving launch compiles to the same code as before.
//
// Segment ids (K7-seg). The stock kernel also takes int32 segment ids of the
// queries and keys, (B, q_seq) and (B, kv_seq), and lets query i see key j
// only where their ids are equal; perf/exp_attn602.py (v_flashpad) pads the
// sequence to a multiple of 128 and gives the pads their own segment. The
// stock kernel adds a finite DEFAULT_MASK_VALUE (-0.7 * FLT_MAX) to the
// scaled logits of a pair whose ids differ, so a query whose id matches no
// key attends to every key alike and gets the mean of V. Here the same
// finite value is added after the scores are scaled into the log2 domain
// (before, the product with log2(e) would overflow to -inf); keys past
// kv_seq and above the causal diagonal keep -inf. The block loads its 64
// query ids into shared memory once and each tile's 64 key ids with the
// tile. The ids are a template flag of the same tile loop (the kernels
// without them are thin wrappers of the same body, so they compile as
// before); no instance writes the log-sum-exp with ids, since nothing
// differentiates the shoot-out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;  // keys per K/V tile (bf16)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
// The stock kernel's DEFAULT_MASK_VALUE, added to a pair whose segment ids
// differ.
constexpr float kSegmentMask = -0.7f * 3.402823466e38f;
// Shared bytes of the ids of a block's 64 queries and of one key tile.
constexpr size_t kIdBytes = 2 * 64 * sizeof(int);

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
// The body of the bf16 forward. With kSegment, q_ids / kv_ids are the
// (batch, q_seq) / (batch, kv_seq) segment ids, and the block keeps its
// query ids and the tile's key ids after L::kBytes of shared memory.
template <int DP, bool kCausal, bool kLse, bool kSegment>
__device__ __forceinline__ void attend_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int q_seq, int kv_seq, int heads, int head_dim,
    float scale_log2, bool vec, const int* __restrict__ q_ids,
    const int* __restrict__ kv_ids) {
  using L = MmaLayout<DP>;
  constexpr int kLd = L::kLd;
  constexpr bool kQInRegs = DP <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  int* sQid = reinterpret_cast<int*>(smem + L::kBytes);
  int* sKvid = sQid + kBlockQ;

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
  if constexpr (kSegment) {
    if (tid < kBlockQ)
      sQid[tid] = q0 + tid < q_seq
                      ? q_ids[static_cast<size_t>(b) * q_seq + q0 + tid]
                      : 0;
  }
  __syncthreads();

  const __nv_bfloat16* wq = sQ + warp * 16 * kLd;
  uint32_t qf[kQInRegs ? DP / 16 : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) ld_a_frag(qf[kk], wq, kLd, kk * 16, g, t);
  }
  int row_id[2] = {0, 0};
  if constexpr (kSegment) {
    row_id[0] = sQid[warp * 16 + g];
    row_id[1] = sQid[warp * 16 + g + 8];
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
    if constexpr (kSegment) {
      if (tid < kBlockK)
        sKvid[tid] = kv0 + tid < kv_seq
                         ? kv_ids[static_cast<size_t>(b) * kv_seq + kv0 + tid]
                         : 0;
    }
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

    // Online softmax in the log2 domain. Keys past kv_seq and above the
    // causal diagonal get -inf; with segment ids, a key of another segment
    // gets the finite kSegmentMask added, as the stock kernel does. Key kv0
    // is below kv_seq and, under the causal mask, at or before every row of
    // the block (tiles start at multiples of 64 no later than q0), so every
    // tile's row max is finite: m_run is finite after the first tile, whose
    // correction is exp2(-inf) = 0. A row whose id matches no key sees
    // kSegmentMask alone (the scores vanish beside it), so p = 1 for each
    // key and the output is the mean of V.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + n * 8 + 2 * t + (i & 1);
        float val = visible<kCausal>(rows[i >> 1], col, kv_seq)
                        ? s[n][i] * scale_log2
                        : -INFINITY;
        if constexpr (kSegment) {
          if (row_id[i >> 1] != sKvid[col - kv0]) val += kSegmentMask;
        }
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
    if (kLse && t == 0)
      lse[static_cast<size_t>(bh) * q_seq + rows[r]] =
          m_run[r] + log2f(l_run[r]);
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

template <int DP, bool kCausal, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int q_seq,
                                int kv_seq, int heads, int head_dim,
                                float scale_log2, bool vec) {
  attend_bf16<DP, kCausal, kLse, false>(q, k, v, o, lse, q_seq, kv_seq, heads,
                                        head_dim, scale_log2, vec, nullptr,
                                        nullptr);
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_segment_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                        const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v,
                                        __nv_bfloat16* __restrict__ o,
                                        const int* __restrict__ q_ids,
                                        const int* __restrict__ kv_ids,
                                        int q_seq, int kv_seq, int heads,
                                        int head_dim, float scale_log2,
                                        bool vec) {
  attend_bf16<DP, kCausal, false, true>(q, k, v, o, nullptr, q_seq, kv_seq,
                                        heads, head_dim, scale_log2, vec,
                                        q_ids, kv_ids);
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

// The body of the fp32 forward; segment ids as in attend_bf16.
template <int DP, int BK, bool kCausal, bool kLse, bool kSegment>
__device__ __forceinline__ void attend_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int q_seq, int kv_seq, int heads, int head_dim,
    float scale_log2, bool vec, const int* __restrict__ q_ids,
    const int* __restrict__ kv_ids) {
  using L = F32Layout<DP, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  int* sQid = reinterpret_cast<int*>(smem + L::kBytes);
  int* sKvid = sQid + kBlockQ;

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
  if constexpr (kSegment) {
    if (tid < kBlockQ)
      sQid[tid] = q0 + tid < q_seq
                      ? q_ids[static_cast<size_t>(b) * q_seq + q0 + tid]
                      : 0;
  }

  // Lane owns row (lane / 2) of its warp's 16 and half of the columns.
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * 16 + r;
  const float* wQ = sQ + (warp * 16 + r) * L::kLdT;
  float* wS = sS + (warp * 16 + r) * L::kLdS;
  float* wO = sO + (warp * 16 + r) * L::kLdO;
  float m_run = -INFINITY, l_run = 0.0f;

  // As in attend_bf16: key 0 is visible to every row in the first tile, so
  // m_run is finite after it; a later causal tile may hide all its keys
  // from a row (32-key tiles at D 256), whose max then stays m_run.
  const int kv_end = kCausal ? min(kv_seq, q0 + kBlockQ) : kv_seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();
    load_tile<float, DP, L::kLdT, BK>(sK, k, kv_base, row_stride, kv0,
                                      kv_seq, head_dim, vec, tid);
    load_tile<float, DP, L::kLdT, BK>(sV, v, kv_base, row_stride, kv0,
                                      kv_seq, head_dim, vec, tid);
    if constexpr (kSegment) {
      if (tid < BK)
        sKvid[tid] = kv0 + tid < kv_seq
                         ? kv_ids[static_cast<size_t>(b) * kv_seq + kv0 + tid]
                         : 0;
    }
    __syncthreads();

    float mx = -INFINITY;
    for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
      float acc = 0.0f;
      for (int d = 0; d < DP; ++d) acc += wQ[d] * sK[c * L::kLdT + d];
      float val =
          visible<kCausal>(row, kv0 + c, kv_seq) ? acc * scale_log2 : -INFINITY;
      if constexpr (kSegment) {
        if (sQid[warp * 16 + r] != sKvid[c]) val += kSegmentMask;
      }
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
    if (kLse && half == 0)
      lse[static_cast<size_t>(bh) * q_seq + row] = m_run + log2f(l_run);
    const float inv = 1.0f / l_run;
    float* out = o + q_base + row * row_stride;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d)
      if (d < head_dim) out[d] = wO[d] * inv;
  }
}

template <int DP, int BK, bool kCausal, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, float* __restrict__ lse,
                               int q_seq, int kv_seq, int heads, int head_dim,
                               float scale_log2, bool vec) {
  attend_f32<DP, BK, kCausal, kLse, false>(q, k, v, o, lse, q_seq, kv_seq,
                                           heads, head_dim, scale_log2, vec,
                                           nullptr, nullptr);
}

template <int DP, int BK, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_segment_f32_kernel(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ o,
                                       const int* __restrict__ q_ids,
                                       const int* __restrict__ kv_ids,
                                       int q_seq, int kv_seq, int heads,
                                       int head_dim, float scale_log2,
                                       bool vec) {
  attend_f32<DP, BK, kCausal, false, true>(q, k, v, o, nullptr, q_seq,
                                           kv_seq, heads, head_dim,
                                           scale_log2, vec, q_ids, kv_ids);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
//
// Replaces the stock Pallas TPU backward of the same flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_bwd:
// _flash_attention_bwd_dkv, body _flash_attention_dkv_kernel, and
// _flash_attention_bwd_dq, body _flash_attention_dq_kernel). Same math in
// exact arithmetic: P = exp(S * scale - lse) with the forward's row
// log-sum-exp (the TPU kernel keeps the row max m and sum l apart; here one
// lse in the log2 domain of the scaled scores), dV = P^T dO with P rounded
// to the input type, dP = dO V^T, dS = P (dP - delta) * scale with
// delta = rowsum(dO o O) (the TPU's di), rounded to the input type,
// dQ = dS K, dK = dS^T Q; fp32 accumulators, outputs in the input type.
// Hidden keys get probability 0 (the TPU kernel adds DEFAULT_MASK_VALUE,
// whose exp is 0 too).
//
// Design: the split of K2 (csrc/flash_tail.cu) with separate q and kv
// lengths and the causal mask. Three launches, no atomics, so the result is
// deterministic:
//   1. delta: one warp per (b, s, h) query row, fp32 dot of dO and O;
//   2. dk/dv: one block per (b*h, 64-key tile); each warp owns 16 keys and
//      loops over 64-query tiles, recomputing S^T = K Q^T and dP^T = V dO^T
//      on mma.sync and accumulating dV += P^T dO, dK += dS^T Q in fp32
//      registers. Causal: the query tiles wholly above the diagonal (every
//      query before the tile's first key) are skipped;
//   3. dq: one block per (b*h, 64-query tile); each warp owns 16 queries and
//      loops over 64-key tiles, recomputing S and dP and accumulating
//      dQ += dS K. Causal: the key tiles wholly right of the query tile are
//      skipped, as in the forward.
// Head dims pad to 64, 128 or 256. At 256 the two accumulators of dk/dv
// would take 256 registers a thread, so both kernels accumulate 128 output
// columns per pass and recompute S and dP for the second pass; the dq
// kernel then also reloads the A fragments of Q and dO from shared memory,
// as the forward does at 256. fp32 inputs take a plain FMA path of the
// same split, for the fp32 comparison.
//
// What bounds it: 7 products of S x S x D per head (S and dP twice, dV, dK,
// dQ) against the 5 that the math needs; the tensor cores' instruction rate on
// paper, the scalar shared-memory gathers of the transposed B fragments in
// practice. ldmatrix, wgmma and TMA are later work.

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[(b * heads + h) * q_seq + s] = sum_d dO[b, s, h, d] * O[b, s, h, d].
template <typename T>
__global__ void flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                                 const T* __restrict__ dout,
                                                 float* __restrict__ delta,
                                                 int rows, int q_seq,
                                                 int heads, int head_dim) {
  const int row = static_cast<int>(
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps only
  const size_t base = static_cast<size_t>(row) * head_dim;
  float acc = 0.0f;
  for (int c = lane; c < head_dim; c += 32)
    acc += to_float(o[base + c]) * to_float(dout[base + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int b = row / (q_seq * heads);
    const int rem = row - b * q_seq * heads;
    const int s = rem / heads;
    const int h = rem - s * heads;
    delta[(static_cast<size_t>(b) * heads + h) * q_seq + s] = acc;
  }
}

// Shared tiles of the bf16 backward: Q, dO, K, V (64 rows each), then the
// lse and delta of the 64 query rows in flight.
template <int DP>
struct BwdLayout {
  static constexpr int kLd = DP + 8;
  static constexpr size_t kTile = align128(2 * 64 * kLd);
  static constexpr size_t kQ = 0;
  static constexpr size_t kDo = kTile;
  static constexpr size_t kK = 2 * kTile;
  static constexpr size_t kV = 3 * kTile;
  static constexpr size_t kLse = 4 * kTile;
  static constexpr size_t kDelta = kLse + 256;
  static constexpr size_t kBytes = kDelta + 256;
};

// B fragment whose column n is row (row0 + n) of a shared tile (B = X^T).
__device__ __forceinline__ void ld_b_rows(uint32_t (&b)[2],
                                          const __nv_bfloat16* tile, int ld,
                                          int row0, int c0, int g, int t) {
  const __nv_bfloat16* p = tile + (row0 + g) * ld + c0 + 2 * t;
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// B fragment whose rows are rows [row0, row0 + 16) of a shared tile and
// columns [c0, c0 + 8) (B = X), gathered with scalar loads.
__device__ __forceinline__ void ld_b_cols(uint32_t (&b)[2],
                                          const __nv_bfloat16* tile, int ld,
                                          int row0, int c0, int g, int t) {
  const __nv_bfloat16* p = tile + (row0 + 2 * t) * ld + c0 + g;
  b[0] = pack_pair(p[0], p[ld]);
  b[1] = pack_pair(p[8 * ld], p[9 * ld]);
}

// Score fragments lo, hi (fp32 C layout, columns [16j, 16j + 8) and
// [16j + 8, 16j + 16)) as the A fragment of those 16 columns, in bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_pair(lo[0], lo[1]);
  a[1] = pack_pair(lo[2], lo[3]);
  a[2] = pack_pair(hi[0], hi[1]);
  a[3] = pack_pair(hi[2], hi[3]);
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_bf16_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int q_seq, int kv_seq, int heads, int head_dim, float scale,
        float scale_log2, bool vec) {
  using L = BwdLayout<DP>;
  constexpr int kLd = L::kLd;
  constexpr int kCols = DP > 128 ? 128 : DP;  // output columns per pass
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* sDo = reinterpret_cast<__nv_bfloat16*>(smem + L::kDo);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kBlockK;
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
  const float* lse_bh = lse + static_cast<size_t>(bh) * q_seq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * q_seq;

  load_tile<__nv_bfloat16, DP, kLd, kBlockK>(sK, k, kv_base, row_stride, k0,
                                             kv_seq, head_dim, vec, tid);
  load_tile<__nv_bfloat16, DP, kLd, kBlockK>(sV, v, kv_base, row_stride, k0,
                                             kv_seq, head_dim, vec, tid);
  const __nv_bfloat16* wk = sK + warp * 16 * kLd;
  const __nv_bfloat16* wv = sV + warp * 16 * kLd;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  // Causal: no query before the tile's first key sees any of its keys.
  const int q_begin = kCausal ? k0 : 0;

#pragma unroll 1
  for (int c0 = 0; c0 < DP; c0 += kCols) {
    float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
    for (int d = 0; d < kCols / 8; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[d][i] = dv_acc[d][i] = 0.0f;

    for (int q0 = q_begin; q0 < q_seq; q0 += kBlockQ) {
      __syncthreads();  // the previous query tile is consumed by every warp
      load_tile<__nv_bfloat16, DP, kLd, kBlockQ>(sQ, q, q_base, row_stride,
                                                 q0, q_seq, head_dim, vec,
                                                 tid);
      load_tile<__nv_bfloat16, DP, kLd, kBlockQ>(sDo, dout, q_base,
                                                 row_stride, q0, q_seq,
                                                 head_dim, vec, tid);
      if (tid < kBlockQ) {
        const int r = q0 + tid;
        sLse[tid] = r < q_seq ? lse_bh[r] : 0.0f;
        sDelta[tid] = r < q_seq ? delta_bh[r] : 0.0f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp.
      float s[kBlockQ / 8][4], dp[kBlockQ / 8][4];
#pragma unroll
      for (int n = 0; n < kBlockQ / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ka[4], va[4];
        ld_a_frag(ka, wk, kLd, kk * 16, g, t);
        ld_a_frag(va, wv, kLd, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < kBlockQ / 8; ++n) {
          uint32_t bq[2], bo[2];
          ld_b_rows(bq, sQ, kLd, n * 8, kk * 16, g, t);
          ld_b_rows(bo, sDo, kLd, n * 8, kk * 16, g, t);
          mma_16816(s[n], ka, bq);
          mma_16816(dp[n], va, bo);
        }
      }

      // P^T = exp2(S^T * scale_log2 - lse), dS^T = P^T (dP^T - delta) * scale;
      // hidden pairs and rows or keys past the ends get probability 0.
#pragma unroll
      for (int n = 0; n < kBlockQ / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = n * 8 + 2 * t + (i & 1);
          float p = 0.0f;
          if (q0 + qc < q_seq &&
              visible<kCausal>(q0 + qc, keys[i >> 1], kv_seq))
            p = exp2f(s[n][i] * scale_log2 - sLse[qc]);
          s[n][i] = p;
          dp[n][i] = p * (dp[n][i] - sDelta[qc]) * scale;
        }
      }

      // dV += P^T dO, dK += dS^T Q over the tile's 64 queries, for the
      // pass's output columns.
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * j], s[2 * j + 1]);
        c_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int d = 0; d < kCols / 8; ++d) {
          uint32_t bo[2], bq[2];
          ld_b_cols(bo, sDo, kLd, j * 16, c0 + d * 8, g, t);
          ld_b_cols(bq, sQ, kLd, j * 16, c0 + d * 8, g, t);
          mma_16816(dv_acc[d], pa, bo);
          mma_16816(dk_acc[d], da, bq);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= kv_seq) continue;
      const size_t off = kv_base + keys[r] * row_stride;
#pragma unroll
      for (int d = 0; d < kCols / 8; ++d) {
        const int c = c0 + d * 8 + 2 * t;
        if (c < head_dim) {
          dk[off + c] = __float2bfloat16(dk_acc[d][2 * r]);
          dv[off + c] = __float2bfloat16(dv_acc[d][2 * r]);
        }
        if (c + 1 < head_dim) {
          dk[off + c + 1] = __float2bfloat16(dk_acc[d][2 * r + 1]);
          dv[off + c + 1] = __float2bfloat16(dv_acc[d][2 * r + 1]);
        }
      }
    }
  }
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_bf16_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, int q_seq, int kv_seq, int heads,
        int head_dim, float scale, float scale_log2, bool vec) {
  using L = BwdLayout<DP>;
  constexpr int kLd = L::kLd;
  constexpr int kCols = DP > 128 ? 128 : DP;  // output columns per pass
  constexpr bool kInRegs = DP <= 128;  // Q's and dO's A fragments
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* sDo = reinterpret_cast<__nv_bfloat16*>(smem + L::kDo);
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

  load_tile<__nv_bfloat16, DP, kLd, kBlockQ>(sQ, q, q_base, row_stride, q0,
                                             q_seq, head_dim, vec, tid);
  load_tile<__nv_bfloat16, DP, kLd, kBlockQ>(sDo, dout, q_base, row_stride,
                                             q0, q_seq, head_dim, vec, tid);
  __syncthreads();

  const __nv_bfloat16* wq = sQ + warp * 16 * kLd;
  const __nv_bfloat16* wo = sDo + warp * 16 * kLd;
  uint32_t qf[kInRegs ? DP / 16 : 1][4], of[kInRegs ? DP / 16 : 1][4];
  if constexpr (kInRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ld_a_frag(qf[kk], wq, kLd, kk * 16, g, t);
      ld_a_frag(of[kk], wo, kLd, kk * 16, g, t);
    }
  }
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < q_seq;
    const size_t stat = static_cast<size_t>(bh) * q_seq + rows[r];
    row_lse[r] = ok ? lse[stat] : 0.0f;
    row_delta[r] = ok ? delta[stat] : 0.0f;
  }
  const int kv_end = kCausal ? min(kv_seq, q0 + kBlockQ) : kv_seq;

#pragma unroll 1
  for (int c0 = 0; c0 < DP; c0 += kCols) {
    float dq_acc[kCols / 8][4];
#pragma unroll
    for (int d = 0; d < kCols / 8; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq_acc[d][i] = 0.0f;

    for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockK) {
      __syncthreads();  // the previous K/V tile is consumed by every warp
      load_tile<__nv_bfloat16, DP, kLd, kBlockK>(sK, k, kv_base, row_stride,
                                                 kv0, kv_seq, head_dim, vec,
                                                 tid);
      load_tile<__nv_bfloat16, DP, kLd, kBlockK>(sV, v, kv_base, row_stride,
                                                 kv0, kv_seq, head_dim, vec,
                                                 tid);
      __syncthreads();

      // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp.
      float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qa[4], oa[4];
        if constexpr (kInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[i] = qf[kk][i];
            oa[i] = of[kk][i];
          }
        } else {
          ld_a_frag(qa, wq, kLd, kk * 16, g, t);
          ld_a_frag(oa, wo, kLd, kk * 16, g, t);
        }
#pragma unroll
        for (int n = 0; n < kBlockK / 8; ++n) {
          uint32_t bk[2], bv[2];
          ld_b_rows(bk, sK, kLd, n * 8, kk * 16, g, t);
          ld_b_rows(bv, sV, kLd, n * 8, kk * 16, g, t);
          mma_16816(s[n], qa, bk);
          mma_16816(dp[n], oa, bv);
        }
      }

      // dS = P (dP - delta) * scale with P = exp2(S * scale_log2 - lse);
      // hidden pairs and rows or keys past the ends get probability 0.
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = rows[i >> 1];
          const int col = kv0 + n * 8 + 2 * t + (i & 1);
          float p = 0.0f;
          if (row < q_seq && visible<kCausal>(row, col, kv_seq))
            p = exp2f(s[n][i] * scale_log2 - row_lse[i >> 1]);
          s[n][i] = p * (dp[n][i] - row_delta[i >> 1]) * scale;
        }
      }

      // dQ += dS K over the tile's 64 keys, for the pass's output columns.
#pragma unroll
      for (int j = 0; j < kBlockK / 16; ++j) {
        uint32_t da[4];
        c_to_a(da, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int d = 0; d < kCols / 8; ++d) {
          uint32_t bk[2];
          ld_b_cols(bk, sK, kLd, j * 16, c0 + d * 8, g, t);
          mma_16816(dq_acc[d], da, bk);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= q_seq) continue;
      __nv_bfloat16* out = dq + q_base + rows[r] * row_stride;
#pragma unroll
      for (int d = 0; d < kCols / 8; ++d) {
        const int c = c0 + d * 8 + 2 * t;
        if (c < head_dim) out[c] = __float2bfloat16(dq_acc[d][2 * r]);
        if (c + 1 < head_dim)
          out[c + 1] = __float2bfloat16(dq_acc[d][2 * r + 1]);
      }
    }
  }
}

// fp32 backward: the same split with plain FMAs. A block owns 32 keys (dk/dv)
// or 32 queries (dq) and walks 64-row tiles of the other side; thread tid
// owns row tid / 4 of its 32 and every fourth column from tid % 4, so its
// accumulators stay in registers; probabilities and dS go through shared
// memory.
constexpr int kF32Rows = 32;

template <int DP>
struct F32BwdLayout {
  static constexpr int kLdT = DP + 4;
  static constexpr int kLdS = 64 + 4;
  static constexpr size_t kOwn0 = 0;  // K (dk/dv) or Q (dq): 32 rows
  static constexpr size_t kOwn1 = kOwn0 + align128(4 * kF32Rows * kLdT);
  static constexpr size_t kLoop0 = kOwn1 + align128(4 * kF32Rows * kLdT);
  static constexpr size_t kLoop1 = kLoop0 + align128(4 * 64 * kLdT);
  static constexpr size_t kP = kLoop1 + align128(4 * 64 * kLdT);
  static constexpr size_t kDs = kP + align128(4 * kF32Rows * kLdS);
  static constexpr size_t kLse = kDs + align128(4 * kF32Rows * kLdS);
  static constexpr size_t kDelta = kLse + 256;
  static constexpr size_t kBytes = kDelta + 256;
};

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_f32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int q_seq,
        int kv_seq, int heads, int head_dim, float scale, float scale_log2,
        bool vec) {
  using L = F32BwdLayout<DP>;
  constexpr int kLdT = L::kLdT, kLdS = L::kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::kOwn0);
  float* sV = reinterpret_cast<float*>(smem + L::kOwn1);
  float* sQ = reinterpret_cast<float*>(smem + L::kLoop0);
  float* sDo = reinterpret_cast<float*>(smem + L::kLoop1);
  float* sP = reinterpret_cast<float*>(smem + L::kP);
  float* sDs = reinterpret_cast<float*>(smem + L::kDs);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kF32Rows;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c0 = tid & 3;
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const size_t q_base = (static_cast<size_t>(b) * q_seq * heads + h) *
                        static_cast<size_t>(head_dim);
  const size_t kv_base = (static_cast<size_t>(b) * kv_seq * heads + h) *
                         static_cast<size_t>(head_dim);

  load_tile<float, DP, kLdT, kF32Rows>(sK, k, kv_base, row_stride, k0,
                                       kv_seq, head_dim, vec, tid);
  load_tile<float, DP, kLdT, kF32Rows>(sV, v, kv_base, row_stride, k0,
                                       kv_seq, head_dim, vec, tid);
  float dk_acc[DP / 4], dv_acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  const int key = k0 + r;
  const int q_begin = kCausal ? k0 / 64 * 64 : 0;

  for (int q0 = q_begin; q0 < q_seq; q0 += 64) {
    __syncthreads();
    load_tile<float, DP, kLdT, 64>(sQ, q, q_base, row_stride, q0, q_seq,
                                   head_dim, vec, tid);
    load_tile<float, DP, kLdT, 64>(sDo, dout, q_base, row_stride, q0, q_seq,
                                   head_dim, vec, tid);
    if (tid < 64) {
      const int row = q0 + tid;
      const size_t stat = static_cast<size_t>(bh) * q_seq + row;
      sLse[tid] = row < q_seq ? lse[stat] : 0.0f;
      sDelta[tid] = row < q_seq ? delta[stat] : 0.0f;
    }
    __syncthreads();
    for (int jj = 0; jj < 16; ++jj) {
      const int j = c0 + 4 * jj;
      float sv = 0.0f, dpv = 0.0f;
      for (int d = 0; d < DP; ++d) {
        sv += sK[r * kLdT + d] * sQ[j * kLdT + d];
        dpv += sV[r * kLdT + d] * sDo[j * kLdT + d];
      }
      float p = 0.0f;
      if (q0 + j < q_seq && visible<kCausal>(q0 + j, key, kv_seq))
        p = exp2f(sv * scale_log2 - sLse[j]);
      sP[r * kLdS + j] = p;
      sDs[r * kLdS + j] = p * (dpv - sDelta[j]) * scale;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int c = c0 + 4 * i;
      float a = dv_acc[i], bk = dk_acc[i];
      for (int j = 0; j < 64; ++j) {
        a += sP[r * kLdS + j] * sDo[j * kLdT + c];
        bk += sDs[r * kLdS + j] * sQ[j * kLdT + c];
      }
      dv_acc[i] = a;
      dk_acc[i] = bk;
    }
  }

  if (key < kv_seq) {
    const size_t off = kv_base + key * row_stride;
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int c = c0 + 4 * i;
      if (c < head_dim) {
        dk[off + c] = dk_acc[i];
        dv[off + c] = dv_acc[i];
      }
    }
  }
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_f32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int q_seq, int kv_seq, int heads,
        int head_dim, float scale, float scale_log2, bool vec) {
  using L = F32BwdLayout<DP>;
  constexpr int kLdT = L::kLdT, kLdS = L::kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kOwn0);
  float* sDo = reinterpret_cast<float*>(smem + L::kOwn1);
  float* sK = reinterpret_cast<float*>(smem + L::kLoop0);
  float* sV = reinterpret_cast<float*>(smem + L::kLoop1);
  float* sDs = reinterpret_cast<float*>(smem + L::kDs);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kF32Rows;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c0 = tid & 3;
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const size_t q_base = (static_cast<size_t>(b) * q_seq * heads + h) *
                        static_cast<size_t>(head_dim);
  const size_t kv_base = (static_cast<size_t>(b) * kv_seq * heads + h) *
                         static_cast<size_t>(head_dim);

  load_tile<float, DP, kLdT, kF32Rows>(sQ, q, q_base, row_stride, q0, q_seq,
                                       head_dim, vec, tid);
  load_tile<float, DP, kLdT, kF32Rows>(sDo, dout, q_base, row_stride, q0,
                                       q_seq, head_dim, vec, tid);
  const int row = q0 + r;
  const bool row_ok = row < q_seq;
  const size_t stat = static_cast<size_t>(bh) * q_seq + row;
  const float row_lse = row_ok ? lse[stat] : 0.0f;
  const float row_delta = row_ok ? delta[stat] : 0.0f;
  float dq_acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dq_acc[i] = 0.0f;
  const int kv_end = kCausal ? min(kv_seq, q0 + kF32Rows) : kv_seq;

  for (int kv0 = 0; kv0 < kv_end; kv0 += 64) {
    __syncthreads();
    load_tile<float, DP, kLdT, 64>(sK, k, kv_base, row_stride, kv0, kv_seq,
                                   head_dim, vec, tid);
    load_tile<float, DP, kLdT, 64>(sV, v, kv_base, row_stride, kv0, kv_seq,
                                   head_dim, vec, tid);
    __syncthreads();
    for (int jj = 0; jj < 16; ++jj) {
      const int j = c0 + 4 * jj;
      float sv = 0.0f, dpv = 0.0f;
      for (int d = 0; d < DP; ++d) {
        sv += sQ[r * kLdT + d] * sK[j * kLdT + d];
        dpv += sDo[r * kLdT + d] * sV[j * kLdT + d];
      }
      float p = 0.0f;
      if (row_ok && visible<kCausal>(row, kv0 + j, kv_seq))
        p = exp2f(sv * scale_log2 - row_lse);
      sDs[r * kLdS + j] = p * (dpv - row_delta) * scale;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int c = c0 + 4 * i;
      float a = dq_acc[i];
      for (int j = 0; j < 64; ++j) a += sDs[r * kLdS + j] * sK[j * kLdT + c];
      dq_acc[i] = a;
    }
  }

  if (row_ok) {
    float* out = dq + q_base + row * row_stride;
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int c = c0 + 4 * i;
      if (c < head_dim) out[c] = dq_acc[i];
    }
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

// The forward: with the log-sum-exp if lse is given, with segment ids if
// q_ids is given (never both).
template <int DP, bool kCausal>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              float* lse, const int* q_ids, const int* kv_ids, int batch,
              int q_seq, int kv_seq, int heads, int head_dim, float scale,
              int is_bf16, cudaStream_t stream) {
  const dim3 grid(batch * heads, (q_seq + kBlockQ - 1) / kBlockQ);
  const bool aligned = aligned16({q, k, v});
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const bool vec = head_dim % 8 == 0 && aligned;
    if (q_ids) {
      auto kernel = flash_attention_segment_bf16_kernel<DP, kCausal>;
      const size_t smem = MmaLayout<DP>::kBytes + kIdBytes;
      if ((err = set_smem(kernel, smem)) != cudaSuccess)
        return static_cast<int>(err);
      kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), q_ids, kv_ids, q_seq,
          kv_seq, heads, head_dim, scale_log2, vec);
      return static_cast<int>(cudaGetLastError());
    }
    auto kernel = lse ? flash_attention_bf16_kernel<DP, kCausal, true>
                      : flash_attention_bf16_kernel<DP, kCausal, false>;
    const size_t smem = MmaLayout<DP>::kBytes;
    if ((err = set_smem(kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, q_seq, kv_seq,
        heads, head_dim, scale_log2, vec);
  } else {
    constexpr int BK = DP > 128 ? 32 : 64;
    const bool vec = head_dim % 4 == 0 && aligned;
    if (q_ids) {
      auto kernel = flash_attention_segment_f32_kernel<DP, BK, kCausal>;
      const size_t smem = F32Layout<DP, BK>::kBytes + kIdBytes;
      if ((err = set_smem(kernel, smem)) != cudaSuccess)
        return static_cast<int>(err);
      kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), q_ids,
          kv_ids, q_seq, kv_seq, heads, head_dim, scale_log2, vec);
      return static_cast<int>(cudaGetLastError());
    }
    auto kernel = lse ? flash_attention_f32_kernel<DP, BK, kCausal, true>
                      : flash_attention_f32_kernel<DP, BK, kCausal, false>;
    const size_t smem = F32Layout<DP, BK>::kBytes;
    if ((err = set_smem(kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, q_seq,
        kv_seq, heads, head_dim, scale_log2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* q_ids, const int* kv_ids, int batch, int q_seq,
           int kv_seq, int heads, int head_dim, float scale, int is_bf16,
           cudaStream_t stream) {
  if (head_dim <= 64)
    return launch_dp<64, kCausal>(q, k, v, o, lse, q_ids, kv_ids, batch,
                                  q_seq, kv_seq, heads, head_dim, scale,
                                  is_bf16, stream);
  if (head_dim <= 128)
    return launch_dp<128, kCausal>(q, k, v, o, lse, q_ids, kv_ids, batch,
                                   q_seq, kv_seq, heads, head_dim, scale,
                                   is_bf16, stream);
  return launch_dp<256, kCausal>(q, k, v, o, lse, q_ids, kv_ids, batch,
                                 q_seq, kv_seq, heads, head_dim, scale,
                                 is_bf16, stream);
}

int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            const void* q_ids, const void* kv_ids, int batch, int q_seq,
            int kv_seq, int heads, int head_dim, float scale, int causal,
            int is_bf16, void* stream) {
  if (batch <= 0 || q_seq <= 0 || kv_seq <= 0 || heads <= 0 ||
      head_dim <= 0 || head_dim > 256 ||
      (q_seq + kBlockQ - 1) / kBlockQ > 65535 ||
      static_cast<long long>(batch) * heads > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* qi = static_cast<const int*>(q_ids);
  const int* ki = static_cast<const int*>(kv_ids);
  if (fwd90::Sm90Takes(is_bf16, head_dim, {q, k, v, o})) {
    fwd90::Params p;
    if (!fwd90::make_params(&p, q, k, v, o, l, qi, ki, batch, q_seq, kv_seq,
                            heads, scale))
      return static_cast<int>(cudaErrorInvalidValue);
    if (qi)
      return causal ? fwd90::launch<true, false, true>(p, batch, st)
                    : fwd90::launch<false, false, true>(p, batch, st);
    if (l)
      return causal ? fwd90::launch<true, true, false>(p, batch, st)
                    : fwd90::launch<false, true, false>(p, batch, st);
    return causal ? fwd90::launch<true, false, false>(p, batch, st)
                  : fwd90::launch<false, false, false>(p, batch, st);
  }
  if (causal)
    return launch<true>(q, k, v, o, l, qi, ki, batch, q_seq, kv_seq, heads,
                        head_dim, scale, is_bf16, st);
  return launch<false>(q, k, v, o, l, qi, ki, batch, q_seq, kv_seq, heads,
                       head_dim, scale, is_bf16, st);
}

template <int DP, bool kCausal>
int launch_bwd_dp(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int batch, int q_seq, int kv_seq,
                  int heads, int head_dim, float scale, int is_bf16,
                  cudaStream_t stream) {
  const int rows = batch * q_seq * heads;
  const int delta_blocks = (rows + 7) / 8;  // 8 warps of 256 threads
  const bool aligned = aligned16({q, k, v, dout});
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    const bool vec = head_dim % 8 == 0 && aligned;
    flash_attention_bwd_delta_kernel<T><<<delta_blocks, 256, 0, stream>>>(
        static_cast<const T*>(o), tdo, delta, rows, q_seq, heads, head_dim);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv(batch * heads, (kv_seq + kBlockK - 1) / kBlockK);
    const dim3 grid_q(batch * heads, (q_seq + kBlockQ - 1) / kBlockQ);
    const size_t smem = BwdLayout<DP>::kBytes;
    auto dkdv = flash_attention_bwd_dkdv_bf16_kernel<DP, kCausal>;
    auto dqk = flash_attention_bwd_dq_bf16_kernel<DP, kCausal>;
    if ((err = set_smem(dkdv, smem)) != cudaSuccess ||
        (err = set_smem(dqk, smem)) != cudaSuccess)
      return static_cast<int>(err);
    dkdv<<<grid_kv, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        q_seq, kv_seq, heads, head_dim, scale, scale_log2, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dqk<<<grid_q, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), q_seq, kv_seq,
        heads, head_dim, scale, scale_log2, vec);
  } else {
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    const float* tdo = static_cast<const float*>(dout);
    const bool vec = head_dim % 4 == 0 && aligned;
    flash_attention_bwd_delta_kernel<float><<<delta_blocks, 256, 0, stream>>>(
        static_cast<const float*>(o), tdo, delta, rows, q_seq, heads,
        head_dim);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv(batch * heads, (kv_seq + kF32Rows - 1) / kF32Rows);
    const dim3 grid_q(batch * heads, (q_seq + kF32Rows - 1) / kF32Rows);
    const size_t smem = F32BwdLayout<DP>::kBytes;
    auto dkdv = flash_attention_bwd_dkdv_f32_kernel<DP, kCausal>;
    auto dqk = flash_attention_bwd_dq_f32_kernel<DP, kCausal>;
    if ((err = set_smem(dkdv, smem)) != cudaSuccess ||
        (err = set_smem(dqk, smem)) != cudaSuccess)
      return static_cast<int>(err);
    dkdv<<<grid_kv, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), q_seq, kv_seq, heads, head_dim, scale,
        scale_log2, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dqk<<<grid_q, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), q_seq, kv_seq,
        heads, head_dim, scale, scale_log2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCausal>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int batch, int q_seq, int kv_seq,
               int heads, int head_dim, float scale, int is_bf16,
               cudaStream_t stream) {
  if (head_dim <= 64)
    return launch_bwd_dp<64, kCausal>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, batch, q_seq, kv_seq, heads,
                                      head_dim, scale, is_bf16, stream);
  if (head_dim <= 128)
    return launch_bwd_dp<128, kCausal>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, batch, q_seq, kv_seq, heads,
                                       head_dim, scale, is_bf16, stream);
  return launch_bwd_dp<256, kCausal>(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv, batch, q_seq, kv_seq, heads,
                                     head_dim, scale, is_bf16, stream);
}

}  // namespace

// q: contiguous (batch, q_seq, heads, head_dim); k, v, o: contiguous
// (batch, kv_seq, heads, head_dim) and (batch, q_seq, heads, head_dim); one
// type, bf16 (is_bf16 = 1) or fp32 (is_bf16 = 0); head_dim <= 256. causal:
// key j visible to query i iff j <= i. lse: null, or fp32
// (batch * heads, q_seq) for the row log-sum-exp (log2 domain of the scaled
// scores) that the backward takes. Returns a cudaError_t.
extern "C" int flash_attention_forward_lse(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int batch, int q_seq, int kv_seq,
                                           int heads, int head_dim,
                                           float scale, int causal,
                                           int is_bf16, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(q, k, v, o, lse, nullptr, nullptr, batch, q_seq, kv_seq,
                 heads, head_dim, scale, causal, is_bf16, stream);
}

// 1 if flash_attention_forward[_lse|_segment] with these arguments runs the
// Hopper forward of flash_fwd_sm90.cuh, else 0: its launch counter reads
// this.
extern "C" int flash_attention_forward_takes_sm90(const void* q,
                                                  const void* k,
                                                  const void* v,
                                                  const void* o, int head_dim,
                                                  int is_bf16) {
  return fwd90::Sm90Takes(is_bf16, head_dim, {q, k, v, o}) ? 1 : 0;
}

// The serving entry: the forward without the log-sum-exp.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int batch,
                                       int q_seq, int kv_seq, int heads,
                                       int head_dim, float scale, int causal,
                                       int is_bf16, void* stream) {
  return forward(q, k, v, o, nullptr, nullptr, nullptr, batch, q_seq, kv_seq,
                 heads, head_dim, scale, causal, is_bf16, stream);
}

// The forward with segment ids (K7-seg): q_ids and kv_ids are contiguous
// int32 (batch, q_seq) and (batch, kv_seq); query i sees key j only where
// their ids are equal (a pair whose ids differ gets the stock kernel's
// finite mask, so a query whose id no key shares gets the mean of V).
extern "C" int flash_attention_forward_segment(
    const void* q, const void* k, const void* v, void* o, const void* q_ids,
    const void* kv_ids, int batch, int q_seq, int kv_seq, int heads,
    int head_dim, float scale, int causal, int is_bf16, void* stream) {
  if (q_ids == nullptr || kv_ids == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return forward(q, k, v, o, nullptr, q_ids, kv_ids, batch, q_seq, kv_seq,
                 heads, head_dim, scale, causal, is_bf16, stream);
}

// dq, dk, dv of the forward above: q, k, v, o (its output), dout and the
// outputs are contiguous BSHD tensors of one type; lse is the forward's
// (batch * heads, q_seq) fp32 output; delta is fp32 scratch of the same
// size. Returns a cudaError_t.
extern "C" int flash_attention_backward(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int batch, int q_seq,
                                        int kv_seq, int heads, int head_dim,
                                        float scale, int causal, int is_bf16,
                                        void* stream) {
  if (batch <= 0 || q_seq <= 0 || kv_seq <= 0 || heads <= 0 ||
      head_dim <= 0 || head_dim > 256 ||
      (q_seq + kF32Rows - 1) / kF32Rows > 65535 ||
      (kv_seq + kF32Rows - 1) / kF32Rows > 65535 ||
      static_cast<long long>(batch) * q_seq * heads > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (causal)
    return launch_bwd<true>(q, k, v, o, dout, l, dl, dq, dk, dv, batch, q_seq,
                            kv_seq, heads, head_dim, scale, is_bf16, st);
  return launch_bwd<false>(q, k, v, o, dout, l, dl, dq, dk, dv, batch, q_seq,
                           kv_seq, heads, head_dim, scale, is_bf16, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
