// Flash attention for Hopper (sm_90a), BSHD layout: the forward (K7) and,
// at the end, the entry of its backward (flash_bwd.cuh, shared with K2).
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
// aligned). The backward is flash_bwd.cuh's, which K2 launches too: the
// Hopper backward of flash_bwd_sm90.cuh at bf16 D 64, mma.sync and FMA
// bodies for the rest.
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

#include "flash_bwd.cuh"
#include "flash_fwd_sm90.cuh"
#include "flash_mma.cuh"

namespace {

// The stock kernel's DEFAULT_MASK_VALUE, added to a pair whose segment ids
// differ.
constexpr float kSegmentMask = -0.7f * 3.402823466e38f;
// Shared bytes of the ids of a block's 64 queries and of one key tile.
constexpr size_t kIdBytes = 2 * 64 * sizeof(int);

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
// Launch
// ---------------------------------------------------------------------------

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

// dq, dk, dv of the forward above (flash_bwd::backward, flash_bwd.cuh):
// q, k, v, o (its output), dout and the outputs are contiguous BSHD tensors
// of one type; lse is the forward's (batch * heads, q_seq) fp32 output;
// delta is fp32 scratch of the same size; dq_ws is the fp32 dQ workspace
// of the Hopper backward, (batch * heads, q_seq rounded up to 64, 64), when
// flash_attention_backward_takes_sm90 says it runs, else null. Returns a
// cudaError_t.
extern "C" int flash_attention_backward(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq_ws, void* dq,
                                        void* dk, void* dv, int batch,
                                        int q_seq, int kv_seq, int heads,
                                        int head_dim, float scale, int causal,
                                        int is_bf16, void* stream) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* ws = static_cast<float*>(dq_ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return flash_bwd::backward<true>(q, k, v, o, dout, l, dl, ws, dq, dk, dv,
                                     batch, q_seq, kv_seq, heads, head_dim,
                                     scale, is_bf16, st);
  return flash_bwd::backward<false>(q, k, v, o, dout, l, dl, ws, dq, dk, dv,
                                    batch, q_seq, kv_seq, heads, head_dim,
                                    scale, is_bf16, st);
}

// 1 if flash_attention_backward with these arguments runs the Hopper
// backward of flash_bwd_sm90.cuh (and needs its dQ workspace), else 0: its
// launch counter reads this.
extern "C" int flash_attention_backward_takes_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* dk, const void* dv, int head_dim, int is_bf16) {
  return bwd90::Sm90BwdTakes(is_bf16, head_dim, q, k, v, dout, dk, dv) ? 1
                                                                        : 0;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
