// The attention backward's bodies and its one entry, which both sources
// include: K2 (flash_tail.cu, q_seq = kv_seq, no causal mask) and the K7
// backward (flash_attention.cu) launch backward() below.
//
// backward() runs the Hopper kernel of flash_bwd_sm90.cuh for every launch
// that Sm90BwdTakes takes (bf16, head dim 64, the tensors TMA touches
// 16-byte aligned: every backward on the port's paths). The other launches
// (fp32, for the fp32 checks and the tiny models; head dims other than 64;
// unaligned pointers) run the mma.sync and FMA bodies below. There is no
// fallback at run time: a launch that Sm90BwdTakes takes runs the Hopper
// kernel or returns its error.
//
// The bodies below replace, in exact arithmetic, the same Pallas kernels
// as the Hopper one: K2 (opendwm_tpu/ops/flash_tail.py:_backward, body
// _bwd_kernel) and the stock backward (_flash_attention_bwd_dkv, body
// _flash_attention_dkv_kernel, and _flash_attention_bwd_dq, body
// _flash_attention_dq_kernel). P = exp(S * scale - lse) with the forward's
// row log-sum-exp (the stock kernel keeps the row max m and sum l apart;
// K2's Pallas body recomputes them; here one lse in the log2 domain of the
// scaled scores), dV = P^T dO with P rounded to the input type,
// dP = dO V^T, dS = P (dP - delta) * scale with delta = rowsum(dO o O)
// (the stock kernel's di; K2's Pallas body takes rowsum(dP o P), equal in
// exact arithmetic since O = P V / sum), rounded to the input type,
// dQ = dS K, dK = dS^T Q; fp32 accumulators, outputs in the input type.
// Hidden keys get probability 0 (the stock kernel adds DEFAULT_MASK_VALUE,
// whose exp is 0 too). They mask by bounds, so any q and kv length works
// (K2's ragged tails), with the top-left causal mask.
//
// Design of these bodies: three launches, no atomics, so the result is
// deterministic:
//   1. delta: bwd90::delta_kernel, one warp per (b, s, h) query row;
//   2. dk/dv: one block per (b*h, 64-key tile); each warp owns 16 keys and
//      loops over 64-query tiles, recomputing S^T = K Q^T and dP^T = V dO^T
//      on mma.sync and accumulating dV += P^T dO, dK += dS^T Q in fp32
//      registers. Causal: the query tiles wholly above the diagonal (every
//      query before the tile's first key) are skipped;
//   3. dq: one block per (b*h, 64-query tile); each warp owns 16 queries and
//      loops over 64-key tiles, recomputing S and dP and accumulating
//      dQ += dS K. Causal: the key tiles wholly right of the query tile are
//      skipped, as in the forward.
// Head dims pad to 64, 128 or 256 (K2's 32 <= D <= 128 included). At 256
// the two accumulators of dk/dv would take 256 registers a thread, so both
// kernels accumulate 128 output columns per pass and recompute S and dP for
// the second pass; the dq kernel then also reloads the A fragments of Q and
// dO from shared memory, as the forward does at 256. fp32 inputs take a
// plain FMA path of the same split. What bounds them: 7 products of
// S x S x D per head against the 5 the math needs, and the scalar
// shared-memory gathers of the transposed B fragments.

#pragma once

#include "flash_bwd_sm90.cuh"
#include "flash_mma.cuh"

namespace {
namespace flash_bwd {

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

template <int DP, bool kCausal>
int launch_bwd_dp(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int batch, int q_seq, int kv_seq,
                  int heads, int head_dim, float scale, int is_bf16,
                  cudaStream_t stream) {
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
    const int rc = bwd90::launch_delta<T>(o, dout, delta, batch, q_seq,
                                          heads, head_dim, nullptr, 0, stream);
    if (rc != 0) return rc;
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
    const int rc = bwd90::launch_delta<float>(o, dout, delta, batch, q_seq,
                                              heads, head_dim, nullptr, 0,
                                              stream);
    if (rc != 0) return rc;
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

// dq, dk, dv of the forward's (o, lse): q, o, dout and dq (batch, q_seq,
// heads, head_dim), k, v, dk, dv (batch, kv_seq, heads, head_dim),
// contiguous, one type, bf16 (is_bf16 = 1) or fp32, head_dim <= 256; lse
// the forward's (batch * heads, q_seq) fp32 log-sum-exp; delta fp32 scratch
// like lse; dq_ws the Hopper kernel's fp32 dQ workspace of
// bwd90::workspace_entries when Sm90BwdTakes takes the launch, else
// unused. kCausal: key j visible to query i iff j <= i. Returns a
// cudaError_t.
template <bool kCausal>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, float* dq_ws,
             void* dq, void* dk, void* dv, int batch, int q_seq, int kv_seq,
             int heads, int head_dim, float scale, int is_bf16,
             cudaStream_t stream) {
  if (batch <= 0 || q_seq <= 0 || kv_seq <= 0 || heads <= 0 ||
      head_dim <= 0 || head_dim > 256 ||
      (q_seq + kF32Rows - 1) / kF32Rows > 65535 ||
      (kv_seq + kF32Rows - 1) / kF32Rows > 65535 ||
      static_cast<long long>(batch) * q_seq * heads > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bwd90::Sm90BwdTakes(is_bf16, head_dim, q, k, v, dout, dk, dv)) {
    if (dq_ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return bwd90::launch<kCausal>(q, k, v, o, dout, lse, delta, dq_ws, dq, dk,
                                  dv, batch, q_seq, kv_seq, heads, scale,
                                  stream);
  }
  return launch_bwd<kCausal>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                             q_seq, kv_seq, heads, head_dim, scale, is_bf16,
                             stream);
}

}  // namespace flash_bwd
}  // namespace
