// Tail-masked attention for Hopper (sm_90a), BSHD layout: the forward (K1),
// K5/K6, and at the end the entry of the backward (K2), which is the K7
// backward's (flash_bwd.cuh) with q_seq = kv_seq and no causal mask.
//
// The forward replaces the Pallas kernel opendwm_tpu/ops/flash_tail.py:_forward
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
// max and sum per row). Rows and keys past S are never read: loads past
// the end are zero-filled and
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
// kernel is bound by the tensor cores' issue rate on paper. The bf16 launch
// at head dim 64 (every launch on the port's paths) therefore runs the
// Hopper forward of flash_fwd_sm90.cuh, shared with K7: a TMA ring of K/V
// tiles, wgmma for both products, masks on the last tile only and a TMA
// store (the rule that picks it is fwd90::Sm90Takes). The mma.sync body
// below, which loads K/V synchronously and gathers B fragments with scalar
// shared loads, serves the other launches (fp32, D 32 and 128, pointers
// that are not 16-byte aligned) and K5/K6.
//
// When a gradient is needed the forward also writes the row log-sum-exp
// (fp32, in the log2 domain of the scaled scores, (B*H, S)); it is a
// template flag, so the serving launch compiles to the same code as before.
//
// K5 and K6, further down, compute K1's function with another share of work
// per block, the grid steps of the tiling experiment perf/exp_tailvar.py:
// K5 (tail_hpack, :75) gives one block all query rows of nh batch-heads,
// K6 (tail_qsplit, :119) gives one block bq = 128 or 256 query rows of one
// batch-head. Both run the mma.sync per-warp tile step (attend_block_bf16 /
// attend_block_f32), as K1's other launches do, and differ only in how many
// warps share each K/V tile and how many blocks fill the card; their
// redesign comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_fwd_sm90.cuh"
#include "flash_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: register-resident online softmax on mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int DP, int ROWS = kBlockQ>  // ROWS: query rows of the Q tile
struct MmaLayout {
  static constexpr int kLd = DP + 8;  // 16-byte row pad: conflict-free frags
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align128(2 * ROWS * kLd);
  static constexpr size_t kV = kK + align128(2 * kBlockK * kLd);
  static constexpr size_t kBytes = kV + align128(2 * kBlockK * kLd);
};

// One warp's 16 query rows (A fragments qf) against one 64-key K/V tile in
// shared memory: the online-softmax update of the running max m_run, the
// lane's share of the row sum l_run (rows g and g + 8) and the output
// accumulator acc.
template <int DP, int kLd>
__device__ __forceinline__ void tile_step_bf16(
    float (&acc)[DP / 8][4], float (&m_run)[2], float (&l_run)[2],
    const uint32_t (&qf)[DP / 16][4], const __nv_bfloat16* sK,
    const __nv_bfloat16* sV, int kv0, int seq, float scale_log2, int g,
    int t) {
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

// Rows row0 + g and row0 + g + 8 of a warp's 16: the quad's shares of the
// row sum combined, o = acc / l in bf16 (and with kLse the row
// log-sum-exp), rows >= seq skipped.
template <int DP, bool kLse>
__device__ __forceinline__ void store_rows_bf16(
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    const float (&acc)[DP / 8][4], const float (&m_run)[2],
    float (&l_run)[2], int row0, int bh, size_t base, size_t row_stride,
    int seq, int head_dim, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int rows[2] = {row0 + g, row0 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    if (kLse && t == 0)
      lse[static_cast<size_t>(bh) * seq + rows[r]] =
          m_run[r] + log2f(l_run[r]);
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

// WARPS warps attend the WARPS * 16 * MT query rows [q0, ...) of batch-head
// bh (BSHD offset base) over all seq keys: warp w owns rows
// [16 MT w, 16 MT (w + 1)) of the block as MT m-tiles of 16, and every K/V
// tile loaded into shared memory serves all of them. Q's A fragments stay
// in registers unless DP * MT > 128, where they are reloaded from the
// shared Q tile for each K/V tile to bound the registers.
template <int DP, int WARPS, int MT, bool kLse>
__device__ __forceinline__ void attend_block_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, unsigned char* smem, int bh, size_t base,
    size_t row_stride, int q0, int seq, int head_dim, float scale_log2,
    bool vec) {
  constexpr int kRows = WARPS * 16 * MT;
  constexpr int kNT = WARPS * 32;
  constexpr bool kQRegs = DP * MT <= 128;
  using L = MmaLayout<DP, kRows>;
  constexpr int kLd = L::kLd;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_tile<__nv_bfloat16, DP, kLd, kRows, kNT>(sQ, q, base, row_stride, q0,
                                                seq, head_dim, vec, tid);
  __syncthreads();

  const __nv_bfloat16* wq = sQ + warp * 16 * MT * kLd;
  uint32_t qf[kQRegs ? MT : 1][DP / 16][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ld_a_frag(qf[mt][kk], wq + mt * 16 * kLd, kLd, kk * 16, g, t);
  }

  float acc[MT][DP / 8][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < DP / 8; ++d)
      acc[mt][d][0] = acc[mt][d][1] = acc[mt][d][2] = acc[mt][d][3] = 0.0f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.0f;
  }

  for (int kv0 = 0; kv0 < seq; kv0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<__nv_bfloat16, DP, kLd, kBlockK, kNT>(sK, k, base, row_stride,
                                                    kv0, seq, head_dim, vec,
                                                    tid);
    load_tile<__nv_bfloat16, DP, kLd, kBlockK, kNT>(sV, v, base, row_stride,
                                                    kv0, seq, head_dim, vec,
                                                    tid);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (kQRegs) {
        tile_step_bf16<DP, kLd>(acc[mt], m_run[mt], l_run[mt], qf[mt], sK,
                                sV, kv0, seq, scale_log2, g, t);
      } else {
        uint32_t qs[DP / 16][4];
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ld_a_frag(qs[kk], wq + mt * 16 * kLd, kLd, kk * 16, g, t);
        tile_step_bf16<DP, kLd>(acc[mt], m_run[mt], l_run[mt], qs, sK, sV,
                                kv0, seq, scale_log2, g, t);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows_bf16<DP, kLse>(o, lse, acc[mt], m_run[mt], l_run[mt],
                              q0 + (warp * MT + mt) * 16, bh, base,
                              row_stride, seq, head_dim, g, t);
}

// K1: one block of 4 warps per 64 query rows of one (batch, head).
template <int DP, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_tail_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int seq, int heads,
                           int head_dim, float scale_log2, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);
  attend_block_bf16<DP, kWarps, 1, kLse>(q, k, v, o, lse, smem, bh, base,
                                         row_stride, blockIdx.y * kBlockQ,
                                         seq, head_dim, scale_log2, vec);
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

// 4 warps attend the 64 query rows [q0, q0 + 64) of batch-head bh over all
// seq keys, streaming 64-key K/V tiles.
template <int DP, bool kLse>
__device__ __forceinline__ void attend_block_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, unsigned char* smem, int bh, size_t base,
    size_t row_stride, int q0, int seq, int head_dim, float scale_log2,
    bool vec) {
  using L = F32Layout<DP>;
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

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
    if (kLse && half == 0)
      lse[static_cast<size_t>(bh) * seq + s] = m_run + log2f(l_run);
    const float inv = 1.0f / l_run;
    float* out = o + base + s * row_stride;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d)
      if (d < head_dim) out[d] = wO[d] * inv;
  }
}

template <int DP, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_tail_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int seq, int heads,
                          int head_dim, float scale_log2, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);
  attend_block_f32<DP, kLse>(q, k, v, o, lse, smem, bh, base, row_stride,
                             blockIdx.y * kBlockQ, seq, head_dim, scale_log2,
                             vec);
}

// ---------------------------------------------------------------------------
// K5 / K6: K1's function with the tiling experiment's share of work
// ---------------------------------------------------------------------------
//
// Replace the Pallas kernels of perf/exp_tailvar.py: tail_hpack (K5, body
// _hpack_kernel) and tail_qsplit (K6, body _qsplit_kernel). Both compute
// K1's function: softmax over the S valid keys of q k^T * scale in fp32,
// the unnormalised probabilities rounded to the input type before the
// product with v, the fp32 sum divided out at the end. The TPU kernels take
// the whole softmax row at once; here it is K1's online softmax over 64-key
// tiles, which rounds p relative to the running max instead of the final
// one (a bf16 rounding apart).
//
// Each block owns the query rows [y * rows, min((y + 1) * rows, seq)) of
// the nh batch-heads [x * nh, (x + 1) * nh), the share of one TPU grid step:
//   K6, tail_qsplit(bq): nh = 1, rows = bq, grid (B*H, Sp / bq). bf16: 8
//     warps own the bq rows at once (16 rows a warp at bq 128, 32 at bq
//     256), so each K/V tile in shared memory serves 128 or 256 rows,
//     against K1's 64;
//   K5, tail_hpack(nh): rows = seq, grid (B*H / nh, 1). bf16: 8 warps walk
//     the nh heads' rows in 128-row blocks, one block after another.
// fp32 takes K1's 64-row FMA step over the same share. What bounds them is
// K1's bound; the CTA share decides how often K/V is reloaded per query row
// and how well the blocks fill 132 SMs (K5 at nh 4 has 216 blocks at
// B*H = 864).

constexpr int kTilingWarps = 8;
constexpr int kTilingRows = kTilingWarps * 16;  // bf16 rows of one m-tile pass

// At one m-tile a warp and D <= 64, two blocks an SM (128 registers a
// thread) keep 16 warps resident, as K1's 4-warp blocks do: uncapped,
// ptxas gave the D 64 instance 136 registers, one block an SM, and half
// K1's speed. At two m-tiles (~254 registers at D 64) or D 128 one fits.
template <int DP, int MT>
__global__ void __launch_bounds__(kTilingWarps * 32,
                                  MT == 1 && DP <= 64 ? 2 : 1)
    tail_tiling_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int seq, int heads,
                            int head_dim, float scale_log2, bool vec, int nh,
                            int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const int row0 = blockIdx.y * rows;
  const int row_end = min(row0 + rows, seq);
  for (int i = 0; i < nh; ++i) {
    const int bh = blockIdx.x * nh + i;
    const int b = bh / heads;
    const int h = bh - b * heads;
    const size_t base = (static_cast<size_t>(b) * seq * heads + h) *
                        static_cast<size_t>(head_dim);
    for (int q0 = row0; q0 < row_end; q0 += kTilingRows * MT) {
      __syncthreads();  // every warp is done with the previous rows' tiles
      attend_block_bf16<DP, kTilingWarps, MT, false>(
          q, k, v, o, nullptr, smem, bh, base, row_stride, q0, seq, head_dim,
          scale_log2, vec);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    tail_tiling_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int seq, int heads, int head_dim, float scale_log2,
                           bool vec, int nh, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t row_stride = static_cast<size_t>(heads) * head_dim;
  const int row0 = blockIdx.y * rows;
  const int row_end = min(row0 + rows, seq);
  for (int i = 0; i < nh; ++i) {
    const int bh = blockIdx.x * nh + i;
    const int b = bh / heads;
    const int h = bh - b * heads;
    const size_t base = (static_cast<size_t>(b) * seq * heads + h) *
                        static_cast<size_t>(head_dim);
    for (int q0 = row0; q0 < row_end; q0 += kBlockQ) {
      __syncthreads();  // every warp is done with the previous rows' tiles
      attend_block_f32<DP, false>(q, k, v, o, nullptr, smem, bh, base,
                                  row_stride, q0, seq, head_dim, scale_log2,
                                  vec);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              float* lse, int batch, int seq, int heads, int head_dim,
              float scale, int is_bf16, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  const bool aligned = aligned16({q, k, v});
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (is_bf16) {
    const bool vec = head_dim % 8 == 0 && aligned;
    auto kernel = lse ? flash_tail_bf16_kernel<DP, true>
                      : flash_tail_bf16_kernel<DP, false>;
    const size_t smem = MmaLayout<DP>::kBytes;
    err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, seq, heads, head_dim, scale_log2, vec);
  } else {
    const bool vec = head_dim % 4 == 0 && aligned;
    auto kernel = lse ? flash_tail_f32_kernel<DP, true>
                      : flash_tail_f32_kernel<DP, false>;
    const size_t smem = F32Layout<DP>::kBytes;
    err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, seq, heads,
        head_dim, scale_log2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int seq, int heads, int head_dim) {
  return batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
         head_dim > 128 || (seq + kBlockQ - 1) / kBlockQ > 65535 ||
         static_cast<long long>(batch) * seq * heads > (1LL << 26);
}

// K5 / K6: blocks of nh batch-heads x `rows` query rows (rows = seq for
// K5), bf16 in 8 warps of mt m-tiles of 16 rows.
template <int DP>
int launch_tiling_dp(const void* q, const void* k, const void* v, void* o,
                     int batch, int seq, int heads, int head_dim, float scale,
                     int is_bf16, int nh, int rows, int mt,
                     cudaStream_t stream) {
  const dim3 grid(batch * heads / nh, (seq + rows - 1) / rows);
  const bool aligned = aligned16({q, k, v});
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (is_bf16) {
    const bool vec = head_dim % 8 == 0 && aligned;
    auto kernel = mt == 2 ? tail_tiling_bf16_kernel<DP, 2>
                          : tail_tiling_bf16_kernel<DP, 1>;
    const size_t smem = mt == 2 ? MmaLayout<DP, 2 * kTilingRows>::kBytes
                                : MmaLayout<DP, kTilingRows>::kBytes;
    err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kTilingWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        seq, heads, head_dim, scale_log2, vec, nh, rows);
  } else {
    const bool vec = head_dim % 4 == 0 && aligned;
    auto kernel = tail_tiling_f32_kernel<DP>;
    const size_t smem = F32Layout<DP>::kBytes;
    err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
        head_dim, scale_log2, vec, nh, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_tiling(const void* q, const void* k, const void* v, void* o,
                  int batch, int seq, int heads, int head_dim, float scale,
                  int is_bf16, int nh, int rows, int mt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim <= 32)
    return launch_tiling_dp<32>(q, k, v, o, batch, seq, heads, head_dim,
                                scale, is_bf16, nh, rows, mt, st);
  if (head_dim <= 64)
    return launch_tiling_dp<64>(q, k, v, o, batch, seq, heads, head_dim,
                                scale, is_bf16, nh, rows, mt, st);
  return launch_tiling_dp<128>(q, k, v, o, batch, seq, heads, head_dim,
                               scale, is_bf16, nh, rows, mt, st);
}

}  // namespace

// q, k, v, o: contiguous (batch, seq, heads, head_dim) tensors of one type,
// bf16 (is_bf16 = 1) or fp32 (is_bf16 = 0). lse: null, or fp32
// (batch * heads, seq) for the row log-sum-exp (log2 domain of the scaled
// scores) that the backward takes. Returns a cudaError_t.
extern "C" int flash_tail_forward_lse(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int batch, int seq, int heads,
                                      int head_dim, float scale, int is_bf16,
                                      void* stream) {
  if (bad_shape(batch, seq, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (fwd90::Sm90Takes(is_bf16, head_dim, {q, k, v, o})) {
    fwd90::Params p;
    if (!fwd90::make_params(&p, q, k, v, o, l, nullptr, nullptr, batch, seq,
                            seq, heads, scale))
      return static_cast<int>(cudaErrorInvalidValue);
    return l ? fwd90::launch<false, true, false>(p, batch, st)
             : fwd90::launch<false, false, false>(p, batch, st);
  }
  if (head_dim <= 32)
    return launch_dp<32>(q, k, v, o, l, batch, seq, heads, head_dim, scale,
                         is_bf16, st);
  if (head_dim <= 64)
    return launch_dp<64>(q, k, v, o, l, batch, seq, heads, head_dim, scale,
                         is_bf16, st);
  return launch_dp<128>(q, k, v, o, l, batch, seq, heads, head_dim, scale,
                        is_bf16, st);
}

// 1 if flash_tail_forward[_lse] with these arguments runs the Hopper forward
// of flash_fwd_sm90.cuh, else 0: its launch counter reads this.
extern "C" int flash_tail_forward_takes_sm90(const void* q, const void* k,
                                             const void* v, const void* o,
                                             int head_dim, int is_bf16) {
  return fwd90::Sm90Takes(is_bf16, head_dim, {q, k, v, o}) ? 1 : 0;
}

// The serving entry: the forward without the log-sum-exp.
extern "C" int flash_tail_forward(const void* q, const void* k, const void* v,
                                  void* o, int batch, int seq, int heads,
                                  int head_dim, float scale, int is_bf16,
                                  void* stream) {
  return flash_tail_forward_lse(q, k, v, o, nullptr, batch, seq, heads,
                                head_dim, scale, is_bf16, stream);
}

// dq, dk, dv of the forward above: K2 is flash_bwd::backward
// (flash_bwd.cuh, shared with the K7 backward) with q_seq = kv_seq = seq
// and no causal mask. q, k, v, o (its output), dout and the outputs are
// contiguous BSHD tensors of one type; lse is the forward's
// (batch * heads, seq) fp32 output; delta is fp32 scratch of the same size;
// dq_ws is the fp32 dQ workspace of the Hopper backward,
// (batch * heads, seq rounded up to 64, 64), when
// flash_tail_backward_takes_sm90 says it runs, else null. Returns a
// cudaError_t.
extern "C" int flash_tail_backward(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq_ws, void* dq,
                                   void* dk, void* dv, int batch, int seq,
                                   int heads, int head_dim, float scale,
                                   int is_bf16, void* stream) {
  if (bad_shape(batch, seq, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  return flash_bwd::backward<false>(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq_ws), dq, dk, dv,
      batch, seq, seq, heads, head_dim, scale, is_bf16,
      static_cast<cudaStream_t>(stream));
}

// 1 if flash_tail_backward with these arguments runs the Hopper backward of
// flash_bwd_sm90.cuh (and needs its dQ workspace), else 0: its launch
// counter reads this.
extern "C" int flash_tail_backward_takes_sm90(const void* q, const void* k,
                                              const void* v, const void* dout,
                                              const void* dk, const void* dv,
                                              int head_dim, int is_bf16) {
  return bwd90::Sm90BwdTakes(is_bf16, head_dim, q, k, v, dout, dk, dv) ? 1
                                                                        : 0;
}

// K5: q, k, v, o as for flash_tail_forward; one block per nh batch-heads
// (heads % nh == 0), all of their query rows. Returns a cudaError_t.
extern "C" int tail_hpack_forward(const void* q, const void* k, const void* v,
                                  void* o, int batch, int seq, int heads,
                                  int head_dim, float scale, int is_bf16,
                                  int nh, void* stream) {
  if (bad_shape(batch, seq, heads, head_dim) || nh <= 0 || heads % nh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiling(q, k, v, o, batch, seq, heads, head_dim, scale,
                       is_bf16, nh, seq, 1, stream);
}

// K6: q, k, v, o as for flash_tail_forward; one block per bq query rows of
// one batch-head, bq 128 or 256 dividing seq padded to a multiple of 128.
// Returns a cudaError_t.
extern "C" int tail_qsplit_forward(const void* q, const void* k,
                                   const void* v, void* o, int batch, int seq,
                                   int heads, int head_dim, float scale,
                                   int is_bf16, int bq, void* stream) {
  const int padded = (seq + 127) / 128 * 128;
  if (bad_shape(batch, seq, heads, head_dim) || (bq != 128 && bq != 256) ||
      padded % bq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiling(q, k, v, o, batch, seq, heads, head_dim, scale,
                       is_bf16, 1, bq, bq / kTilingRows, stream);
}

extern "C" const char* flash_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
