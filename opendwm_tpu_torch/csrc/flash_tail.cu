// Tail-masked attention for Hopper (sm_90a), BSHD layout: the forward (K1)
// and, further down, the backward (K2).
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

#include <initializer_list>

#include "flash_fwd_sm90.cuh"

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

// Copies rows [row0, row0 + ROWS) of one head of a BSHD tensor into a
// (ROWS, ld) shared tile, zero-filling rows >= seq and columns >= head_dim;
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
//
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
// Backward (K2)
// ---------------------------------------------------------------------------
//
// Replaces the Pallas kernel opendwm_tpu/ops/flash_tail.py:_backward (body
// _bwd_kernel): dq, dk, dv of the masked softmax attention, with the
// probability matrix never in global memory. Same math as _bwd_kernel in
// exact arithmetic: P = exp(S * scale - lse) (the forward's row
// log-sum-exp stands in for the recomputed max and sum), dV = P^T dO with
// P rounded to the input type, dP = dO V^T, dS = P (dP - delta) * scale
// rounded to the input type, dQ = dS K, dK = dS^T Q, fp32 accumulators,
// outputs in the input type. delta = rowsum(dO o O) equals _bwd_kernel's
// rowsum(dP o P) in exact arithmetic (O = P V / sum).
//
// Design. The TPU kernel holds one whole padded head in VMEM and
// recomputes the full softmax per batch-head in one grid step. On Hopper
// the work is split into three launches, none with atomics, so the result
// is deterministic:
//   1. delta: one warp per (b, s, h) row, fp32 dot of dO and O;
//   2. dk/dv: one block per (b*h, 64-key tile); each warp owns 16 keys and
//      loops over 64-query tiles, recomputing S^T = K Q^T and dP^T = V dO^T
//      on mma.sync and accumulating dV += P^T dO, dK += dS^T Q in fp32
//      registers;
//   3. dq: one block per (b*h, 64-query tile); each warp owns 16 queries and
//      loops over 64-key tiles, recomputing S and dP and accumulating
//      dQ += dS K.
// The C fragments of S^T / dS^T (and S / dS) are fed straight back as A
// fragments, as K1 does with P. Rows and keys past S are zero-filled on
// load and get probability 0, and offsets come from the BSHD strides: no
// padded copy and no head transpose. What bounds it: S and dP are computed
// twice (once per kernel), 7 S*S*D products against the 5 of _bwd_kernel,
// and the B fragments of dO, Q and K are gathered from shared memory with
// scalar loads; the tensor cores' issue rate on paper, the shared-memory
// gathers in practice. ldmatrix, wgmma and TMA are later work. fp32 inputs
// take a plain FMA path of the same split, for the fp32 comparison.

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[(b * heads + h) * seq + s] = sum_d dO[b, s, h, d] * O[b, s, h, d].
template <typename T>
__global__ void flash_tail_bwd_delta_kernel(const T* __restrict__ o,
                                            const T* __restrict__ dout,
                                            float* __restrict__ delta,
                                            int rows, int seq, int heads,
                                            int head_dim) {
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
    const int b = row / (seq * heads);
    const int rem = row - b * seq * heads;
    const int s = rem / heads;
    const int h = rem - s * heads;
    delta[(static_cast<size_t>(b) * heads + h) * seq + s] = acc;
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

// Score fragments 2j, 2j + 1 (fp32 C layout) as the A fragment of columns
// [16j, 16j + 16), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_pair(lo[0], lo[1]);
  a[1] = pack_pair(lo[2], lo[3]);
  a[2] = pack_pair(hi[0], hi[1]);
  a[3] = pack_pair(hi[2], hi[3]);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_tail_bwd_dkdv_bf16_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int seq, int heads, int head_dim, float scale, float scale_log2,
        bool vec) {
  using L = BwdLayout<DP>;
  constexpr int kLd = L::kLd;
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
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);
  const float* lse_bh = lse + static_cast<size_t>(bh) * seq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * seq;

  load_tile<__nv_bfloat16, DP, kLd>(sK, k, base, row_stride, k0, seq,
                                    head_dim, vec, tid);
  load_tile<__nv_bfloat16, DP, kLd>(sV, v, base, row_stride, k0, seq,
                                    head_dim, vec, tid);
  const __nv_bfloat16* wk = sK + warp * 16 * kLd;
  const __nv_bfloat16* wv = sV + warp * 16 * kLd;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[d][i] = dv_acc[d][i] = 0.0f;

  for (int q0 = 0; q0 < seq; q0 += kBlockQ) {
    __syncthreads();  // the previous query tile is consumed by every warp
    load_tile<__nv_bfloat16, DP, kLd>(sQ, q, base, row_stride, q0, seq,
                                      head_dim, vec, tid);
    load_tile<__nv_bfloat16, DP, kLd>(sDo, dout, base, row_stride, q0, seq,
                                      head_dim, vec, tid);
    if (tid < kBlockQ) {
      const int r = q0 + tid;
      sLse[tid] = r < seq ? lse_bh[r] : 0.0f;
      sDelta[tid] = r < seq ? delta_bh[r] : 0.0f;
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

    // P^T = exp2(S^T * scale_log2 - lse) and dS^T = P^T (dP^T - delta) * scale;
    // query rows and keys past seq get probability 0.
#pragma unroll
    for (int n = 0; n < kBlockQ / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = n * 8 + 2 * t + (i & 1);
        float p = 0.0f;
        if (q0 + qc < seq && keys[i >> 1] < seq)
          p = exp2f(s[n][i] * scale_log2 - sLse[qc]);
        s[n][i] = p;
        dp[n][i] = p * (dp[n][i] - sDelta[qc]) * scale;
      }
    }

    // dV += P^T dO, dK += dS^T Q over the tile's 64 queries.
#pragma unroll
    for (int j = 0; j < kBlockQ / 16; ++j) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * j], s[2 * j + 1]);
      c_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int d = 0; d < DP / 8; ++d) {
        uint32_t bo[2], bq[2];
        ld_b_cols(bo, sDo, kLd, j * 16, d * 8, g, t);
        ld_b_cols(bq, sQ, kLd, j * 16, d * 8, g, t);
        mma_16816(dv_acc[d], pa, bo);
        mma_16816(dk_acc[d], da, bq);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= seq) continue;
    const size_t off = base + keys[r] * row_stride;
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int c = d * 8 + 2 * t;
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_tail_bwd_dq_bf16_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, int seq, int heads, int head_dim,
        float scale, float scale_log2, bool vec) {
  using L = BwdLayout<DP>;
  constexpr int kLd = L::kLd;
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
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);

  load_tile<__nv_bfloat16, DP, kLd>(sQ, q, base, row_stride, q0, seq,
                                    head_dim, vec, tid);
  load_tile<__nv_bfloat16, DP, kLd>(sDo, dout, base, row_stride, q0, seq,
                                    head_dim, vec, tid);
  __syncthreads();

  uint32_t qf[DP / 16][4], of[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ld_a_frag(qf[kk], sQ + warp * 16 * kLd, kLd, kk * 16, g, t);
    ld_a_frag(of[kk], sDo + warp * 16 * kLd, kLd, kk * 16, g, t);
  }
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < seq;
    row_lse[r] = ok ? lse[static_cast<size_t>(bh) * seq + rows[r]] : 0.0f;
    row_delta[r] = ok ? delta[static_cast<size_t>(bh) * seq + rows[r]] : 0.0f;
  }

  float dq_acc[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[d][i] = 0.0f;

  for (int kv0 = 0; kv0 < seq; kv0 += kBlockK) {
    __syncthreads();  // the previous K/V tile is consumed by every warp
    load_tile<__nv_bfloat16, DP, kLd>(sK, k, base, row_stride, kv0, seq,
                                      head_dim, vec, tid);
    load_tile<__nv_bfloat16, DP, kLd>(sV, v, base, row_stride, kv0, seq,
                                      head_dim, vec, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp.
    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t bk[2], bv[2];
        ld_b_rows(bk, sK, kLd, n * 8, kk * 16, g, t);
        ld_b_rows(bv, sV, kLd, n * 8, kk * 16, g, t);
        mma_16816(s[n], qf[kk], bk);
        mma_16816(dp[n], of[kk], bv);
      }
    }

    // dS = P (dP - delta) * scale with P = exp2(S * scale_log2 - lse);
    // key columns past seq get probability 0.
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + n * 8 + 2 * t + (i & 1);
        float p = 0.0f;
        if (col < seq) p = exp2f(s[n][i] * scale_log2 - row_lse[i >> 1]);
        s[n][i] = p * (dp[n][i] - row_delta[i >> 1]) * scale;
      }
    }

    // dQ += dS K over the tile's 64 keys.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t da[4];
      c_to_a(da, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int d = 0; d < DP / 8; ++d) {
        uint32_t bk[2];
        ld_b_cols(bk, sK, kLd, j * 16, d * 8, g, t);
        mma_16816(dq_acc[d], da, bk);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    __nv_bfloat16* out = dq + base + rows[r] * row_stride;
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int c = d * 8 + 2 * t;
      if (c < head_dim) out[c] = __float2bfloat16(dq_acc[d][2 * r]);
      if (c + 1 < head_dim) out[c + 1] = __float2bfloat16(dq_acc[d][2 * r + 1]);
    }
  }
}

// fp32 backward: the same split with plain FMAs. A block owns 32 keys (dk/dv)
// or 32 queries (dq); thread tid owns row tid / 4 of them and every fourth
// column from tid % 4, so its accumulators stay in registers; probabilities
// and dS go through shared memory.
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_tail_bwd_dkdv_f32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int seq, int heads,
        int head_dim, float scale, float scale_log2, bool vec) {
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
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);

  load_tile<float, DP, kLdT, kF32Rows>(sK, k, base, row_stride, k0, seq,
                                       head_dim, vec, tid);
  load_tile<float, DP, kLdT, kF32Rows>(sV, v, base, row_stride, k0, seq,
                                       head_dim, vec, tid);
  float dk_acc[DP / 4], dv_acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  const bool key_ok = k0 + r < seq;

  for (int q0 = 0; q0 < seq; q0 += 64) {
    __syncthreads();
    load_tile<float, DP, kLdT>(sQ, q, base, row_stride, q0, seq, head_dim,
                               vec, tid);
    load_tile<float, DP, kLdT>(sDo, dout, base, row_stride, q0, seq,
                               head_dim, vec, tid);
    if (tid < 64) {
      const int row = q0 + tid;
      sLse[tid] = row < seq ? lse[static_cast<size_t>(bh) * seq + row] : 0.0f;
      sDelta[tid] =
          row < seq ? delta[static_cast<size_t>(bh) * seq + row] : 0.0f;
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
      if (key_ok && q0 + j < seq) p = exp2f(sv * scale_log2 - sLse[j]);
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

  if (key_ok) {
    const size_t off = base + (k0 + r) * row_stride;
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_tail_bwd_dq_f32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int seq, int heads, int head_dim, float scale,
        float scale_log2, bool vec) {
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
  const size_t base =
      (static_cast<size_t>(b) * seq * heads + h) * static_cast<size_t>(head_dim);

  load_tile<float, DP, kLdT, kF32Rows>(sQ, q, base, row_stride, q0, seq,
                                       head_dim, vec, tid);
  load_tile<float, DP, kLdT, kF32Rows>(sDo, dout, base, row_stride, q0, seq,
                                       head_dim, vec, tid);
  const bool row_ok = q0 + r < seq;
  const size_t stat = static_cast<size_t>(bh) * seq + q0 + r;
  const float row_lse = row_ok ? lse[stat] : 0.0f;
  const float row_delta = row_ok ? delta[stat] : 0.0f;
  float dq_acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dq_acc[i] = 0.0f;

  for (int kv0 = 0; kv0 < seq; kv0 += 64) {
    __syncthreads();
    load_tile<float, DP, kLdT>(sK, k, base, row_stride, kv0, seq, head_dim,
                               vec, tid);
    load_tile<float, DP, kLdT>(sV, v, base, row_stride, kv0, seq, head_dim,
                               vec, tid);
    __syncthreads();
    for (int jj = 0; jj < 16; ++jj) {
      const int j = c0 + 4 * jj;
      float sv = 0.0f, dpv = 0.0f;
      for (int d = 0; d < DP; ++d) {
        sv += sQ[r * kLdT + d] * sK[j * kLdT + d];
        dpv += sDo[r * kLdT + d] * sV[j * kLdT + d];
      }
      float p = 0.0f;
      if (kv0 + j < seq) p = exp2f(sv * scale_log2 - row_lse);
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
    float* out = dq + base + (q0 + r) * row_stride;
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

template <int DP>
int launch_bwd_dp(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int batch, int seq, int heads,
                  int head_dim, float scale, int is_bf16,
                  cudaStream_t stream) {
  const int rows = batch * seq * heads;
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
    flash_tail_bwd_delta_kernel<T><<<delta_blocks, 256, 0, stream>>>(
        static_cast<const T*>(o), tdo, delta, rows, seq, heads, head_dim);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv(batch * heads, (seq + kBlockK - 1) / kBlockK);
    const dim3 grid_q(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
    const size_t smem = BwdLayout<DP>::kBytes;
    auto dkdv = flash_tail_bwd_dkdv_bf16_kernel<DP>;
    auto dqk = flash_tail_bwd_dq_bf16_kernel<DP>;
    if ((err = set_smem(dkdv, smem)) != cudaSuccess ||
        (err = set_smem(dqk, smem)) != cudaSuccess)
      return static_cast<int>(err);
    dkdv<<<grid_kv, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        seq, heads, head_dim, scale, scale_log2, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dqk<<<grid_q, kThreads, smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                                            static_cast<T*>(dq), seq, heads,
                                            head_dim, scale, scale_log2, vec);
  } else {
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    const float* tdo = static_cast<const float*>(dout);
    const bool vec = head_dim % 4 == 0 && aligned;
    flash_tail_bwd_delta_kernel<float><<<delta_blocks, 256, 0, stream>>>(
        static_cast<const float*>(o), tdo, delta, rows, seq, heads, head_dim);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * heads, (seq + kF32Rows - 1) / kF32Rows);
    const size_t smem = F32BwdLayout<DP>::kBytes;
    auto dkdv = flash_tail_bwd_dkdv_f32_kernel<DP>;
    auto dqk = flash_tail_bwd_dq_f32_kernel<DP>;
    if ((err = set_smem(dkdv, smem)) != cudaSuccess ||
        (err = set_smem(dqk, smem)) != cudaSuccess)
      return static_cast<int>(err);
    dkdv<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), seq, heads, head_dim, scale, scale_log2, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dqk<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                                          static_cast<float*>(dq), seq, heads,
                                          head_dim, scale, scale_log2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int seq, int heads, int head_dim) {
  return batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
         head_dim > 128 || (seq + kF32Rows - 1) / kF32Rows > 65535 ||
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

// dq, dk, dv of the forward above: q, k, v, o (its output), dout and the
// outputs are contiguous BSHD tensors of one type; lse is the forward's
// (batch * heads, seq) fp32 output; delta is fp32 scratch of the same size.
// Returns a cudaError_t.
extern "C" int flash_tail_backward(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int batch, int seq, int heads,
                                   int head_dim, float scale, int is_bf16,
                                   void* stream) {
  if (bad_shape(batch, seq, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (head_dim <= 32)
    return launch_bwd_dp<32>(q, k, v, o, dout, l, dl, dq, dk, dv, batch, seq,
                             heads, head_dim, scale, is_bf16, st);
  if (head_dim <= 64)
    return launch_bwd_dp<64>(q, k, v, o, dout, l, dl, dq, dk, dv, batch, seq,
                             heads, head_dim, scale, is_bf16, st);
  return launch_bwd_dp<128>(q, k, v, o, dout, l, dl, dq, dk, dv, batch, seq,
                            heads, head_dim, scale, is_bf16, st);
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
