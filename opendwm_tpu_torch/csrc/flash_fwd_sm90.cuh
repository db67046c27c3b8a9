// The attention forward for Hopper (sm_90a) in bf16 at head dim 64: one
// TMA + wgmma mainloop that both forward sources include.
//
// It replaces, for every bf16 head-dim-64 launch (every head on the port's
// paths: DiT 24 x 64, UNet 5/10/20 x 64):
//   - K1: the Pallas kernel opendwm_tpu/ops/flash_tail.py:_forward (:55,
//     body _kernel :31), launched by flash_tail.cu with q_seq = kv_seq and
//     no causal mask;
//   - K7 and K7-seg: the stock Pallas flash attention forward that
//     opendwm_tpu/ops/attention.py:151-187 and perf/exp_attn602.py:67 call,
//     launched by flash_attention.cu with its causal, log-sum-exp and
//     segment-id flags.
// Both launches instantiate the same kernel, so K1 and K7 (non-causal,
// q_seq = kv_seq) give the same bits. It computes what the bodies it
// replaces compute: fp32 logits scaled into the log2 domain and an online
// softmax in fp32; probabilities rounded to bf16 before the product with V;
// keys past kv_seq at -inf; top-left causal masking (key j visible to query
// i iff j <= i); with segment ids the finite kSegmentMask added after
// scaling to a pair whose ids differ (a row that sees no key of its segment
// gets the mean of V); with kLse the row log-sum-exp in the log2 domain.
//
// What bounds it on this card. Per (batch, head) the work is 4*Sq*Skv*64
// flops against 2*(Sq + Skv)*64*2 bytes of q/k/v/o: ~300-900 flops a byte
// at the paths' shapes, so the tensor cores' rate bounds it on paper. At
// head dim 64 the softmax's exponentials and fp32 arithmetic (one MUFU.EX2
// and ~6 ALU instructions a score, against 64 MACs of tensor-core work) are
// as costly as the two products; only wgmma reaches the tensor cores' full
// rate, and the softmax of one warpgroup has to overlap the products of
// another. The mma.sync bodies this replaces loaded each K/V tile between
// two __syncthreads(), built B fragments with scalar shared loads, tested
// the bounds of every score, and stored 2-byte outputs.
//
// The design:
//   - An asynchronous K/V ring. kStages 64-key K and V tiles in shared
//     memory, filled by one producer warp with TMA (a 4-D tensor map over
//     the BSHD tensor, (D, H, S, B), box 64 x 1 x 64 x 1, 128-byte swizzle;
//     a 64-wide bf16 row is exactly 128 bytes). Each stage completes on an
//     mbarrier with its byte count; the consumers release it on another.
//     TMA zero-fills rows past the end, which gives K1's ragged tails (602,
//     448, 336, 168) and the last query tile for free. Under K7-seg the
//     producer warp also copies the tile's 64 key ids into the stage.
//     cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
//     library links no -lcuda.
//   - wgmma for both products. The consumer warpgroup owns the block's 64
//     query rows. S = Q K^T is 4 wgmma m64n64k16 with Q and K read from
//     the swizzled shared tiles (K-major). The fp32 accumulator
//     of wgmma m64nN has, per warp, the m16n8 C-fragment layout (rows g and
//     g + 8, columns 2t and 2t + 1 of each 8-column slice), so the online
//     softmax, the masks and the log-sum-exp work on it in registers. P,
//     packed to bf16 in registers, is wgmma's register A operand (per warp
//     mma.sync's A layout); O += P V is 4 wgmma m64n64k16 with V the
//     MN-major shared B operand (the transpose bit), so V is never
//     transposed in memory.
//   - Masks only where needed: interior tiles run no bounds test; the last
//     tile masks keys >= kv_seq; under the causal mask only the diagonal
//     tile masks, and the tiles wholly above it are never loaded.
//   - Epilogue: O is normalised, converted to bf16, written into the
//     block's Q tile in the same 128-byte-swizzled layout and stored
//     with one TMA store, which drops rows past q_seq.
//   - Block shape: one consumer warpgroup (64 query rows) after one
//     producer warpgroup whose first warp issues the loads, two blocks an
//     SM; setmaxnreg moves the producer's registers to the consumer at
//     run time, but ptxas compiles the consumer's code within the launch's
//     128 registers (the backward's builds spill above that count whatever
//     the split), which this consumer fits. On the card this was faster at
//     every path shape than two consumer warpgroups at one block an SM,
//     and than one at three blocks, which spills (PERF.md has the times).
//     The blocks walk the query tiles of one (batch, head) first, so the
//     blocks resident on the card share K/V in L2.
//   - Inside the warpgroup the products are issued one tile apart: the
//     softmax of tile i runs while the tensor cores finish P V of tile
//     i - 1 and S of tile i + 1 waits for it.
//   - The warpgroup's mainloop (attend_rows) and epilogue (finish_rows)
//     are functions of their own: the tilings K5 and K6
//     (tail_tiling_sm90.cuh) call them under another schedule, so a row
//     gets the same bits in K1, K7, K5 and K6.
//
// The wrapper's launch decides which body runs before the launch
// (Sm90Takes, sm90.cuh, which also holds the PTX helpers this kernel shares
// with the backward): this one for bf16 at head dim 64 with q, k, v and o
// 16-byte aligned. Every other launch (fp32, other head dims, unaligned
// pointers) keeps the mma.sync or FMA body of its source.

#pragma once

#include "sm90.cuh"

namespace {
namespace fwd90 {

using namespace sm90;

constexpr int kThreads = 256;    // the producer and the consumer warpgroup
constexpr int kBlocksPerSm = 2;
constexpr int kStages = 4;       // K/V tiles in flight
constexpr float kSegmentMask = -0.7f * 3.402823466e38f;

// Registers a thread at launch (the __launch_bounds__ below give ptxas
// exactly this many: the SM's 64K shared by the blocks), and after
// setmaxnreg: the producer's 4 warps drop to 24 and the consumer takes
// what they free.
constexpr int kLaunchRegs = 65536 / (kThreads * kBlocksPerSm);  // 128
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 2 * kLaunchRegs - kProducerRegs;  // 232
static_assert(kConsumerRegs % 8 == 0 && kConsumerRegs <= 256,
              "setmaxnreg takes a multiple of 8 up to 256");

// Shared memory (bytes from a 1024-byte-aligned base: the 128-byte swizzle
// repeats every 8 rows of 128 bytes).
struct Smem {
  static constexpr uint32_t kQ = 0;  // the Q tile; the epilogue's O after
  static constexpr uint32_t kK = kQ + kTileBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kIds = kV + kStages * kTileBytes;  // 64 int32
  static constexpr uint32_t kBar = kIds + kStages * kTileRows * 4;
  // q_full, full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr size_t kDynamic = kBytes + 1024;  // base alignment
};

struct Params {
  CUtensorMap q, k, v, o;  // (64, heads, seq, batch) bf16 maps
  float* lse;              // (batch * heads, q_seq) or null
  const int* q_ids;        // (batch, q_seq) or null
  const int* kv_ids;       // (batch, kv_seq) or null
  int q_seq, kv_seq, heads, q_tiles;
  float scale_log2;
};

// ---------------------------------------------------------------------------
// One tile's online-softmax update
// ---------------------------------------------------------------------------

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// op over the thread's 16 values of fragment row r (s[4n + 2r + {0, 1}]),
// as a tree: 4 dependent steps instead of 15.
template <typename Op>
__device__ __forceinline__ float row_reduce(const float (&s)[32], int r,
                                            Op op) {
  float v[8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    v[n] = op(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int n = 0; n < w; ++n) v[n] = op(v[n], v[n + w]);
  }
  return v[0];
}

// s: the warp's scores of this tile in the C-fragment layout (s[4n + i]:
// row rows[i >> 1], key kv0 + 8n + 2t + (i & 1)). Scales them into the log2
// domain; with kMask hides keys >= kv_seq and, under kCausal, keys after
// the row; with kSegment adds kSegmentMask where the ids differ. Then the
// running max m_run, the lane's share of the row sum l_run (tree sums of
// the tile's probabilities), the correction of the output and the
// probabilities (left in s).
template <bool kMask, bool kCausal, bool kSegment>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m_run)[2], float (&l_run)[2], float (&corr)[2],
    const int (&rows)[2], const int (&row_id)[2], const int* ids, int kv0,
    int kv_seq, float scale_log2, int t) {
  // keys [kv0, kv0 + limit[r]) are visible to row rows[r]
  int limit[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    limit[r] = (kCausal ? min(kv_seq, rows[r] + 1) : kv_seq) - kv0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * n + 2 * t + (i & 1);
      float val = s[4 * n + i] * scale_log2;
      if constexpr (kMask) {
        if (c >= limit[i >> 1]) val = -INFINITY;
      }
      if constexpr (kSegment) {
        if (row_id[i >> 1] != ids[c]) val += kSegmentMask;
      }
      s[4 * n + i] = val;
    }
  }
  // The first tile holds key 0, visible to every row, so m_run is finite
  // after it (its correction is exp2(-inf) = 0).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = row_reduce(s, r, Max());
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    corr[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = ex2(s[i] - m_run[(i >> 1) & 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_run[r] = l_run[r] * corr[r] + row_reduce(s, r, Sum());
}

// ---------------------------------------------------------------------------
// One consumer warpgroup's 64 query rows against a run of K/V tiles
// ---------------------------------------------------------------------------

// The K/V ring as a consumer reads it: stage s holds a K tile at
// k + s * kTileBytes, a V tile at v + s * kTileBytes and (K7-seg) the
// tile's 64 key ids at ids + s * kTileRows; it completes on the mbarrier at
// full + 8 * s and is released on the one at empty + 8 * s.
struct Ring {
  uint32_t k, v, full, empty;
  const int* ids;
};

// When a warpgroup may issue its products: take() before it issues, pass()
// after. A lone warpgroup needs no turns; two that share an SM may take
// them in turn (tail_tiling_sm90.cuh), so that one's softmax runs while
// the other's products do. The order of issue changes no bit.
struct NoTurns {
  __device__ __forceinline__ void take() const {}
  __device__ __forceinline__ void pass() const {}
};

// The mainloop of one consumer warpgroup: its 64 query rows [q0, q0 + 64)
// (the K-major tile at sQ; rows[] are this thread's two, row_id[] their
// segment ids) against the n_tiles K/V tiles 0, 1, ... of their head, which
// the ring delivers at positions first, first + 1, ...: position pos lives
// in stage pos % kStages and completes the phase of parity
// (pos / kStages) & 1. Leaves the unnormalised output in o, the running max
// in m_run and the lane's share of the row sums in l_run, and releases
// every stage it read. K1, K7 and K7-seg (one run a block, first = 0) and
// the tilings K5 and K6 (tail_tiling_sm90.cuh: runs one after another
// through one ring) all call it, so a row gets the same bits in each. It
// issues products n_tiles + 1 times, each between turns.take() and
// turns.pass().
template <int kStages, bool kCausal, bool kSegment, class Turns = NoTurns>
__device__ __forceinline__ void attend_rows(
    float (&o)[32], float (&m_run)[2], float (&l_run)[2], uint32_t sQ,
    const Ring& ring, int first, int n_tiles, int q0, const int (&rows)[2],
    const int (&row_id)[2], int kv_seq, float scale_log2, int t,
    const Turns& turns = Turns()) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  m_run[0] = m_run[1] = -INFINITY;
  l_run[0] = l_run[1] = 0.0f;

  // Tile `it` lives in stage (first + it) % kStages. The products are
  // issued one tile apart: while the softmax of tile it runs on the ALUs,
  // the tensor cores finish P V of tile it - 1. The operations on O keep
  // the order of a loop without the overlap (O corr_i, then + P_i V_i), so
  // the overlap changes no bit.
  float sc[32];
  float corr[2];
  uint32_t pa[4][4];
  auto stage = [&](int it) { return (first + it) % kStages; };
  auto wait_full = [&](int it) {
    mbar_wait(ring.full + 8 * stage(it), ((first + it) / kStages) & 1);
  };
  auto release = [&](int it) { mbar_arrive(ring.empty + 8 * stage(it)); };
  auto issue_scores = [&](int it) {  // sc = Q K_it^T
    const uint32_t sK = ring.k + stage(it) * kTileBytes;
    wgmma_ss<false>(sc, kmajor_desc(sQ, 0), kmajor_desc(sK, 0));
#pragma unroll
    for (int k = 1; k < kD / 16; ++k)
      wgmma_ss<true>(sc, kmajor_desc(sQ, k), kmajor_desc(sK, k));
    wgmma_commit();
  };
  auto issue_pv = [&](int it) {  // o += P_it V_it
    const uint32_t sV = ring.v + stage(it) * kTileBytes;
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs(o, pa[j], mnmajor_desc(sV, j));
    wgmma_commit();
  };
  auto softmax = [&](int it) {
    const int kv0 = it * kTileRows;
    const int* ids = ring.ids + stage(it) * kTileRows;
    const bool edge = kv0 + kTileRows > kv_seq ||
                      (kCausal && kv0 + kTileRows - 1 > q0);
    if (edge)
      softmax_tile<true, kCausal, kSegment>(sc, m_run, l_run, corr, rows,
                                            row_id, ids, kv0, kv_seq,
                                            scale_log2, t);
    else
      softmax_tile<false, kCausal, kSegment>(sc, m_run, l_run, corr, rows,
                                             row_id, ids, kv0, kv_seq,
                                             scale_log2, t);
  };
  // P's 16-key slice j is the A fragment of score slices 2j and 2j + 1.
  auto pack_p = [&] {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[j][x] = pack_bf16(sc[8 * j + 2 * x], sc[8 * j + 2 * x + 1]);
    }
  };

  for (int it = 0; it < n_tiles; ++it) {
    wait_full(it);
    turns.take();
    wgmma_fence();
    issue_scores(it);
    if (it > 0) issue_pv(it - 1);
    turns.pass();
    if (it > 0) {
      wgmma_wait<1>();  // the scores; P V of tile it - 1 runs on
    } else {
      wgmma_wait<0>();
    }
    pin(sc);
    softmax(it);
    if (it > 0) {  // tile 0 finds O at 0: no correction
      wgmma_wait<0>();
      pin(o);
      release(it - 1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
    }
    pack_p();
  }
  turns.take();
  wgmma_fence();
  issue_pv(n_tiles - 1);
  turns.pass();
  wgmma_wait<0>();
  pin(o);
  release(n_tiles - 1);
}

// The epilogue of attend_rows: the row sums, with kLse the log-sum-exp of
// the rows below q_seq into lse[bh * q_seq + row], and O / l in bf16 into
// the 64-row tile at `tile` (128-byte swizzle: 16-byte chunk n of row r at
// chunk n ^ (r % 8)), made visible to the TMA store that follows.
template <bool kLse>
__device__ __forceinline__ void finish_rows(float (&o)[32],
                                            const float (&m_run)[2],
                                            float (&l_run)[2],
                                            unsigned char* tile, float* lse,
                                            int bh, const int (&rows)[2],
                                            int q_seq, int warp, int g,
                                            int t) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.0f / l_run[r];
    if (kLse && t == 0 && rows[r] < q_seq)
      lse[static_cast<size_t>(bh) * q_seq + rows[r]] =
          m_run[r] + log2f(l_run[r]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= inv[(i >> 1) & 1];
  store_tile_bf16(tile, o, warp, g, t);
  fence_async_smem();
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <bool kCausal, bool kLse, bool kSegment>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p) {
  using L = Smem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  // Query tiles of one (batch, head) are neighbours in launch order.
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x - bh * p.q_tiles) * kTileRows;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int kv_end = kCausal ? min(p.kv_seq, q0 + kTileRows) : p.kv_seq;
  const int n_tiles = (kv_end + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // the loads' expected bytes, and with ids the producer warp's lanes
      mbar_init(bar_full + 8 * s, kSegment ? 33 : 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: warp 0 keeps the ring full; warps 1-3 only give
    // their registers up.
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bar_q, kTileBytes);
        tma_load(base + L::kQ, &p.q, bar_q, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
          tma_load(base + L::kK + s * kTileBytes, &p.k, bar_full + 8 * s, h,
                   it * kTileRows, b);
          tma_load(base + L::kV + s * kTileBytes, &p.v, bar_full + 8 * s, h,
                   it * kTileRows, b);
        }
        if constexpr (kSegment) {
          int* ids = reinterpret_cast<int*>(smem + L::kIds) + s * kTileRows;
          for (int j = lane; j < kTileRows; j += 32) {
            const int kv = it * kTileRows + j;
            ids[j] = kv < p.kv_seq
                         ? p.kv_ids[static_cast<size_t>(b) * p.kv_seq + kv]
                         : 0;
          }
          mbar_arrive(bar_full + 8 * s);
        }
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int ctid = threadIdx.x - 128;
    const int warp = ctid >> 5;
    const int lane = ctid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
    const uint32_t sQ = base + L::kQ;
    int row_id[2] = {0, 0};
    if constexpr (kSegment) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < p.q_seq)
          row_id[r] = p.q_ids[static_cast<size_t>(b) * p.q_seq + rows[r]];
    }

    const Ring ring = {base + L::kK, base + L::kV, bar_full, bar_empty,
                       reinterpret_cast<const int*>(smem + L::kIds)};
    float o[32], m_run[2], l_run[2];
    mbar_wait(bar_q, 0);
    attend_rows<kStages, kCausal, kSegment>(o, m_run, l_run, sQ, ring, 0,
                                            n_tiles, q0, rows, row_id,
                                            p.kv_seq, p.scale_log2, t);
    // Epilogue: O into the Q tile, then one TMA store of the block's 64
    // rows (it drops rows past q_seq).
    finish_rows<kLse>(o, m_run, l_run, smem + L::kQ, p.lse, bh, rows,
                      p.q_seq, warp, g, t);
    bar_sync(1, 128);
    if (ctid == 0) tma_store(&p.o, sQ, h, q0, b);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The parameters of a launch on this body: q (batch, q_seq, heads, 64), k
// and v (batch, kv_seq, heads, 64), o like q, all bf16 and 16-byte aligned
// (Sm90Takes); lse null or (batch * heads, q_seq) fp32; q_ids / kv_ids null
// or the int32 segment ids. False if a tensor map cannot be made.
inline bool make_params(Params* p, const void* q, const void* k,
                        const void* v, void* o, float* lse, const int* q_ids,
                        const int* kv_ids, int batch, int q_seq, int kv_seq,
                        int heads, float scale) {
  if (!make_map(&p->q, q, batch, q_seq, heads) ||
      !make_map(&p->k, k, batch, kv_seq, heads) ||
      !make_map(&p->v, v, batch, kv_seq, heads) ||
      !make_map(&p->o, o, batch, q_seq, heads))
    return false;
  p->lse = lse;
  p->q_ids = q_ids;
  p->kv_ids = kv_ids;
  p->q_seq = q_seq;
  p->kv_seq = kv_seq;
  p->heads = heads;
  p->q_tiles = (q_seq + kTileRows - 1) / kTileRows;
  p->scale_log2 = scale * kLog2e;
  return true;
}

// One launch of the body with its flags. Returns a cudaError_t.
template <bool kCausal, bool kLse, bool kSegment>
int launch(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<kCausal, kLse, kSegment>;
  // setmaxnreg moves registers that were allocated at launch, so ptxas must
  // have given the kernel exactly kLaunchRegs a thread; checked once.
  static const cudaError_t ready = [kernel] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem::kDynamic));
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs == kLaunchRegs ? cudaSuccess
                                      : cudaErrorInvalidConfiguration;
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const long long blocks =
      static_cast<long long>(p.q_tiles) * batch * p.heads;
  if (blocks > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, Smem::kDynamic, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd90
}  // namespace
